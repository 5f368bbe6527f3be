"""Coregistration: Nuth & Kääb and vertical shift on raster pairs, with the matrix toolbox."""

from xdem_tpu_torch.coreg.base import (
    Coreg,
    apply_matrix,
    invert_matrix,
    matrix_from_translations_rotations,
    translations_rotations_from_matrix,
)
from xdem_tpu_torch.coreg.affine import AffineCoreg, NuthKaab, VerticalShift

__all__ = [
    "Coreg",
    "AffineCoreg",
    "VerticalShift",
    "NuthKaab",
    "apply_matrix",
    "invert_matrix",
    "matrix_from_translations_rotations",
    "translations_rotations_from_matrix",
]
