"""3-D coregistration of raster pairs (Rasters/DEMs, or arrays and tensors with a transform):
affine methods, bias corrections and pipelines, with the matrix toolbox. Blockwise
coregistration (BlockwiseCoreg, BlockwiseNuthKaab, MultiprocConfig) is not ported yet: those
names raise NotImplementedError."""

from xdem_tpu_torch.coreg.base import (
    Coreg,
    CoregPipeline,
    apply_matrix,
    invert_matrix,
    matrix_from_translations_rotations,
    translations_rotations_from_matrix,
)
from xdem_tpu_torch.coreg.affine import CPD, ICP, LZD, AffineCoreg, DhMinimize, NuthKaab, VerticalShift
from xdem_tpu_torch.coreg.biascorr import BiasCorr, Deramp, DirectionalBias, TerrainBias
from xdem_tpu_torch.coreg.blockwise import BlockwiseCoreg, BlockwiseNuthKaab, MultiprocConfig

__all__ = [
    "Coreg",
    "CoregPipeline",
    "AffineCoreg",
    "VerticalShift",
    "NuthKaab",
    "DhMinimize",
    "ICP",
    "CPD",
    "LZD",
    "BiasCorr",
    "Deramp",
    "DirectionalBias",
    "TerrainBias",
    "BlockwiseCoreg",
    "BlockwiseNuthKaab",
    "MultiprocConfig",
    "apply_matrix",
    "invert_matrix",
    "matrix_from_translations_rotations",
    "translations_rotations_from_matrix",
]
