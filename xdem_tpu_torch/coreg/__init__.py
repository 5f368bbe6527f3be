"""3-D coregistration of raster-raster and raster-point pairs (Rasters/DEMs, arrays and tensors
with a transform, PointCloud/EPC): affine methods, bias corrections and pipelines, blockwise
coregistration (BlockwiseCoreg, BlockwiseNuthKaab, MultiprocConfig), with the matrix
toolbox."""

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
