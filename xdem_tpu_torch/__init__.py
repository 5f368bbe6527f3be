"""xdem_tpu_torch: the PyTorch and CUDA port of xdem_tpu.

Terrain attributes (``xdem_tpu_torch.terrain``), 3-D coregistration of raster pairs
(``xdem_tpu_torch.coreg``: Nuth & Kääb, vertical shift, DhMinimize, ICP, CPD, LZD, the bias
corrections Deramp, DirectionalBias and TerrainBias, pipelines, and the matrix apply), the
robust fits behind them (``xdem_tpu_torch.fit``), the uncertainty of elevation differences
(``xdem_tpu_torch.uncertainty``, ``xdem_tpu_torch.spatialstats``) and volume change by
hypsometric binning (``xdem_tpu_torch.volume``) on tensors, in float32, on one device: CUDA
when present, else the CPU. On a CUDA tensor the terrain attributes come from hand-written
CUDA kernels built with ``nvcc`` at first use; on a CPU tensor from their plain PyTorch
versions. The package imports neither JAX nor xdem_tpu, which stays the reference it is
tested against.
"""

from __future__ import annotations

__version__ = "0.1.0"

from xdem_tpu_torch._device import as_tensor, default_device
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch import coreg, fit, georef, ops, spatialstats, terrain, uncertainty, volume

__all__ = ["Affine", "as_tensor", "default_device", "coreg", "fit", "georef", "ops", "spatialstats", "terrain",
           "uncertainty", "volume"]
