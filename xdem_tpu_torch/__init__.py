"""xdem_tpu_torch: the PyTorch and CUDA port of xdem_tpu.

Elevation objects (``DEM`` and ``Raster``: a float32 tensor with NaN nodata, an ``Affine``
transform and a ``CRS``; GeoTIFF I/O through a native codec in ``xdem_tpu_torch.io``;
reprojection and vertical CRS transforms on the tensors' device; ``Vector`` masks; the point
clouds ``PointCloud`` and ``EPC``, float64 tensors on one device, with LAS/npz/text files),
terrain attributes (``xdem_tpu_torch.terrain``), 3-D coregistration of raster-raster and
raster-point pairs (``xdem_tpu_torch.coreg``: Nuth & Kääb, vertical shift, DhMinimize, ICP,
CPD, LZD, the bias corrections Deramp, DirectionalBias and TerrainBias, pipelines, blockwise
Nuth & Kääb, and the matrix apply), the
robust fits behind them (``xdem_tpu_torch.fit``), the uncertainty of elevation differences
(``xdem_tpu_torch.uncertainty``, ``xdem_tpu_torch.spatialstats``) and volume change by
hypsometric binning (``xdem_tpu_torch.volume``, ``dDEM`` and ``DEMCollection``), out-of-core
tiled terrain attributes (``terrain.tiled_terrain_attribute``) and the Topo and Accuracy
workflows with their command line (``xdem_tpu_torch.workflows``, ``xdem_tpu_torch.cli``), in
float32, on one device: CUDA when present, else the CPU. On a CUDA tensor the terrain
attributes come from hand-written CUDA kernels built with ``nvcc`` at first use; on a CPU tensor
from their plain PyTorch versions.
The package imports neither JAX nor xdem_tpu, which stays the reference it is tested against.

>>> from xdem_tpu_torch import DEM, examples, coreg
>>> ref, tba = examples.get_ref_dem_test(), examples.get_tba_dem_test()  # doctest: +SKIP
>>> aligned = tba.coregister_3d(ref, inlier_mask=~examples.get_glacier_outlines().create_mask(ref))  # doctest: +SKIP
"""

from __future__ import annotations

__version__ = "0.1.0"

from xdem_tpu_torch._device import as_tensor, default_device
from xdem_tpu_torch.georef import CRS, Affine
from xdem_tpu_torch import (coreg, examples, fit, georef, io, ops, spatialstats, terrain, uncertainty, vcrs,
                            volume)
from xdem_tpu_torch.config import config, config_context
from xdem_tpu_torch.ddem import dDEM
from xdem_tpu_torch.dem import DEM
from xdem_tpu_torch.demcollection import DEMCollection
from xdem_tpu_torch.epc import EPC
from xdem_tpu_torch.pointcloud import PointCloud
from xdem_tpu_torch.raster import Raster
from xdem_tpu_torch.vector import Vector


def __getattr__(name: str):
    # The workflows (reports, plots, YAML) load on first use, as in xdem_tpu.
    if name == "workflows":
        import importlib

        mod = importlib.import_module(f"xdem_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'xdem_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"workflows"})


__all__ = ["DEM", "dDEM", "DEMCollection", "EPC", "PointCloud", "Raster", "Vector", "CRS", "Affine", "config",
           "config_context", "as_tensor", "default_device",
           "coreg", "examples", "fit", "georef", "io", "ops", "spatialstats", "terrain", "uncertainty", "vcrs",
           "volume", "workflows"]
