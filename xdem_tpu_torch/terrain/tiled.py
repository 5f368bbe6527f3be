"""Out-of-core terrain attributes: row bands streamed through the kernels into GeoTIFFs.

Port of xdem_tpu/terrain/tiled.py. Each band of `tile_rows` rows, with the stencils' halo and
NaN beyond the raster, goes to the device, runs `get_terrain_attribute` (so the kernels K1,
K2 and K3 launch once a band each), and only its output rows come back to be written into
one uncompressed striped GeoTIFF per attribute (`io.StreamingRasterWriter`). Peak memory is
one band, not the attribute stack: the full suite at 20 000 x 20 000 would be ~22 GB.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from xdem_tpu_torch._device import default_device
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.terrain.surfit import SURFACE_FIT_ATTRS
from xdem_tpu_torch.terrain.terrain import ALL_ATTRS, FREQUENCY_ATTRS, get_terrain_attribute
from xdem_tpu_torch.terrain.window import FRACTAL_ATTRS, WINDOWED_ATTRS


@dataclass
class TilingConfig:
    """Out-of-core tiling parameters (the analog of upstream xdem's MultiprocConfig)."""

    tile_rows: int = 1024
    outdir: str | None = None
    out_paths: dict[str, str] = field(default_factory=dict)

    def path_for(self, attr: str) -> str:
        if attr in self.out_paths:
            return self.out_paths[attr]
        if self.outdir is None:
            raise ValueError("TilingConfig needs `outdir` or per-attribute `out_paths`.")
        Path(self.outdir).mkdir(parents=True, exist_ok=True)
        return str(Path(self.outdir) / f"{attr}.tif")


def _halo_for(attrs: Sequence[str], surface_fit: str, window_size: int, window_size_fractal: int) -> int:
    halo = 0
    if any(a in SURFACE_FIT_ATTRS for a in attrs):
        halo = max(halo, 2 if surface_fit.lower() == "florinsky" else 1)
    if any(a in WINDOWED_ATTRS for a in attrs):
        halo = max(halo, window_size // 2)
    if any(a in FRACTAL_ATTRS for a in attrs):
        halo = max(halo, window_size_fractal // 2)
    return halo


class _RowSource:
    """Row access to the input DEM: a Raster's or a tensor's rows sliced where they live, an
    array's on the host, or windowed reads of a GeoTIFF (an uncompressed striped file is read
    band by band; a compressed one is decoded once)."""

    def __init__(self, dem: Any):
        from xdem_tpu_torch.raster import Raster

        self.transform: Affine | None = None
        self.crs = None
        self._data: torch.Tensor | np.ndarray | None = None
        self._path: str | None = None
        if isinstance(dem, (str, Path)):
            import ctypes

            from xdem_tpu_torch.io import _GtInfo, _lib, read_raster, read_rows

            info = _GtInfo()
            if _lib().gt_info(str(dem).encode(), ctypes.byref(info)) != 0:
                raise OSError(f"Cannot read GeoTIFF '{dem}'.")
            self.shape = (int(info.height), int(info.width))
            self.transform = Affine(*info.transform)
            self.crs = int(info.epsg) if info.epsg else None
            try:  # windowed reads need the uncompressed striped float32 layout
                read_rows(str(dem), 0, 1)
                self._path = str(dem)
            except OSError:
                self._data = read_raster(str(dem)).data
        elif isinstance(dem, Raster):
            self._data = dem.data
            self.transform = dem.transform
            self.crs = dem.crs
        elif isinstance(dem, torch.Tensor):
            self._data = dem
        else:
            self._data = np.asarray(dem)
        if self._data is not None:
            self.shape = tuple(self._data.shape)
        self.device = self._data.device if isinstance(self._data, torch.Tensor) else default_device()

    def rows(self, r0: int, nrows: int) -> torch.Tensor | np.ndarray:
        """Rows [r0, r0 + nrows) as float32, on the host or the device they live on."""
        if self._data is None:
            from xdem_tpu_torch.io import read_rows

            return read_rows(self._path, r0, nrows)
        block = self._data[r0: r0 + nrows]
        return block.to(torch.float32) if isinstance(block, torch.Tensor) else np.asarray(block, dtype=np.float32)


def _band_on(device: torch.device, band_shape: tuple[int, int], rows: Any, at: int) -> torch.Tensor:
    """A NaN band of `band_shape` on `device` holding `rows` from its row `at`."""
    band = torch.full(band_shape, torch.nan, dtype=torch.float32, device=device)
    block = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(rows))
    band[at: at + block.shape[0]] = block.to(device)
    return band


def _rows_to_host(planes: Sequence[torch.Tensor], halo: int, nrows: int) -> list[np.ndarray]:
    """The band's output rows of each attribute plane, copied to the host."""
    return [p[halo: halo + nrows].cpu().numpy() for p in planes]


def tiled_terrain_attribute(
    dem: Any,
    attribute: str | Sequence[str],
    tiling: TilingConfig,
    resolution: float | tuple[float, float] | None = None,
    transform: Affine | None = None,
    crs: Any = None,
    nodata: float = -99999.0,
    **kwargs: Any,
) -> list[str]:
    """Compute terrain attributes band by band, streaming the results to GeoTIFFs.

    Bands of `tiling.tile_rows` rows plus the stencils' halo all have one shape (the last
    is padded with NaN); each attribute is written to `tiling.path_for(attr)` as its band
    completes. Each band is centred on its own mean before the surface fit, as in xdem_tpu,
    so the surface-fit attributes differ from the whole-array pass by float32 rounding.
    Texture shading is a global FFT and cannot be tiled. Returns the output paths.

    :param dem: Raster, 2-D array or tensor, or the path of a GeoTIFF. A Raster's or a
        tensor's bands are sliced on its device; an array's or a file's go to the default
        device.
    """
    attrs = [attribute] if isinstance(attribute, str) else list(attribute)
    for a in attrs:
        if a in FREQUENCY_ATTRS:
            raise ValueError(f"'{a}' is a global frequency-domain attribute and cannot be tiled.")
        if a not in ALL_ATTRS:
            raise ValueError(f"Attribute '{a}' is not supported. Choices: {list(ALL_ATTRS)}")

    # The streaming writer lays out float32 strips: refuse other output types.
    out_dtype = kwargs.pop("out_dtype", None)
    if out_dtype is not None and np.dtype(out_dtype) != np.float32:
        raise ValueError(
            f"tiled= streams float32 GeoTIFFs; out_dtype={np.dtype(out_dtype)} is not supported "
            f"out of core. Use the in-memory path for other output dtypes."
        )

    src = _RowSource(dem)
    if transform is None:
        transform = src.transform
    if crs is None:
        crs = src.crs
    if resolution is None and transform is not None:
        resolution = (abs(transform.xres), abs(transform.yres))

    surface_fit = kwargs.get("surface_fit", "Florinsky")
    window_size = int(kwargs.get("window_size", 3))
    window_size_fractal = int(kwargs.get("window_size_fractal", 13))
    halo = _halo_for(attrs, surface_fit, window_size, window_size_fractal)

    h, w = src.shape
    tile_rows = int(tiling.tile_rows)
    if transform is None:
        transform = Affine(1.0, 0.0, 0.0, 0.0, -1.0, float(h))

    from xdem_tpu_torch.io import StreamingRasterWriter

    writers = {
        a: StreamingRasterWriter(tiling.path_for(a), (h, w), transform, crs=crs, nodata=nodata)
        for a in attrs
    }
    band_shape = (tile_rows + 2 * halo, w)
    try:
        for r0 in range(0, h, tile_rows):
            nrows = min(tile_rows, h - r0)
            lo = max(0, r0 - halo)
            hi = min(h, r0 + nrows + halo)
            # Real rows land so that the band's first output row is always at index `halo`.
            band = _band_on(src.device, band_shape, src.rows(lo, hi - lo), halo - (r0 - lo))
            out = get_terrain_attribute(band, attrs, resolution=resolution, **kwargs)
            del band
            for a, rows in zip(attrs, _rows_to_host(out if isinstance(out, list) else [out], halo, nrows)):
                writers[a].write_rows(r0, rows)
    finally:
        for wtr in writers.values():
            wtr.close()
    return [tiling.path_for(a) for a in attrs]
