"""Vertical CRS handling: parsing, compound CRS semantics, and z transforms.

Port of xdem_tpu/vcrs.py (its tables are copied, and a CPU test holds them equal): the
product-to-vcrs table, the vcrs from user input (name / EPSG / grid / VerticalCRS), and
`_transform_zz`, which here runs on the elevations' device in float64: the horizontal
coordinates go to longitude and latitude through `projections.TORCH`, and the geoid
undulation is a bilinear lookup on its grid with `torch.searchsorted`.

The package ships no PROJ geoid grids, so geoid transforms use *registered*
geoid-undulation grids: `register_geoid_grid(name, lons, lats, undulations)` makes 'name'
transformable; EGM96 and EGM08 fall back to the built-in coarse field of `geoid.py`.
'Ellipsoid' is always available. Unregistered geoids raise an informative error at transform
time (parsing and metadata round-trip still work).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, TypedDict

import numpy as np
import torch

from xdem_tpu_torch import projections
from xdem_tpu_torch.georef import CRS, transform_points

class VCRSMetaDict(TypedDict, total=False):
    """Metadata of a common vertical CRS: PROJ grid file name and EPSG code
    (reference vcrs.py:199-202)."""

    grid: str
    epsg: int


# EPSG codes for common vertical CRSs
_VCRS_EPSG = {5773: "EGM96", 3855: "EGM08", 4979: "Ellipsoid", 5703: "NAVD88"}
_VCRS_GRIDS = {"us_nga_egm96_15.tif": "EGM96", "us_nga_egm08_25.tif": "EGM08"}

_PRODUCT_VCRS = {
    "ArcticDEM": "Ellipsoid",
    "REMA": "Ellipsoid",
    "EarthDEM": "Ellipsoid",
    "TDM1": "Ellipsoid",
    "NASADEM-HGTS": "Ellipsoid",
    "AW3D30": "EGM96",
    "SRTMv4.1": "EGM96",
    "SRTMGL1": "EGM96",
    "ASTGTM2": "EGM96",
    "NASADEM-HGT": "EGM96",
    "COPDEM": "EGM08",
}


@dataclass(frozen=True)
class VerticalCRS:
    """A vertical reference: 'Ellipsoid' or a named geoid (e.g. 'EGM96')."""

    name: str

    def __str__(self) -> str:
        return self.name

    @property
    def is_ellipsoid(self) -> bool:
        return self.name.lower() == "ellipsoid"


_GEOID_GRIDS: Dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def register_geoid_grid(name: str, lons: np.ndarray, lats: np.ndarray, undulations: np.ndarray) -> None:
    """Register a geoid undulation grid (meters above the ellipsoid) usable in to_vcrs.

    :param name: Geoid name (e.g. 'EGM96').
    :param lons: 1-D ascending longitudes (degrees).
    :param lats: 1-D ascending latitudes (degrees).
    :param undulations: (len(lats), len(lons)) geoid heights above the ellipsoid.
    """
    _GEOID_GRIDS[name.upper()] = (np.asarray(lons, float), np.asarray(lats, float), np.asarray(undulations, float))


def register_geoid_grid_file(name: str, path: str) -> None:
    """Register a geoid undulation grid from a PROJ grid file for use in to_vcrs.

    Supports the two formats PROJ ships geoid models in (reference vcrs.py:78-200 downloads
    these from cdn.proj.org):
      * ``.gtx`` — NOAA/VDatum binary: big-endian f64 header (ll_lat, ll_lon, dlat, dlon),
        i32 (nrows, ncols), then f32 undulations row-major from the south-west corner.
      * ``.tif`` — PROJ GeoTIFF grids, read through the native codec (the value band is the
        undulation in meters; georeferencing gives the lon/lat axes).
    """
    lower = path.lower()
    if lower.endswith(".gtx"):
        import struct

        with open(path, "rb") as f:
            head = f.read(40)
            ll_lat, ll_lon, dlat, dlon = struct.unpack(">4d", head[:32])
            nrows, ncols = struct.unpack(">2i", head[32:40])
            vals = np.frombuffer(f.read(nrows * ncols * 4), ">f4").reshape(nrows, ncols)
        lats = ll_lat + dlat * np.arange(nrows)  # ascending from the SW corner
        lons = ll_lon + dlon * np.arange(ncols)
        und = np.asarray(vals, np.float64)
    elif lower.endswith((".tif", ".tiff")):
        from xdem_tpu_torch.io import read_raster

        r = read_raster(path)
        t = r.transform
        h, w = r.shape
        lons = t.c + t.a * (np.arange(w) + 0.5)
        lats = t.f + t.e * (np.arange(h) + 0.5)
        und = r.get_nanarray().astype(np.float64)
        if lats[0] > lats[-1]:  # store ascending-latitude rows
            lats = lats[::-1]
            und = und[::-1]
    else:
        raise ValueError(f"Unsupported geoid grid format: '{path}' (use .gtx or .tif).")
    lons = np.where(lons > 180.0, lons - 360.0, lons)  # PROJ grids often span 0..360
    order = np.argsort(lons)
    register_geoid_grid(name, lons[order], lats, und[:, order])


def grid_name_for(vcrs: "VerticalCRS | str | None") -> str | None:
    """PROJ grid filename for a vertical CRS: the name itself if set from a grid file, the
    standard product grid for known geoids, else None (shared by DEM/EPC .vcrs_grid)."""
    if vcrs is None:
        return None
    name = str(vcrs)
    if name.endswith((".tif", ".tiff", ".gtx")):
        return name
    return {v: k for k, v in _VCRS_GRIDS.items()}.get(name.upper())


def _parse_vcrs_from_product(product: str) -> str | None:
    return _PRODUCT_VCRS.get(product)


def _vcrs_from_user_input(value: Any) -> VerticalCRS:
    """Parse a vertical CRS from a name, EPSG code, grid filename, or VerticalCRS."""
    if isinstance(value, VerticalCRS):
        return value
    if isinstance(value, int):
        if value in _VCRS_EPSG:
            return VerticalCRS(_VCRS_EPSG[value])
        return VerticalCRS(f"EPSG:{value}")
    if isinstance(value, str):
        if value in _VCRS_GRIDS:
            return VerticalCRS(_VCRS_GRIDS[value])
        low = value.lower()
        if low == "ellipsoid":
            return VerticalCRS("Ellipsoid")
        if low in ("egm96", "egm08", "navd88"):
            return VerticalCRS(value.upper())
        if value.endswith((".tif", ".tiff", ".gtx")):
            import os

            # A real grid file: load it on first use (once — grids can be hundreds of MB)
            if value.upper() not in _GEOID_GRIDS and os.path.exists(value):
                register_geoid_grid_file(value, value)
            return VerticalCRS(value)  # else: transform gated until a grid is registered
        return VerticalCRS(value)
    raise ValueError(f"Cannot parse vertical CRS from {value!r}.")


_BUILTIN_GEOIDS = ("EGM96", "EGM08", "EGM2008")
_warned_builtin: set[str] = set()


def _geoid_undulation(name: str, lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Geoid height above the ellipsoid (m) at float64 longitude/latitude tensors."""
    key = name.upper()
    if key not in _GEOID_GRIDS and key in _BUILTIN_GEOIDS:
        # Out-of-the-box path: register the built-in long-wavelength model (geoid.py). At its
        # degree-6 truncation EGM96 and EGM2008 share the same field.
        import logging

        from xdem_tpu_torch.geoid import builtin_geoid_grid

        lons, lats, grid = builtin_geoid_grid(1.0)
        for alias in _BUILTIN_GEOIDS:
            # Never clobber a user-registered precise grid for a sibling alias
            _GEOID_GRIDS.setdefault(alias, (lons, lats, grid))
        if key not in _warned_builtin:
            _warned_builtin.update(_BUILTIN_GEOIDS)
            logging.warning(
                "Using the built-in station-augmented %s geoid (degree-28 damped harmonics "
                "+ great-circle RBF over ~350 published station undulations): ~1.5 m median "
                "/ ~4.7 m p90 held-out error on land, <=1 m median at the fitted stations, "
                "worst ~11 m at the sparsest ocean anchors. Register a precise undulation "
                "grid with xdem_tpu_torch.vcrs.register_geoid_grid() for survey-grade (cm-dm) work.",
                key,
            )
    if key not in _GEOID_GRIDS:
        raise ValueError(
            f"Geoid '{name}' has no registered undulation grid. The package ships no PROJ grids; "
            f"load one with xdem_tpu_torch.vcrs.register_geoid_grid()."
        )
    lons, lats, und = (torch.as_tensor(a, dtype=torch.float64, device=lon.device) for a in _GEOID_GRIDS[key])
    # Bilinear interpolation on the registered grid, on the coordinates' device
    ci = torch.clamp(torch.searchsorted(lons, lon.contiguous()) - 1, 0, len(lons) - 2)
    ri = torch.clamp(torch.searchsorted(lats, lat.contiguous()) - 1, 0, len(lats) - 2)
    fx = torch.clamp((lon - lons[ci]) / (lons[ci + 1] - lons[ci]), 0, 1)
    fy = torch.clamp((lat - lats[ri]) / (lats[ri + 1] - lats[ri]), 0, 1)
    v00 = und[ri, ci]
    v01 = und[ri, ci + 1]
    v10 = und[ri + 1, ci]
    v11 = und[ri + 1, ci + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _transform_zz(
    src: VerticalCRS,
    dst: VerticalCRS,
    crs_horizontal: CRS,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
) -> torch.Tensor:
    """Transform elevations from one vertical CRS to another at locations (x, y): float64
    tensors on one device, z included; returns float64 on that device."""
    if src == dst:
        return z
    lon, lat = transform_points(crs_horizontal, 4326, x, y, xp=projections.TORCH)
    # h (ellipsoid) = H (geoid) + N  =>  convert src to ellipsoidal, then to dst
    z_ell = z if src.is_ellipsoid else z + _geoid_undulation(src.name, lon, lat)
    return z_ell if dst.is_ellipsoid else z_ell - _geoid_undulation(dst.name, lon, lat)
