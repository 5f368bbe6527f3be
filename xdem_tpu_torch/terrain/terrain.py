"""Terrain attribute dispatcher: validation, family split, kernel dispatch and epilog.

Port of xdem_tpu/terrain/terrain.py for arrays and tensors. The requested attributes split
into the surface-fit family (kernel K1), the windowed family (K2), fractal roughness (K3)
and texture shading (an FFT filter, terrain/freq.py);
the input's device decides between each kernel and its plain version (see cuda_kernels.py),
not ``engine=``. Slope and aspect are converted to degrees, hillshade is clipped to
[0, 255], and the results come back in request order: tensors for an array or tensor input,
Rasters (nodata -99999, the input's georeferencing) for a Raster or DEM.
"""

from __future__ import annotations

import warnings
from typing import Any, Literal, Sequence

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.profiler import profile as _profile
from xdem_tpu_torch.parallel.halo import sharded_stencil, sharded_surface_attributes
from xdem_tpu_torch.parallel.sharded import shard
from xdem_tpu_torch.raster import Raster
from xdem_tpu_torch.terrain import cuda_kernels, freq, surfit
from xdem_tpu_torch.terrain.surfit import SURFACE_FIT_ATTRS
from xdem_tpu_torch.terrain.window import FRACTAL_ATTRS, WINDOWED_ATTRS, normalize_engine

FREQUENCY_ATTRS = ("texture_shading",)

ALL_ATTRS = tuple(SURFACE_FIT_ATTRS) + WINDOWED_ATTRS + FRACTAL_ATTRS + FREQUENCY_ATTRS

_CURVATURES = (
    "curvature",
    "profile_curvature",
    "tangential_curvature",
    "planform_curvature",
    "flowline_curvature",
    "max_curvature",
    "min_curvature",
)


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _terrain_epilog(plane: torch.Tensor, attr: str, degrees: bool, dtype: torch.dtype) -> torch.Tensor:
    """Per-attribute post ops: degree conversion, hillshade clip and the output dtype cast."""
    if degrees and attr in ("slope", "aspect"):
        plane = torch.rad2deg(plane)
    if attr == "hillshade":
        plane = torch.clamp(plane, 0, 255)
    return plane.to(dtype)


@_profile("xdem_tpu_torch.terrain.get_terrain_attribute", memprof=True)
def get_terrain_attribute(
    dem: Any,
    attribute: str | Sequence[str],
    resolution: float | tuple[float, float] | None = None,
    degrees: bool = True,
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
    slope_method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    curv_method: Literal["geometric", "directional"] = "geometric",
    tri_method: Literal["Riley", "Wilson"] = "Riley",
    window_size: int = 3,
    window_size_fractal: int = 13,
    texture_alpha: float = 0.8,
    out_dtype: Any = None,
    mesh: Any = None,
    engine: Literal["xla", "pallas"] = "xla",
    tiled: Any = None,
    mp_config: Any = None,
) -> Any:
    """Derive one or several terrain attributes from a DEM (Raster), array or tensor.

    Same parameters and numerics as xdem_tpu.terrain.get_terrain_attribute. A numpy input
    goes to the default device; a tensor, or a Raster's data, stays where it is. On a CUDA
    tensor the attributes come from the hand-written kernels, on a CPU tensor from their
    plain PyTorch versions. ``engine`` is validated but does not pick the path. Returns a
    tensor, or a list of tensors in request order; for a Raster input, Rasters on its grid
    with nodata -99999. ``tiled=`` (a `terrain.TilingConfig`; ``mp_config=`` with
    ``tile_rows`` is its alias) streams row bands into one GeoTIFF per attribute and
    returns their paths (`terrain.tiled_terrain_attribute`); any other ``mp_config`` raises.
    ``mesh=`` (a `parallel.Mesh`) cuts the DEM once over the mesh's devices and runs the
    stencils with halo exchange (`parallel.sharded_stencil`): the kernels launch once per
    shard, and the planes come back as `parallel.ShardedArray`s left on the mesh (``.to(device)``
    or ``.numpy()`` assemble one), equal to the single-device planes to the bit; texture
    shading is computed whole and then cut. For a Raster input the planes are assembled on
    its device. ``tiled=`` and ``mesh=`` are exclusive. A Raster's resolution comes from its
    transform, and one in a geographic CRS warns that the surface-fit attributes may be wrong.

    The device sets one limit: ``window_size_fractal`` 3 or 4 warns and then, on a CPU
    tensor, gives the reference's XLA result (all NaN for 3, where one box scale leaves no
    slope), while on a CUDA tensor it raises ValueError, as the reference's Pallas kernel
    does, because the fractal kernel takes windows of 5 and more.
    """
    engine = normalize_engine(engine)
    if mp_config is not None:
        if not hasattr(mp_config, "tile_rows"):
            raise ValueError(
                "mp_config process-pool tiling does not exist on this backend (one device "
                "streams fixed-shape row bands): pass tiled=terrain.TilingConfig(...) for "
                "out-of-core streaming, or mesh= to shard across devices."
            )
        if tiled is not None:
            raise ValueError("Pass only one of mp_config= and tiled= (they are aliases here).")
        tiled = mp_config
    if slope_method is not None:
        warnings.warn("'slope_method' is deprecated, use 'surface_fit' instead.", DeprecationWarning, stacklevel=2)
        surface_fit = slope_method

    if tiled is not None:
        if mesh is not None:
            raise ValueError("tiled= (out-of-core streaming) and mesh= (device sharding) are exclusive.")
        from xdem_tpu_torch.terrain.tiled import tiled_terrain_attribute

        return tiled_terrain_attribute(
            dem, attribute, tiled, resolution=resolution,
            surface_fit=surface_fit, curv_method=curv_method, tri_method=tri_method,
            window_size=window_size, window_size_fractal=window_size_fractal,
            degrees=degrees, hillshade_altitude=hillshade_altitude,
            hillshade_azimuth=hillshade_azimuth, hillshade_z_factor=hillshade_z_factor,
            engine=engine, out_dtype=out_dtype,
        )

    single = isinstance(attribute, str)
    attrs = [attribute] if single else list(attribute)

    # --- validation, as xdem_tpu/terrain/terrain.py
    if surface_fit == "Horn" and any(a in _CURVATURES for a in attrs):
        raise ValueError(
            "'Horn' surface fit method cannot be used for to calculate curvatures. "
            "Use 'ZevenbergThorne' or 'Florinsky' instead."
        )
    for a in attrs:
        if a not in ALL_ATTRS:
            raise ValueError(f"Attribute '{a}' is not supported. Choices: {list(ALL_ATTRS)}")
    if surface_fit.lower() not in ("horn", "zevenbergthorne", "florinsky"):
        raise ValueError(f"Surface fit '{surface_fit}' is not supported.")
    if curv_method.lower() not in ("geometric", "directional"):
        raise ValueError(f"Curvature method '{curv_method}' is not supported.")
    if tri_method.lower() not in ("riley", "wilson"):
        raise ValueError(f"TRI method '{tri_method}' is not supported.")
    if not 0.0 <= hillshade_azimuth <= 360.0:
        raise ValueError(f"Azimuth must be a value between 0 and 360 degrees (given value: {hillshade_azimuth})")
    if not 0.0 <= hillshade_altitude <= 90.0:
        raise ValueError(f"Altitude must be a value between 0 and 90 degrees (given value: {hillshade_altitude})")
    if hillshade_z_factor < 0 or not np.isfinite(hillshade_z_factor):
        raise ValueError(f"z_factor must be a non-negative finite value (given value: {hillshade_z_factor})")
    if "fractal_roughness" in attrs:
        if window_size_fractal < 5:
            warnings.warn("Fractal roughness can only be computed on window sizes larger or equal to 5.", UserWarning)
        elif window_size_fractal < 13:
            warnings.warn("Fractal roughness results with window size of less than 13 can be inaccurate.", UserWarning)

    is_raster = isinstance(dem, Raster)
    if is_raster and resolution is None:
        resolution = dem.res

    sf_attrs = [a for a in attrs if a in SURFACE_FIT_ATTRS]
    win_attrs = [a for a in attrs if a in WINDOWED_ATTRS]

    needing_res = sf_attrs + (["rugosity"] if "rugosity" in attrs else [])
    if needing_res:
        if resolution is None:
            raise ValueError(f"Attributes {needing_res} need the pixel size: pass resolution=.")
        if isinstance(resolution, (tuple, list)):
            if resolution[0] != resolution[1]:
                raise ValueError(
                    f"Attributes {needing_res} assume square pixels, but resolution {resolution} has "
                    f"different X and Y steps. Resample to a square grid first."
                )
    if resolution is None:
        resolution = 1.0
    if isinstance(resolution, (tuple, list)):
        resolution = float(resolution[0])
    resolution = float(resolution)

    if is_raster and not dem.crs.is_projected and sf_attrs:
        warnings.warn(
            f"DEM is not in a projected CRS, the following surface fit attributes might be wrong: {sf_attrs}. "
            f"Use DEM.reproject(crs=DEM.get_metric_crs()) to reproject in a projected CRS.",
            UserWarning,
        )

    arr = as_tensor(dem).contiguous()
    out_dtype = torch.float32 if out_dtype is None else _torch_dtype(out_dtype)

    # With a mesh the DEM is cut and sent to the shards once; each stencil family then
    # exchanges only its own halo between the blocks already on the cards.
    src = None if mesh is None else shard(arr, mesh)

    def stencil(fn, halo: int):
        """`fn` of the whole DEM, or of each halo-padded block of the mesh."""
        return fn(arr) if mesh is None else sharded_stencil(fn, src, halo=halo, mesh=mesh)

    planes: dict[str, Any] = {}

    def keep(names, stack) -> None:
        """A family's planes after their epilog. With a mesh each block's epilog runs on its
        card into a block of its own, so the family's halo-padded output (K1's radian planes
        too) is freed before the next family runs."""
        for a, p in zip(names, stack):
            planes[a] = _terrain_epilog(p, a, degrees, out_dtype) if mesh is None else p.map(
                lambda b, a=a: _terrain_epilog(b, a, degrees, out_dtype).contiguous())

    if sf_attrs:
        kwargs = dict(surface_fit=surface_fit, curv_method=curv_method,
                      hillshade_altitude=float(hillshade_altitude), hillshade_azimuth=float(hillshade_azimuth),
                      hillshade_z_factor=float(hillshade_z_factor))
        if mesh is None:
            keep(sf_attrs, cuda_kernels.surface_attributes(arr, resolution, tuple(sf_attrs), **kwargs))
        else:  # the whole DEM's centre, on its device, as the single-device call removes it
            keep(sf_attrs, sharded_surface_attributes(src, resolution, mesh, tuple(sf_attrs),
                                                      center=surfit.dem_center(arr), **kwargs))

    # Rugosity is defined on a 3x3 window only (Jenness 2004): with window_size != 3 it
    # takes its own 3x3 pass, so [roughness@5x5, rugosity@3x3] matches the reference.
    def windowed(attrs_w: tuple[str, ...], wsize: int) -> torch.Tensor:
        return stencil(lambda a: cuda_kernels.windowed_indexes(a, resolution, attrs_w, window_size=wsize,
                                                               tri_method=tri_method), wsize // 2)

    if win_attrs:
        shared = [a for a in win_attrs if not (a == "rugosity" and window_size != 3)]
        if shared:
            keep(shared, windowed(tuple(shared), window_size))
        if "rugosity" in win_attrs and window_size != 3:
            keep(["rugosity"], windowed(("rugosity",), 3))

    if "fractal_roughness" in attrs:
        keep(["fractal_roughness"], [stencil(
            lambda a: cuda_kernels.fractal_roughness(a, window_size=window_size_fractal), window_size_fractal // 2)])

    # Texture shading is a global FFT filter: it runs whole, and a mesh gets its blocks.
    if "texture_shading" in attrs:
        tex = freq.texture_shading(arr, alpha=texture_alpha)
        keep(["texture_shading"], [tex if mesh is None else shard(tex, src.mesh)])

    ordered = [planes[a] for a in attrs]
    if is_raster:
        # A Raster holds one tensor: sharded planes are assembled on the DEM's device.
        ordered = [Raster(o if mesh is None else o.to(arr.device), transform=dem.transform, crs=dem.crs,
                          nodata=-99999, area_or_point=dem.area_or_point) for o in ordered]
    return ordered[0] if single else ordered


def _resolve_deprecated_method(method: Any, surface_fit: str) -> str:
    """`method=` is the deprecated alias of `surface_fit=` for slope/aspect/hillshade."""
    if method is not None:
        warnings.warn("'method' is deprecated, use 'surface_fit' instead.", DeprecationWarning, stacklevel=3)
        return method
    return surface_fit


def slope(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    degrees: bool = True,
    resolution: float | tuple[float, float] | None = None,
    **kwargs: Any,
) -> Any:
    """Slope in degrees (default) or radians, from a local surface fit (Horn 1981 /
    Zevenbergen & Thorne 1987 / Florinsky 2009).

    A unit ramp has a 45-degree slope:

    >>> import numpy as np
    >>> ramp = np.repeat(np.arange(5, dtype=float)[None, :], 5, axis=0)
    >>> round(float(slope(ramp, surface_fit="ZevenbergThorne", resolution=1.0)[2, 2]), 4)
    45.0
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="slope", surface_fit=surface_fit,
                                 degrees=degrees, resolution=resolution, **kwargs)


def aspect(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    degrees: bool = True,
    **kwargs: Any,
) -> Any:
    """Aspect (0=N, 90=E, clockwise) in degrees or radians.

    A ramp rising eastward faces west:

    >>> import numpy as np
    >>> ramp = np.repeat(np.arange(5, dtype=float)[None, :], 5, axis=0)
    >>> round(float(aspect(ramp, surface_fit="ZevenbergThorne", resolution=1.0)[2, 2]), 4)
    270.0
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="aspect", surface_fit=surface_fit,
                                 degrees=degrees, **kwargs)


def hillshade(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    azimuth: float = 315.0,
    altitude: float = 45.0,
    z_factor: float = 1.0,
    resolution: float | tuple[float, float] | None = None,
    **kwargs: Any,
) -> Any:
    """GDAL-matching hillshade in [0, 255] (Horn 1981).

    A flat surface under the default 45-degree sun shades to 1.5 + 254*sin(45deg):

    >>> import numpy as np
    >>> round(float(hillshade(np.zeros((5, 5)), resolution=1.0)[2, 2]), 2)
    181.11
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="hillshade", surface_fit=surface_fit,
                                 hillshade_azimuth=azimuth, hillshade_altitude=altitude,
                                 hillshade_z_factor=z_factor, resolution=resolution, **kwargs)


def _curvature_fn(attr: str, blurb: str):
    def fn(
        dem: Any,
        resolution: float | tuple[float, float] | None = None,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Any:
        return get_terrain_attribute(dem, attribute=attr, resolution=resolution,
                                     surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    fn.__name__ = fn.__qualname__ = attr
    fn.__doc__ = (f"{blurb} (100 m-1); `curv_method` picks the geometric (Minár 2020) or "
                  f"directional-derivative (Zevenbergen & Thorne 1987) variant.")
    return fn


profile_curvature = _curvature_fn("profile_curvature", "Profile curvature")
tangential_curvature = _curvature_fn("tangential_curvature", "Tangential curvature")
planform_curvature = _curvature_fn("planform_curvature", "Planform curvature")
flowline_curvature = _curvature_fn("flowline_curvature", "Flowline curvature")
max_curvature = _curvature_fn("max_curvature", "Maximal curvature")
min_curvature = _curvature_fn("min_curvature", "Minimal curvature")


def topographic_position_index(dem: Any, window_size: int = 3, **kwargs: Any) -> Any:
    """TPI (Weiss 2001): difference to the window mean of neighbours.

    A unit bump on a flat plane sits one unit above its (all-zero) neighbours:

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> float(topographic_position_index(bump)[2, 2])
    1.0
    """
    return get_terrain_attribute(dem, attribute="topographic_position_index",
                                 window_size=window_size, **kwargs)


def terrain_ruggedness_index(
    dem: Any,
    method: Literal["Riley", "Wilson"] = "Riley",
    window_size: int = 3,
    **kwargs: Any,
) -> Any:
    """TRI: cumulated differences to neighbouring pixels — Riley 1999 (sqrt of squared diffs,
    topography) or Wilson 2007 (mean absolute diff, bathymetry). Here `method` selects the
    TRI variant, not the deprecated surface-fit alias.

    Riley on a unit bump: sqrt of eight squared unit differences = 2*sqrt(2):

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> round(float(terrain_ruggedness_index(bump)[2, 2]), 4)
    2.8284
    """
    return get_terrain_attribute(dem, attribute="terrain_ruggedness_index",
                                 tri_method=method, window_size=window_size, **kwargs)


def roughness(dem: Any, window_size: int = 3, **kwargs: Any) -> Any:
    """Roughness (Dartnell 2000): window max - min.

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> float(roughness(bump)[2, 2])
    1.0
    """
    return get_terrain_attribute(dem, attribute="roughness", window_size=window_size, **kwargs)


def rugosity(dem: Any, resolution: float | tuple[float, float] | None = None, **kwargs: Any) -> Any:
    """Rugosity (Jenness 2004): real-to-planimetric area ratio, 3x3 only."""
    return get_terrain_attribute(dem, attribute="rugosity", resolution=resolution, **kwargs)


def fractal_roughness(dem: Any, window_size_fractal: int = 13, **kwargs: Any) -> Any:
    """Fractal roughness (Taud & Parrot 2005): local 3-D fractal dimension in [1, 3] by voxel
    box-counting; window >= 5 (3 and 4 warn, then run on a CPU tensor and raise on a CUDA
    tensor: see get_terrain_attribute)."""
    return get_terrain_attribute(dem, attribute="fractal_roughness",
                                 window_size_fractal=window_size_fractal, **kwargs)


def texture_shading(dem: Any, alpha: float = 0.8, **kwargs: Any) -> Any:
    """Texture shading (Brown 2010): a fractional-Laplacian |f|^alpha high-pass in the
    frequency domain, alpha in [0, 2]."""
    return get_terrain_attribute(dem, attribute="texture_shading", texture_alpha=alpha, **kwargs)


def curvature(
    dem: Any,
    resolution: float | tuple[float, float] | None = None,
    surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
    **kwargs: Any,
) -> Any:
    """Legacy total curvature -2(D+E)*100 (Moore et al. 1991); deprecated, kept for parity."""
    warnings.warn(
        "The curvature attribute is deprecated, refer to docs for specific curvature functions.",
        DeprecationWarning,
        stacklevel=2,
    )
    return get_terrain_attribute(dem, attribute="curvature", resolution=resolution,
                                 surface_fit=surface_fit, **kwargs)
