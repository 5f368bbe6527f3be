"""Uncertainty of elevation differences: heteroscedasticity and spatial correlation.

Port of the raster-raster path of xdem_tpu/uncertainty.py for DEMs (Rasters), or for arrays
and tensors on one grid with ``transform=`` (and optionally ``crs=``, as the port's
coregistration takes them):

  * H2022 (default): the error sigma(x, y) binned against terrain variables (slope and
    maximum curvature from the surface-fit kernel) plus a multi-range variogram of the
    standardized dh (Hugonnet et al., 2022);
  * R2009: a constant error (NMAD of the stable dh) plus a multi-range variogram (Rolstad
    et al., 2009);
  * Basic: the NMAD plus a single-range variogram.

The input's device runs the whole path; on a CUDA tensor nothing larger than per-bin tables
leaves the card. A Raster ``other_elev`` on another grid is reprojected onto the DEM's, and a
stable-terrain mask may be an array, a tensor, a Raster or a Vector. ``mesh=`` shards the raster pipeline.

``other_elev`` may also be an elevation point cloud (PointCloud/EPC, moved to the DEM's CRS,
or a data frame with x/y columns and the elevation in ``z_name``, read by column): dh is read
at the points by ``Raster.interp_points`` (float64 coordinates, on the DEM's device), the
terrain variables are interpolated at the points, the error function is binned from every
stable point on the device (``xdem_tpu`` bins them on the host in float64) and evaluated over
the whole grid there, and the variogram samples the explicit point coordinates.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Literal, Sequence

import numpy as np
import torch

from xdem_tpu_torch import spatialstats, terrain
from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.georef import CRS, Affine
from xdem_tpu_torch.ops.reductions import masked_nmad
from xdem_tpu_torch.pointcloud import PointCloud
from xdem_tpu_torch.profiler import profile as _profile
from xdem_tpu_torch.profiler import span
from xdem_tpu_torch.raster import Raster, mask_on

__all__ = ["estimate_uncertainty"]


def _stable_spread(dh: torch.Tensor, stable: torch.Tensor | None,
                   spread_estimator: Callable[[np.ndarray], float]) -> float:
    """The spread of the finite stable dh: the NMAD on the device, or a user estimator on
    the host values."""
    keep = torch.isfinite(dh) if stable is None else torch.isfinite(dh) & stable
    if spread_estimator is spatialstats._stat_nmad:
        return float(masked_nmad(dh, keep))
    return float(spread_estimator(dh[keep].to(torch.float64).cpu().numpy()))


@_profile("xdem_tpu_torch.uncertainty.estimate_uncertainty", memprof=True)
def estimate_uncertainty(
    dem: Any,
    other_elev: Any,
    stable_terrain: Any = None,
    approach: Literal["H2022", "R2009", "Basic"] = "H2022",
    precision_of_other: Literal["finer", "same"] = "finer",
    spread_estimator: Callable[[np.ndarray], float] | None = None,
    variogram_estimator: str = "dowd",
    list_vars: Sequence[str] = ("slope", "max_curvature"),
    list_vario_models: Sequence[str] = ("gaussian", "spherical"),
    z_name: str = "z",
    subsample: int = 1000,
    random_state: int | None = None,
    mesh: Any = None,
    transform: Affine | None = None,
    crs: Any = None,
) -> tuple[Any, Callable[[np.ndarray], np.ndarray]]:
    """Estimate (sigma(x, y), rho(lag)) of the elevation differences `other_elev` - `dem`.

    :param dem: The DEM whose uncertainty is estimated: a DEM/Raster, or a 2-D array or
        tensor with `transform`.
    :param other_elev: An independent elevation dataset: a Raster (reprojected onto the grid of a
        Raster `dem` when the grids differ), a 2-D array or tensor on the grid of `dem`, or an
        elevation point cloud (PointCloud/EPC, or a data frame with x/y columns and `z_name`).
    :param stable_terrain: Stable-terrain mask (boolean array or tensor on the grid, a Raster
        whose pixels > 0 are stable, regridded onto a Raster `dem` when its grid differs, or a
        Vector rasterized on the grid of a Raster `dem`; for point input also per-point booleans).
    :param approach: "H2022", "R2009" or "Basic".
    :param precision_of_other: "finer" attributes all error to this DEM; "same" divides the
        pair error by sqrt(2).
    :param spread_estimator: Dispersion estimator of numpy values (default: the NMAD, which
        runs on the device).
    :param variogram_estimator: "dowd" (default), "matheron", "cressie" or "genton".
    :param z_name: Elevation column of a data-frame `other_elev`.
    :param transform: The grid's affine transform for an array `dem` (its pixel size sets the
        terrain attributes and the variogram lags); a Raster `dem` brings its own.
    :param crs: The grid's CRS for an array `dem`: checked, and the CRS point input is moved to.
    :param mesh: A `parallel.Mesh` to run the raster pipeline over several shards: the terrain
        attributes by halo-sharded stencils, the error over the full extent with its rows
        split, and the variogram runs split with their bins summed; sigma equals the
        single-device result to the bit, and so does rho with the Dowd estimator. Point input
        refuses it.
    :returns: sigma (a Raster on the grid of a Raster `dem`, else a float32 tensor, on the DEM's
        device) and rho as a function of lags in m.
    """
    if spread_estimator is None:
        spread_estimator = spatialstats._stat_nmad
    if not isinstance(other_elev, (np.ndarray, torch.Tensor, Raster)):
        if not isinstance(dem, Raster):
            if transform is None or crs is None:
                raise ValueError("transform= and crs= are needed to read point elevations on an array `dem`.")
            dem = Raster(dem, transform, crs)
        if mesh is not None:
            raise ValueError(
                "mesh= supports the raster pipeline (halo-sharded stencils + grid-mode "
                "variogram runs); point-cloud uncertainty samples explicit coordinate pairs on "
                "one device. Pass a Raster other_elev to run multi-chip."
            )
        return _estimate_uncertainty_points(
            dem, other_elev, stable_terrain=stable_terrain, approach=approach, precision_of_other=precision_of_other,
            spread_estimator=spread_estimator, variogram_estimator=variogram_estimator, list_vars=list_vars,
            list_vario_models=list_vario_models, z_name=z_name, subsample=subsample, random_state=random_state)
    dem_r = dem if isinstance(dem, Raster) else None
    if dem_r is not None:
        transform, crs = dem_r.transform, dem_r.crs
        if isinstance(other_elev, Raster) and (other_elev.shape != dem_r.shape or other_elev.crs != dem_r.crs
                                               or not other_elev.transform.almost_equals(dem_r.transform)):
            other_elev = other_elev.reproject(dem_r)
    if transform is None:
        raise ValueError("transform= is needed: its pixel size sets the terrain attributes and the variogram lags.")
    if crs is not None:
        CRS(crs)

    dem_t = as_tensor(dem)
    other_t = as_tensor(other_elev, device=dem_t.device)
    if dem_t.dim() != 2 or other_t.shape != dem_t.shape:
        raise ValueError(
            f"other_elev (shape {tuple(other_t.shape)}) is not on the grid of dem (shape {tuple(dem_t.shape)}): "
            "pass both as Rasters to reproject other_elev onto the grid of dem.")
    dh = other_t - dem_t
    gsd = float(transform.xres)
    stable = mask_on(stable_terrain, dem_r, dh.shape, dh.device)

    if approach == "H2022":
        with span("xdem_tpu_torch.uncertainty.attributes"):
            attrs = terrain.get_terrain_attribute(dem_t, list(list_vars),
                                                  resolution=(transform.xres, transform.yres), mesh=mesh)
        if not isinstance(attrs, list):
            attrs = [attrs]
        # The spread is binned on at most 5e6 stable samples; sigma covers the full extent.
        sig, _df, _err_fun = spatialstats.infer_heteroscedasticity_from_stable(
            dvalues=dh, list_var=attrs, list_var_names=list(list_vars), stable_mask=stable,
            spread_statistic=spread_estimator, subsample=5_000_000, random_state=random_state, mesh=mesh,
        )
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh, list_models=list(list_vario_models), stable_mask=stable, errors=sig,
            estimator=variogram_estimator, gsd=gsd, subsample=subsample, random_state=random_state, mesh=mesh,
        )
    elif approach in ("R2009", "Basic"):
        sigma = _stable_spread(dh, stable, spread_estimator)
        sig = torch.full(dh.shape, sigma, dtype=torch.float32, device=dh.device)
        models = list(list_vario_models) if approach == "R2009" else _single_range_models(list_vario_models)
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh, list_models=models, stable_mask=stable, estimator=variogram_estimator, gsd=gsd,
            subsample=subsample, random_state=random_state, mesh=mesh,
        )
    else:
        raise ValueError(f"Unknown uncertainty approach: {approach} (use 'H2022', 'R2009' or 'Basic').")

    # For a same-precision pair, each DEM contributes half the error variance.
    if precision_of_other == "same":
        sig = sig / torch.tensor(np.float32(np.sqrt(2)), device=sig.device)
    if dem_r is not None:
        sig = Raster(sig, dem_r.transform, dem_r.crs)
    return sig, rho


def _single_range_models(list_vario_models: Sequence[str] | str) -> list[str]:
    """The Basic approach uses a single correlation range: the first model, with a warning
    when several were passed."""
    if isinstance(list_vario_models, str):
        return [list_vario_models]
    models = list(list_vario_models)
    if len(models) > 1:
        warnings.warn(
            "Several variogram models passed but this approach uses a single range, "
            "keeping only the first model.",
            category=UserWarning,
        )
    return models[:1]


def _point_stable_mask(stable_terrain: Any, dem: Raster, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-point stable mask on the points' device: per-point booleans, or a mask on the DEM's
    grid (any form `raster.mask_on` takes: array, tensor, Raster, Vector) read at the nearest
    pixel."""
    n = int(x.numel())
    if stable_terrain is None:
        return torch.ones(n, dtype=torch.bool, device=x.device)
    if isinstance(stable_terrain, np.ma.MaskedArray):
        stable_terrain = stable_terrain.filled(False)  # masked slots are not stable
    if not (isinstance(stable_terrain, Raster) or hasattr(stable_terrain, "create_mask")) \
            and tuple(np.shape(stable_terrain)) == (n,):
        m = stable_terrain if isinstance(stable_terrain, torch.Tensor) else torch.from_numpy(np.array(stable_terrain, bool))
        return m.to(device=x.device, dtype=torch.bool)
    grid_mask = mask_on(stable_terrain, dem, dem.shape, x.device)
    rows, cols = dem.transform.rowcol(x, y)
    # rowcol is centre-convention fractional: the nearest centre is the containing pixel
    rows = torch.clamp(torch.round(torch.nan_to_num(rows, nan=0.0)), 0, dem.height - 1).long()
    cols = torch.clamp(torch.round(torch.nan_to_num(cols, nan=0.0)), 0, dem.width - 1).long()
    return grid_mask[rows, cols]


def _point_xyz(other_elev: Any, dem: Raster, z_name: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, y, z) in the DEM's CRS as float64 tensors on the DEM's device, from a
    PointCloud/EPC or a data frame with x/y (or E/N) columns and the elevation in `z_name`."""
    dev = dem.data.device
    if isinstance(other_elev, PointCloud):
        pc = other_elev.to_crs(dem.crs) if other_elev.crs != dem.crs else other_elev
        return pc.x.to(dev), pc.y.to(dev), pc.z.to(dev)
    if not hasattr(other_elev, "columns"):
        raise TypeError(
            "Other elevation should be a DEM/Raster, an elevation point cloud "
            "(EPC/PointCloud), or a dataframe with x/y columns and elevation in "
            f"z_name (got {type(other_elev).__name__})."
        )
    cols = {c.lower(): c for c in other_elev.columns}
    if z_name not in other_elev.columns:
        raise ValueError(f"Point elevation column {z_name!r} not found in the dataframe.")
    xcol = cols.get("x") or cols.get("e") or cols.get("easting")
    ycol = cols.get("y") or cols.get("n") or cols.get("northing")
    if xcol is None or ycol is None:
        raise ValueError("Point dataframe needs x/y (or E/N) coordinate columns.")
    return tuple(torch.from_numpy(np.array(other_elev[c], np.float64)).to(dev)  # type: ignore[return-value]
                 for c in (xcol, ycol, z_name))


def _estimate_uncertainty_points(dem: Raster, other_elev: Any, stable_terrain: Any, approach: str,
                                 precision_of_other: str, spread_estimator: Callable[[np.ndarray], float],
                                 variogram_estimator: str, list_vars: Sequence[str], list_vario_models: Sequence[str],
                                 z_name: str, subsample: int, random_state: int | None) -> tuple[Raster, Callable]:
    """The point-cloud branch: dh at the points, the error function binned from the values at
    the points and evaluated over the grid on its device, the variogram over the points'
    coordinates."""
    x, y, z = _point_xyz(other_elev, dem, z_name)
    dh_pts = z - dem.interp_points((x, y)).to(torch.float64)
    stable = _point_stable_mask(stable_terrain, dem, x, y) & torch.isfinite(dh_pts)
    if int(stable.sum()) < 10:
        raise ValueError("Too few stable, finite points to estimate uncertainty.")
    dh_stable = torch.where(stable, dh_pts, torch.nan).cpu().numpy()
    coords = torch.stack([x, y], dim=1).cpu().numpy()
    gsd = float(dem.res[0])
    if approach == "H2022":
        with span("xdem_tpu_torch.uncertainty.attributes"):
            attrs = terrain.get_terrain_attribute(dem, list(list_vars))
        if not isinstance(attrs, list):
            attrs = [attrs]
        # Every stable point is binned (a subsample of all of them), on the device: the error at
        # the points comes back with the fitted function, which is then evaluated over the grid.
        err_pts, _df, err_fun = spatialstats.infer_heteroscedasticity_from_stable(
            dvalues=torch.where(stable, dh_pts, torch.nan), list_var=[a.interp_points((x, y)) for a in attrs],
            list_var_names=list(list_vars), spread_statistic=spread_estimator, subsample=int(stable.numel()),
            random_state=random_state)
        unscaled = err_fun.unscaled
        sig = err_fun.scale * spatialstats._interp_grid_device(
            unscaled.mids_ext, unscaled.grid_ext, [a.data for a in attrs])
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh_stable, list_models=list(list_vario_models), errors=err_pts.cpu().numpy(),
            estimator=variogram_estimator, gsd=gsd, coords=coords, subsample=subsample, random_state=random_state)
    elif approach in ("R2009", "Basic"):
        sigma = spread_estimator(dh_stable[np.isfinite(dh_stable)])
        sig = torch.full(dem.shape, float(sigma), dtype=torch.float32, device=dem.data.device)
        models = list(list_vario_models) if approach == "R2009" else _single_range_models(list_vario_models)
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh_stable, list_models=models, estimator=variogram_estimator, gsd=gsd, coords=coords,
            subsample=subsample, random_state=random_state)
    else:
        raise ValueError(f"Unknown uncertainty approach: {approach} (use 'H2022', 'R2009' or 'Basic').")
    if precision_of_other == "same":
        sig = sig / torch.tensor(np.float32(np.sqrt(2)), device=sig.device)
    return Raster(sig.to(torch.float32), dem.transform, dem.crs), rho
