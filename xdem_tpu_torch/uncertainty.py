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
stable-terrain mask may be an array, a tensor, a Raster or a Vector. A point-cloud
``other_elev`` and ``mesh=`` are not ported yet.
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
    :param other_elev: An independent DEM: a Raster (reprojected onto the grid of a Raster
        `dem` when the grids differ), or a 2-D array or tensor on the grid of `dem`.
    :param stable_terrain: Stable-terrain mask (boolean array or tensor on the grid, a Raster
        whose pixels > 0 are stable, regridded onto a Raster `dem` when its grid differs, or a
        Vector rasterized on the grid of a Raster `dem`).
    :param approach: "H2022", "R2009" or "Basic".
    :param precision_of_other: "finer" attributes all error to this DEM; "same" divides the
        pair error by sqrt(2).
    :param spread_estimator: Dispersion estimator of numpy values (default: the NMAD, which
        runs on the device).
    :param variogram_estimator: "dowd" (default), "matheron", "cressie" or "genton".
    :param z_name: Elevation column of a point-cloud input (not ported; kept for parity).
    :param transform: The grid's affine transform for an array `dem` (its pixel size sets the
        terrain attributes and the variogram lags); a Raster `dem` brings its own.
    :param crs: The grid's CRS for an array `dem`, checked and otherwise unused.
    :returns: sigma (a Raster on the grid of a Raster `dem`, else a float32 tensor, on the DEM's
        device) and rho as a function of lags in m.
    """
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device uncertainty) is not ported to xdem_tpu_torch; run on one device.")
    if not isinstance(other_elev, (np.ndarray, torch.Tensor, Raster)):
        raise NotImplementedError(
            f"other_elev of type {type(other_elev).__name__}: point-cloud and dataframe elevations are "
            "not ported to xdem_tpu_torch yet; pass a DEM (Raster), or an array or tensor on the grid of `dem`.")
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
    if spread_estimator is None:
        spread_estimator = spatialstats._stat_nmad

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
        attrs = terrain.get_terrain_attribute(dem_t, list(list_vars), resolution=(transform.xres, transform.yres))
        if not isinstance(attrs, list):
            attrs = [attrs]
        # The spread is binned on at most 5e6 stable samples; sigma covers the full extent.
        sig, _df, _err_fun = spatialstats.infer_heteroscedasticity_from_stable(
            dvalues=dh, list_var=attrs, list_var_names=list(list_vars), stable_mask=stable,
            spread_statistic=spread_estimator, subsample=5_000_000, random_state=random_state,
        )
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh, list_models=list(list_vario_models), stable_mask=stable, errors=sig,
            estimator=variogram_estimator, gsd=gsd, subsample=subsample, random_state=random_state,
        )
    elif approach in ("R2009", "Basic"):
        sigma = _stable_spread(dh, stable, spread_estimator)
        sig = torch.full(dh.shape, sigma, dtype=torch.float32, device=dh.device)
        models = list(list_vario_models) if approach == "R2009" else _single_range_models(list_vario_models)
        _emp, _params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh, list_models=models, stable_mask=stable, estimator=variogram_estimator, gsd=gsd,
            subsample=subsample, random_state=random_state,
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
