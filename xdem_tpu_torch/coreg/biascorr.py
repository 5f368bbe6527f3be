"""Bias corrections (non-rigid alignment) against arbitrary variables: BiasCorr, and its
DirectionalBias, TerrainBias and Deramp forms.

Port of xdem_tpu/coreg/biascorr.py for raster-raster and raster-point pairs (the variables
are read on the grid side, and at the points by bilinear interpolation). The fit draws the
same numpy subsample as xdem_tpu, then bins (``spatialstats.nd_binning``, dicts of numpy arrays, no pandas) and/or
fits (``xdem_tpu_torch.fit``) on the host. The apply evaluates the correction over the whole
raster on its device: the fitted model with float32 parameters, or the binned table by
multilinear interpolation. The variables are made on the device too: pixel coordinates
(Deramp), the rotated along-track coordinate (DirectionalBias), or a terrain attribute
(TerrainBias, through ``terrain.get_terrain_attribute``, so the CUDA kernels run on a CUDA
tensor). For the fit, variables defined everywhere (pixel and rotated coordinates) are
computed in float64 at the drawn pixels only.

Spans (``xdem_tpu_torch.profiler.span``): ``coreg.biascorr.vars`` around each variable (a
plane on the DEM's device, or a coordinate at the drawn pixels), ``coreg.biascorr.bin`` around
the host binning (counters ``values`` and ``bins``), ``coreg.biascorr.fit`` around the host fit
(counters ``evaluations``, the residual evaluations of its LM loops, and ``frequencies``, the
sines a sum of sines keeps) and ``coreg.biascorr.apply`` around the correction plane and its
addition; the draw keeps ``coreg.draw``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable, Literal

import numpy as np
import torch

from xdem_tpu_torch.coreg.affine import _subsample_pair_values
from xdem_tpu_torch.coreg.base import Coreg, NotImplementedCoregApply, _grid_side
from xdem_tpu_torch.fit import (
    curve_fit_lm,
    polynomial_1d,
    polynomial_2d,
    robust_nfreq_sumsin_fit,
    robust_norder_polynomial_fit,
    sumsin_1d,
)
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.ops.transfer import host_array as _host
from xdem_tpu_torch.pointcloud import PointCloud
from xdem_tpu_torch.profiler import span

# Workflow names mapped to (model function, robust optimizer).
fit_workflows = {
    "norder_polynomial": {"func": polynomial_1d, "optimizer": robust_norder_polynomial_fit},
    "nfreq_sumsin": {"func": sumsin_1d, "optimizer": robust_nfreq_sumsin_fit},
}

_DEVICE_MODELS = (polynomial_1d, polynomial_2d, sumsin_1d)

_VARS, _BIN, _FIT, _APPLY = (f"xdem_tpu_torch.coreg.biascorr.{stage}" for stage in ("vars", "bin", "fit", "apply"))


def _in_vars_span(fn: Callable, device: torch.device) -> Callable:
    """`fn` of the drawn (rows, cols), evaluated inside the ``coreg.biascorr.vars`` span."""

    def at_picks(rr, cc):
        with span(_VARS, devices=[device]):
            return fn(rr, cc)

    return at_picks


def _eval_fit_func_device(func: Callable, x_in: Any, params: torch.Tensor, n: int) -> torch.Tensor:
    """A model function on device tensors with `n` tensor parameters."""
    return func(x_in, *[params[i] for i in range(n)])


def _get_xy_rotated(shape: tuple[int, int], transform: Affine, along_track_angle: float):
    """Rotated coordinates of every pixel (float64, host): x along `along_track_angle` degrees
    (counter-clockwise from the X axis), both from the grid's lowest x and y."""
    h, w = shape
    cgrid, rgrid = np.meshgrid(np.arange(w), np.arange(h))
    return _rotated_at(rgrid, cgrid, shape, transform, along_track_angle)


def _rotated_at(rr: np.ndarray, cc: np.ndarray, shape: tuple[int, int], transform: Affine, angle: float):
    """The rotated coordinates of `_get_xy_rotated` at pixels (rr, cc) only, equal to the
    full-grid values there (the grid's lowest x and y are at its corners)."""
    h, w = shape
    x, y = transform.xy(rr, cc)
    xc, yc = transform.xy(np.array([0, 0, h - 1, h - 1]), np.array([0, w - 1, 0, w - 1]))
    theta = np.deg2rad(angle)
    x0, y0 = np.min(xc), np.min(yc)
    xr = (x - x0) * np.cos(theta) + (y - y0) * np.sin(theta)
    yr = -(x - x0) * np.sin(theta) + (y - y0) * np.cos(theta)
    return xr, yr


def _pixel_grids(shape: tuple[int, int], device: torch.device) -> dict[str, torch.Tensor]:
    """Column (xx) and row (yy) indices of every pixel as float32 tensors."""
    h, w = shape
    return {"xx": torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w),
            "yy": torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)}


class BiasCorr(Coreg):
    """N-dimensional bias correction by binning, fitting, or both."""

    _is_affine = False
    _needs_vars = True

    def __init__(
        self,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "fit",
        fit_func: Callable[..., np.ndarray] | str = "norder_polynomial",
        fit_optimizer: Callable[..., Any] | None = None,
        bin_sizes: int | dict[str, Any] = 10,
        bin_statistic: Callable[[np.ndarray], Any] = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        bias_var_names: Iterable[str] | None = None,
        subsample: float | int = 1.0,
    ):
        if fit_or_bin not in ["fit", "bin", "bin_and_fit"]:
            raise ValueError(f"Argument `fit_or_bin` must be 'bin_and_fit', 'fit' or 'bin', got {fit_or_bin}.")
        if fit_or_bin in ("fit", "bin_and_fit"):
            if not (callable(fit_func) or (isinstance(fit_func, str) and fit_func in fit_workflows)):
                raise TypeError(
                    "Argument `fit_func` must be a function (callable) or the string '{}', got {}.".format(
                        "', '".join(fit_workflows.keys()), type(fit_func)
                    )
                )
            if isinstance(fit_func, str):
                fit_optimizer = fit_workflows[fit_func]["optimizer"]
                fit_func = fit_workflows[fit_func]["func"]
        if fit_or_bin in ("bin", "bin_and_fit"):
            if not (isinstance(bin_sizes, int) or (
                isinstance(bin_sizes, dict) and all(isinstance(v, (int, Iterable)) for v in bin_sizes.values())
            )):
                raise TypeError(
                    f"Argument `bin_sizes` must be an integer, or a dictionary of integers or iterables, "
                    f"got {type(bin_sizes)}."
                )
            if not callable(bin_statistic):
                raise TypeError(f"Argument `bin_statistic` must be a function (callable), got {type(bin_statistic)}.")
            if not isinstance(bin_apply_method, str):
                raise TypeError(
                    f"Argument `bin_apply_method` must be the string 'linear' or 'per_bin', "
                    f"got {type(bin_apply_method)}."
                )
        super().__init__()
        self._meta["inputs"]["fitorbin"] = {
            "fit_or_bin": fit_or_bin,
            "fit_func": fit_func,
            "fit_optimizer": fit_optimizer,
            "bin_sizes": bin_sizes,
            "bin_statistic": bin_statistic,
            "bin_apply_method": bin_apply_method,
            "bias_var_names": list(bias_var_names) if bias_var_names is not None else None,
            "nd": len(list(bias_var_names)) if bias_var_names is not None else None,
        }
        self._meta["inputs"]["random"]["subsample"] = subsample

    # ------------------------------------------------- bin and/or fit the subsampled values

    def _bin_or_and_fit_biasvars(self, values: np.ndarray, bias_vars: dict[str, np.ndarray],
                                 p0: np.ndarray | None = None, device: torch.device | None = None,
                                 **kwargs: Any) -> None:
        """Bin and/or fit the drawn `values` against `bias_vars`. With `device` (the grids'),
        a binning by one variable into a number of bins with their median runs there."""
        from xdem_tpu_torch import spatialstats

        fb = self._meta["inputs"]["fitorbin"]
        fit_or_bin = fb["fit_or_bin"]
        var_names = list(bias_vars.keys())
        fb["bias_var_names"] = var_names

        df = None
        params = None
        if fit_or_bin in ("bin", "bin_and_fit"):
            bin_sizes = fb["bin_sizes"]
            if isinstance(bin_sizes, dict):
                bin_sizes = [bin_sizes[k] for k in var_names]
            with span(_BIN) as bin_span:
                if (device is not None and len(var_names) == 1 and isinstance(bin_sizes, (int, np.integer))
                        and fb["bin_statistic"] is np.nanmedian):
                    df = spatialstats._nd_binning_median_1d(values, bias_vars[var_names[0]], var_names[0],
                                                            int(bin_sizes), device)
                else:
                    df = spatialstats.nd_binning(values=values, list_var=list(bias_vars.values()),
                                                 list_var_names=var_names, list_var_bins=bin_sizes,
                                                 statistics=("count", fb["bin_statistic"]))
                bin_span.count("values", int(np.size(values)))
                bin_span.count("bins", len(df["count"]))

        if fit_or_bin in ("fit", "bin_and_fit"):
            with span(_FIT) as fit_span:
                if fit_or_bin == "bin_and_fit":
                    rows = np.asarray(df["nd"]) == len(var_names)
                    xdata = [spatialstats._bin_mids(df, n)[rows] for n in var_names]
                    ydata = np.asarray(df[fb["bin_statistic"].__name__], dtype=np.float64)[rows]
                else:
                    xdata = [np.asarray(v, dtype=np.float64).ravel() for v in bias_vars.values()]
                    ydata = np.asarray(values, dtype=np.float64).ravel()
                valid = np.isfinite(ydata)
                for xv in xdata:
                    valid &= np.isfinite(xv)
                xfit = xdata[0][valid] if len(xdata) == 1 else tuple(xv[valid] for xv in xdata)
                yfit = ydata[valid]

                optimizer = fb["fit_optimizer"]
                if optimizer in (robust_norder_polynomial_fit, robust_nfreq_sumsin_fit):
                    params, _ = optimizer(xfit, yfit, random_state=self._meta["inputs"]["random"]["random_state"],
                                          **{k: v for k, v in kwargs.items() if k in ("hop_length",)})
                elif optimizer is not None:
                    params, *_ = optimizer(fb["fit_func"], xfit, yfit, p0=p0)
                else:
                    fit_func = fb["fit_func"]
                    if p0 is None:
                        # Size the initial guess from the model's signature f(x, p1, ..., pk).
                        import inspect

                        p0 = [1.0] * max(len(inspect.signature(fit_func).parameters) - 1, 1)
                    params = curve_fit_lm(fit_func, xfit, yfit, p0=list(p0))
                if fb["fit_func"] is sumsin_1d:
                    fit_span.count("frequencies", len(params) // 3)

        self._meta["outputs"]["fitorbin"] = {"fit_params": params, "bin_dataframe": df}

    # ------------------------------------------------- fit

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z", bias_vars=None,
                     weights=None, **kwargs):
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars=bias_vars, **kwargs)

    def _fit_rst_pts(self, **kwargs):
        # Every bias correction fits a raster-point pair as it fits a raster pair: the values
        # are subsampled at the points, the variables read on the grid side.
        self._fit_rst_rst(**kwargs)

    def _fit_biascorr(self, ref_elev, tba_elev, inlier_mask, transform, bias_vars=None, p0=None, **kwargs):
        """Subsample dh and the bias variables (tensors, host arrays, or functions of the
        drawn pixels) at common pixels, then bin and/or fit."""
        if bias_vars is None:
            raise ValueError("At least one `bias_var` should be passed to the fitting function, got None.")
        fb = self._meta["inputs"]["fitorbin"]
        if fb["bias_var_names"] is not None and sorted(bias_vars.keys()) != sorted(fb["bias_var_names"]):
            raise ValueError(
                "The keys of `bias_vars` do not match the `bias_var_names` defined during "
                "instantiation: {}.".format(fb["bias_var_names"])
            )
        p = self._meta["inputs"]["random"]
        device = _grid_side(ref_elev, tba_elev).device
        bias_vars = {k: _in_vars_span(v, device) if callable(v) else v for k, v in bias_vars.items()}
        sub_ref, sub_tba, _, _, sub_aux = _subsample_pair_values(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"], aux_vars=bias_vars,
        )
        diff = sub_ref - sub_tba
        self._bin_or_and_fit_biasvars(diff, {k: sub_aux[k] for k in bias_vars}, p0=p0, device=device, **kwargs)
        self._meta["outputs"]["random"] = {"subsample_final": len(diff)}

    # ------------------------------------------------- apply

    def _apply_func(self, elev, bias_vars=None, transform=None, crs=None, **kwargs):
        if isinstance(elev, PointCloud):
            raise NotImplementedCoregApply("BiasCorr apply is implemented for rasters.")
        with span(_VARS, devices=[elev.device]):
            vars_ = self._apply_vars(elev, transform, bias_vars)
        with span(_APPLY, devices=[elev.device]):
            return elev + self._correction(elev, vars_, **kwargs), transform

    def _apply_vars(self, elev: torch.Tensor, transform: Affine, bias_vars: dict[str, torch.Tensor] | None):
        """The bias variables over the whole raster, as tensors on its device."""
        if bias_vars is None:
            raise ValueError("At least one `bias_var` should be passed to the `apply` function, got None.")
        return bias_vars

    def _correction(self, elev: torch.Tensor, vars_: dict[str, torch.Tensor], **kwargs) -> torch.Tensor:
        """The fitted (or binned) correction over the raster at the variables `vars_`, float32
        on its device."""
        from xdem_tpu_torch import spatialstats

        fb = self._meta["inputs"]["fitorbin"]
        names = fb["bias_var_names"]
        if sorted(vars_.keys()) != sorted(names):
            raise ValueError(
                "The keys of `bias_vars` do not match the `bias_var_names` defined during "
                "instantiation or fitting: {}.".format(names)
            )
        shape, dev = tuple(elev.shape), elev.device
        out = self._meta["outputs"]["fitorbin"]
        if fb["fit_or_bin"] in ("fit", "bin_and_fit"):
            params = np.asarray(out["fit_params"])
            if fb["fit_func"] in _DEVICE_MODELS:
                v = tuple(vars_[k].to(torch.float32) for k in names)
                p_t = torch.from_numpy(params.astype(np.float32)).to(dev)
                corr = _eval_fit_func_device(fb["fit_func"], v[0] if len(v) == 1 else v, p_t, len(params))
            else:  # a user model: evaluated in numpy on the host
                v = tuple(vars_[k].double().cpu().numpy() for k in names)
                corr = torch.from_numpy(np.asarray(fb["fit_func"](v[0] if len(v) == 1 else v, *params),
                                                   dtype=np.float32)).to(dev)
        elif fb["bin_apply_method"] == "linear":
            fun = spatialstats.interp_nd_binning(df=out["bin_dataframe"], list_var_names=names,
                                                 statistic=fb["bin_statistic"], min_count=kwargs.get("min_count", 0))
            corr = spatialstats._interp_grid_device(fun.mids_ext, fun.grid_ext, [vars_[k] for k in names])
        else:
            corr = torch.from_numpy(np.asarray(spatialstats.get_perbin_nd_binning(
                df=out["bin_dataframe"], list_var=[vars_[k].double().cpu().numpy() for k in names],
                list_var_names=names, statistic=fb["bin_statistic"]), dtype=np.float32)).to(dev)
        return corr.reshape(shape)


class DirectionalBias(BiasCorr):
    """Directional bias correction along an angle, e.g. along-track undulations of a
    satellite. Default: bin_and_fit with a sum of sines over 100 bins."""

    _needs_vars = False

    def __init__(
        self,
        angle: float = 0,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "bin_and_fit",
        fit_func: Any = "nfreq_sumsin",
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 100,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 1.0,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic, bin_apply_method,
                         ["angle"], subsample)
        self._meta["inputs"]["specific"]["angle"] = angle

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z", bias_vars=None,
                     weights=None, **kwargs):
        logging.info("Estimating rotated coordinates.")
        shape, angle = tuple(_grid_side(ref_elev, tba_elev).shape), self._meta["inputs"]["specific"]["angle"]
        if "hop_length" not in kwargs:
            kwargs["hop_length"] = (transform.xres + transform.yres) / 2
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform,
                           bias_vars={"angle": lambda rr, cc: _rotated_at(rr, cc, shape, transform, angle)[0]},
                           **kwargs)

    def _apply_vars(self, elev, transform, bias_vars):
        # The rotated coordinate is affine in (row, col): its float64 coefficients are folded
        # on the host, the plane is made on the device.
        h, w = elev.shape
        theta = np.deg2rad(self._meta["inputs"]["specific"]["angle"])
        t = transform
        corners = [t.xy(r, c) for r, c in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1))]
        x0 = min(p[0] for p in corners)
        y0 = min(p[1] for p in corners)
        kc = t.a * np.cos(theta) + t.d * np.sin(theta)
        kr = t.b * np.cos(theta) + t.e * np.sin(theta)
        k0 = (t.a * 0.5 + t.b * 0.5 + t.c - x0) * np.cos(theta) + (t.d * 0.5 + t.e * 0.5 + t.f - y0) * np.sin(theta)
        g = _pixel_grids((h, w), elev.device)
        return {"angle": float(np.float32(kc)) * g["xx"] + float(np.float32(kr)) * g["yy"] + float(np.float32(k0))}


class TerrainBias(BiasCorr):
    """Bias correction against a terrain attribute, default the maximum curvature, computed
    on the reference for the fit and on the DEM being corrected for the apply. Default: pure
    binning with 100 bins."""

    _needs_vars = False

    def __init__(
        self,
        terrain_attribute: str = "max_curvature",
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "bin",
        fit_func: Any = "norder_polynomial",
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 100,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 1.0,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic, bin_apply_method,
                         [terrain_attribute], subsample)
        self._meta["inputs"]["specific"]["terrain_attribute"] = terrain_attribute

    def _terrain_var(self, grid: torch.Tensor, transform: Affine, bias_vars) -> torch.Tensor:
        from xdem_tpu_torch import terrain

        name = self._meta["inputs"]["specific"]["terrain_attribute"]
        if bias_vars is not None and name in bias_vars:
            return bias_vars[name]
        if name == "elevation":
            return grid
        return terrain.get_terrain_attribute(grid, attribute=name, resolution=(transform.xres, transform.yres))

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z", bias_vars=None,
                     weights=None, **kwargs):
        name = self._meta["inputs"]["specific"]["terrain_attribute"]
        grid = _grid_side(ref_elev, tba_elev)
        with span(_VARS, devices=[grid.device]):
            plane = self._terrain_var(grid, transform, bias_vars)
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars={name: plane}, **kwargs)

    def _apply_vars(self, elev, transform, bias_vars):
        name = self._meta["inputs"]["specific"]["terrain_attribute"]
        return {name: self._terrain_var(elev, transform, bias_vars)}


class Deramp(BiasCorr):
    """2-D polynomial deramping on pixel coordinates. Default order 2, subsample 5e5."""

    _needs_vars = False

    def __init__(
        self,
        poly_order: int = 2,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "fit",
        fit_func: Callable = polynomial_2d,
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 10,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 5e5,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic, bin_apply_method,
                         ["xx", "yy"], subsample)
        self._meta["inputs"]["specific"]["poly_order"] = poly_order

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z", bias_vars=None,
                     weights=None, **kwargs):
        p0 = np.zeros(shape=((self._meta["inputs"]["specific"]["poly_order"] + 1) ** 2))
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform,
                           bias_vars={"xx": lambda rr, cc: cc, "yy": lambda rr, cc: rr}, p0=p0, **kwargs)

    def _bin_or_and_fit_biasvars(self, values, bias_vars, p0=None, device=None, **kwargs):
        # The 2-D polynomial is linear in its coefficients: a float64 least-squares solve in
        # normalised coordinates through the normal equations, formed on `device` (the
        # monomials as rows; one refinement step on the residual; the minimum-norm solution
        # where they are singular), coefficients rescaled back.
        fb = self._meta["inputs"]["fitorbin"]
        if fb["fit_or_bin"] != "fit":
            super()._bin_or_and_fit_biasvars(values, bias_vars, p0=p0, device=device, **kwargs)
            return
        order = self._meta["inputs"]["specific"]["poly_order"] + 1
        with span(_FIT):
            x, y, v = (torch.from_numpy(np.asarray(a, dtype=np.float64).ravel()).to(device or "cpu")
                       for a in (bias_vars["xx"], bias_vars["yy"], values))
            ok = torch.isfinite(v) & torch.isfinite(x) & torch.isfinite(y)
            x, y, v = x[ok], y[ok], v[ok]
            sx, sy = (max(m, 1.0) for m in torch.stack([x.abs().max(), y.abs().max()]).tolist())
            xn, yn = x / sx, y / sy
            px, py = [torch.ones_like(xn)], [torch.ones_like(yn)]
            for _ in range(order - 1):
                px.append(px[-1] * xn)
                py.append(py[-1] * yn)
            At = torch.stack([px[i] * py[j] for i in range(order) for j in range(order)])
            gram = _host(At @ At.T)
            params_n = np.linalg.lstsq(gram, _host(At @ v), rcond=None)[0]
            residual = v - torch.from_numpy(params_n).to(v.device) @ At
            params_n += np.linalg.lstsq(gram, _host(At @ residual), rcond=None)[0]
            scale = np.array([sx**i * sy**j for i in range(order) for j in range(order)])
        fb["bias_var_names"] = list(bias_vars.keys())
        self._meta["outputs"]["fitorbin"] = {"fit_params": params_n / scale, "bin_dataframe": None}

    def _apply_vars(self, elev, transform, bias_vars):
        return _pixel_grids(tuple(elev.shape), elev.device)
