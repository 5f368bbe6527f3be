"""Spatial statistics of the uncertainty path: N-D binning, heteroscedasticity, convolutions,
variograms, the number of effective samples, the patches method and the plots.

Port of xdem_tpu/spatialstats.py for arrays and tensors. The per-pixel work (the seeded
subsample, the binned medians and NMADs, the sigma evaluation over the raster, the ring draw
and the pair estimators, the n_eff double sums) runs in torch on the device of its input;
only per-bin tables, the variogram's gamma/count vectors and scalars cross to the host,
where the binning tables, the interpolation grid and ``curve_fit`` live in numpy/scipy, as
in xdem_tpu.

Tables are dicts of 1-D numpy arrays with xdem_tpu's column names (``count``,
``nanmedian``, ``nmad``, ``exp``, ``lags``, ``err_exp``, ``model``, ``range``, ``psill``);
a binned variable's interval column becomes two edge columns ``<var>_left`` and
``<var>_right``. The port never imports pandas. Every function that reads variogram
parameters reads them as ``params["model"]``, ``params["range"]`` and ``params["psill"]``,
so a pandas frame made by xdem_tpu works too.

Random draws on the device use an explicit ``torch.Generator``: from one seed they give
other bits than the ``jax.random`` draws of xdem_tpu. The host draws (numpy) are identical.
"""

from __future__ import annotations

import itertools
import logging
import math
import warnings
from typing import Any, Callable, Sequence, TypedDict

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor, default_device
from xdem_tpu_torch.ops.reductions import _NMAD_FACTOR, binned_median
from xdem_tpu_torch.ops.reductions import nmad as _nmad_tensor
from xdem_tpu_torch.ops.sampling import seed_from, topk_subsample
from xdem_tpu_torch.ops.transfer import host_array as _host
from xdem_tpu_torch.parallel.sharded import ShardedArray
from xdem_tpu_torch.raster import Raster
from xdem_tpu_torch.raster import mask_on as _mask_on

Table = dict  # column name -> 1-D numpy array


def _raster_data(x: Any) -> tuple[Any, Any]:
    """(x's data tensor, x) for a Raster, (x, None) otherwise: a Raster's grid serves the
    Vector masks and its pixel size the default gsd. A `parallel.ShardedArray` (a plane of a
    ``mesh=`` terrain call) is assembled on its mesh's root."""
    if isinstance(x, ShardedArray):
        return x.to(x.mesh.root), None
    return (x.data, x) if isinstance(x, Raster) else (x, None)


def nmad(data: Any, nfact: float = _NMAD_FACTOR) -> float:
    """Normalized median absolute deviation of an array or tensor, NaNs ignored, as a float
    (xdem_tpu.spatialstats.nmad, deprecated there in favour of ``ops.nmad``, which takes and
    returns tensors and has the factor fixed)."""
    warnings.warn("Call to deprecated function 'nmad'. Use xdem_tpu_torch.ops.nmad instead.",
                  DeprecationWarning, stacklevel=2)
    data = _host(data)
    med = np.nanmedian(data)
    return float(nfact * np.nanmedian(np.abs(data - med)))


def _stat_nmad(x: np.ndarray) -> float:
    med = np.nanmedian(x)
    return float(_NMAD_FACTOR * np.nanmedian(np.abs(x - med)))


# Binned-statistic tables name their columns after the statistic's __name__.
_stat_nmad.__name__ = "nmad"


# ---------------------------------------------------------------------- N-D binning


def _combos(nvars: int) -> list[tuple[int, ...]]:
    """Every 1-D binning, every 2-D pair, then the full N-D binning (for N > 2)."""
    combos: list[tuple[int, ...]] = [(i,) for i in range(nvars)]
    if nvars > 1:
        combos += list(itertools.combinations(range(nvars), 2))
    if nvars > 2:
        combos.append(tuple(range(nvars)))
    return combos


def _concat_tables(frames: list[Table], cols: list[str]) -> Table:
    """Stack tables row-wise over `cols`; a column a table lacks is NaN in its rows."""
    return {c: np.concatenate([f[c] if c in f else np.full(len(f["count"]), np.nan) for f in frames])
            for c in cols}


def _interval_columns(names: Sequence[str]) -> list[str]:
    return [f"{n}_{side}" for n in names for side in ("left", "right")]


def nd_binning(
    values: Any,
    list_var: Sequence[Any],
    list_var_names: Sequence[str],
    list_var_bins: int | Sequence[int] | Sequence[np.ndarray] | None = None,
    statistics: Sequence[Callable[[np.ndarray], float] | str] = ("count", np.nanmedian, _stat_nmad),
    list_ranges: Sequence[tuple[float, float]] | None = None,
) -> Table:
    """N-dimensional binned statistics: all 1-D, all 2-D combinations, and the full N-D binning.

    Host numpy, as xdem_tpu.spatialstats.nd_binning. Returns a table with one column per
    statistic (``count`` first), ``<var>_left``/``<var>_right`` bin edges per variable (NaN
    in rows that do not bin that variable; bins are closed on the left) and ``nd``.
    """
    values = _host(values).ravel()
    list_var = [_host(v).ravel() for v in list_var]
    if len(list_var) != len(list_var_names):
        raise ValueError("Number of variables and variable names must match.")
    n_vars = len(list_var)

    stats: list[tuple[str, Callable[[np.ndarray], float]]] = []
    for s in statistics:
        if isinstance(s, str):
            if s == "count":
                continue
            raise ValueError(f"Unknown statistic name: {s}")
        stats.append((s.__name__, s))

    if list_var_bins is None:
        list_var_bins = [10] * n_vars
    elif np.isscalar(list_var_bins):
        list_var_bins = [int(list_var_bins)] * n_vars  # type: ignore[list-item]
    # Bin ranges come from the jointly valid sample (values AND all variables finite).
    valid_all = np.isfinite(values)
    for v in list_var:
        valid_all &= np.isfinite(v)

    edges: list[np.ndarray] = []
    for i, b in enumerate(list_var_bins):  # type: ignore[arg-type]
        finite = list_var[i][valid_all]
        if isinstance(b, (int, np.integer)):
            lo, hi = (
                list_ranges[i] if list_ranges is not None and list_ranges[i] is not None else (finite.min(), finite.max())
            )
            edges.append(np.linspace(lo, hi, int(b) + 1))
        else:
            edges.append(np.asarray(b, dtype=np.float64))

    def _binned(var_idx: list[int]) -> Table:
        sel_edges = [edges[i] for i in var_idx]
        sel_vars = [list_var[i][valid_all] for i in var_idx]
        vals = values[valid_all]
        ids = np.zeros(len(vals), dtype=np.int64)
        n_bins_tot = 1
        dims = []
        for e, v in zip(sel_edges, sel_vars):
            d = len(e) - 1
            idx = np.clip(np.digitize(v, e) - 1, -1, d)
            idx = np.where((v >= e[0]) & (v <= e[-1]), np.clip(idx, 0, d - 1), -1)
            ids = ids * d + np.where(idx >= 0, idx, 0)
            ids = np.where(idx >= 0, ids, -1) if len(dims) == 0 else np.where((idx >= 0) & (ids >= 0), ids, -1)
            n_bins_tot *= d
            dims.append(d)
        ok = ids >= 0
        # One stable argsort groups the values by bin; statistics run on contiguous segments.
        ids_ok = ids[ok]
        order = np.argsort(ids_ok, kind="stable")
        sorted_vals = vals[ok][order]
        counts_arr = np.bincount(ids_ok, minlength=n_bins_tot)
        starts = np.concatenate([[0], np.cumsum(counts_arr)[:-1]])

        out: Table = {"count": counts_arr.astype(np.int64)}
        for name, fn in stats:
            col = np.full(n_bins_tot, np.nan)
            for flat in range(n_bins_tot):
                sub = sorted_vals[starts[flat]: starts[flat] + counts_arr[flat]]
                if len(sub):
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", RuntimeWarning)
                        col[flat] = fn(sub)
            out[name] = col
        # Flat bin ids decompose into per-variable bins, the first variable most significant.
        rem = np.arange(n_bins_tot)
        per = []
        for d in dims[::-1]:
            per.append(rem % d)
            rem = rem // d
        per = per[::-1]
        for k, i_var in enumerate(var_idx):
            e = edges[i_var]
            out[f"{list_var_names[i_var]}_left"] = e[per[k]].astype(np.float64)
            out[f"{list_var_names[i_var]}_right"] = e[per[k] + 1].astype(np.float64)
        out["nd"] = np.full(n_bins_tot, len(var_idx), dtype=np.int64)
        return out

    frames = [_binned(list(c)) for c in _combos(n_vars)]
    cols = ["count"] + [name for name, _ in stats] + _interval_columns(list_var_names) + ["nd"]
    table = _concat_tables(frames, cols)
    table["nd"] = table["nd"].astype(np.int64)
    return table


def _bin_mids(df: Any, name: str) -> np.ndarray:
    """Bin midpoints of variable `name`: 0.5 * (left + right) of its edge columns, or its
    numeric column of mid values."""
    if f"{name}_left" in df and f"{name}_right" in df:
        return 0.5 * (np.asarray(df[f"{name}_left"], np.float64) + np.asarray(df[f"{name}_right"], np.float64))
    try:
        return np.asarray(df[name], dtype=np.float64)
    except (TypeError, ValueError):
        raise ValueError("The variable columns must be provided as numerical mid values, or as "
                         "<var>_left/<var>_right bin edges.") from None


def interp_nd_binning(
    df: Any,
    list_var_names: str | Sequence[str],
    statistic: str | Callable[[np.ndarray], float] = _stat_nmad,
    interpolate_method: str = "linear",
    min_count: int | None = 100,
) -> Callable[..., np.ndarray]:
    """N-D linear interpolator over binned statistics with flat extrapolation.

    As xdem_tpu.spatialstats.interp_nd_binning, on a table of :func:`nd_binning` or one with
    numeric mid-value columns. Bins with count < min_count are masked and in-filled (linear
    inside the valid hull when ``interpolate_method="linear"``, then nearest); the grid is
    extended by one edge-valued cell per side. The returned function carries ``mids_ext``
    and ``grid_ext`` for :func:`_interp_grid_device`.

    >>> fun = interp_nd_binning({"var1": [1, 2, 3, 1, 2, 3, 1, 2, 3],
    ...                          "var2": [1, 1, 1, 2, 2, 2, 3, 3, 3],
    ...                          "statistic": [1, 2, 3, 4, 5, 6, 7, 8, 9]},
    ...                         list_var_names=["var1", "var2"], statistic="statistic", min_count=None)
    >>> float(fun((2, 2))), float(fun((1.5, 1.5))), float(fun((-1, 1)))
    (5.0, 3.0, 1.0)
    """
    if interpolate_method not in ("linear", "nearest"):
        raise ValueError(f"interpolate_method must be 'linear' or 'nearest', got {interpolate_method!r}.")
    if isinstance(list_var_names, str):
        list_var_names = [list_var_names]
    stat_name = statistic if isinstance(statistic, str) else statistic.__name__

    for name in list_var_names:
        if name not in df and not (f"{name}_left" in df and f"{name}_right" in df):
            raise ValueError(f'Variable "{name}" does not exist in the provided dataframe.')
    if stat_name not in df:
        raise ValueError(f'Statistic "{stat_name}" does not exist in the provided dataframe.')
    if min_count is not None and "count" not in df:
        raise ValueError('Statistic "count" is not in the provided dataframe, necessary to '
                         "use the min_count argument.")
    stat_all = np.asarray(df[stat_name], dtype=np.float64)
    if len(stat_all) == 0:
        raise ValueError("Dataframe is empty.")

    # Keep the requested dimensionality, and drop sibling combos of that dimensionality
    # (their requested columns are NaN).
    keep = np.ones(len(stat_all), dtype=bool)
    if "nd" in df:
        keep &= np.asarray(df["nd"]) == len(list_var_names)
    mid_cols = [_bin_mids(df, name) for name in list_var_names]
    for m in mid_cols:
        keep &= np.isfinite(m)
    if not keep.any():
        raise ValueError(f"No {len(list_var_names)}-D binning found in the DataFrame.")
    mid_cols = [m[keep] for m in mid_cols]
    stat = stat_all[keep]
    cnt = np.asarray(df["count"], np.float64)[keep] if "count" in df else np.full(len(stat), np.nan)

    mids = [np.asarray(sorted(set(m)), dtype=np.float64) for m in mid_cols]
    shape = tuple(len(m) for m in mids)
    grid = np.full(shape, np.nan)
    counts = np.zeros(shape)
    for r in range(len(stat)):
        idx = tuple(int(np.argmin(np.abs(mids[i] - mid_cols[i][r]))) for i in range(len(mids)))
        grid[idx] = stat[r]
        counts[idx] = cnt[r]
    if min_count is not None:
        grid = np.where(counts >= min_count, grid, np.nan)

    if not np.isfinite(grid).any():
        raise ValueError("No valid bins to interpolate from (check min_count).")
    # In-fill in bin-midpoint coordinates: linearly inside the valid hull when requested,
    # then nearest-neighbour for the rest.
    if np.isnan(grid).any():
        from scipy.interpolate import griddata

        pts = np.stack(np.meshgrid(*mids, indexing="ij"), axis=-1).reshape(-1, len(mids))
        valid = np.isfinite(grid)
        if interpolate_method == "linear" and valid.sum() > len(mids):
            try:
                filled = griddata(pts[valid.ravel()], grid[valid], pts, method="linear").reshape(grid.shape)
                grid = np.where(valid, grid, filled)
            except Exception:  # degenerate hulls (collinear points) fall back to nearest
                pass
        if np.isnan(grid).any():
            valid = np.isfinite(grid)
            try:
                filled = griddata(pts[valid.ravel()], grid[valid], pts, method="nearest").reshape(grid.shape)
                grid = np.where(valid, grid, filled)
            except Exception:  # degenerate point sets: index-space nearest propagation
                from scipy import ndimage

                idx_nearest = ndimage.distance_transform_edt(~valid, return_distances=False, return_indices=True)
                grid = grid[tuple(idx_nearest)]

    from scipy.interpolate import RegularGridInterpolator

    # One extra edge-valued cell per side makes extrapolation flat.
    mids_ext = []
    for m in mids:
        step0 = m[1] - m[0] if len(m) > 1 else 1.0
        step1 = m[-1] - m[-2] if len(m) > 1 else 1.0
        mids_ext.append(np.r_[m[0] - step0, m, m[-1] + step1])
    grid_ext = np.pad(grid, 1, mode="edge")
    rgi = RegularGridInterpolator(tuple(mids_ext), grid_ext, method="linear", bounds_error=False, fill_value=None)

    def interpolator(*args: np.ndarray) -> np.ndarray:
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = tuple(args[0])
        pts = np.stack([_host(a, np.float64).ravel() for a in args], axis=-1)
        return rgi(pts).reshape(np.shape(args[0]))

    interpolator.mids_ext = mids_ext
    interpolator.grid_ext = grid_ext
    return interpolator


def _interp_grid_device(mids_ext: Sequence[np.ndarray], grid_ext: np.ndarray,
                        vars_dev: Sequence[torch.Tensor]) -> torch.Tensor:
    """Multilinear interpolation of a small binned grid at device-resident coordinates, in
    float32 on the coordinates' device: interp_nd_binning's interpolator (clamping to the
    edge-padded grid is its flat extrapolation); NaN coordinates give NaN. The corner values
    are an indexed gather from the tiny table."""
    dev = vars_dev[0].device
    grid = torch.from_numpy(np.ascontiguousarray(grid_ext, dtype=np.float32)).to(dev)
    grid_flat = grid.reshape(-1)
    idxs, fracs = [], []
    nan_any = None
    for d, m in enumerate(mids_ext):
        mj = torch.from_numpy(np.asarray(m, dtype=np.float32)).to(dev)
        x = vars_dev[d].to(torch.float32)
        isnan = torch.isnan(x)
        nan_any = isnan if nan_any is None else (nan_any | isnan)
        xc = torch.clamp(torch.where(isnan, mj[0], x), mj[0], mj[-1])
        i = torch.clamp(torch.searchsorted(mj, xc, right=True) - 1, 0, len(m) - 2)
        idxs.append(i)
        fracs.append((xc - mj[i]) / (mj[i + 1] - mj[i]))
    dims = grid.shape
    out = torch.zeros_like(fracs[0])
    for corner in itertools.product((0, 1), repeat=len(mids_ext)):
        wgt = None
        flat = None
        for d, c in enumerate(corner):
            w_d = fracs[d] if c else (1.0 - fracs[d])
            wgt = w_d if wgt is None else wgt * w_d
            i_d = idxs[d] + c
            flat = i_d if flat is None else flat * dims[d] + i_d
        out = out + wgt * grid_flat[flat]
    return torch.where(nan_any, torch.nan, out)


def get_perbin_nd_binning(
    df: Any,
    list_var: Sequence[Any],
    list_var_names: str | Sequence[str],
    statistic: str | Callable[[np.ndarray], float] = np.nanmedian,
    min_count: int | None = 0,
) -> np.ndarray:
    """Per-bin (piecewise-constant) lookup of a binned statistic at variable values; bins
    with fewer than ``min_count`` samples stay NaN. Host numpy, on an :func:`nd_binning`
    table."""
    if isinstance(list_var_names, str):
        list_var_names = [list_var_names]
    stat_name = statistic if isinstance(statistic, str) else statistic.__name__
    keep = np.asarray(df["nd"]) == len(list_var_names)
    lefts = [np.asarray(df[f"{n}_left"], np.float64) for n in list_var_names]
    rights = [np.asarray(df[f"{n}_right"], np.float64) for n in list_var_names]
    for lo in lefts:
        keep &= ~np.isnan(lo)  # sibling combos of the same dimensionality
    stat = np.asarray(df[stat_name], np.float64)
    count = np.asarray(df["count"], np.float64) if "count" in df else np.zeros(len(stat))

    shape = np.shape(_host(list_var[0]))
    flat_vars = [_host(v).ravel() for v in list_var]
    out_flat = np.full(int(np.prod(shape)), np.nan)
    for r in np.flatnonzero(keep):
        if min_count and count[r] < min_count:
            continue
        sel = np.ones(len(flat_vars[0]), dtype=bool)
        for k, v in enumerate(flat_vars):
            sel &= (v >= lefts[k][r]) & (v < rights[k][r])
        out_flat[sel] = stat[r]
    return out_flat.reshape(shape)


# ---------------------------------------------------------------------- heteroscedasticity


def _binned_count_med_nmad(vals: torch.Tensor, ids: torch.Tensor, n_bins: int):
    """Per-bin (count, median, NMAD) by (bin, value) sorts; `ids` in [0, n_bins), n_bins
    marks an invalid entry. Counts are int64."""
    valid = ids < n_bins
    counts = torch.bincount(ids, minlength=n_bins + 1)[:n_bins]
    med = binned_median(vals, ids, valid, n_bins)
    absdev = torch.abs(vals - med[torch.clamp(ids, 0, n_bins - 1)])
    return counts, med, _NMAD_FACTOR * binned_median(absdev, ids, valid, n_bins)


def _hetero_bin_tables_device(gathered: torch.Tensor, n_bins: int):
    """All nd_binning combos of a gathered stable sample, on its device.

    gathered: (1 + nvars, N) with row 0 = dh. Bin edges are ``n_bins`` equal steps between
    each variable's min and max over the jointly valid sample, in float32 as xdem_tpu forms
    them in its program (``jnp.linspace``, whose division by the step count XLA turns into
    a product with its float32 reciprocal). Returns ([(counts, median, nmad) per combo],
    gmin, gmax) as tensors.
    """
    d = gathered[0]
    x = gathered[1:]
    nvars = x.shape[0]
    valid = torch.isfinite(gathered).all(0)
    gmin = torch.where(valid[None, :], x, torch.inf).amin(1)
    gmax = torch.where(valid[None, :], x, -torch.inf).amax(1)
    steps = np.append(np.arange(n_bins, dtype=np.float32) * np.float32(1.0 / n_bins), np.float32(1.0))
    lin = torch.from_numpy(steps).to(x.device)
    edges = gmin[:, None] + (gmax - gmin)[:, None] * lin[None, :]
    # Every valid value lies within its edges, so digitize reduces to a clipped searchsorted.
    var_ids = [torch.clamp(torch.searchsorted(edges[i].contiguous(), x[i].contiguous(), right=True) - 1, 0, n_bins - 1)
               for i in range(nvars)]
    tables = []
    for combo in _combos(nvars):
        ids = torch.zeros_like(var_ids[0])
        for i in combo:
            ids = ids * n_bins + var_ids[i]
        ids = torch.where(valid, ids, n_bins ** len(combo))
        tables.append(_binned_count_med_nmad(d, ids, n_bins ** len(combo)))
    return tables, gmin, gmax


def _hetero_sample_indices(valid_flat: torch.Tensor, count: int, seed: int) -> torch.Tensor:
    """`count` flat indices drawn without replacement, valid pixels first: uniform scores
    from a generator seeded with `seed` on the mask's device, then top-k."""
    generator = torch.Generator(device=valid_flat.device).manual_seed(int(seed))
    return topk_subsample(generator, valid_flat, count)[0]


def _hetero_prepare_device(d: torch.Tensor, vars_t: Sequence[torch.Tensor], inc: torch.Tensor | None,
                           exc: torch.Tensor | None, seed: int, count: int) -> torch.Tensor:
    """Joint validity, a seeded subsample of `count` pixels over it, and the gathers: the
    (1 + nvars, count) sample, NaN where a pick is not valid."""
    valid = torch.isfinite(d)
    for v in vars_t:
        valid = valid & torch.isfinite(v)
    if inc is not None:
        valid = valid & inc
    if exc is not None:
        valid = valid & ~exc
    valid_flat = valid.reshape(-1)
    idx = _hetero_sample_indices(valid_flat, count, seed)
    ok = valid_flat[idx]
    return torch.stack([torch.where(ok, a.reshape(-1)[idx], torch.nan) for a in (d, *vars_t)])


def _two_step_scale_core(gathered: torch.Tensor, mids_ext: Sequence[np.ndarray], grid_ext: np.ndarray,
                         fac_spread_outliers: float) -> torch.Tensor:
    """Two-step standardization's scale on the device: z-score the sample's dh by the
    interpolated unscaled error, drop |z| > fac * NMAD, return the NMAD of the rest."""
    err = _interp_grid_device(mids_ext, grid_ext, list(gathered[1:]))
    z = gathered[0] / err
    spread0 = _nmad_tensor(z)
    z = torch.where(torch.abs(z) > fac_spread_outliers * spread0, torch.nan, z)
    return _nmad_tensor(z)


def _scale_and_sigma_device(gathered: torch.Tensor, mids_ext: Sequence[np.ndarray], grid_ext: np.ndarray,
                            fac_spread_outliers: float, vars_full: Sequence[torch.Tensor], mesh: Any = None):
    """The standardization scale and the sigma raster over the full extent, on the device."""
    scale = _two_step_scale_core(gathered, mids_ext, grid_ext, fac_spread_outliers)
    return scale, _sigma_grid(scale, mids_ext, grid_ext, vars_full, mesh)


def _sigma_grid(scale: torch.Tensor | float, mids_ext: Sequence[np.ndarray], grid_ext: np.ndarray,
                vars_full: Sequence[torch.Tensor], mesh: Any = None) -> torch.Tensor:
    """`scale` times the binned error function over the full extent, on the variables' device.
    With a `mesh`, the rows are split over it (the interpolation is elementwise, so the
    result is the single-device one to the bit) and assembled back."""
    if mesh is None:
        return scale * _interp_grid_device(mids_ext, grid_ext, vars_full)
    from xdem_tpu_torch.parallel._collectives import all_gather, replicate, scatter
    from xdem_tpu_torch.parallel.mesh import as_mesh_1d

    m1 = as_mesh_1d(mesh)
    h, w = vars_full[0].shape
    parts = zip(*(scatter(v, m1, math.nan) for v in vars_full))
    scales = replicate(scale, m1) if isinstance(scale, torch.Tensor) else [scale] * m1.devices.size
    sig = [s * _interp_grid_device(mids_ext, grid_ext, list(vs)) for s, vs in zip(scales, parts)]
    return all_gather(sig, m1).reshape(-1, w)[:h].to(vars_full[0].device)


def two_step_standardization(
    dvalues: np.ndarray,
    list_var: Sequence[np.ndarray],
    unscaled_error_fun: Callable[..., np.ndarray],
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    fac_spread_outliers: float | None = 7,
) -> tuple[np.ndarray, Callable[..., np.ndarray]]:
    """Two-step standardization (host): z-score by the unscaled error function, clip
    outliers at `fac_spread_outliers` * spread, then rescale so the final spread is 1."""
    zscores = _host(dvalues) / unscaled_error_fun(*[_host(v) for v in list_var])
    if fac_spread_outliers is not None:
        spread0 = spread_statistic(zscores)
        zscores[np.abs(zscores) > fac_spread_outliers * spread0] = np.nan
    scale = spread_statistic(zscores)
    zscores /= scale

    def error_fun(*args: np.ndarray) -> np.ndarray:
        return scale * unscaled_error_fun(*args)

    error_fun.scale = scale
    error_fun.unscaled = unscaled_error_fun
    return zscores, error_fun


def _standardize_masked_device(d: torch.Tensor, e: torch.Tensor | None, inc: torch.Tensor | None,
                               exc: torch.Tensor | None) -> torch.Tensor:
    """dh / sigma (dh alone when `e` is None) with include/exclude masks applied."""
    z = d.to(torch.float32)
    if e is not None:
        z = z / e.to(torch.float32)
    if inc is not None:
        z = torch.where(inc, z, torch.nan)
    if exc is not None:
        z = torch.where(exc, torch.nan, z)
    return z


def _preprocess_values_with_mask_to_array(
    values: Sequence[Any] | Any,
    include_mask: Any = None,
    exclude_mask: Any = None,
    gsd: float | None = None,
    preserve_shape: bool = True,
) -> tuple[list[np.ndarray] | np.ndarray, float | None]:
    """Host arrays (float64) with the pixels outside include_mask, or inside exclude_mask,
    set to NaN; Raster values give their data, their grid to Vector masks and their pixel
    size as the default gsd."""
    single = not isinstance(values, (list, tuple))
    unwrapped = [_raster_data(v) for v in ([values] if single else values)]
    ref = next((r for _, r in unwrapped if r is not None), None)
    if gsd is None and ref is not None:
        gsd = ref.res[0]
    arrays = [np.array(_host(v), dtype=np.float64) for v, _ in unwrapped]
    stable = np.ones(arrays[0].shape, dtype=bool)
    for m, keep in ((include_mask, True), (exclude_mask, False)):
        m = _mask_on(m, ref, stable.shape, "cpu")
        if m is not None:
            stable &= m.numpy() if keep else ~m.numpy()
    out = [np.where(stable, a, np.nan) for a in arrays]
    return (out[0] if single else out), gsd


def _estimate_model_heteroscedasticity(
    dvalues: np.ndarray,
    list_var: Sequence[np.ndarray],
    list_var_names: Sequence[str],
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    list_var_bins: Any = None,
    min_count: int | None = 100,
    fac_spread_outliers: float | None = 7,
) -> tuple[Table, Callable[..., np.ndarray]]:
    """Bin the spread against the variables, interpolate, standardize (host)."""
    df = nd_binning(values=dvalues, list_var=list_var, list_var_names=list_var_names,
                    list_var_bins=list_var_bins, statistics=("count", np.nanmedian, spread_statistic))
    unscaled = interp_nd_binning(df, list_var_names=list(list_var_names),
                                 statistic=spread_statistic.__name__, min_count=min_count)
    _, error_fun = two_step_standardization(dvalues, list_var, unscaled, spread_statistic=spread_statistic,
                                            fac_spread_outliers=fac_spread_outliers)
    return df, error_fun


def _table_from_device_bins(tables, gmin: torch.Tensor, gmax: torch.Tensor, n_bins: int,
                            list_var_names: Sequence[str], spread_name: str) -> Table:
    """The nd_binning table of :func:`_hetero_bin_tables_device`'s output (on the host)."""
    lo = gmin.cpu().numpy().astype(np.float64)
    hi = gmax.cpu().numpy().astype(np.float64)
    edges = [np.linspace(lo[i], hi[i], n_bins + 1) for i in range(len(lo))]
    frames = []
    for combo, (counts, med, spread) in zip(_combos(len(lo)), tables):
        tot = n_bins ** len(combo)
        rec: Table = {"count": counts.cpu().numpy().astype(np.int64),
                      "nanmedian": med.cpu().numpy().astype(np.float64),
                      spread_name: spread.cpu().numpy().astype(np.float64)}
        rem = np.arange(tot)
        per = []
        for _ in combo:
            per.append(rem % n_bins)
            rem = rem // n_bins
        per = per[::-1]
        for k, i_var in enumerate(combo):
            rec[f"{list_var_names[i_var]}_left"] = edges[i_var][per[k]]
            rec[f"{list_var_names[i_var]}_right"] = edges[i_var][per[k] + 1]
        rec["nd"] = np.full(tot, len(combo), dtype=np.int64)
        frames.append(rec)
    table = _concat_tables(frames, ["count", "nanmedian", spread_name] + _interval_columns(list_var_names) + ["nd"])
    table["nd"] = table["nd"].astype(np.int64)
    return table


def infer_heteroscedasticity_from_stable(
    dvalues: Any,
    list_var: Sequence[Any],
    stable_mask: Any = None,
    unstable_mask: Any = None,
    list_var_names: Sequence[str] | None = None,
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    list_var_bins: Any = None,
    min_count: int | None = 100,
    fac_spread_outliers: float | None = 7,
    subsample: int | None = None,
    random_state: int | None = None,
    mesh: Any = None,
) -> tuple[Any, Table, Callable[..., np.ndarray]]:
    """Infer the per-pixel error sigma(vars) from stable terrain.

    Returns (error over the full extent, binning table, error function), as
    xdem_tpu.spatialstats.infer_heteroscedasticity_from_stable. With a tensor `dvalues`,
    tensor `list_var` and an absolute `subsample`, the sample is drawn and binned on the
    tensors' device and the error is a tensor there; the default statistics (NMAD spread,
    integer bins, outlier clipping) never bring more than the per-bin tables to the host.
    Otherwise the inputs are host arrays and the error is a numpy array. Raster inputs give
    their data (a Raster `dvalues` its grid to Vector masks), and then the error is a Raster
    on the grid of `dvalues`. ``mesh=`` (a `parallel.Mesh`) splits the rows of the
    full-extent error over the mesh; it needs the device path (tensor or Raster inputs and an
    absolute `subsample`), and the result equals the single-device one to the bit.
    """
    if list_var_names is None:
        list_var_names = [f"var{i+1}" for i in range(len(list_var))]
    dvalues, ref = _raster_data(dvalues)
    list_var = [_raster_data(v)[0] for v in list_var]
    if ref is not None:
        error, df, error_fun = infer_heteroscedasticity_from_stable(
            dvalues, list_var, stable_mask=_mask_on(stable_mask, ref, dvalues.shape, dvalues.device),
            unstable_mask=_mask_on(unstable_mask, ref, dvalues.shape, dvalues.device),
            list_var_names=list_var_names, spread_statistic=spread_statistic, list_var_bins=list_var_bins,
            min_count=min_count, fac_spread_outliers=fac_spread_outliers, subsample=subsample,
            random_state=random_state, mesh=mesh)
        error = error if isinstance(error, torch.Tensor) else torch.from_numpy(np.asarray(error, np.float32))
        return Raster(error.to(torch.float32), ref.transform, ref.crs), df, error_fun

    device_ok = (subsample is not None and isinstance(dvalues, torch.Tensor)
                 and all(isinstance(v, torch.Tensor) for v in list_var))
    if mesh is not None and not device_ok:
        raise ValueError("mesh= requires the device path: a tensor or Raster `dvalues`, tensor or Raster "
                         "`list_var` entries, and an absolute `subsample` count.")
    if device_ok:
        d = dvalues.to(torch.float32)
        vars_t = [v.to(device=d.device, dtype=torch.float32) for v in list_var]
        inc = _mask_on(stable_mask, None, d.shape, d.device)
        exc = _mask_on(unstable_mask, None, d.shape, d.device)
        count = int(min(subsample, d.numel()))
        gathered = _hetero_prepare_device(d, vars_t, inc, exc, seed_from(random_state), count)

        device_stats = (
            spread_statistic is _stat_nmad
            and (list_var_bins is None or isinstance(list_var_bins, (int, np.integer)))
            and fac_spread_outliers is not None
        )
        if device_stats:
            n_bins = int(list_var_bins) if list_var_bins is not None else 10
            tables, gmin, gmax = _hetero_bin_tables_device(gathered, n_bins)
            df = _table_from_device_bins(tables, gmin, gmax, n_bins, list_var_names, spread_statistic.__name__)
            unscaled = interp_nd_binning(df, list_var_names=list(list_var_names),
                                         statistic=spread_statistic.__name__, min_count=min_count)
            scale_dev, sig = _scale_and_sigma_device(gathered, unscaled.mids_ext, unscaled.grid_ext,
                                                     float(fac_spread_outliers), vars_t, mesh)
            scale = float(scale_dev)

            def error_fun(*args: np.ndarray) -> np.ndarray:
                return scale * unscaled(*args)

            error_fun.scale = scale
            error_fun.unscaled = unscaled
            return sig, df, error_fun

        # Custom statistics run on the host, on the gathered sample only.
        gathered_np = gathered.cpu().numpy().astype(np.float64)
        df, error_fun = _estimate_model_heteroscedasticity(
            gathered_np[0], list(gathered_np[1:]), list_var_names, spread_statistic=spread_statistic,
            list_var_bins=list_var_bins, min_count=min_count, fac_spread_outliers=fac_spread_outliers,
        )
        unscaled = error_fun.unscaled
        sig = _sigma_grid(error_fun.scale, unscaled.mids_ext, unscaled.grid_ext, vars_t, mesh)
        return sig, df, error_fun

    all_arrays, _ = _preprocess_values_with_mask_to_array(
        [dvalues] + list(list_var), include_mask=stable_mask, exclude_mask=unstable_mask)
    d_stable = all_arrays[0]
    vars_stable = all_arrays[1:]
    if subsample is not None and d_stable.size > subsample:
        rng = np.random.default_rng(random_state)
        flat_valid = np.flatnonzero(np.isfinite(d_stable).ravel())
        if len(flat_valid) > subsample:
            sel = rng.choice(flat_valid, subsample, replace=False)
            d_stable = d_stable.ravel()[sel]
            vars_stable = [np.asarray(v).ravel()[sel] for v in vars_stable]
    df, error_fun = _estimate_model_heteroscedasticity(
        d_stable, vars_stable, list_var_names, spread_statistic=spread_statistic,
        list_var_bins=list_var_bins, min_count=min_count, fac_spread_outliers=fac_spread_outliers,
    )
    error = error_fun(*[_host(v, np.float64) for v in list_var])
    return error, df, error_fun


# ---------------------------------------------------------------------- convolutions


def _kernel_runs(row: np.ndarray) -> list[tuple[int, int, float]]:
    """The runs [b0, b1) of equal non-zero weight in one kernel row."""
    runs = []
    b = 0
    while b < len(row):
        if row[b] == 0:
            b += 1
            continue
        e = b
        while e < len(row) and row[e] == row[b]:
            e += 1
        runs.append((b, e, float(row[b])))
        b = e
    return runs


def _conv2d_runs(imgs: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """True convolution (the kernel flipped) of (N, H, W) images with one (k1, k2) kernel,
    zero padding ((k - 1) // 2, k // 2) per axis, as a float64 (N, H, W) tensor.

    No library convolution: on an H100 cuDNN's float32 convolutions run in TF32 unless they
    are told otherwise. Each image row is summed once into a float64 prefix sum; a run of
    equal weights in a kernel row is then one difference of two shifted slices of it. A 0/1
    kernel of side k (the mean filter's disk or square) takes k such passes, a general
    kernel at most one per tap. The sums are float64, so their order does not matter at
    float32 precision. `imgs` must be finite."""
    n, h, w = imgs.shape
    k1, k2 = kernel.shape
    flipped = np.asarray(kernel, np.float64)[::-1, ::-1]
    p1, p2 = (k1 - 1) // 2, (k2 - 1) // 2
    cs = torch.cumsum(imgs.to(torch.float64), dim=2)
    # column c of `csp` is the sum of the image columns before c - p2, for c in [0, w + k2)
    csp = torch.cat([torch.zeros((n, h, p2 + 1), dtype=torch.float64, device=imgs.device), cs,
                     cs[:, :, -1:].expand(n, h, k2 - 1 - p2)], dim=2)
    out = torch.zeros((n, h, w), dtype=torch.float64, device=imgs.device)
    for a in range(k1):
        # output row y reads image row y + a - p1
        y0, y1 = max(0, p1 - a), min(h, h + p1 - a)
        if y1 <= y0:
            continue
        src = slice(y0 + a - p1, y1 + a - p1)
        for b0, b1, weight in _kernel_runs(flipped[a]):
            run = csp[:, src, b1:b1 + w] - csp[:, src, b0:b0 + w]
            out[:, y0:y1] += run if weight == 1.0 else weight * run
    return out


def _check_conv_method(method: str) -> None:
    if method not in ("scipy", "numba"):
        raise ValueError(f"Convolution method must be 'scipy' or 'numba', got {method!r}.")


def convolution(imgs: Any, filters: Any, method: str = "scipy") -> Any:
    """Multi-image x multi-kernel convolution: (N, H, W) images and (M, k1, k2) kernels give
    (N, M, H, W) in float32, on the images' device (numpy goes to the default device and
    comes back as numpy).

    NaN handling matches scipy.ndimage.convolve on NaN inputs (a NaN poisons its footprint);
    edges use zero padding; even kernels pad ((k - 1) // 2, k // 2) like scipy's same-shape
    output. ``method`` is kept for signature parity with the scipy/numba backend switch of
    xdem: both names run the same sums here and any other value raises.
    """
    _check_conv_method(method)
    t = as_tensor(imgs)
    filt = _host(filters, np.float64)
    if t.dim() != 3 or filt.ndim != 3:
        raise ValueError("convolution takes (N, H, W) images and (M, k1, k2) kernels.")
    nanmask = ~torch.isfinite(t)
    imgs0 = torch.where(nanmask, 0.0, t)
    # any output whose footprint touched a NaN is poisoned
    touched = _conv2d_runs(nanmask.to(torch.float32), np.ones(filt.shape[1:])) > 0
    out = torch.stack([torch.where(touched, torch.nan, _conv2d_runs(imgs0, k).to(torch.float32)) for k in filt], dim=1)
    return out if isinstance(imgs, torch.Tensor) else out.cpu().numpy()


def _mean_filter_kernel(kernel_size: int, kernel_shape: str) -> np.ndarray:
    if kernel_shape == "circular":
        # integer centre at size // 2, radius = distance to the nearest wall, strict
        # inequality: 9 pixels for a 5 x 5 kernel, not 13
        c = int(kernel_size / 2)
        radius = min(c, kernel_size - c)
        yy, xx = np.mgrid[:kernel_size, :kernel_size]
        return (np.hypot(xx - c, yy - c) < radius).astype(np.float32)
    return np.ones((kernel_size, kernel_size), dtype=np.float32)


def _mean_filter_nan_device(img: torch.Tensor, kernel: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, valid count) float32 tensors of the NaN-aware mean filter of one image."""
    valid = torch.isfinite(img)
    sums = _conv2d_runs(torch.where(valid, img, 0.0)[None], kernel)[0]
    cnts = _conv2d_runs(valid.to(torch.float32)[None], kernel)[0]
    return (sums / cnts).to(torch.float32), cnts.to(torch.float32)


def mean_filter_nan(img: Any, kernel_size: int, kernel_shape: str = "circular",
                    method: str = "scipy") -> tuple[Any, Any, int]:
    """NaN-aware mean filter from two convolutions (sum and valid count): returns (mean,
    valid count per footprint, pixels per kernel). The mean is NaN where no pixel of the
    footprint is valid. Tensors stay on their device; numpy comes back as numpy. ``method``
    is kept for signature parity (see :func:`convolution`)."""
    _check_conv_method(method)
    kernel = _mean_filter_kernel(kernel_size, kernel_shape)
    mean, cnts = _mean_filter_nan_device(as_tensor(img), kernel)
    if not isinstance(img, torch.Tensor):
        mean, cnts = mean.cpu().numpy(), cnts.cpu().numpy()
    return mean, cnts, int(kernel.sum())


# ---------------------------------------------------------------------- variogram models

_VARIOGRAM_MODELS = ("spherical", "gaussian", "exponential", "cubic", "stable", "matern")


def _get_variogram_model_name(model: Any) -> str:
    """Normalize a model name ('Sph'/'Spherical'/'spherical')."""
    if callable(model):
        return model.__name__
    if isinstance(model, str):
        for supp in _VARIOGRAM_MODELS:
            if model.lower() in (supp[:3], supp):
                return supp
    raise ValueError(
        f"Variogram model name {model} not recognized. Supported models are: "
        + ", ".join(_VARIOGRAM_MODELS) + "."
    )


def _model_gamma(h: Any, model: str, r: float, psill: float, smooth: float | None = None, xp: Any = np) -> Any:
    """Variogram model forms with skgstat's effective-range conventions: spherical (range r),
    exponential (a = r/3), gaussian (a = r/2), cubic (range r), stable (a = r / 3^(1/s)),
    matern (a = r/2, Bessel-K form, numpy only). ``xp`` is numpy (float64) or torch (the
    tensor's dtype and device; divisions are by tensors, never by Python numbers, which
    CUDA would turn into a product with the reciprocal)."""
    if xp is np:
        h = np.asarray(h, dtype=np.float64)

        def div(a: Any, b: float) -> Any:
            return a / b
    else:
        h = torch.as_tensor(h)

        def div(a: Any, b: float) -> Any:
            return a / torch.tensor(b, dtype=h.dtype, device=h.device)
    if model == "spherical":
        hr = xp.clip(div(h, r), 0, 1)
        return psill * (1.5 * hr - 0.5 * hr**3)
    if model == "exponential":
        return psill * (1 - xp.exp(div(-h, r / 3.0)))
    if model == "gaussian":
        a = r / 2.0
        return psill * (1 - xp.exp(div(-(h**2), a**2)))
    if model == "cubic":
        hr = xp.clip(div(h, r), 0, 1)
        return psill * (7 * hr**2 - 8.75 * hr**3 + 3.5 * hr**5 - 0.75 * hr**7)
    if model == "stable":
        s = smooth if smooth is not None else 1.0
        return psill * (1 - xp.exp(-(div(h, r / (3 ** (1 / s))) ** s)))
    if model == "matern":
        from scipy.special import gamma as _gamma, kv as _kv

        s = smooth if smooth is not None else 0.5
        a = r / 2.0
        hh = np.asarray(h, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            val = psill * (1 - (2 / _gamma(s)) * ((hh * np.sqrt(s)) / a) ** s * _kv(s, 2 * ((hh * np.sqrt(s)) / a)))
        return np.where(hh == 0, 0.0, val)
    raise ValueError(f"Unknown variogram model: {model}")


def _check_validity_params_variogram(params_variogram_model: Any) -> None:
    """Validate variogram parameters: columns model, range and psill; known models; ranges
    and partial sills non-negative."""
    for col in ("model", "range", "psill"):
        if col not in params_variogram_model:
            raise ValueError(
                'The dataframe with variogram parameters must contain the columns "model", "range" and "psill".'
            )
    for m in params_variogram_model["model"]:
        _get_variogram_model_name(m)
    if (np.asarray(params_variogram_model["range"], np.float64) < 0).any() or \
            (np.asarray(params_variogram_model["psill"], np.float64) < 0).any():
        raise ValueError("The variogram ranges and partial sills must have non-negative values.")


def _variogram_rows(params: Any) -> list[tuple[str, float, float, float | None]]:
    """(model name, range, psill, smooth or None) per row of validated parameters."""
    _check_validity_params_variogram(params)
    models = list(params["model"])
    smooth = list(params["smooth"]) if "smooth" in params else [None] * len(models)
    return [(_get_variogram_model_name(m), float(r), float(p), s)
            for m, r, p, s in zip(models, np.asarray(params["range"], np.float64),
                                  np.asarray(params["psill"], np.float64), smooth)]


def _total_sill(params: Any) -> float:
    return float(np.sum(np.asarray(params["psill"], np.float64)))


def get_variogram_model_func(params_variogram_model: Any) -> Callable[[np.ndarray], np.ndarray]:
    """Sum-of-models variogram function gamma(h) (float64 numpy)."""
    rows = _variogram_rows(params_variogram_model)

    def sum_model(h: np.ndarray) -> np.ndarray:
        h = np.asarray(h, dtype=np.float64)
        out = np.zeros(np.shape(h))
        for name, r, p, s in rows:
            out = out + _model_gamma(h, name, r, p, s)
        return out

    return sum_model


def covariance_from_variogram(params_variogram_model: Any) -> Callable[[np.ndarray], np.ndarray]:
    """Covariance C(h) = total sill - gamma(h)."""
    _check_validity_params_variogram(params_variogram_model)
    total_sill = _total_sill(params_variogram_model)
    gamma = get_variogram_model_func(params_variogram_model)

    def cov(h: np.ndarray) -> np.ndarray:
        return total_sill - gamma(h)

    return cov


def correlation_from_variogram(params_variogram_model: Any) -> Callable[[np.ndarray], np.ndarray]:
    """Correlation rho(h) = C(h) / total sill."""
    _check_validity_params_variogram(params_variogram_model)
    total_sill = _total_sill(params_variogram_model)
    cov = covariance_from_variogram(params_variogram_model)

    def rho(h: np.ndarray) -> np.ndarray:
        return cov(h) / total_sill

    return rho


# ---------------------------------------------------------------------- empirical variogram

_ESTIMATORS = ("matheron", "cressie", "dowd")  # reduced per lag bin on the device
_GENTON = "genton"  # reduced on the host from a per-bin sample of at most _GENTON_CAP pairs


def _check_estimator(estimator: str, allowed: Sequence[str] = _ESTIMATORS + (_GENTON,)) -> None:
    if estimator not in allowed:
        raise ValueError(f"Estimator '{estimator}' not supported; use 'matheron', 'dowd', 'cressie' or 'genton'.")


def _lag_bins(h: torch.Tensor, edges: torch.Tensor, n_bins: int, valid: torch.Tensor) -> torch.Tensor:
    """Lag-bin index of each pair, `n_bins` for pairs outside the edges or not `valid`."""
    valid = valid & torch.isfinite(h) & (h >= edges[0]) & (h <= edges[-1])
    idx = torch.clamp(torch.searchsorted(edges, h, right=True) - 1, 0, n_bins - 1)
    return torch.where(valid, idx, n_bins)


def _dowd_gamma(med: torch.Tensor) -> torch.Tensor:
    return 2.198 * med**2 / 2


def _pair_weights(estimator: str, d: torch.Tensor, parked: torch.Tensor, n_bins: int) -> torch.Tensor:
    """float64 d^2 (Matheron) or sqrt(d) (Cressie) per pair, 0 for parked pairs."""
    d = torch.where(parked < n_bins, d, 0.0).to(torch.float64)
    return d * d if estimator == "matheron" else torch.sqrt(d)


def _gamma_from_sums(estimator: str, sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Matheron or Cressie gamma per bin from float64 per-bin sums of d^2 or sqrt(d)."""
    n = torch.clamp(counts, min=1).to(torch.float64)
    if estimator == "matheron":
        gamma = sums / (2 * n)
    else:
        gamma = (sums / n) ** 4 / (0.457 + 0.494 / n + 0.045 / n**2) / 2
    return torch.where(counts > 0, gamma, torch.nan)


def _binned_pair_core(diffs: torch.Tensor, dists: torch.Tensor, edges: torch.Tensor, estimator: str,
                      n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lag-bin (gamma float64, count int64) over pairwise |diffs| at `dists`, on their
    device. Dowd's median comes from the (bin, |d|) ordering (exact order statistics);
    Matheron and Cressie sum in float64, so they agree with xdem_tpu's float32 sums to
    rounding, not bitwise."""
    _check_estimator(estimator, _ESTIMATORS)
    d = torch.abs(diffs.reshape(-1))
    parked = _lag_bins(dists.reshape(-1), edges, n_bins, torch.isfinite(d))
    counts = torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
    if estimator == "dowd":
        return _dowd_gamma(binned_median(d, parked, parked < n_bins, n_bins)).double(), counts
    sums = torch.zeros(n_bins + 1, dtype=torch.float64, device=d.device).index_add_(
        0, parked, _pair_weights(estimator, d, parked, n_bins))[:n_bins]
    return _gamma_from_sums(estimator, sums, counts), counts


def _binned_pair_estimator(diffs: torch.Tensor, dists: torch.Tensor, bin_edges: np.ndarray,
                           estimator: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-lag-bin (gamma, count) as numpy, with float32 edges (see _gather_grid).

    Estimators: matheron sum(d^2) / (2 n); dowd 2.198 * median(|d|)^2 / 2; cressie
    mean(sqrt|d|)^4 / (0.457 + 0.494/n + 0.045/n^2) / 2; genton (2.2191 * Qn)^2 / 2 (see
    :func:`_binned_genton`)."""
    if estimator == _GENTON:
        return _binned_genton(diffs, dists, bin_edges)
    edges = torch.from_numpy(np.asarray(bin_edges, dtype=np.float32)).to(diffs.device)
    gamma, counts = _binned_pair_core(diffs, dists, edges, estimator, len(bin_edges) - 1)
    return gamma.cpu().numpy(), counts.cpu().numpy().astype(np.int64)


def _gather_grid(arr: torch.Tensor, ij: torch.Tensor, gsd: float):
    """Values and float32 coordinates of grid samples (row, col); rows of -1 give NaN.

    Coordinates are float32 index * gsd, as xdem_tpu computes them: grid lags then tie
    exactly at the sqrt(2)-geometric bin edges, where a float64 lag would move the pair
    to the next bin."""
    ok = ij[..., 0] >= 0
    ii = torch.clamp(ij[..., 0].long(), 0, arr.shape[0] - 1)
    jj = torch.clamp(ij[..., 1].long(), 0, arr.shape[1] - 1)
    gsd32 = float(np.float32(gsd))
    z = torch.where(ok, arr[ii, jj], torch.nan)
    ci = torch.where(ok, ii.to(torch.float32) * gsd32, torch.nan)
    cj = torch.where(ok, jj.to(torch.float32) * gsd32, torch.nan)
    return z, ci, cj


def _grid_pairs(arr: torch.Tensor, ija: torch.Tensor, ijb: torch.Tensor, gsd: float):
    """|dz| and lag of every (run, a, b) pair of grid samples, flattened; self-pairs NaN."""
    za, cai, caj = _gather_grid(arr, ija, gsd)
    zb, cbi, cbj = _gather_grid(arr, ijb, gsd)
    d = torch.abs(za[:, :, None] - zb[:, None, :]).reshape(-1)
    h = torch.sqrt((cai[:, :, None] - cbi[:, None, :]) ** 2 + (caj[:, :, None] - cbj[:, None, :]) ** 2).reshape(-1)
    return d, torch.where(h <= 0, torch.nan, h)


def _grid_variogram_device(arr: torch.Tensor, ija: torch.Tensor, ijb: torch.Tensor, gsd: float,
                           edges: torch.Tensor, estimator: str, n_bins: int):
    """Grid equidistant variogram in one pass: gather the sampled pixels, form all pairs of
    each run, reduce to per-lag-bin (gamma, count) tensors."""
    d, h = _grid_pairs(arr, ija, ijb, gsd)
    return _binned_pair_core(d, h, edges, estimator, n_bins)


def _grid_variogram_device_chunked(arr: torch.Tensor, ija: torch.Tensor, ijb: torch.Tensor, gsd: float,
                                   edges: torch.Tensor, estimator: str, n_bins: int, chunk: int):
    """Memory-bounded _grid_variogram_device: runs in chunks of `chunk`. ija/ijb run counts
    must be padded to a multiple of `chunk` with -1 rows."""
    n_chunks = ija.shape[0] // chunk

    def pair_block(ij_a, ij_b):
        d, h = _grid_pairs(arr, ij_a, ij_b, gsd)
        return d, _lag_bins(h, edges, n_bins, torch.isfinite(d))

    xs = (ija.reshape(n_chunks, chunk, *ija.shape[1:]), ijb.reshape(n_chunks, chunk, *ijb.shape[1:]))
    return _chunked_pair_reduce(pair_block, xs, estimator, n_bins)


def _pairs_variogram_device_chunked(za: torch.Tensor, zb: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor,
                                    edges: torch.Tensor, estimator: str, n_bins: int, chunk: int):
    """Chunked variogram over explicit (R, N)/(R, M) samples and (.., 2) coordinates. Run
    counts must be padded to a multiple of `chunk` with NaN rows."""
    n_chunks = za.shape[0] // chunk

    def pair_block(za_c, zb_c, ca_c, cb_c):
        d = torch.abs(za_c[:, :, None] - zb_c[:, None, :]).reshape(-1)
        h = torch.sqrt(((ca_c[:, :, None, :] - cb_c[:, None, :, :]) ** 2).sum(-1)).reshape(-1)
        return d, _lag_bins(h, edges, n_bins, torch.isfinite(d) & (h > 0))

    xs = tuple(a.reshape(n_chunks, chunk, *a.shape[1:]) for a in (za, zb, ca, cb))
    return _chunked_pair_reduce(pair_block, xs, estimator, n_bins)


def _chunked_pair_reduce(pair_block: Callable, xs: tuple[torch.Tensor, ...], estimator: str, n_bins: int):
    """Per-lag-bin (gamma, count) accumulated over chunks: ``pair_block(*chunk_inputs)``
    returns (|d|, parked bin index), and `xs` holds the inputs with a leading chunk axis.

    Matheron and Cressie sums accumulate in float64 (where xdem_tpu, without float64 on
    its chip, keeps Kahan-compensated float32 sums). Dowd's exact global median per bin
    comes from two passes of 16-bit radix histograms over the bits of the non-negative
    float32 |d|: the first finds the high half of each middle order statistic, the
    second its low half. Counts are int64.
    """
    _check_estimator(estimator, _ESTIMATORS)
    blocks = [tuple(x[k] for x in xs) for k in range(xs[0].shape[0])]
    dev = xs[0].device
    counts = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    if estimator != "dowd":
        sums = torch.zeros(n_bins + 1, dtype=torch.float64, device=dev)
        for block in blocks:
            d, parked = pair_block(*block)
            counts += torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
            sums.index_add_(0, parked, _pair_weights(estimator, d, parked, n_bins))
        return _gamma_from_sums(estimator, sums[:n_bins], counts), counts

    hist_hi = torch.zeros(n_bins * 32768 + 1, dtype=torch.int64, device=dev)
    for block in blocks:
        d, parked = pair_block(*block)
        counts += torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
        hi = d.to(torch.float32).contiguous().view(torch.int32) >> 16
        flat = torch.where(parked < n_bins, parked * 32768 + hi, n_bins * 32768)
        hist_hi += torch.bincount(flat, minlength=n_bins * 32768 + 1)
    cum_hi = torch.cumsum(hist_hi[:-1].reshape(n_bins, 32768), dim=1)
    k_lo = torch.clamp(torch.div(counts - 1, 2, rounding_mode="floor"), min=0)
    k_hi = torch.div(counts, 2, rounding_mode="floor")

    def bucket_of(k):
        # argmax returns the first maximal index: the first bucket whose cumulative count passes k.
        sel = torch.argmax((cum_hi > k[:, None]).to(torch.int32), dim=1)
        prev = torch.gather(cum_hi, 1, torch.clamp(sel - 1, min=0)[:, None])[:, 0]
        return sel, torch.where(sel > 0, prev, 0)

    sel_a, below_a = bucket_of(k_lo)
    sel_b, below_b = bucket_of(k_hi)
    # One pass resolves both middle ranks (they share a high bucket unless they straddle one).
    hist_a = torch.zeros(n_bins * 65536 + 1, dtype=torch.int64, device=dev)
    hist_b = torch.zeros_like(hist_a)
    for block in blocks:
        d, parked = pair_block(*block)
        bits = d.to(torch.float32).contiguous().view(torch.int32)
        hi, lo = bits >> 16, bits & 0xFFFF
        inb = parked < n_bins
        pk = torch.clamp(parked, 0, n_bins - 1)
        for sel, hist in ((sel_a, hist_a), (sel_b, hist_b)):
            flat = torch.where(inb & (hi == sel[pk]), parked * 65536 + lo, n_bins * 65536)
            hist += torch.bincount(flat, minlength=n_bins * 65536 + 1)

    def resolve(hist, sel, below, k):
        cum_lo = torch.cumsum(hist[:-1].reshape(n_bins, 65536), dim=1)
        sel_lo = torch.argmax((cum_lo > (k - below)[:, None]).to(torch.int32), dim=1)
        return ((sel << 16) | sel_lo).to(torch.int32).view(torch.float32)

    med = 0.5 * (resolve(hist_a, sel_a, below_a, k_lo) + resolve(hist_b, sel_b, below_b, k_hi))
    med = torch.where(counts > 0, med, torch.nan)
    return _dowd_gamma(med).double(), counts


# Pair count above which the one-pass grid variogram switches to chunks (the flat
# (bin, |d|) sort needs ~20 B per pair; the value is xdem_tpu's, not retuned for 80 GB).
_PAIR_CHUNK_BUDGET = int(2e8)
# xdem_tpu counts pairs per bin in int32 and refuses past this total; the port keeps the
# same limit so that both accept the same requests.
_PAIR_COUNT_LIMIT = 2**31 - 1


def _check_pair_count(total_pairs: int, chunked_available: bool = True) -> None:
    if not chunked_available and total_pairs > _PAIR_CHUNK_BUDGET:
        raise ValueError(
            f"This sampling method materializes all {total_pairs:.2e} pairwise comparisons "
            f"in one block (limit {_PAIR_CHUNK_BUDGET:.0e}). Reduce `subsample`, or use "
            f"subsample_method='cdist_equidistant' (memory-bounded at any pair count)."
        )
    if total_pairs > _PAIR_COUNT_LIMIT:
        raise ValueError(
            f"The requested variogram forms {total_pairs:.2e} pairwise comparisons, beyond "
            f"the per-bin count limit ({_PAIR_COUNT_LIMIT:.2e}). Reduce `subsample` "
            f"(pairs grow ~subsample^2/2) or split into several `n_variograms` runs."
        )


# ---------------------------------------------------------------------- Genton estimator

_GENTON_CAP = 400  # values per lag bin that feed the O(n^2) Qn


def _genton_qn_gamma(x: np.ndarray) -> float:
    """Genton's gamma (2.2191 * Qn)^2 / 2 of one bin's signed differences `x` (n >= 2): Qn is
    the k-th order statistic, k = C(n // 2 + 1, 2), of the pairwise |x_i - x_j|."""
    n = len(x)
    pair_diffs = np.abs(x[:, None] - x[None, :])[np.triu_indices(n, k=1)]
    k = int((n // 2 + 1) * (n // 2) / 2)
    k = min(max(k, 1), len(pair_diffs))
    qn = np.partition(pair_diffs, k - 1)[k - 1]
    return float((2.2191 * qn) ** 2 / 2)


def _binned_genton(diffs: torch.Tensor, dists: torch.Tensor, bin_edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Genton (1998) highly robust variogram per lag bin, over the signed pairwise
    differences (their spread is what Qn estimates).

    Lags are binned in float32 like every estimator here. A bin with more than 400 pairs is
    subsampled to 400 with ``np.random.default_rng(0)``, bin after bin, as xdem_tpu does on
    the host: numpy's ``choice(x, k, replace=False)`` draws the same positions as
    ``choice(len(x), k, replace=False)``, so only each bin's count goes to the host before
    the draw and only the drawn values after it. The pairs are binned on their device."""
    edges = torch.from_numpy(np.asarray(bin_edges, dtype=np.float32)).to(diffs.device)
    n_bins = len(bin_edges) - 1
    d = diffs.reshape(-1)
    parked = _lag_bins(dists.reshape(-1).to(torch.float32), edges, n_bins, torch.isfinite(d))
    counts_t = torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
    order = torch.argsort(parked, stable=True)  # each bin's pairs in their original order
    counts = counts_t.cpu().numpy().astype(np.int64)
    starts = np.cumsum(counts) - counts
    gamma = np.full(n_bins, np.nan)
    rng = np.random.default_rng(0)
    for b in range(n_bins):
        n = int(counts[b])
        if n < 2:
            continue
        pos = rng.choice(n, _GENTON_CAP, replace=False) if n > _GENTON_CAP else np.arange(n)
        picks = order[torch.from_numpy(starts[b] + pos).to(d.device)]
        gamma[b] = _genton_qn_gamma(d[picks].cpu().numpy().astype(np.float64))
    return gamma, counts


_U32 = 0xFFFFFFFF


def _genton_pair_keys(run0: int, n_local_runs: int, n: int, m: int, parked: torch.Tensor, n_bins: int) -> torch.Tensor:
    """A ranking key per pair for the Genton reservoir: the 32-bit Knuth multiplicative hash
    of the global pair index plus one (int64 holding uint32 values).

    The multiplier is odd, so the map is a bijection modulo 2^32: unique pair indices give
    unique keys and the top-CAP selection has no ties, whatever the chunking. The +1 keeps
    every valid key non-zero: key 0 marks invalid pairs and unfilled reservoir slots (last
    in descending order), so the valid pair at global index 0 is never taken for padding."""
    dev = parked.device
    local_run = torch.arange(n_local_runs, dtype=torch.int64, device=dev)[:, None, None]
    ii = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
    jj = torch.arange(m, dtype=torch.int64, device=dev)[None, None, :]
    gidx = (((int(run0) + local_run) * (n * m) + ii * m + jj).reshape(-1) + 1) & _U32
    # (gidx * 2654435769) mod 2^32 from 16-bit halves of the multiplier (2^32 / phi): the
    # whole product would pass 2^63
    golden_hi, golden_lo = 2654435769 >> 16, 2654435769 & 0xFFFF
    key = (gidx * golden_lo + (((gidx * golden_hi) & 0xFFFF) << 16)) & _U32
    return torch.where(parked < n_bins, key, 0)


def _genton_local_topcap(d: torch.Tensor, parked: torch.Tensor, key: torch.Tensor, n_bins: int):
    """Per-bin top-CAP (values, keys) by descending key: an ordering by (bin, -key), then the
    head of each bin's segment. Unfilled slots carry NaN values and key 0."""
    by_key = torch.argsort(_U32 - key, stable=True)
    order = by_key[torch.argsort(parked[by_key], stable=True)]
    d_s = d[order]
    key_s = key[order]
    counts_local = torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
    starts = torch.cumsum(counts_local, 0) - counts_local
    take = torch.clamp(counts_local, max=_GENTON_CAP)
    offs = torch.arange(_GENTON_CAP, device=d.device)[None, :]
    pos = torch.clamp(starts[:, None] + offs, 0, max(d.numel() - 1, 0))
    filled = offs < take[:, None]
    return torch.where(filled, d_s[pos], torch.nan), torch.where(filled, key_s[pos], 0)


def _genton_merge_topcap(merged_v: torch.Tensor, merged_k: torch.Tensor):
    """Global top-CAP per bin from concatenated (n_bins, K) candidate values and keys."""
    top = torch.argsort(_U32 - merged_k, dim=1, stable=True)[:, :_GENTON_CAP]
    return torch.gather(merged_v, 1, top), torch.gather(merged_k, 1, top)


def _pairs_genton_reservoir_chunked(za: torch.Tensor, zb: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor,
                                    edges: torch.Tensor, n_bins: int, chunk: int):
    """Memory-bounded Genton reservoir: over run chunks, keep the global top-CAP signed pair
    differences per lag bin, ranked by the pair keys, so that the chunk size never changes
    which 400 values feed the Qn. Run counts must be padded to a multiple of `chunk` with NaN
    rows. Returns ((n_bins, CAP) reservoir padded with NaN, per-bin int64 counts)."""
    n_chunks = za.shape[0] // chunk
    n, m = za.shape[1], zb.shape[1]
    dev = za.device
    res_v = torch.full((n_bins, _GENTON_CAP), torch.nan, dtype=torch.float32, device=dev)
    res_k = torch.zeros((n_bins, _GENTON_CAP), dtype=torch.int64, device=dev)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        d_signed = (za[rows, :, None] - zb[rows, None, :]).reshape(-1)
        h = torch.sqrt(((ca[rows, :, None, :] - cb[rows, None, :, :]) ** 2).sum(-1)).reshape(-1)
        parked = _lag_bins(h, edges, n_bins, torch.isfinite(d_signed) & (h > 0))
        counts += torch.bincount(parked, minlength=n_bins + 1)[:n_bins]
        key = _genton_pair_keys(c * chunk, chunk, n, m, parked, n_bins)
        loc_v, loc_k = _genton_local_topcap(d_signed, parked, key, n_bins)
        res_v, res_k = _genton_merge_topcap(torch.cat([res_v, loc_v], dim=1), torch.cat([res_k, loc_k], dim=1))
    return res_v, counts


def _genton_qn_from_reservoir(reservoir: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Genton's gamma per bin from the (n_bins, CAP) NaN-padded reservoir."""
    gamma = np.full(reservoir.shape[0], np.nan)
    for b in range(reservoir.shape[0]):
        x = reservoir[b][np.isfinite(reservoir[b])]
        if len(x) >= 2:
            gamma[b] = _genton_qn_gamma(x)
    return gamma


def _choose_cdist_equidistant_sampling_parameters(
    extent: tuple[float, float, float, float], shape: tuple[int, int], subsample: int, nb_rings: int = 10
) -> tuple[int, int, float]:
    """Partition `subsample` into runs/samples matching ~N^2/2 pairwise comparisons."""
    min_subsample = np.ceil(np.sqrt(2 * nb_rings * 2**2) + 1)
    if subsample < min_subsample:
        raise ValueError(f"The number of subsamples needs to be at least {min_subsample:.0f}.")
    pairwise_comp_per_disk = np.ceil(subsample**2 / (2 * nb_rings))
    if pairwise_comp_per_disk < 10:
        runs = int(pairwise_comp_per_disk / 2**2)
    else:
        runs = int(min(100, 10 * np.ceil((pairwise_comp_per_disk / (2**2 * 10)) ** (1 / 3))))
    samples = int(np.ceil(np.sqrt(pairwise_comp_per_disk / runs)))
    maxdist = np.sqrt((extent[1] - extent[0]) ** 2 + (extent[3] - extent[2]) ** 2)
    res = np.mean([(extent[1] - extent[0]) / (shape[0] - 1), (extent[3] - extent[2]) / (shape[1] - 1)])
    ratio_subsample = res**2 * samples / (np.pi * maxdist**2 / np.sqrt(2) ** (2 * nb_rings))
    return runs, samples, ratio_subsample


def _draw_rings_from_coords(rng: np.random.Generator, coords: torch.Tensor, runs: int, samples: int, nb_rings: int,
                            radius0: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Equidistant disk/ring sampling of explicit (N, 2) float64 coordinates on their device,
    with numpy's draws: per run a random centre, up to `samples` points of the disk of
    radius0 and of each ring (radius0 * sqrt(2)^(k-1), radius0 * sqrt(2)^k], padded with -1.
    Returns (disk, disk + rings) positions of shapes (runs, samples) and (runs, (nb_rings + 1)
    * samples). The points are grouped by ring with one stable sort a run, in index order
    within each group, so ``choice(len(group), take)`` on the host picks what
    ``choice(group, take)`` would, and only the group sizes reach the host."""
    dev = coords.device
    edges = torch.tensor([radius0 * np.sqrt(2) ** k for k in range(nb_rings + 1)], dtype=torch.float64, device=dev)
    disk, rings = [], []
    for _r in range(runs):
        center = coords[int(rng.integers(0, coords.shape[0]))]
        dist = torch.hypot(coords[:, 0] - center[0], coords[:, 1] - center[1])
        group = torch.searchsorted(edges, dist)  # 0 in the disk, k in ring k, nb_rings + 1 beyond
        order = torch.argsort(group, stable=True)
        counts = torch.bincount(group, minlength=nb_rings + 2)[: nb_rings + 1].tolist()
        starts = np.cumsum([0] + counts[:-1])
        picks = []
        for k, n_k in enumerate(counts):
            out = torch.full((samples,), -1, dtype=torch.int64, device=dev)
            if n_k:
                take = min(samples, n_k)
                pos = torch.from_numpy(rng.choice(n_k, take, replace=False) + int(starts[k])).to(dev)
                out[:take] = order[pos]
            picks.append(out)
        disk.append(picks[0])
        rings.append(torch.cat(picks))
    return torch.stack(disk), torch.stack(rings)


def _draw_equidistant_rings_device(generator: torch.Generator, valid: torch.Tensor, runs: int, samples: int,
                                   nb_rings: int, nx: int, ny: int, radius0_px: float, m: int):
    """Equidistant disk/ring sampling on the mask's device: `runs` random valid centres,
    `m` candidate draws per (run, ring) slot, the first `samples` candidates that land on
    valid pixels kept (stable argsort), empty slots -1. Returns int64 (ija, ijb) of shapes
    (runs, samples, 2) and (runs, (nb_rings + 1) * samples, 2)."""
    dev = valid.device
    valid_flat = valid.reshape(-1)
    ci = topk_subsample(generator, valid_flat, runs)[0]
    cr = torch.div(ci, ny, rounding_mode="floor").to(torch.float32)
    cc = (ci % ny).to(torch.float32)
    n_rings1 = nb_rings + 1
    ring_hi = float(radius0_px) * math.sqrt(2.0) ** torch.arange(n_rings1, dtype=torch.float32, device=dev)
    ring_lo = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev), ring_hi[:-1]])
    theta = 2.0 * math.pi * torch.rand((runs, n_rings1, m), generator=generator, device=dev)
    u = torch.rand((runs, n_rings1, m), generator=generator, device=dev)
    lo2, hi2 = ring_lo[None, :, None] ** 2, ring_hi[None, :, None] ** 2
    r = torch.sqrt(lo2 + u * (hi2 - lo2))
    ii = torch.round(cr[:, None, None] + r * torch.cos(theta)).to(torch.int64)
    jj = torch.round(cc[:, None, None] + r * torch.sin(theta)).to(torch.int64)
    okm = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
    okm &= valid_flat[torch.clamp(ii, 0, nx - 1) * ny + torch.clamp(jj, 0, ny - 1)]
    order = torch.argsort((~okm).to(torch.int8), dim=-1, stable=True)[..., :samples]
    keep = torch.arange(samples, device=dev) < okm.sum(dim=-1, keepdim=True)
    ii_s = torch.where(keep, torch.gather(ii, -1, order), -1)
    jj_s = torch.where(keep, torch.gather(jj, -1, order), -1)
    rings = torch.stack([ii_s, jj_s], dim=-1)  # (runs, n_rings1, samples, 2)
    return rings[:, 0], rings.reshape(runs, n_rings1 * samples, 2)


def _draw_rings_from_arr(seed: int, arr: torch.Tensor, runs: int, samples: int, nb_rings: int,
                         nx: int, ny: int, radius0_px: float, m: int):
    """The ring draw over the finite pixels of `arr`, from a generator seeded with `seed` on
    its device."""
    generator = torch.Generator(device=arr.device).manual_seed(int(seed))
    return _draw_equidistant_rings_device(generator, torch.isfinite(arr), runs, samples, nb_rings,
                                          nx, ny, radius0_px, m)


def _draw_equidistant_rings_host(rng: np.random.Generator, grid_valid: np.ndarray, runs: int, samples: int,
                                 nb_rings: int, radius0: float, gsd: float):
    """The ring draw of xdem_tpu's host grid mode (numpy, identical draws): all (run, ring)
    annuli in one batch, 8x candidates per slot, the first `samples` valid hits kept."""
    nx_g, ny_g = grid_valid.shape
    rr_v, cc_v = np.nonzero(grid_valid)
    n_rings1 = nb_rings + 1
    m = 8 * samples
    ci = rng.integers(0, len(rr_v), runs)
    centers = np.stack([rr_v[ci], cc_v[ci]], axis=1).astype(np.float64)
    ring_hi = radius0 * np.sqrt(2.0) ** np.arange(n_rings1)
    ring_lo = np.concatenate([[0.0], ring_hi[:-1]])
    theta = rng.uniform(0, 2 * np.pi, (runs, n_rings1, m))
    r = np.sqrt(rng.uniform(ring_lo[:, None] ** 2, ring_hi[:, None] ** 2, (runs, n_rings1, m))) / gsd
    ii = np.round(centers[:, None, None, 0] + r * np.cos(theta)).astype(np.int64)
    jj = np.round(centers[:, None, None, 1] + r * np.sin(theta)).astype(np.int64)
    okm = (ii >= 0) & (ii < nx_g) & (jj >= 0) & (jj < ny_g)
    okm &= grid_valid[np.clip(ii, 0, nx_g - 1), np.clip(jj, 0, ny_g - 1)]
    order = np.argsort(~okm, axis=-1, kind="stable")[..., :samples]
    keep = np.arange(samples) < okm.sum(axis=-1, keepdims=True)
    rings = np.full((runs, n_rings1, samples, 2), -1, dtype=np.int64)
    rings[..., 0] = np.where(keep, np.take_along_axis(ii, order, -1), -1)
    rings[..., 1] = np.where(keep, np.take_along_axis(jj, order, -1), -1)
    return rings[:, 0], rings.reshape(runs, n_rings1 * samples, 2)


def _pad_runs(a: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    return torch.cat([a, torch.full((pad, *a.shape[1:]), value, dtype=a.dtype, device=a.device)]) if pad else a


_POINT_METHODS = ("cdist_point", "pdist_point", "pdist_disk", "pdist_ring")


class _ValidPoints:
    """The valid samples of a variogram input on one device, addressed by their position
    among the valid samples in raster (or input) order, as numpy draws them.

    A grid keeps only the flat indexes of its finite pixels: coordinates are (row * gsd,
    col * gsd) in float64, computed for the positions asked for, so no coordinate array of
    the raster's size is ever held. Explicit points keep their float64 coordinates."""

    def __init__(self, values: torch.Tensor, gsd: float | None = None, coords: torch.Tensor | None = None):
        self.values = values.reshape(-1)
        self.flat = torch.nonzero(torch.isfinite(self.values)).reshape(-1)
        self.ny = values.shape[1] if coords is None else None
        self.gsd = gsd
        self.coords = coords

    def __len__(self) -> int:
        return int(self.flat.numel())

    def _pick(self, pos: Any) -> torch.Tensor:
        if isinstance(pos, np.ndarray):
            pos = torch.from_numpy(np.asarray(pos, np.int64)).to(self.flat.device)
        return self.flat if pos is None else self.flat[pos]

    def coords_at(self, pos: Any = None) -> torch.Tensor:
        """float64 (n, 2) coordinates of the valid samples at positions `pos` (None: all)."""
        flat = self._pick(pos)
        if self.coords is not None:
            return self.coords[flat]
        rows = torch.div(flat, self.ny, rounding_mode="floor")
        cols = flat - rows * self.ny
        return torch.stack([rows.to(torch.float64) * self.gsd, cols.to(torch.float64) * self.gsd], dim=-1)

    def values_at(self, pos: Any) -> torch.Tensor:
        return self.values[self._pick(pos)].to(torch.float32)


def _point_pairs(points: _ValidPoints, pos1: np.ndarray, pos2: np.ndarray | None):
    """Pairwise (signed differences, lags) of the samples at `pos1` against those at `pos2`,
    in float32; with ``pos2=None`` each pair of `pos1` once (the upper triangle). Pairs at
    zero distance and, for one set, the lower triangle have a NaN lag."""
    z1, c1 = points.values_at(pos1), points.coords_at(pos1).to(torch.float32)
    z2, c2 = (z1, c1) if pos2 is None else (points.values_at(pos2), points.coords_at(pos2).to(torch.float32))
    diffs = z1[:, None] - z2[None, :]
    dists = torch.sqrt(((c1[:, None, :] - c2[None, :, :]) ** 2).sum(-1))
    dists = torch.where(dists <= 0, torch.nan, dists)
    if pos2 is None:
        dists = torch.where(torch.triu(torch.ones_like(dists, dtype=torch.bool), diagonal=1), dists, torch.nan)
    return diffs, dists


class EmpiricalVariogramKArgs(TypedDict, total=False):
    """Optional keyword arguments of sample_empirical_variogram, for forwarding through
    higher-level wrappers (a copy of xdem_tpu's)."""

    runs: int
    samples: int
    nb_rings: int
    maxlag: float
    bin_func: Sequence[float]
    estimator: str


def sample_empirical_variogram(
    values: Any,
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    random_state: int | None = None,
    estimator: str = "dowd",
    maxlag: float | None = None,
    bin_func: Sequence[float] | None = None,
    nb_rings: int = 10,
    runs: int | None = None,
    samples: int | None = None,
    mesh: Any = None,
    **kwargs: Any,
) -> Table:
    """Empirical variogram with spatial subsampling adapted to grids.

    As xdem_tpu.spatialstats.sample_empirical_variogram. ``subsample_method``:

    * "cdist_equidistant" (default): Hugonnet et al. (2022) equidistant disk/ring sampling,
      in three modes: a 2-D tensor is sampled, gathered and reduced on its device (only the
      gamma/count vectors come back); a 2-D numpy grid is sampled on the host with numpy
      (xdem_tpu's identical draw) and reduced on the default device; 1-D values with
      `coords` sample explicit coordinates.
    * "cdist_point" / "pdist_point": two random point sets against each other, or one
      against itself (each pair once).
    * "pdist_disk" / "pdist_ring": one random point set within a disk (a quarter of the
      extent's diagonal) or a ring (an eighth to a quarter) around a random centre.

    The point methods draw with numpy exactly as xdem_tpu does and form their pairs on the
    device of a tensor input (the default device otherwise). Lag bins are sqrt(2)-geometric
    from sqrt(2) * gsd to maxlag and the last, undersampled bin is dropped. Estimators:
    dowd (default), matheron, cressie and genton; Genton's Qn is reduced on the host from at
    most 400 pairs per bin, so its device grid mode gathers the samples and goes through
    the pair path. Returns a table with ``exp``, ``lags``, ``count`` and ``err_exp``.

    ``mesh=`` (a `parallel.Mesh`, with "cdist_equidistant" only) draws the runs as without
    it and splits them over the mesh (`parallel.variogram.sharded_variogram_bins`): counts and
    the Dowd and Genton estimates are the same for any sharding.
    """
    if n_jobs != 1:
        raise NotImplementedError(
            "n_jobs process parallelism does not exist on this backend (one device computes "
            "all runs in a single pass).")
    if mesh is not None and subsample_method != "cdist_equidistant":
        raise ValueError("mesh= sharding is only implemented for subsample_method="
                         "'cdist_equidistant' (the reference's default scheme).")
    if subsample_method != "cdist_equidistant" and subsample_method not in _POINT_METHODS:
        raise TypeError(
            'The subsampling method must be one of "cdist_equidistant, "cdist_point", "pdist_point", '
            '"pdist_disk" or "pdist_ring".')
    _check_estimator(estimator)
    equidistant = subsample_method == "cdist_equidistant"
    values, ref = _raster_data(values)
    if ref is not None:
        gsd = ref.res[0]

    arr_dev = arr = grid_valid = coords_v = vals_v = points = None
    if isinstance(values, torch.Tensor) and values.dim() == 2:
        arr_dev = values.to(torch.float32)
        ndim = 2
    else:
        arr = np.squeeze(_host(values, np.float64))
        ndim = arr.ndim
    if ndim == 1 and coords is None:
        raise ValueError("Coordinates must be provided for 1D value arrays.")
    if ndim == 2 and gsd is None:
        raise ValueError("The ground sampling distance must be defined when passing a 2D values array.")

    if ndim == 2:
        nx, ny = arr_dev.shape if arr_dev is not None else arr.shape
        shape = (nx, ny)
        extent = (0.0, (nx - 1) * gsd, 0.0, (ny - 1) * gsd)
        if arr is not None and equidistant:
            grid_valid = np.isfinite(arr)
        if not equidistant:
            points = _ValidPoints(arr_dev if arr_dev is not None else as_tensor(arr), gsd=float(gsd))
    else:
        coords_all = _host(coords, np.float64)
        if coords_all.shape[0] == 2 and coords_all.shape[1] != 2:
            coords_all = coords_all.T
        shape = (int(np.sqrt(len(arr))),) * 2
        extent = (coords_all[:, 0].min(), coords_all[:, 0].max(), coords_all[:, 1].min(), coords_all[:, 1].max())
        valid = np.isfinite(arr)
        coords_v = coords_all[valid]
        vals_v = arr[valid]
        if gsd is None:
            gsd = float(np.sqrt(np.median(np.diff(np.sort(np.unique(coords_v[:, 0]))) ** 2)))
        if not equidistant:
            dev = default_device()
            points = _ValidPoints(torch.from_numpy(vals_v).to(dev),
                                  coords=torch.from_numpy(np.ascontiguousarray(coords_v)).to(dev))

    if maxlag is None:
        maxlag = float(np.hypot(extent[1] - extent[0], extent[3] - extent[2]))
    if bin_func is None:
        edges = [0.0]
        right = np.sqrt(2) * gsd
        while right < maxlag:
            edges.append(right)
            right *= np.sqrt(2)
        edges.append(maxlag)
    else:
        edges = [0.0] + list(bin_func)
    bin_edges = np.asarray(edges, dtype=np.float64)
    n_bins = len(bin_edges) - 1

    def point_variogram(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        if subsample_method in ("cdist_point", "pdist_point"):
            n = min(subsample, len(points))
            _check_pair_count(n * n, chunked_available=False)
            pos1 = rng.choice(len(points), n, replace=False)
            pos2 = rng.choice(len(points), n, replace=False) if subsample_method == "cdist_point" else None
        else:
            # a disk or ring footprint around a random centre; numpy's choice(sel, n) draws
            # the positions choice(len(sel), n) does, so `sel` stays on the device
            center = points.coords_at(np.array([rng.integers(0, len(points))]))[0]
            all_c = points.coords_at()
            dist_c = torch.hypot(all_c[:, 0] - center[0], all_c[:, 1] - center[1])
            maxdist = np.hypot(extent[1] - extent[0], extent[3] - extent[2])
            inside = dist_c <= maxdist / 4
            if subsample_method == "pdist_ring":
                inside &= dist_c > maxdist / 8
            sel = torch.nonzero(inside).reshape(-1)
            n = min(subsample, int(sel.numel()))
            if n < 2:
                raise ValueError("Not enough valid points in the disk/ring for subsampling.")
            _check_pair_count(n * n, chunked_available=False)
            pos1 = sel[torch.from_numpy(rng.choice(int(sel.numel()), n, replace=False)).to(sel.device)]
            pos2 = None
        diffs, dists = _point_pairs(points, pos1, pos2)
        return _binned_pair_estimator(diffs, dists, bin_edges, estimator)

    def one_variogram(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        if not equidistant:
            return point_variogram(rng)
        if runs is None or samples is None:
            runs_, samples_, _ratio = _choose_cdist_equidistant_sampling_parameters(extent, shape, subsample, nb_rings)
        else:
            runs_, samples_ = runs, samples
        maxdist = np.hypot(extent[1] - extent[0], extent[3] - extent[2])
        radius0 = maxdist / np.sqrt(2) ** nb_rings

        if arr_dev is not None:
            ija, ijb = _draw_rings_from_arr(int(rng.integers(2**31)), arr_dev, runs_, samples_, nb_rings,
                                            nx, ny, float(np.float32(radius0 / gsd)), 8 * samples_)
            total_pairs = ija.shape[0] * ija.shape[1] * ijb.shape[1]
            _check_pair_count(total_pairs)
            if mesh is not None:
                # float32 index * gsd coordinates, as the one-pass grid route forms its lags
                (za_g, ci_a, cj_a), (zb_g, ci_b, cj_b) = _gather_grid(arr_dev, ija, gsd), _gather_grid(arr_dev, ijb, gsd)
                return sharded_variogram_bins(za_g, zb_g, torch.stack([ci_a, cj_a], -1), torch.stack([ci_b, cj_b], -1),
                                              bin_edges, mesh, estimator=estimator)
            if estimator != _GENTON:
                edges_t = torch.from_numpy(bin_edges.astype(np.float32)).to(arr_dev.device)
                if total_pairs > _PAIR_CHUNK_BUDGET:
                    chunk = max(1, _PAIR_CHUNK_BUDGET // (8 * ija.shape[1] * ijb.shape[1]))
                    pad = (-ija.shape[0]) % chunk
                    gamma, counts = _grid_variogram_device_chunked(
                        arr_dev, _pad_runs(ija, pad, -1), _pad_runs(ijb, pad, -1), gsd, edges_t, estimator, n_bins,
                        chunk)
                else:
                    gamma, counts = _grid_variogram_device(arr_dev, ija, ijb, gsd, edges_t, estimator, n_bins)
                return gamma.cpu().numpy(), counts.cpu().numpy().astype(np.int64)

            def gather_dev(ij):
                # float64 index * gsd, then float32, as the host modes (and xdem_tpu) form them
                ok_ij = ij[..., 0] >= 0
                ii = torch.clamp(ij[..., 0], 0, nx - 1)
                jj = torch.clamp(ij[..., 1], 0, ny - 1)
                z = torch.where(ok_ij, arr_dev[ii, jj], torch.nan)
                co = torch.stack([ii, jj], dim=-1).to(torch.float64) * gsd
                return z, torch.where(ok_ij[..., None], co, torch.nan).to(torch.float32)

            (za_t, ca_t), (zb_t, cb_t) = gather_dev(ija), gather_dev(ijb)
        else:
            if grid_valid is not None:
                ija, ijb = _draw_equidistant_rings_host(rng, grid_valid, runs_, samples_, nb_rings, radius0, gsd)

                def gather(ij):
                    ok_ij = ij[..., 0] >= 0
                    ii = np.clip(ij[..., 0], 0, nx - 1)
                    jj = np.clip(ij[..., 1], 0, ny - 1)
                    z = np.where(ok_ij, arr[ii, jj], np.nan)
                    co = np.stack([np.where(ok_ij, ii * gsd, np.nan), np.where(ok_ij, jj * gsd, np.nan)], axis=-1)
                    return z, co

                za, ca = gather(ija)
                zb, cb = gather(ijb)
                dev = default_device()
                za_t, zb_t, ca_t, cb_t = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (za, zb, ca, cb))
            else:
                coords_t = torch.from_numpy(np.ascontiguousarray(coords_v)).to(default_device())
                ia, ib = _draw_rings_from_coords(rng, coords_t, runs_, samples_, nb_rings, radius0)
                vals_t = torch.from_numpy(vals_v).to(coords_t.device)

                def gather_pts(ii):
                    ok_i = ii >= 0
                    jj = torch.clamp(ii, min=0)
                    z = torch.where(ok_i, vals_t[jj], torch.nan).to(torch.float32)
                    return z, torch.where(ok_i[..., None], coords_t[jj], torch.nan).to(torch.float32)

                (za_t, ca_t), (zb_t, cb_t) = gather_pts(ia), gather_pts(ib)

        total_pairs = za_t.shape[0] * za_t.shape[1] * zb_t.shape[1]
        _check_pair_count(total_pairs)
        if mesh is not None:
            return sharded_variogram_bins(za_t, zb_t, ca_t, cb_t, bin_edges, mesh, estimator=estimator)
        if total_pairs > _PAIR_CHUNK_BUDGET:
            chunk = max(1, _PAIR_CHUNK_BUDGET // (8 * za_t.shape[1] * zb_t.shape[1]))
            pad = (-za_t.shape[0]) % chunk
            edges_t = torch.from_numpy(bin_edges.astype(np.float32)).to(za_t.device)
            padded = tuple(_pad_runs(a, pad, np.nan) for a in (za_t, zb_t, ca_t, cb_t))
            if estimator == _GENTON:
                res, counts = _pairs_genton_reservoir_chunked(*padded, edges_t, n_bins, chunk)
                counts = counts.cpu().numpy().astype(np.int64)
                return _genton_qn_from_reservoir(res.cpu().numpy().astype(np.float64), counts), counts
            gamma, counts = _pairs_variogram_device_chunked(*padded, edges_t, estimator, n_bins, chunk)
            return gamma.cpu().numpy(), counts.cpu().numpy().astype(np.int64)
        diffs = za_t[:, :, None] - zb_t[:, None, :]
        dists = torch.sqrt(((ca_t[:, :, None, :] - cb_t[:, None, :, :]) ** 2).sum(-1))
        dists = torch.where(dists <= 0, torch.nan, dists)  # self-pairs of the duplicated disk block
        return _binned_pair_estimator(diffs, dists, bin_edges, estimator)

    if mesh is not None:
        from xdem_tpu_torch.parallel.variogram import sharded_variogram_bins
    rng_master = np.random.default_rng(random_state)
    gammas, counts = [], []
    for _ in range(n_variograms):
        g, c = one_variogram(np.random.default_rng(rng_master.integers(0, 2**31 - 1)))
        gammas.append(g)
        counts.append(c)
    gammas_arr = np.asarray(gammas, dtype=np.float64)
    counts_arr = np.asarray(counts, dtype=np.int64)
    if n_variograms == 1:
        exp, count, err = gammas_arr[0], counts_arr[0], np.full(n_bins, np.nan)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            exp = np.nanmean(gammas_arr, axis=0)
            err = np.nanstd(gammas_arr, axis=0) / np.sqrt(n_variograms)
        count = counts_arr.sum(axis=0)
    # The last lag bin is always undersampled: drop it.
    return {"exp": exp[:-1], "lags": bin_edges[1:][:-1], "count": count[:-1], "err_exp": err[:-1]}


def fit_sum_model_variogram(
    list_models: Sequence[str],
    empirical_variogram: Any,
    bounds: Sequence[tuple[float, float]] | None = None,
    p0: Sequence[float] | None = None,
    maxfev: int | None = None,
) -> tuple[Callable[[np.ndarray], np.ndarray], Table]:
    """Weighted bounded fit of a sum of variogram models to an empirical variogram: scipy's
    trf ``curve_fit`` on the host, p0 from the moving-average sill. Returns (gamma function,
    parameters table with ``model``, ``range``, ``psill``)."""
    from scipy.optimize import curve_fit

    model_names = [_get_variogram_model_name(m) for m in list_models]

    def variogram_sum(h, *args):
        out = np.zeros(np.shape(h))
        for i, name in enumerate(model_names):
            out = out + _model_gamma(h, name, args[2 * i], args[2 * i + 1])
        return out

    exp_all = np.asarray(empirical_variogram["exp"], np.float64)
    ok_exp = np.isfinite(exp_all)
    exp = exp_all[ok_exp]
    lags = np.asarray(empirical_variogram["lags"], np.float64)[ok_exp]
    err = np.asarray(empirical_variogram["err_exp"], np.float64)[ok_exp]
    if maxfev is None:
        # Near-flat (noise-dominated) variograms can exhaust scipy's default budget.
        maxfev = 20000
    n_average = max(int(np.ceil(len(exp) / 10)), 1)
    max_var = np.max(np.convolve(exp, np.ones(n_average) / n_average, mode="valid"))
    if bounds is None:
        bounds = [(0, lags[-1]), (0, max_var)] * len(model_names)
    if p0 is None:
        p0 = []
        for i in range(len(model_names)):
            p0 += [((i + 1) / len(model_names)) * lags[-1], ((i + 1) / len(model_names)) * max_var]

    final_bounds = np.transpose(np.asarray(bounds))
    if not (np.all(np.isnan(err)) or np.all(err == 0)):
        ok = np.isfinite(err) & (err > 0)
        cof, _ = curve_fit(variogram_sum, lags[ok], exp[ok], method="trf", p0=p0, bounds=final_bounds,
                           sigma=err[ok], maxfev=maxfev)
    else:
        cof, _ = curve_fit(variogram_sum, lags, exp, method="trf", p0=p0, bounds=final_bounds, maxfev=maxfev)
    params = {"model": np.array(model_names), "range": np.asarray(cof[0::2], np.float64),
              "psill": np.asarray(cof[1::2], np.float64)}
    return get_variogram_model_func(params), params


def _estimate_model_spatial_correlation(
    dvalues: Any,
    list_models: Sequence[str],
    estimator: str = "dowd",
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    random_state: int | None = None,
    bounds: Any = None,
    p0: Any = None,
    mesh: Any = None,
    **kwargs: Any,
) -> tuple[Table, Table, Callable[[np.ndarray], np.ndarray]]:
    """Empirical variogram, sum-of-models fit and correlation function."""
    emp = sample_empirical_variogram(
        values=dvalues, gsd=gsd, coords=coords, subsample=subsample, subsample_method=subsample_method,
        n_variograms=n_variograms, n_jobs=n_jobs, random_state=random_state, estimator=estimator,
        mesh=mesh, **kwargs,
    )
    _, params = fit_sum_model_variogram(list_models, emp, bounds=bounds, p0=p0)
    return emp, params, correlation_from_variogram(params)


def infer_spatial_correlation_from_stable(
    dvalues: Any,
    list_models: Sequence[str],
    stable_mask: Any = None,
    unstable_mask: Any = None,
    errors: Any = None,
    estimator: str = "dowd",
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    bounds: Any = None,
    p0: Any = None,
    random_state: int | None = None,
    mesh: Any = None,
    **kwargs: Any,
) -> tuple[Table, Table, Callable[[np.ndarray], np.ndarray]]:
    """Infer the spatial correlation of dh errors from stable terrain: (empirical variogram,
    fitted parameters, correlation function). A tensor `dvalues` is standardized by
    `errors` and masked on its device, and its variogram is sampled there. A Raster gives its
    data, its grid to Vector masks and its pixel size as the default gsd."""
    dvalues, ref = _raster_data(dvalues)
    errors = _raster_data(errors)[0]
    if ref is not None:
        stable_mask, unstable_mask = (_mask_on(m, ref, dvalues.shape, dvalues.device) for m in (stable_mask, unstable_mask))
        gsd = ref.res[0] if gsd is None else gsd
    if isinstance(dvalues, torch.Tensor):
        d = dvalues.to(torch.float32)
        e = None if errors is None else as_tensor(errors, device=d.device)
        d_stable = _standardize_masked_device(d, e, _mask_on(stable_mask, None, d.shape, d.device),
                                              _mask_on(unstable_mask, None, d.shape, d.device))
    else:
        d_stable, gsd = _preprocess_values_with_mask_to_array(
            values=dvalues, include_mask=stable_mask, exclude_mask=unstable_mask, gsd=gsd)
        if errors is not None:
            d_stable = d_stable / _host(errors)
    return _estimate_model_spatial_correlation(
        dvalues=d_stable, list_models=list_models, estimator=estimator, gsd=gsd, coords=coords,
        subsample=subsample, subsample_method=subsample_method, n_variograms=n_variograms,
        n_jobs=n_jobs, random_state=random_state, bounds=bounds, p0=p0, mesh=mesh, **kwargs,
    )


# ---------------------------------------------------------------------- effective samples


def neff_circular_approx_theoretical(area: float, params_variogram_model: Any) -> float:
    """Closed-form disk-integral n_eff per model (Rolstad et al. 2009, generalized)."""
    rows = _variogram_rows(params_variogram_model)
    l_equiv = np.sqrt(area / np.pi)

    def spherical_i(a1, c1, L):
        if l_equiv <= a1:
            return c1 * (1 - L / a1 + 1 / 5 * (L / a1) ** 3)
        return c1 / 5 * (a1 / L) ** 2

    def exponential_i(a1, c1, L):
        a = a1 / 3
        return 2 * c1 * (a / L) ** 2 * (1 - np.exp(-L / a) * (1 + L / a))

    def gaussian_i(a1, c1, L):
        a = a1 / 2
        return c1 * (a / L) ** 2 * (1 - np.exp(-(L**2) / a**2))

    def cubic_i(a1, c1, L):
        if l_equiv <= a1:
            return c1 * (6 * a1**7 - 21 * a1**5 * L**2 + 21 * a1**4 * L**3 - 6 * a1**2 * L**5 + L**7) / (6 * a1**7)
        return 1 / 6 * c1 * a1**2 / L**2

    table = {"spherical": spherical_i, "exponential": exponential_i, "gaussian": gaussian_i, "cubic": cubic_i}
    squared_se = 0.0
    for name, r, p, _s in rows:
        if name in table:
            squared_se += table[name](r, p, l_equiv)
    return float(np.nansum(np.asarray(params_variogram_model["psill"], np.float64)) / squared_se)


def neff_circular_approx_numerical(area: float, params_variogram_model: Any) -> float:
    """Numerical disk-integral n_eff for any model forms."""
    from scipy import integrate

    cov = covariance_from_variogram(params_variogram_model)
    total_sill = np.nansum(np.asarray(params_variogram_model["psill"], np.float64))
    l_equiv = np.sqrt(area / np.pi)
    full_int = integrate.quad(lambda h: h * cov(h), 0, l_equiv)[0]
    return float(total_sill / (2 * full_int / l_equiv**2))


def _pairwise_sq_dists(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """(N, M) squared distances by direct per-coordinate differences: translation-invariant,
    never squaring an absolute coordinate (the |a|^2 + |b|^2 - 2ab expansion is
    ill-conditioned at UTM magnitudes in float32)."""
    d2 = None
    for k in range(c1.shape[1]):
        d = c1[:, k][:, None] - c2[:, k][None, :]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _rho_device(h: torch.Tensor, params_variogram_model: Any) -> torch.Tensor:
    """Correlation function on a tensor of lags (models without Bessel terms)."""
    total_sill = _total_sill(params_variogram_model)
    gamma = torch.zeros_like(h)
    for name, r, p, s in _variogram_rows(params_variogram_model):
        if name == "matern":
            raise NotImplementedError("Matern n_eff on device not supported; use host path.")
        gamma = gamma + _model_gamma(h, name, r, p, s, xp=torch)
    return (total_sill - gamma) / torch.tensor(total_sill, dtype=h.dtype, device=h.device)


def _chunked_weighted_rho_sum(c1: Any, e1: Any, c2: Any, e2: Any, params_variogram_model: Any,
                              target_elems: int = 1 << 26) -> float:
    """sum_ij e1_i e2_j rho(|c1_i - c2_j|) in row chunks of about `target_elems` pairs.

    On the device of `c1` when it is a tensor, else on the default device, in float32 with
    a Kahan-compensated sum across chunks. Matern (Bessel K) runs on the host in float64.
    """
    rows = _variogram_rows(params_variogram_model)
    n, m = len(e1), len(e2)
    chunk = int(min(max(64, target_elems // max(m, 1)), max(n, 1)))
    if any(name == "matern" for name, *_ in rows):
        total_sill = _total_sill(params_variogram_model)
        c1h, e1h, c2h, e2h = (_host(a, np.float64) for a in (c1, e1, c2, e2))
        acc = 0.0
        for i0 in range(0, n, chunk):
            d = np.sqrt(((c1h[i0:i0 + chunk, None, :] - c2h[None, :, :]) ** 2).sum(-1))
            gamma = np.zeros_like(d)
            for name, r, p, s in rows:
                gamma += _model_gamma(d, name, r, p, s)
            acc += float(np.sum(e1h[i0:i0 + chunk, None] * e2h[None, :] * (total_sill - gamma) / total_sill))
        return acc

    dev = c1.device if isinstance(c1, torch.Tensor) else default_device()
    c1_t, e1_t, c2_t, e2_t = (as_tensor(a, device=dev) for a in (c1, e1, c2, e2))
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(acc)
    for i0 in range(0, n, chunk):
        d = torch.sqrt(_pairwise_sq_dists(c1_t[i0:i0 + chunk], c2_t))
        rho = _rho_device(d, params_variogram_model)
        y = torch.sum(e1_t[i0:i0 + chunk, None] * e2_t[None, :] * rho) - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return float(acc)


def _weighted_rho_sum(c1: Any, e1: Any, c2: Any, e2: Any, params_variogram_model: Any, mesh: Any) -> float:
    """The double covariance sum on one device, or with its rows split over `mesh`."""
    if mesh is not None:
        if any(name == "matern" for name, *_ in _variogram_rows(params_variogram_model)):
            logging.warning("A Matern model's n_eff runs on the host in float64 (no Bessel K on the "
                            "device): mesh= is ignored for it.")
        else:
            from xdem_tpu_torch.parallel.neff import weighted_rho_sum_sharded

            return weighted_rho_sum_sharded(c1, e1, c2, e2, params_variogram_model, mesh)
    return _chunked_weighted_rho_sum(c1, e1, c2, e2, params_variogram_model)


def _centred_f32(coords: Any) -> np.ndarray:
    """Coordinates mean-centred in float64, then cast to float32 (distances are
    translation-invariant; centring keeps float32 headroom at UTM magnitudes)."""
    coords = _host(coords, np.float64)
    return np.asarray(coords - coords.mean(axis=0), np.float32)


def neff_exact(coords: Any, errors: Any, params_variogram_model: Any, vectorized: bool = True,
               mesh: Any = None) -> float:
    """Exact n_eff from the double covariance sum over all pixel pairs. ``vectorized`` is
    kept for signature parity; both values run the same chunked sum. ``mesh=`` (a
    `parallel.Mesh`) splits the rows of the sum over the mesh
    (`parallel.neff.weighted_rho_sum_sharded`); a Matern model runs on the host."""
    _check_validity_params_variogram(params_variogram_model)
    coords = _centred_f32(coords)
    errors = _host(errors, np.float32)
    var = _weighted_rho_sum(coords, errors, coords, errors, params_variogram_model, mesh)
    return float(np.mean(errors)) ** 2 / (var / len(errors) ** 2)


def neff_hugonnet_approx(
    coords: Any,
    errors: Any,
    params_variogram_model: Any,
    subsample: int = 1000,
    vectorized: bool = True,
    random_state: int | None = None,
    mesh: Any = None,
) -> float:
    """Hugonnet et al. (2022) n_eff: one of the two sums over a random subset of `subsample`
    pixels (numpy draw, identical to xdem_tpu's); ``mesh=`` as in `neff_exact`."""
    _check_validity_params_variogram(params_variogram_model)
    rng = np.random.default_rng(random_state)
    n = len(coords)
    subsample = min(subsample, n)
    sel = rng.choice(n, size=subsample, replace=False)
    coords = _centred_f32(coords)
    errors = _host(errors, np.float32)
    var = _weighted_rho_sum(coords, errors, coords[sel], errors[sel], params_variogram_model, mesh)
    return float(np.mean(errors)) ** 2 / (var / (n * subsample))


def number_effective_samples(area: Any, params_variogram_model: Any, rasterize_resolution: Any = None,
                             **kwargs: Any) -> float:
    """n_eff in an area: the continuous disk integral for a numeric area (m^2), the
    discretized Hugonnet approximation over a Vector area rasterized at
    `rasterize_resolution` (a pixel size in m, or a Raster whose grid is used; default one
    fifth of the shortest correlation range)."""
    from xdem_tpu_torch.georef import Affine

    _check_validity_params_variogram(params_variogram_model)
    if isinstance(area, (float, int, np.floating, np.integer)):
        return neff_circular_approx_numerical(area=float(area), params_variogram_model=params_variogram_model)
    if hasattr(area, "create_mask"):
        if rasterize_resolution is None:
            rasterize_resolution = float(np.min(np.asarray(params_variogram_model["range"], np.float64)) / 5.0)
            warnings.warn(
                "No rasterization resolution given; defaulting to one fifth of the shortest "
                "correlation range. Long-range models then produce very large grids — pass "
                "rasterize_resolution to bound memory.",
                UserWarning,
            )
        if isinstance(rasterize_resolution, (float, int, np.floating, np.integer)):
            res = float(rasterize_resolution)
            left, bottom, right, top = area.bounds
            w = max(int(np.ceil((right - left) / res)), 1)
            h = max(int(np.ceil((top - bottom) / res)), 1)
            transform = Affine.from_origin(left, top, res, res)
            mask = area.mask_array(transform=transform, shape=(h, w), crs=area.crs)
        else:
            transform = rasterize_resolution.transform
            mask = area.mask_array(rasterize_resolution)
        rr, cc = np.nonzero(mask)
        xs, ys = transform.xy(rr, cc)
        coords_on_mask = np.column_stack([xs, ys])
        return neff_hugonnet_approx(coords=coords_on_mask, errors=np.ones(len(coords_on_mask)),
                                    params_variogram_model=params_variogram_model, **kwargs)
    raise ValueError("Area must be a float, integer, or Vector subclass.")


def spatial_error_propagation(areas: Sequence[Any], errors: Any, params_variogram_model: Any,
                              **kwargs: Any) -> list[float]:
    """Areal standard errors SE = mean(sigma) / sqrt(n_eff) per area (m^2, or a Vector), with
    mean(sigma) over the finite `errors` (a tensor or Raster is averaged on its device; a
    Raster over the pixels inside a Vector area)."""
    err, ref = _raster_data(errors)
    out = []
    for area in areas:
        if isinstance(err, torch.Tensor):
            e = err.to(torch.float64)
            if ref is not None and hasattr(area, "create_mask"):
                e = e[area.create_mask(ref).to(e.device)]
            mean_err = float(torch.nanmean(e))
        else:
            mean_err = float(np.nanmean(_host(err)))
        neff = number_effective_samples(area, params_variogram_model, **kwargs)
        out.append(float(mean_err / np.sqrt(neff)))
    return out


# ---------------------------------------------------------------------- patches method


def _patches_kernel_size(area: float, gsd: float, patch_shape: str) -> int:
    """Kernel pixels matching ``area``: diameter for circular patches, side for square."""
    if patch_shape.lower() == "circular":
        k = int(np.round(2 * np.sqrt(area / np.pi) / gsd, decimals=0))
    elif patch_shape.lower() == "square":
        k = int(np.round(np.sqrt(area) / gsd, decimals=0))
    else:
        raise ValueError('Patch shape should be "square" or "circular".')
    return max(k, 1)


def _patches_convolution(
    values: torch.Tensor,
    gsd: float,
    area: float,
    perc_min_valid: float = 80.0,
    patch_shape: str = "circular",
    method: str = "scipy",
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    return_in_patch_statistics: bool = False,
    verbose: bool = False,
) -> tuple[float, float, float] | tuple[float, float, float, Table]:
    """Patches method by convolution: a NaN-aware mean filter on the device of `values`, then
    the spread statistic averaged over all kernel-strided offset grids (convolved patches
    overlap, so only samples one kernel apart are independent; averaging the kernel^2 offset
    estimates makes the result robust).

    With the default NMAD, the kernel^2 medians come from one (offset, value) ordering on the
    device, in float32; any other statistic runs on the host over the strided slices.
    Returns (statistic between patches, mean independent-patch count, exact discretized patch
    area[, per-patch table with ``nanmean`` and ``count``])."""
    _check_conv_method(method)
    kernel_size = _patches_kernel_size(area, gsd, patch_shape)
    kernel = _mean_filter_kernel(kernel_size, patch_shape.lower())
    nb_per_kernel = int(kernel.sum())
    mean, counts = _mean_filter_nan_device(values, kernel)
    mean = torch.where(counts < nb_per_kernel * perc_min_valid / 100, torch.nan, mean)
    if statistic_between_patches is _stat_nmad:
        h, w = mean.shape
        offs = (torch.arange(h, device=mean.device) % kernel_size)[:, None] * kernel_size \
            + (torch.arange(w, device=mean.device) % kernel_size)[None, :]
        n_offs = kernel_size**2
        ids = torch.where(torch.isfinite(mean), offs, n_offs).reshape(-1)
        nbs_t, _med, nmads = _binned_count_med_nmad(mean.reshape(-1), ids, n_offs)
        stats_arr = nmads.cpu().numpy().astype(np.float64)
        nbs = nbs_t.cpu().numpy()
    else:
        mean_h = mean.cpu().numpy()
        stats, nbs = [], []
        for i in range(kernel_size):
            for j in range(kernel_size):
                sub = mean_h[i::kernel_size, j::kernel_size].ravel()
                fin = np.isfinite(sub)
                stats.append(float(statistic_between_patches(sub)) if fin.any() else np.nan)
                nbs.append(int(fin.sum()))
        stats_arr = np.asarray(stats)
    stat = float(np.mean(stats_arr[np.isfinite(stats_arr)])) if np.isfinite(stats_arr).any() else np.nan
    nb_indep = float(np.mean(nbs))
    exact_area = float(nb_per_kernel) * gsd**2
    if return_in_patch_statistics:
        table = {"nanmean": mean[::kernel_size, ::kernel_size].reshape(-1).cpu().numpy(),
                 "count": counts[::kernel_size, ::kernel_size].reshape(-1).cpu().numpy()}
        return stat, nb_indep, exact_area, table
    return stat, nb_indep, exact_area


def _patches_loop_quadrants(
    values: np.ndarray,
    gsd: float,
    area: float,
    patch_shape: str = "circular",
    n_patches: int = 1000,
    perc_min_valid: float = 80.0,
    statistics_in_patch: Sequence[Callable | str] = (np.nanmean,),
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    random_state: int | None = None,
    verbose: bool = False,
) -> tuple[Table, float]:
    """Patches method by quadrant sampling on the host: draw random non-overlapping quadrants
    of the right area (numpy, the draws of xdem_tpu) and reduce each patch.

    Returns (per-patch table with ``tile`` and one column per statistic, exact discretized
    patch area: the footprint pixels actually reduced per patch)."""
    rng = np.random.default_rng(random_state)
    values = _host(values, np.float64)
    side = max(int(np.round(np.sqrt(area) / gsd)), 1)
    h, w = values.shape
    nx = h // side
    ny = w // side
    if nx == 0 or ny == 0:
        raise ValueError("Patch area larger than the array extent.")
    all_quadrants = [(i, j) for i in range(nx) for j in range(ny)]
    rng.shuffle(all_quadrants)

    if patch_shape.lower() == "circular":
        yy, xx = np.mgrid[0:side, 0:side] - (side - 1) / 2
        footprint = (xx**2 + yy**2) <= ((side - 1) / 2) ** 2 if side > 1 else np.ones((1, 1), bool)
    else:
        footprint = np.ones((side, side), bool)

    names = [s if isinstance(s, str) else getattr(s, "__name__", str(s)) for s in statistics_in_patch]
    rows: dict[str, list] = {name: [] for name in ["tile"] + names}
    for (i, j) in all_quadrants[:n_patches]:
        vals = values[i * side:(i + 1) * side, j * side:(j + 1) * side][footprint]
        frac_valid = np.isfinite(vals).mean() * 100
        if verbose:
            logging.info("Working on patch (%d, %d): %.0f%% valid", i, j, frac_valid)
        if frac_valid < perc_min_valid:
            continue
        rows["tile"].append(f"{i}_{j}")
        for stat, name in zip(statistics_in_patch, names):
            fn = stat if callable(stat) else {"count": lambda v: np.isfinite(v).sum()}[stat]
            rows[name].append(fn(vals))
    return {name: np.asarray(col) for name, col in rows.items()}, float(footprint.sum()) * gsd**2


def patches_method(
    values: Any,
    areas: Sequence[float] | float | None = None,
    gsd: float | None = None,
    stable_mask: Any = None,
    unstable_mask: Any = None,
    statistics_in_patch: Sequence[Any] = (np.nanmean,),
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    perc_min_valid: float = 80.0,
    patch_shape: str = "circular",
    vectorized: bool = True,
    convolution_method: str = "scipy",
    n_patches: int = 1000,
    return_in_patch_statistics: bool = False,
    verbose: bool = False,
    random_state: int | None = None,
    area: float | None = None,
) -> Any:
    """Empirical estimation of the standard error in averaged areas.

    Pass ``areas`` as a list for one row per area in a table with the columns
    [<statistic name>, nb_indep_patches, exact_areas, areas];
    ``return_in_patch_statistics=True`` additionally returns the concatenated per-patch
    table. Passing a single number (``areas=1e4`` or the keyword ``area=``) gives the
    compact returns: (spread between patches, independent-patch count) for the vectorized
    variant, the per-patch table for the loop variant. ``convolution_method`` is validated
    and otherwise ignored (see :func:`convolution`).

    The vectorized variant filters on the device of a tensor `values` (numpy goes to the
    default device); the loop variant draws and reduces its quadrants on the host.
    """
    if areas is None and area is not None:
        areas = area
    if areas is None:
        areas = 10000.0
    values, ref = _raster_data(values)
    if ref is not None:
        stable_mask, unstable_mask = (_mask_on(m, ref, values.shape, values.device) for m in (stable_mask, unstable_mask))
        gsd = ref.res[0] if gsd is None else gsd
    if gsd is None:
        raise ValueError("A ground sampling distance is required (pass gsd or a Raster).")

    if isinstance(values, torch.Tensor) and vectorized:
        arr = _standardize_masked_device(values, None, _mask_on(stable_mask, None, values.shape, values.device),
                                         _mask_on(unstable_mask, None, values.shape, values.device))
    else:
        arr, _ = _preprocess_values_with_mask_to_array(values, include_mask=stable_mask,
                                                       exclude_mask=unstable_mask, gsd=gsd)
        if vectorized:
            arr = as_tensor(arr)

    def loop_variant(a: float) -> tuple[Table, float]:
        return _patches_loop_quadrants(
            arr, gsd, a, patch_shape=patch_shape, n_patches=n_patches, perc_min_valid=perc_min_valid,
            statistics_in_patch=statistics_in_patch, statistic_between_patches=statistic_between_patches,
            random_state=random_state, verbose=verbose)

    def one_area(a: float) -> tuple[float, float, float, Table | None]:
        """(statistic, nb independent patches, exact area, per-patch table or None)."""
        if vectorized:
            if verbose:
                k = _patches_kernel_size(a, gsd, patch_shape)
                logging.info("Patches (convolution variant): %d x %d px kernel over a %s grid",
                             k, k, "x".join(map(str, arr.shape)))
            out = _patches_convolution(
                arr, gsd, a, perc_min_valid=perc_min_valid, patch_shape=patch_shape, method=convolution_method,
                statistic_between_patches=statistic_between_patches,
                return_in_patch_statistics=return_in_patch_statistics)
            return out[0], out[1], out[2], (out[3] if return_in_patch_statistics else None)
        table, exact = loop_variant(a)
        first = statistics_in_patch[0]
        first_name = first if isinstance(first, str) else getattr(first, "__name__", str(first))
        if len(table["tile"]):
            firsts = table[first_name].astype(np.float64)
            stat = float(statistic_between_patches(firsts))
            nb = int(np.isfinite(firsts).sum())
        else:
            stat, nb = np.nan, 0
            warnings.warn("No valid patch found covering this area size, returning NaN "
                          "for statistic.", UserWarning)
        return stat, float(nb), exact, (table if return_in_patch_statistics else None)

    # A single area: the compact returns
    if np.ndim(areas) == 0:
        if vectorized:
            stat, nb, _exact, _table = one_area(float(areas))
            return stat, nb
        return loop_variant(float(areas))[0]

    # A list of areas: one table row per area
    stats, nbs, exacts, tables = [], [], [], []
    for a in areas:
        stat, nb, exact, table = one_area(float(a))
        stats.append(stat)
        nbs.append(nb)
        exacts.append(exact)
        if return_in_patch_statistics and table is not None:
            n_rows = len(next(iter(table.values())))
            tables.append({**table, "areas": np.full(n_rows, float(a)), "exact_areas": np.full(n_rows, exact)})
    table_statistic = {
        getattr(statistic_between_patches, "__name__", "statistic"): np.asarray(stats, np.float64),
        "nb_indep_patches": np.asarray(nbs, np.float64),
        "exact_areas": np.asarray(exacts, np.float64),
        "areas": np.asarray(list(areas), np.float64),
    }
    if return_in_patch_statistics:
        cols = list(tables[0]) if tables else []
        return table_statistic, {c: np.concatenate([t[c] for t in tables]) for c in cols}
    return table_statistic


# ---------------------------------------------------------------------- plotting


def _column(df: Any, name: str, dtype: Any = np.float64) -> np.ndarray:
    """A column of a table of this module or of a pandas frame, as a numpy array."""
    return np.asarray(df[name], dtype=dtype)


def _pyplot(out_fname: str | None):
    """matplotlib and its pyplot, imported at plot time; with `out_fname` the backend is Agg."""
    import matplotlib

    if out_fname is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def _interval_mids(df: Any, name: str) -> np.ndarray:
    """Bin mid-points of variable `name`, NaN in rows that do not bin it: from the
    ``<name>_left``/``<name>_right`` columns of this module's tables, or from a frame's column
    of intervals (objects with ``.mid``, or their '[a, b)' strings)."""
    if f"{name}_left" in df and f"{name}_right" in df:
        return 0.5 * (_column(df, f"{name}_left") + _column(df, f"{name}_right"))
    import re

    mids = []
    for v in np.asarray(df[name], dtype=object):
        if hasattr(v, "mid"):
            mids.append(float(v.mid))
            continue
        m = re.match(r"[\[\(]\s*([-\d.e+]+)\s*,\s*([-\d.e+]+)\s*[\]\)]", v) if isinstance(v, str) else None
        mids.append(0.5 * (float(m.group(1)) + float(m.group(2))) if m else np.nan)
    return np.asarray(mids, np.float64)


def plot_variogram(
    df: Any,
    list_fit_fun: Sequence[Callable[[np.ndarray], np.ndarray]] | None = None,
    list_fit_fun_label: Sequence[str] | None = None,
    ax: Any = None,
    xscale: str = "linear",
    xscale_range_split: Sequence[float] | None = None,
    xlabel: str | None = None,
    ylabel: str | None = None,
    xlim: Any = None,
    ylim: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot an empirical variogram (pair counts as bars, variance as points) with optional
    fitted models, from a table of :func:`sample_empirical_variogram` or a pandas frame.

    ``xscale_range_split`` splits the lag axis into side-by-side panels at the given
    distances, so that short-range structure stays readable next to the long-range lags;
    each panel carries its own pair-count histogram on top.
    """
    _matplotlib, plt = _pyplot(out_fname)

    if xscale_range_split is not None:
        return _plot_variogram_split(
            df, list_fit_fun=list_fit_fun, list_fit_fun_label=list_fit_fun_label, ax=ax,
            xscale=xscale, xscale_range_split=list(xscale_range_split), xlabel=xlabel,
            ylabel=ylabel, xlim=xlim, ylim=ylim, out_fname=out_fname,
        )

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 5))
    else:
        fig = ax.figure

    lags, exp, counts = _column(df, "lags"), _column(df, "exp"), _column(df, "count")
    err = _column(df, "err_exp") if "err_exp" in df else np.full_like(exp, np.nan)

    ax2 = ax.twinx() if hasattr(ax, "twinx") else None
    if ax2 is not None:
        ax2.bar(lags, counts, width=np.r_[lags[0], np.diff(lags)] * 0.9, alpha=0.2,
                color="grey", label="pair count")
        ax2.set_ylabel("pairwise sample count")
    if np.isfinite(err).any():
        ax.errorbar(lags, exp, yerr=err, fmt="o", ms=4, label="empirical")
    else:
        ax.plot(lags, exp, "o", ms=4, label="empirical")

    if list_fit_fun is not None:
        h = np.linspace(0, np.nanmax(lags), 500)
        for i, fn in enumerate(list_fit_fun):
            label = list_fit_fun_label[i] if list_fit_fun_label else f"model {i+1}"
            ax.plot(h, fn(h), "-", label=label)

    ax.set_xscale(xscale)
    ax.set_xlabel(xlabel or "spatial lag")
    ax.set_ylabel(ylabel or "variance")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.legend(loc="lower right")
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def _plot_variogram_split(
    df: Any,
    list_fit_fun: Sequence[Callable[[np.ndarray], np.ndarray]] | None,
    list_fit_fun_label: Sequence[str] | None,
    ax: Any,
    xscale: str,
    xscale_range_split: list[float],
    xlabel: str | None,
    ylabel: str | None,
    xlim: Any,
    ylim: Any,
    out_fname: str | None,
) -> Any:
    """Multi-panel variogram: one sub-axis per lag range, pair-count histogram on top."""
    import matplotlib.pyplot as plt

    lags, exp, counts = _column(df, "lags"), _column(df, "exp"), _column(df, "count")
    err = _column(df, "err_exp") if "err_exp" in df else np.full_like(exp, np.nan)
    edges = np.r_[0.0, lags]
    centers = 0.5 * (edges[:-1] + edges[1:])

    # Panel boundaries: prepend the axis origin only when the first split is not it, append
    # the largest lag when absent
    first = float(np.min(lags)) / 2 if xscale == "log" else 0.0
    splits = list(xscale_range_split)
    if splits[0] == 0.0 and xscale == "log":
        splits[0] = first  # a log axis cannot start at 0
    elif splits[0] != 0.0 and splits[0] != first:
        splits = [first] + splits
    if splits[-1] < float(np.max(lags)):
        splits.append(float(np.max(lags)))
    n_panels = len(splits) - 1

    if ax is None:
        fig = plt.figure(figsize=(3.0 * n_panels + 2.0, 5.0))
        make_axes = fig.add_axes
    else:
        fig = ax.figure
        ax.axis("off")
        make_axes = ax.inset_axes

    no_err = bool(np.all(np.isnan(err)))
    ymax = float(np.nanmax(exp)) * 1.05 if no_err else float(np.nanmax(exp) + np.nanmean(err[np.isfinite(err)]))
    axes = []
    for k in range(n_panels):
        x0, x1 = splits[k], splits[k + 1]
        left, width = 0.08 + 0.92 * k / n_panels, 0.92 / n_panels * 0.94
        ax_hist = make_axes([left, 0.78, width, 0.20])
        ax_stat = make_axes([left, 0.10, width, 0.64])
        in_panel = (edges[1:] > x0) & (edges[:-1] < x1)
        for i in np.flatnonzero(in_panel):
            ax_hist.fill_between([edges[i], edges[i + 1]], 0, counts[i],
                                 facecolor="grey", alpha=0.6, edgecolor="white", linewidth=0.5)
        ax_hist.set_xscale(xscale)
        ax_hist.set_xlim(x0, x1)
        ax_hist.set_xticks([])
        sel = (centers >= x0) & (centers <= x1)
        if no_err:
            ax_stat.plot(centers[sel], exp[sel], "x", color="tab:blue", label="empirical")
        else:
            ax_stat.errorbar(centers[sel], exp[sel], yerr=err[sel], fmt="x", label="empirical")
        if list_fit_fun is not None:
            h = np.linspace(max(x0, 1e-9), x1, 300)
            for i, fn in enumerate(list_fit_fun):
                label = list_fit_fun_label[i] if list_fit_fun_label else f"model {i + 1}"
                ax_stat.plot(h, fn(h), "--", label=label)
        ax_stat.set_xscale(xscale)
        ax_stat.set_xlim(xlim if xlim is not None else (x0, x1))
        ax_stat.set_ylim(ylim if ylim is not None else (0, ymax))
        if k == 0:
            ax_hist.set_ylabel("pair count")
            ax_stat.set_ylabel(ylabel or "variance")
        else:
            ax_hist.set_yticks([])
            ax_stat.set_yticks([])
        if k == n_panels // 2:
            ax_stat.set_xlabel(xlabel or "spatial lag")
        if k == n_panels - 1:
            ax_stat.legend(loc="lower right", fontsize=8)
        axes.append(ax_stat)

    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return axes


def plot_1d_binning(
    df: Any,
    var_name: str,
    statistic_name: str,
    label_var: str | None = None,
    label_statistic: str | None = None,
    min_count: int = 30,
    ax: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot a 1-D binned statistic of an :func:`nd_binning` table (or xdem_tpu's frame)
    against the bin mid-points of `var_name`, with the per-bin counts as bars on top."""
    _matplotlib, plt = _pyplot(out_fname)

    mids_all = _interval_mids(df, var_name)
    keep = (_column(df, "nd", np.int64) == 1) & np.isfinite(mids_all)
    mids = mids_all[keep]
    counts = _column(df, "count")[keep]
    vals = np.where(counts >= min_count, _column(df, statistic_name)[keep], np.nan)

    if ax is None:
        fig, (ax_hist, ax) = plt.subplots(
            2, 1, figsize=(7, 6), sharex=True, gridspec_kw={"height_ratios": [1, 3]}
        )
        ax_hist.bar(mids, counts, width=np.median(np.diff(mids)) * 0.9, alpha=0.4, color="grey")
        ax_hist.set_ylabel("count")
    else:
        fig = ax.figure
    ax.plot(mids, vals, "o-", ms=4)
    ax.set_xlabel(label_var or var_name)
    ax.set_ylabel(label_statistic or statistic_name)
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_2d_binning(
    df: Any,
    var_name_1: str,
    var_name_2: str,
    statistic_name: str,
    label_var_name_1: str | None = None,
    label_var_name_2: str | None = None,
    label_statistic: str | None = None,
    cmap: str = "Reds",
    min_count: int = 30,
    scale_var_1: str = "linear",
    scale_var_2: str = "linear",
    vmin: float | None = None,
    vmax: float | None = None,
    nodata_color: Any = "yellow",
    ax: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot a 2-D binned statistic of an :func:`nd_binning` table (or xdem_tpu's frame) as a
    coloured mesh.

    ``scale_var_1/2`` set the axis scales ("linear"/"log"), ``vmin/vmax`` clamp the colour
    range, and ``nodata_color`` paints the bins masked by ``min_count``."""
    matplotlib, plt = _pyplot(out_fname)

    mids_1, mids_2 = _interval_mids(df, var_name_1), _interval_mids(df, var_name_2)
    keep = (_column(df, "nd", np.int64) == 2) & np.isfinite(mids_1) & np.isfinite(mids_2)
    if not keep.any():
        raise ValueError(f"No 2-D binning of ({var_name_1}, {var_name_2}) in the dataframe.")
    m1 = sorted(set(mids_1[keep]))
    m2 = sorted(set(mids_2[keep]))
    counts, stat = _column(df, "count"), _column(df, statistic_name)
    grid = np.full((len(m2), len(m1)), np.nan)
    for r in np.flatnonzero(keep):
        if counts[r] >= min_count:
            grid[m2.index(mids_2[r]), m1.index(mids_1[r])] = stat[r]
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 5))
    else:
        fig = ax.figure
    cmap_obj = matplotlib.colormaps[cmap].copy()
    cmap_obj.set_bad(nodata_color)
    im = ax.pcolormesh(m1, m2, np.ma.masked_invalid(grid), cmap=cmap_obj, shading="nearest",
                       vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, label=label_statistic or statistic_name)
    ax.set_xscale(scale_var_1)
    ax.set_yscale(scale_var_2)
    ax.set_xlabel(label_var_name_1 or var_name_1)
    ax.set_ylabel(label_var_name_2 or var_name_2)
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax
