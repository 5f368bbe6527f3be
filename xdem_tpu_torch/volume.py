"""Volume change: hypsometric binning, interpolation, area/volume, and gap-filling.

Port of xdem_tpu/volume.py for arrays, tensors and Rasters (by their data): hypsometric_binning,
interpolate_hypsometric_bins, fit_hypsometric_bins_poly, calculate_hypsometry_area,
idw_interpolation, hypsometric_interpolation, local_hypsometric_interpolation,
get_regional_hypsometric_signal and norm_regional_hypsometric_interpolation, with the same
parameters.

Tables are dicts of 1-D numpy arrays (the port never imports pandas). Where xdem_tpu returns
a frame indexed by elevation intervals, the dict holds its value columns under the same names
(``value`` and ``count``; ``w_mean``, ``median``, ``std``, ``sigma-1-lower``,
``sigma-1-upper`` and ``count`` for the regional signal; ``area`` for the series of
calculate_hypsometry_area) plus the two edge columns ``bin_left`` and ``bin_right`` for the
interval index (bins are closed on the left). Every function that takes bins reads such a
dict or an xdem_tpu frame alike (``.index.left``/``.right`` and the columns by name).

The binned medians of large or device-resident inputs run in torch on the input's device
(numpy inputs of 2**21 pixels and more go to the default device): only the reference's
minimum and maximum and the per-bin vectors cross to the host. The gap fillers and the area
are host numpy/scipy in float64, as in xdem_tpu.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Literal

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor, default_device
from xdem_tpu_torch.ops.reductions import binned_median
from xdem_tpu_torch.ops.transfer import host_array as _host
from xdem_tpu_torch.ops.transfer import unmask

Table = dict  # column name -> 1-D numpy array


# ---------------------------------------------------------------------- tables


def _is_frame(bins: Any) -> bool:
    """True for a pandas frame or series indexed by intervals (read by duck typing)."""
    return hasattr(bins, "index") and hasattr(bins.index, "left")


def _bin_edges(bins: Any) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) bin edges of a table of this module or of an interval-indexed frame."""
    if _is_frame(bins):
        return np.asarray(bins.index.left, np.float64), np.asarray(bins.index.right, np.float64)
    return np.asarray(bins["bin_left"], np.float64), np.asarray(bins["bin_right"], np.float64)


def _bin_mids(bins: Any) -> np.ndarray:
    if _is_frame(bins):
        return np.asarray(bins.index.mid, np.float64)
    left, right = _bin_edges(bins)
    return 0.5 * (left + right)


def _column_names(bins: Any) -> list[str]:
    if _is_frame(bins):
        return list(bins.columns) if hasattr(bins, "columns") else []
    return [c for c in bins if c not in ("bin_left", "bin_right")]


def _copy_table(bins: Any) -> Table:
    """A table of this module with the columns and bins of `bins` (frame or dict)."""
    out: Table = {c: np.array(bins[c]) for c in _column_names(bins)}
    out["bin_left"], out["bin_right"] = (e.copy() for e in _bin_edges(bins))
    return out


def _table(columns: dict, edges: np.ndarray) -> Table:
    out: Table = dict(columns)
    edges = np.asarray(edges, np.float64)
    out["bin_left"], out["bin_right"] = edges[:-1].copy(), edges[1:].copy()
    return out


# ---------------------------------------------------------------------- binning


def _elevation_bin_edges(bins: float | np.ndarray, kind: str, min_max: Callable[[], tuple[float, float]],
                         percentiles: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """float64 bin edges of the reference elevations: `bins` is the bin size ("fixed"), the
    number of equal-width bins ("count") or of equal-count bins ("quantile"), or the edges
    themselves. `min_max()` and `percentiles(qs)` read the valid reference elevations."""
    if isinstance(bins, np.ndarray) or kind == "custom":
        return np.asarray(bins, dtype=np.float64)
    if kind == "fixed":
        lo, hi = min_max()
        return np.arange(lo, hi + bins + 1e-6, step=bins)
    if kind == "count":
        lo, hi = min_max()
        return np.linspace(lo, hi + 1e-6 / bins, num=int(bins) + 1)
    if kind == "quantile":
        zbins = np.asarray(percentiles(np.linspace(0, 100, int(bins) + 1)), np.float64)
        zbins[-1] += 1e-6
        return zbins
    raise ValueError(f"Invalid bin kind: {kind}")


def hypsometric_binning(
    ddem: Any,
    ref_dem: Any,
    bins: float | np.ndarray = 50.0,
    kind: Literal["fixed", "count", "quantile", "custom"] = "fixed",
    aggregation_function: Callable[[np.ndarray], float] = np.median,
) -> Table:
    """Bin dh by reference elevation; returns a table with one row per elevation interval.

    :param ddem: Elevation differences (same shape as ref_dem), NaN = nodata.
    :param ref_dem: Reference elevations.
    :param bins: Bin size (fixed), number of bins (count), count per bin (quantile), or edges.
    :param kind: Binning strategy.
    :param aggregation_function: Statistic per bin (default median).

    With the default median statistic, a tensor input or one of 2**21 pixels and more is
    binned on its device in float32 (a pixel within float32 rounding of a bin edge may take
    the neighbouring bin against the host's float64 path).

    >>> import numpy as np
    >>> ref = np.repeat(np.arange(4.0), 4).reshape(4, 4) * 100
    >>> dh = np.ones((4, 4)) * np.arange(4)[:, None]
    >>> [float(v) for v in hypsometric_binning(dh, ref, bins=100.0)["value"]]
    [0.0, 1.0, 2.0, 3.0]
    """
    ddem, ref_dem = unmask(ddem), unmask(ref_dem)
    if _wants_device(ddem, ref_dem, stat_ok=aggregation_function in (np.median, np.nanmedian)):
        dev = _device_of(ddem, ref_dem)
        ref_t = as_tensor(ref_dem, device=dev).reshape(-1)
        dh_t = as_tensor(ddem, device=dev).reshape(-1)
        zbins = _elevation_bin_edges(bins, kind, lambda: _nan_min_max(ref_t),
                                     lambda qs: _nanpercentile_device(ref_t, qs))
        values, counts = _hypso_bin_device(dh_t, ref_t, zbins)
        return _table({"value": values, "count": counts}, zbins)

    ddem = _host(ddem, np.float64).ravel()
    ref = _host(ref_dem, np.float64).ravel()
    # Bin edges come from all valid reference pixels: a dh nodata only excludes the pair
    # from the aggregation, not from the elevation range.
    ref_ok = np.isfinite(ref)
    ref = ref[ref_ok]
    ddem = ddem[ref_ok]

    zbins = _elevation_bin_edges(bins, kind, lambda: (ref.min(), ref.max()), lambda qs: np.percentile(ref, qs))

    indices = np.digitize(ref, zbins, right=False)
    values = np.full(len(zbins) - 1, np.nan)
    counts = np.zeros(len(zbins) - 1, dtype=int)
    for i in range(1, len(zbins)):
        vals_in = ddem[indices == i]
        vals_in = vals_in[np.isfinite(vals_in)]
        counts[i - 1] = vals_in.size
        if vals_in.size > 0:
            # Each statistic stays with its own interval (as xdem_tpu, which does not
            # rotate the values down one bin as its upstream does).
            values[i - 1] = aggregation_function(vals_in)
    return _table({"value": values, "count": counts}, zbins)


def interpolate_hypsometric_bins(
    hypsometric_bins: Any,
    value_column: str = "value",
    method: str = "polynomial",
    order: int = 3,
    count_threshold: int | None = None,
) -> Table:
    """Interpolate NaN (or under-populated) bins from their neighbours over the bin
    mid-points.

    ``method`` is read as pandas' ``Series.interpolate`` reads it (xdem_tpu calls that):
    "polynomial" is ``scipy.interpolate.interp1d`` of kind ``order``, and "linear", "nearest",
    "zero", "slinear", "quadratic" and "cubic" are interp1d kinds themselves: bins outside
    the range of the valid mid-points stay NaN (no extrapolation). "spline" is a
    ``UnivariateSpline`` of degree ``order``, which extrapolates. A bin excluded by
    ``count_threshold`` keeps the value it came with."""
    out = _copy_table(hypsometric_bins)
    mids = _bin_mids(hypsometric_bins)
    original = np.asarray(out[value_column], np.float64)
    vals = original.copy()
    under = None
    if count_threshold is not None:
        assert "count" in out
        under = np.asarray(out["count"]) < count_threshold
        vals[under] = np.nan
    valid = np.isfinite(vals)
    if int(np.count_nonzero(valid)) <= order + 1:
        warnings.warn("Not enough valid bins for interpolation -> returning copy", UserWarning)
        return _copy_table(hypsometric_bins)
    if not valid.all():
        from scipy import interpolate

        if method == "spline":
            terp = interpolate.UnivariateSpline(mids[valid], vals[valid], k=order)
        elif method == "polynomial" or method in ("linear", "nearest", "zero", "slinear", "quadratic", "cubic"):
            terp = interpolate.interp1d(mids[valid], vals[valid], kind=order if method == "polynomial" else method,
                                        bounds_error=False, fill_value=np.nan)
        else:
            raise ValueError(f"Interpolation method {method!r} is not supported; use 'polynomial', 'spline' "
                             "or a scipy interp1d kind.")
        vals[~valid] = terp(mids[~valid])
    if under is not None:
        vals[under] = original[under]
    out[value_column] = vals
    return out


def fit_hypsometric_bins_poly(
    hypsometric_bins: Any,
    value_column: str = "value",
    degree: int = 3,
    iterations: int = 1,
    count_threshold: int | None = None,
) -> Table:
    """Iterative 3-sigma-clipped polynomial fit over the bin mid-points."""
    mids = _bin_mids(hypsometric_bins)
    vals = np.asarray(hypsometric_bins[value_column], np.float64).copy()
    if count_threshold is not None:
        vals = np.where(np.asarray(hypsometric_bins["count"]) < count_threshold, np.nan, vals)

    keep = np.isfinite(vals)
    coefs = None
    for _ in range(iterations):
        if keep.sum() < degree + 1:
            break
        coefs = np.polyfit(mids[keep], vals[keep], deg=degree)
        resid = vals - np.polyval(coefs, mids)
        sigma = np.nanstd(resid[keep])
        new_keep = keep & (np.abs(resid) < 3 * sigma)
        if new_keep.sum() == keep.sum():
            keep = new_keep
            break
        keep = new_keep
    if coefs is None:
        raise ValueError("Not enough valid bins for polynomial fit.")
    out = _copy_table(hypsometric_bins)
    out[value_column] = np.polyval(coefs, mids)
    return out


def calculate_hypsometry_area(
    ddem_bins: Any,
    ref_dem: Any,
    pixel_size: float | tuple[float, float],
    timeframe: Literal["reference", "nonreference", "mean"] = "reference",
) -> Table:
    """Representative area per elevation bin at a given timeframe: a table with ``area`` and
    the bin edges. ``ddem_bins`` is a table of this module, or an xdem_tpu frame or series."""
    if timeframe not in ("reference", "nonreference", "mean"):
        raise ValueError(
            f"Argument 'timeframe={timeframe}' is invalid. Choices: ['reference', 'nonreference', 'mean']."
        )
    if isinstance(ddem_bins, dict) or hasattr(ddem_bins, "columns"):
        ddem_values = np.asarray(ddem_bins["value"], np.float64)
    else:  # a series indexed by intervals
        ddem_values = np.asarray(ddem_bins.values, np.float64)
    left, right = _bin_edges(ddem_bins)

    ref = _host(ref_dem, np.float64)
    assert not np.any(np.isnan(ref)), "The given reference DEM has NaNs. No NaNs are allowed to calculate area!"

    if timeframe in ("nonreference", "mean"):
        assert not np.any(np.isnan(ddem_values)), \
            "The dDEM bins cannot contain NaNs. Remove or fill them first."
        # dh is ref - other, so the other timeframe's elevations are ref - dh; linear
        # extrapolation beyond the outermost bin mid-points
        from scipy.interpolate import interp1d

        dh_of_z = interp1d(_bin_mids(ddem_bins), ddem_values, kind="linear", fill_value="extrapolate")
        if timeframe == "nonreference":
            ref = ref - dh_of_z(ref)
        else:
            ref = ref - dh_of_z(ref) / 2

    edges = np.r_[left, right[-1]]
    counts, _ = np.histogram(ref, bins=edges)
    px_area = pixel_size**2 if not isinstance(pixel_size, (tuple, list)) else pixel_size[0] * pixel_size[1]
    return {"area": counts * px_area, "bin_left": left.copy(), "bin_right": right.copy()}


# ---------------------------------------------------------------------- gap filling


def idw_interpolation(array: Any, max_search_distance: int = 10, extrapolate: bool = False,
                      force_fill: bool = False) -> np.ndarray:
    """Distance-weighted gap filling on the host.

    Iterative 3x3 NaN-aware mean dilation up to max_search_distance rings, optionally trimming
    extrapolated values outside the convex data region (approximated by a validity dilation).
    ``force_fill=True`` replaces any remaining gap with the median of all valid input values.
    """
    from scipy import ndimage

    out_dtype = _host(array).dtype if hasattr(array, "dtype") else np.float32
    arr = _host(array, np.float64).copy()
    if arr.ndim != 2:
        arr = arr.squeeze()
    valid0 = np.isfinite(arr)
    filled = arr.copy()
    for _ in range(int(max_search_distance)):
        invalid = ~np.isfinite(filled)
        if not invalid.any():
            break
        vals = np.where(np.isfinite(filled), filled, 0.0)
        cnts = np.isfinite(filled).astype(np.float64)
        ksum = ndimage.uniform_filter(vals, size=3) * 9
        kcnt = ndimage.uniform_filter(cnts, size=3) * 9
        with np.errstate(invalid="ignore", divide="ignore"):
            est = ksum / kcnt
        filled = np.where(invalid & (kcnt > 0), est, filled)
    if not extrapolate:
        # Trim values extrapolated outside the data hull; interior holes stay filled
        struct = np.ones((3, 3))
        inside = ndimage.binary_fill_holes(ndimage.binary_dilation(valid0, structure=struct, iterations=1))
        filled[~inside] = np.nan
    if force_fill:
        filled[~np.isfinite(filled)] = np.nanmedian(arr)
    return filled.astype(out_dtype)


def hypsometric_interpolation(
    voided_ddem: Any,
    ref_dem: Any,
    mask: Any,
    count_threshold: int | None = 1,
) -> np.ma.MaskedArray:
    """Fill gaps within `mask` using the hypsometric signal of dh against elevation."""
    voided_ddem, ref_dem = _host(voided_ddem, np.float64), _host(ref_dem, np.float64)
    mask = _host(mask).astype(bool)
    ddem = np.where(mask, voided_ddem, np.nan)
    bins = hypsometric_binning(ddem, ref_dem)
    interp_bins = interpolate_hypsometric_bins(bins, count_threshold=count_threshold)
    signal = np.interp(ref_dem, _bin_mids(interp_bins), interp_bins["value"])
    out = np.where(np.isfinite(ddem), ddem, signal)
    out = np.where(mask & np.isfinite(ref_dem), out, np.nan)
    return np.ma.masked_invalid(out)


def local_hypsometric_interpolation(
    voided_ddem: Any,
    ref_dem: Any,
    mask: Any,
    min_coverage: float = 0.2,
    count_threshold: int | None = 1,
    nodata: float | int = -9999,
    plot: bool = False,
) -> np.ma.MaskedArray:
    """Feature-wise hypsometric filling: one signal per connected mask feature.

    ``count_threshold`` excludes under-populated elevation bins from each feature's curve,
    ``nodata`` sets the returned masked array's fill value, and ``plot=True`` displays the
    inlier mask."""
    from scipy import ndimage

    voided_ddem, ref_dem = _host(voided_ddem, np.float64), _host(ref_dem, np.float64)
    mask = _host(mask).astype(bool)
    labels, n = ndimage.label(mask)
    out = np.where(mask, voided_ddem, np.nan)
    if plot:
        import matplotlib.pyplot as plt

        plt.matshow(mask & np.isfinite(voided_ddem))
        plt.title("inlier mask")
        plt.show()
    for i in range(1, n + 1):
        feat = labels == i
        dh_feat = np.where(feat, voided_ddem, np.nan)
        coverage = np.isfinite(dh_feat[feat]).mean() if feat.sum() else 0.0
        if coverage < min_coverage:
            continue
        with warnings.catch_warnings():
            # A small feature can have too few populated bins to interpolate; its bins are
            # then returned as they are and only the populated part of the signal fills it.
            warnings.simplefilter("ignore", UserWarning)
            filled = hypsometric_interpolation(dh_feat, ref_dem, feat, count_threshold=count_threshold)
        out = np.where(feat, filled.filled(np.nan), out)
    res = np.ma.masked_invalid(out)
    res.fill_value = nodata
    return res


def _signal_table(med: np.ndarray, std: np.ndarray, cnt: np.ndarray, n_bins: int) -> Table:
    return _table({"w_mean": med, "median": med.copy(), "std": std, "sigma-1-lower": med - std,
                   "sigma-1-upper": med + std, "count": cnt}, np.linspace(0, 1, n_bins + 1))


def get_regional_hypsometric_signal(
    ddem: Any,
    ref_dem: Any,
    glacier_index_map: Any = None,
    n_bins: int = 20,
    min_coverage: float = 0.05,
) -> Table:
    """Normalized regional hypsometric signal: dh/dh_max against normalized elevation.

    A tensor input, or one of 2**21 pixels and more, takes one pass of per-glacier segment
    reductions and binned medians on its device (the host loop scans the raster once per
    glacier)."""
    ddem, ref_dem = unmask(ddem), unmask(ref_dem)
    if glacier_index_map is None:
        glacier_index_map = np.ones(tuple(np.shape(ref_dem)), dtype=int)
    if _wants_device(ddem, ref_dem, glacier_index_map, stat_ok=True):
        return _regional_signal_device(ddem, ref_dem, glacier_index_map, n_bins, min_coverage)
    ddem = _host(ddem, np.float64)
    ref = _host(ref_dem, np.float64)
    glacier_index_map = _host(glacier_index_map)

    norm_z_all = []
    norm_dh_all = []
    for gid in np.unique(glacier_index_map):
        if gid == 0:
            continue
        sel = (glacier_index_map == gid) & np.isfinite(ref)
        if sel.sum() < 10:
            continue
        z = ref[sel]
        dh = ddem[sel]
        if np.isfinite(dh).mean() < min_coverage:
            continue
        zmin, zmax = z.min(), z.max()
        if zmax == zmin:
            continue
        norm_z = 1 - (z - zmin) / (zmax - zmin)
        scale = np.nanmax(np.abs(dh)) if np.isfinite(dh).any() else np.nan
        if not np.isfinite(scale) or scale == 0:
            continue
        norm_z_all.append(norm_z[np.isfinite(dh)])
        norm_dh_all.append(dh[np.isfinite(dh)] / scale)

    if not norm_z_all:
        raise ValueError("No valid glaciers for regional hypsometric signal.")
    norm_z = np.concatenate(norm_z_all)
    norm_dh = np.concatenate(norm_dh_all)

    edges = np.linspace(0, 1, n_bins + 1)
    idx = np.clip(np.digitize(norm_z, edges) - 1, 0, n_bins - 1)
    med = np.full(n_bins, np.nan)
    std = np.full(n_bins, np.nan)
    cnt = np.zeros(n_bins, dtype=int)
    sigma_filt = np.isfinite(norm_dh)
    for i in range(n_bins):
        sel = (idx == i) & sigma_filt
        cnt[i] = sel.sum()
        if cnt[i]:
            med[i] = np.median(norm_dh[sel])
            std[i] = np.std(norm_dh[sel])
    return _signal_table(med, std, cnt, n_bins)


def norm_regional_hypsometric_interpolation(
    voided_ddem: Any,
    ref_dem: Any,
    glacier_index_map: Any = None,
    min_coverage: float = 0.1,
    regional_signal: Any = None,
    min_elevation_range: float = 0.33,
    idealized_ddem: bool = False,
) -> np.ma.MaskedArray:
    """Fill gaps per glacier by scaling the regional normalized signal.

    Glaciers whose valid pixels cover less than ``min_elevation_range`` of the normalized
    elevation bins are skipped (a signal scaled from one elevation band extrapolates badly).
    ``idealized_ddem=True`` replaces all glacier values with the scaled signal, which is
    useful for error assessments. ``regional_signal`` is a table of
    :func:`get_regional_hypsometric_signal` or xdem_tpu's frame."""
    ddem = _host(voided_ddem, np.float64)
    ref = _host(ref_dem, np.float64)
    if glacier_index_map is None:
        glacier_index_map = np.ones(ref.shape, dtype=int)
    glacier_index_map = _host(glacier_index_map)

    if regional_signal is None:
        regional_signal = get_regional_hypsometric_signal(ddem, ref, glacier_index_map)
    mids = _bin_mids(regional_signal)
    signal_vals = np.asarray(regional_signal["median"], np.float64)

    out = ddem.copy()
    for gid in np.unique(glacier_index_map):
        if gid == 0:
            continue
        sel = (glacier_index_map == gid) & np.isfinite(ref)
        if sel.sum() < 10:
            continue
        z = ref[sel]
        dh = ddem[sel]
        finite = np.isfinite(dh)
        if finite.mean() < min_coverage or finite.sum() < 5:
            continue
        zmin, zmax = z.min(), z.max()
        if zmax == zmin:
            continue
        norm_z = 1 - (z - zmin) / (zmax - zmin)
        # The bins of the signal touched by valid pixels must span at least
        # min_elevation_range of [0, 1]
        n_bins = len(mids)
        touched = np.unique(np.clip(np.digitize(norm_z[finite], np.linspace(0, 1, n_bins + 1)) - 1,
                                    0, n_bins - 1))
        if len(touched) / n_bins < min_elevation_range:
            continue
        signal_here = np.interp(norm_z, mids, signal_vals)
        # Scale factor from overlapping valid pixels (least squares through the origin)
        denom = np.sum(signal_here[finite] ** 2)
        scale = np.sum(dh[finite] * signal_here[finite]) / denom if denom > 0 else 0.0
        filled = signal_here * scale
        vals = out[sel]
        if idealized_ddem:
            vals = filled
        else:
            vals[~finite] = filled[~finite]
        out[sel] = vals
    out = np.where(glacier_index_map > 0, out, np.nan)
    return np.ma.masked_invalid(out)


# ---------------------------------------------------------------------- device paths
# At 1e8-pixel dDEMs the digitize-and-loop aggregation crawls; the paths below bin with one
# (bin, value) ordering on the device. Engaged for the default statistics on large or
# device-resident inputs; the host path keeps float64 for everything else.

_DEVICE_BIN_THRESHOLD = 1 << 21  # ~2 Mpx: below this the host loop is faster than a transfer


def _wants_device(*arrays: Any, stat_ok: bool) -> bool:
    if not stat_ok:
        return False
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return True
    return int(np.size(arrays[0])) >= _DEVICE_BIN_THRESHOLD


def _device_of(*arrays: Any) -> torch.device:
    """The device of the first tensor among `arrays`, else the default device."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return default_device()


def _nan_min_max(x: torch.Tensor) -> tuple[float, float]:
    """(nanmin, nanmax) of a float32 tensor as Python floats: one transfer of two numbers."""
    nan = torch.isnan(x)
    both = torch.stack([torch.where(nan, torch.inf, x).amin(), torch.where(nan, -torch.inf, x).amax()])
    lo, hi = both.cpu().tolist()
    return float(lo), float(hi)


def _nanpercentile_device(x: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """Percentiles `qs` of the non-NaN entries with numpy's default linear interpolation
    between order statistics (float64 on the host from the two gathered neighbours).
    One sort; ``torch.quantile`` refuses inputs above 16 M elements."""
    xs = torch.sort(x[~torch.isnan(x)]).values
    n = xs.numel()
    if n == 0:
        return np.full(len(qs), np.nan)
    virtual = np.asarray(qs, np.float64) / 100.0 * (n - 1)
    lo = np.clip(np.floor(virtual).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    picks = xs[torch.from_numpy(np.concatenate([lo, hi])).to(xs.device)].cpu().numpy().astype(np.float64)
    v_lo, v_hi = picks[:len(lo)], picks[len(lo):]
    return v_lo + (v_hi - v_lo) * (virtual - lo)


def _binned_count_median_device(vals: torch.Tensor, ids: torch.Tensor, n_bins: int):
    """Per-bin (count int64, median) on the device; ids == n_bins marks invalid."""
    counts = torch.bincount(ids, minlength=n_bins + 1)[:n_bins]
    return counts, binned_median(vals, ids, ids < n_bins, n_bins)


def _segment_extremes(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(minimum, maximum) of `vals` in each of `n_seg` segments; seg == n_seg leaves an entry
    out, and an empty segment gives (+inf, -inf).

    From one (segment, value) ordering, as the binned medians: a scatter with "amin"/"amax"
    gives the same numbers, but its compare-and-swap loops queue up when the 1e8 pixels of a
    raster share a few dozen slots, which took most of this path's time on an H100."""
    by_value = torch.argsort(vals, stable=True)
    order = by_value[torch.argsort(seg[by_value], stable=True)]
    counts = torch.bincount(seg, minlength=n_seg + 1)[:n_seg]
    starts = torch.cumsum(counts, 0) - counts
    sorted_vals = vals[order]
    last = max(vals.numel() - 1, 0)
    lo = sorted_vals[torch.clamp(starts, 0, last)]
    hi = sorted_vals[torch.clamp(starts + counts - 1, 0, last)]
    return torch.where(counts > 0, lo, torch.inf), torch.where(counts > 0, hi, -torch.inf)


def _hypso_bin_device(ddem_flat: torch.Tensor, ref_flat: torch.Tensor, zbins: np.ndarray):
    """Device hypsometric binning: returns (values, counts) as numpy arrays. The edges are
    cast to float32 for the search, as xdem_tpu casts them."""
    n_bins = len(zbins) - 1
    edges = torch.from_numpy(np.asarray(zbins, np.float32)).to(ref_flat.device)
    # np.digitize(right=False) is searchsorted(side="right"); out-of-range and NaN-dh
    # pixels park in the invalid bin n_bins
    idx = torch.searchsorted(edges, ref_flat.contiguous(), right=True) - 1
    ok = torch.isfinite(ddem_flat) & torch.isfinite(ref_flat) & (idx >= 0) & (idx < n_bins)
    ids = torch.where(ok, idx, n_bins)
    counts, med = _binned_count_median_device(ddem_flat, ids, n_bins)
    values = med.cpu().numpy().astype(np.float64)
    counts_np = counts.cpu().numpy().astype(np.int64)
    values[counts_np == 0] = np.nan
    return values, counts_np


def _regional_signal_device(ddem: Any, ref: Any, gid_map: Any, n_bins: int, min_coverage: float) -> Table:
    """One-pass device regional hypsometric signal (per-glacier segment reductions)."""
    dev = _device_of(ddem, ref, gid_map)
    dh = as_tensor(ddem, device=dev).reshape(-1)
    z = as_tensor(ref, device=dev).reshape(-1)
    if isinstance(gid_map, torch.Tensor):
        g = gid_map.to(device=dev, dtype=torch.int64).reshape(-1)
    else:
        g = torch.from_numpy(np.ascontiguousarray(_host(gid_map), dtype=np.int64)).to(dev).reshape(-1)
    gmin, gmax = (int(v) for v in torch.stack([g.min(), g.max()]).cpu().tolist()) if g.numel() else (0, 0)
    gmax = max(gmax, 0)
    if gmax > 4_000_000 or min(gmin, 0) < 0:
        # Sparse, huge or negative ids are densified first: bincount refuses a negative id,
        # and the host path treats such ids as ordinary glaciers
        uniq, g = torch.unique(g, return_inverse=True)
        gmax = uniq.numel() - 1
        pos = int(torch.searchsorted(uniq, torch.zeros(1, dtype=uniq.dtype, device=dev)))
        zero_id = pos if pos < uniq.numel() and int(uniq[pos]) == 0 else -1
    else:
        zero_id = 0
    K = gmax + 1

    valid_ref = torch.isfinite(z)
    valid_dh = valid_ref & torch.isfinite(dh)
    gi = torch.where(valid_ref, g, K)
    gd = torch.where(valid_dh, g, K)
    cnt_ref = torch.bincount(gi, minlength=K + 1)[:K]
    cnt_dh = torch.bincount(gd, minlength=K + 1)[:K]
    zmin, zmax = _segment_extremes(z, gi, K)
    scale = torch.clamp(_segment_extremes(torch.abs(dh), gd, K)[1], min=0.0)
    ok_g = (cnt_ref >= 10) & (cnt_dh >= torch.tensor(min_coverage, dtype=torch.float32, device=dev) * cnt_ref) \
        & (zmax > zmin) & torch.isfinite(scale) & (scale > 0)
    if zero_id >= 0:
        ok_g[zero_id] = False
    gc = torch.clamp(g, 0, K - 1)
    norm_z = 1.0 - (z - zmin[gc]) / torch.clamp(zmax[gc] - zmin[gc], min=1e-30)
    norm_dh = dh / torch.clamp(scale[gc], min=1e-30)
    px_ok = valid_dh & ok_g[gc]
    # float32 edges k * (1 / n_bins) closed by 1, as xdem_tpu's jnp.linspace forms them
    # (float64 steps cast to float32 differ in the last bit of a few edges)
    steps = np.append(np.arange(n_bins, dtype=np.float32) * np.float32(1.0 / n_bins), np.float32(1.0))
    edges = torch.from_numpy(steps).to(dev)
    idx = torch.clamp(torch.searchsorted(edges, norm_z.contiguous(), right=True) - 1, 0, n_bins - 1)
    ids = torch.where(px_ok, idx, n_bins)
    counts_t, med_t = _binned_count_median_device(norm_dh, ids, n_bins)
    # The per-bin sums behind the standard deviation accumulate in float64.
    nd64 = torch.where(px_ok, norm_dh, 0.0).to(torch.float64)
    s1 = torch.bincount(ids, weights=nd64, minlength=n_bins + 1)[:n_bins]
    s2 = torch.bincount(ids, weights=nd64 * nd64, minlength=n_bins + 1)[:n_bins]
    if not bool(px_ok.any()):
        raise ValueError("No valid glaciers for regional hypsometric signal.")
    counts = counts_t.cpu().numpy().astype(np.int64)
    med = med_t.cpu().numpy().astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = s1.cpu().numpy() / np.maximum(counts, 1)
        var = s2.cpu().numpy() / np.maximum(counts, 1) - mean**2
        std = np.sqrt(np.maximum(var, 0.0))
    med[counts == 0] = np.nan
    std[counts == 0] = np.nan
    return _signal_table(med, std, counts, n_bins)
