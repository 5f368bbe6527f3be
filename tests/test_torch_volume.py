"""xdem_tpu_torch.volume against xdem_tpu.volume on the same seeded inputs.

Host paths (numpy in, fewer than 2**21 pixels, or a custom statistic) are float64 numpy on
both sides and are held to 1e-12 with identical counts. Device paths (a tensor against a
jnp array) are held to identical counts and NaN patterns, and values within 1e-4 of their
mean magnitude, the North-star tolerance for hypsometric bins; the medians are exact order
statistics of one float32 set on both sides, so the deviation observed is 0. The port's
tables are dicts with ``bin_left``/``bin_right``; xdem_tpu's are frames with an
IntervalIndex, and every function that takes bins is given both.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu import volume as jv
from xdem_tpu_torch import volume as tv


def _ramp(seed=0, shape=(120, 150)):
    """An elevation ramp and a dh that is linear in elevation plus noise
    (tests/test_volume.py's fixture), as float64."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    ref = (1000 - 3.0 * yy + 0.5 * xx).astype(np.float64)
    dh = -20 + 0.015 * ref + rng.normal(0, 0.1, ref.shape)
    return ref, dh


def _rough(seed=0, shape=(300, 340), dtype=np.float32):
    """Uniform elevations, noisy dh with 20 % voids and a NaN strip in the reference."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(100, 2100, shape)
    dh = rng.normal(-2, 1, shape) - (ref - 100) / 400
    dh[rng.random(shape) < 0.2] = np.nan
    ref[5:9, 3:60] = np.nan
    return dh.astype(dtype), ref.astype(dtype)


def _assert_bins_equal(ours, theirs, value_tol=1e-12, columns=("value",)):
    """Edges equal, counts identical, NaN pattern identical, values within `value_tol`
    (absolute and relative)."""
    np.testing.assert_array_equal(ours["bin_left"], np.asarray(theirs.index.left))
    np.testing.assert_array_equal(ours["bin_right"], np.asarray(theirs.index.right))
    if "count" in theirs:
        np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    for c in columns:
        want = theirs[c].values.astype(np.float64)
        assert np.array_equal(np.isnan(ours[c]), np.isnan(want)), c
        np.testing.assert_allclose(ours[c], want, rtol=value_tol, atol=value_tol, equal_nan=True)


KINDS = [("fixed", 50.0), ("count", 12), ("quantile", 10),
         ("custom", np.array([150.0, 400.0, 800.0, 1500.0, 2050.0, 2300.0, 2400.0]))]


# ---------------------------------------------------------------------- hypsometric_binning


@pytest.mark.parametrize("kind,bins", KINDS, ids=[k for k, _ in KINDS])
def test_binning_host_path_equals_xdem_tpu(kind, bins):
    """Host float64 numpy on both sides: 1e-12, counts identical. The custom edges end in an
    all-empty bin, which is NaN with count 0 in both."""
    dh, ref = _rough(dtype=np.float64)
    ours = tv.hypsometric_binning(dh, ref, bins=bins, kind=kind)
    theirs = jv.hypsometric_binning(dh, ref, bins=bins, kind=kind)
    _assert_bins_equal(ours, theirs)
    if kind == "custom":
        assert ours["count"][-1] == 0 and np.isnan(ours["value"][-1])


def test_binning_custom_statistic_stays_on_host():
    """A statistic other than the median runs the host loop even for tensors: 1e-12."""
    dh, ref = _rough(shape=(60, 70), dtype=np.float64)
    ours = tv.hypsometric_binning(torch.from_numpy(dh), torch.from_numpy(ref), bins=200.0,
                                  aggregation_function=np.nanmean)
    theirs = jv.hypsometric_binning(dh, ref, bins=200.0, aggregation_function=np.nanmean)
    _assert_bins_equal(ours, theirs)


@pytest.mark.parametrize("kind,bins", KINDS, ids=[k for k, _ in KINDS])
def test_binning_device_path_matches_xdem_tpu(kind, bins):
    """Tensor against jnp array, float32: counts and NaN pattern identical, values within
    1e-4 of the mean magnitude (observed 0: exact order statistics of one set). Quantile
    edges interpolate in float64 here and in float32 there: edges within 1e-6 relative,
    counts within 2."""
    dh, ref = _rough()
    ours = tv.hypsometric_binning(torch.from_numpy(dh), torch.from_numpy(ref), bins=bins, kind=kind)
    theirs = jv.hypsometric_binning(jnp.asarray(dh), jnp.asarray(ref), bins=bins, kind=kind)
    want = theirs["value"].values
    assert len(ours["value"]) == len(theirs)
    if kind == "quantile":
        np.testing.assert_allclose(ours["bin_left"], np.asarray(theirs.index.left), rtol=1e-6)
        np.testing.assert_allclose(ours["bin_right"], np.asarray(theirs.index.right), rtol=1e-6)
        assert np.abs(ours["count"] - theirs["count"].values).max() <= 2
    else:
        np.testing.assert_array_equal(ours["bin_left"], np.asarray(theirs.index.left))
        np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    assert np.array_equal(np.isnan(ours["value"]), np.isnan(want))
    ok = np.isfinite(want)
    assert np.abs(ours["value"][ok] - want[ok]).max() <= 1e-4 * np.abs(want[ok]).mean()


def test_binning_large_numpy_input_takes_the_device_path(monkeypatch):
    """A numpy input at or above the pixel threshold is binned on the default device: equal
    to the tensor call, and different in dtype of work from the host path (float32)."""
    dh, ref = _rough(shape=(80, 90))
    monkeypatch.setattr(tv, "_DEVICE_BIN_THRESHOLD", dh.size)
    auto = tv.hypsometric_binning(dh, ref, bins=100.0)
    tens = tv.hypsometric_binning(torch.from_numpy(dh), torch.from_numpy(ref), bins=100.0)
    for c in ("value", "count", "bin_left", "bin_right"):
        np.testing.assert_array_equal(auto[c], tens[c])


def test_binning_device_against_host_recovers_signal():
    """The device bins of the ramp follow dh = -20 + 0.015 z on interior bins (0.1 m), and
    agree with the host's float64 bins to 5e-2 with counts within 2
    (tests/test_volume.py:228-242)."""
    ref, dh = _ramp()
    host = tv.hypsometric_binning(dh, ref, bins=50.0)
    dev = tv.hypsometric_binning(torch.from_numpy(dh), torch.from_numpy(ref), bins=50.0)
    assert np.abs(host["count"] - dev["count"]).max() <= 2
    np.testing.assert_allclose(dev["value"], host["value"], atol=5e-2, equal_nan=True)
    mids = 0.5 * (dev["bin_left"] + dev["bin_right"])
    inner = dev["count"] > 20
    inner[0] = inner[-1] = False
    np.testing.assert_allclose(dev["value"][inner], (-20 + 0.015 * mids)[inner], atol=0.1)


def test_binning_invalid_kind_raises():
    dh, ref = _rough(shape=(20, 20))
    for args in ((dh, ref), (torch.from_numpy(dh), torch.from_numpy(ref))):
        with pytest.raises(ValueError, match="Invalid bin kind"):
            tv.hypsometric_binning(*args, bins=10, kind="other")


def test_binning_reads_masked_arrays():
    """Masked slots are nodata, as in xdem_tpu: 1e-12."""
    dh, ref = _rough(shape=(60, 70), dtype=np.float64)
    mask = np.zeros(dh.shape, bool)
    mask[10:20, 10:30] = True
    ours = tv.hypsometric_binning(np.ma.masked_array(dh, mask), ref, bins=200.0)
    theirs = jv.hypsometric_binning(np.ma.masked_array(dh, mask), ref, bins=200.0)
    _assert_bins_equal(ours, theirs)


# ---------------------------------------------------------------------- regional signal


def _glaciers(shape, ids=(1, 2, 3, 4)):
    gid = np.zeros(shape, int)
    h, w = shape[0] // 2, shape[1] // 2
    for k, (i, j) in zip(ids, [(0, 0), (0, w), (h, 0), (h, w)]):
        gid[i + 5:i + h - 5, j + 5:j + w - 5] = k
    return gid


SIGNAL_COLUMNS = ("w_mean", "median", "std", "sigma-1-lower", "sigma-1-upper")


@pytest.mark.parametrize("ids", [(1, 2, 3, 4), (-3, 7, 5_000_000, 12)], ids=["dense", "negative-sparse"])
def test_regional_signal_host_path_equals_xdem_tpu(ids):
    """Host float64 loops on both sides: 1e-12, counts identical."""
    dh, ref = _rough(dtype=np.float64)
    gid = _glaciers(dh.shape, ids)
    ours = tv.get_regional_hypsometric_signal(dh, ref, gid)
    theirs = jv.get_regional_hypsometric_signal(dh, ref, gid)
    _assert_bins_equal(ours, theirs, columns=SIGNAL_COLUMNS)


@pytest.mark.parametrize("ids", [(1, 2, 3, 4), (-3, 7, 5_000_000, 12)], ids=["dense", "negative-sparse"])
def test_regional_signal_device_path_matches_xdem_tpu(ids):
    """Tensor against jnp array: counts identical, median 1e-5, std 1e-4 (absolute, on a
    normalized signal of order 1; tests/test_volume.py:254-258). The std's sums are float64
    here and float32 there."""
    dh, ref = _rough()
    gid = _glaciers(dh.shape, ids)
    ours = tv.get_regional_hypsometric_signal(torch.from_numpy(dh), torch.from_numpy(ref), torch.from_numpy(gid))
    theirs = jv.get_regional_hypsometric_signal(jnp.asarray(dh), jnp.asarray(ref), gid)
    np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    np.testing.assert_array_equal(ours["bin_left"], np.asarray(theirs.index.left))
    np.testing.assert_allclose(ours["median"], theirs["median"].values, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(ours["w_mean"], theirs["w_mean"].values, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(ours["std"], theirs["std"].values, atol=1e-4, equal_nan=True)
    host = tv.get_regional_hypsometric_signal(dh.astype(np.float64), ref.astype(np.float64), gid)
    np.testing.assert_array_equal(ours["count"], host["count"])
    np.testing.assert_allclose(ours["std"], host["std"], atol=1e-4, equal_nan=True)


def test_regional_signal_default_index_map_and_numpy_ids():
    """No index map means one glacier; a numpy id map beside tensors is moved to their
    device. Against xdem_tpu: counts identical, median 1e-5."""
    dh, ref = _rough(shape=(100, 120))
    ours = tv.get_regional_hypsometric_signal(torch.from_numpy(dh), torch.from_numpy(ref), n_bins=10)
    theirs = jv.get_regional_hypsometric_signal(jnp.asarray(dh), jnp.asarray(ref), n_bins=10)
    np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    np.testing.assert_allclose(ours["median"], theirs["median"].values, atol=1e-5, equal_nan=True)
    gid = _glaciers(dh.shape)
    a = tv.get_regional_hypsometric_signal(torch.from_numpy(dh), torch.from_numpy(ref), gid)
    b = tv.get_regional_hypsometric_signal(torch.from_numpy(dh), torch.from_numpy(ref), torch.from_numpy(gid))
    np.testing.assert_array_equal(a["median"], b["median"])


@pytest.mark.parametrize("device_path", [False, True])
def test_regional_signal_without_valid_glaciers_raises(device_path):
    dh, ref = _rough(shape=(40, 40))
    gid = np.zeros(dh.shape, int)
    args = (torch.from_numpy(dh), torch.from_numpy(ref), torch.from_numpy(gid)) if device_path else (dh, ref, gid)
    with pytest.raises(ValueError, match="No valid glaciers"):
        tv.get_regional_hypsometric_signal(*args)


# ---------------------------------------------------------------------- table functions


def _binned_pair(bins=50.0):
    ref, dh = _ramp()
    return ref, dh, tv.hypsometric_binning(dh, ref, bins=bins), jv.hypsometric_binning(dh, ref, bins=bins)


def _with_nans(ours, theirs, rows):
    ours = {k: v.copy() for k, v in ours.items()}
    theirs = theirs.copy()
    for r in rows:
        ours["value"][r] = np.nan
        theirs.loc[theirs.index[r], "value"] = np.nan
    return ours, theirs


@pytest.mark.parametrize("rows", [(3,), (0, 1, 5), (4, 5, 6, -1), (0, 3, -2, -1)],
                         ids=["inner", "leading", "run-and-trailing", "both-ends"])
@pytest.mark.parametrize("as_frame", [False, True], ids=["dict", "frame"])
def test_interpolate_bins_matches_pandas(rows, as_frame):
    """NaN bins inside the valid range take the cubic through the valid mid-points; NaN
    bins outside it stay NaN, as pandas' Series.interpolate(method="polynomial", order=3)
    leaves them. 1e-9 relative (scipy interp1d on both sides)."""
    _, _, ours, theirs = _binned_pair()
    ours, theirs = _with_nans(ours, theirs, rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jv.interpolate_hypsometric_bins(theirs)
    got = tv.interpolate_hypsometric_bins(theirs if as_frame else ours)
    _assert_bins_equal(got, want, value_tol=1e-9)
    if rows == (3,):
        assert np.isfinite(got["value"]).all()


@pytest.mark.parametrize("threshold", [50, 400])
def test_interpolate_bins_count_threshold(threshold):
    """Under-populated bins are left out of the curve and keep the value they came with
    (NaN when they came with NaN): 1e-9."""
    _, _, ours, theirs = _binned_pair()
    ours, theirs = _with_nans(ours, theirs, (2, 6))
    ours["count"][[6, 8]] = 3
    theirs.loc[theirs.index[[6, 8]], "count"] = 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jv.interpolate_hypsometric_bins(theirs, count_threshold=threshold)
    got = tv.interpolate_hypsometric_bins(ours, count_threshold=threshold)
    _assert_bins_equal(got, want, value_tol=1e-9)


def test_interpolate_bins_too_few_valid_returns_copy():
    _, _, ours, theirs = _binned_pair(bins=200.0)
    ours, theirs = _with_nans(ours, theirs, (0, 1))
    with pytest.warns(UserWarning, match="Not enough valid bins"):
        want = jv.interpolate_hypsometric_bins(theirs)
    with pytest.warns(UserWarning, match="Not enough valid bins"):
        got = tv.interpolate_hypsometric_bins(ours)
    _assert_bins_equal(got, want)
    assert got["value"] is not ours["value"]


@pytest.mark.parametrize("method,order", [("linear", 1), ("spline", 2), ("polynomial", 1)])
def test_interpolate_bins_other_methods(method, order):
    """The other interp1d kinds that pandas forwards: 1e-9."""
    _, _, ours, theirs = _binned_pair()
    ours, theirs = _with_nans(ours, theirs, (3, 7))
    want = jv.interpolate_hypsometric_bins(theirs, method=method, order=order)
    got = tv.interpolate_hypsometric_bins(ours, method=method, order=order)
    _assert_bins_equal(got, want, value_tol=1e-9)


@pytest.mark.parametrize("as_frame", [False, True], ids=["dict", "frame"])
@pytest.mark.parametrize("degree,iterations,threshold", [(1, 1, None), (3, 5, None), (2, 3, 400)])
def test_fit_poly_matches_xdem_tpu(as_frame, degree, iterations, threshold):
    """numpy polyfit on both sides: 1e-10 relative; the linear fit recovers the ramp's law."""
    _, _, ours, theirs = _binned_pair()
    ours, theirs = _with_nans(ours, theirs, (4,))
    want = jv.fit_hypsometric_bins_poly(theirs, degree=degree, iterations=iterations, count_threshold=threshold)
    got = tv.fit_hypsometric_bins_poly(theirs if as_frame else ours, degree=degree, iterations=iterations,
                                       count_threshold=threshold)
    _assert_bins_equal(got, want, value_tol=1e-10)
    if degree == 1:
        mids = 0.5 * (got["bin_left"] + got["bin_right"])
        np.testing.assert_allclose(got["value"][1:-1], (-20 + 0.015 * mids)[1:-1], atol=0.2)


def test_fit_poly_without_enough_bins_raises():
    _, _, ours, _ = _binned_pair(bins=400.0)
    with pytest.raises(ValueError, match="Not enough valid bins"):
        tv.fit_hypsometric_bins_poly(ours, degree=6)


@pytest.mark.parametrize("timeframe", ["reference", "nonreference", "mean"])
@pytest.mark.parametrize("source", ["dict", "frame", "series"])
def test_area_matches_xdem_tpu(timeframe, source):
    """Histogram counts times the pixel area: equal; the reference timeframe's areas sum to
    the raster's area."""
    ref, _, ours, theirs = _binned_pair(bins=100.0)
    want = jv.calculate_hypsometry_area(theirs, ref, pixel_size=20.0, timeframe=timeframe)
    bins_in = {"dict": ours, "frame": theirs, "series": theirs["value"]}[source]
    got = tv.calculate_hypsometry_area(bins_in, torch.from_numpy(ref) if source == "dict" else ref,
                                       pixel_size=20.0, timeframe=timeframe)
    np.testing.assert_array_equal(got["area"], want.values)
    np.testing.assert_array_equal(got["bin_left"], np.asarray(want.index.left))
    if timeframe == "reference":
        assert got["area"].sum() == pytest.approx(ref.size * 400.0, rel=1e-6)
    rect = tv.calculate_hypsometry_area(ours, ref, pixel_size=(20.0, 10.0), timeframe=timeframe)
    np.testing.assert_array_equal(rect["area"] * 2, got["area"])


def test_area_rejects_bad_input():
    ref, _, ours, _ = _binned_pair(bins=100.0)
    with pytest.raises(ValueError, match="timeframe"):
        tv.calculate_hypsometry_area(ours, ref, 20.0, timeframe="later")
    bad = ref.copy()
    bad[0, 0] = np.nan
    with pytest.raises(AssertionError, match="NaNs"):
        tv.calculate_hypsometry_area(ours, bad, 20.0)
    holes, _ = _with_nans(ours, pd.DataFrame({"value": ours["value"]}), (2,))
    with pytest.raises(AssertionError, match="cannot contain NaNs"):
        tv.calculate_hypsometry_area(holes, ref, 20.0, timeframe="mean")


# ---------------------------------------------------------------------- gap filling


@pytest.mark.parametrize("kwargs", [{}, {"extrapolate": True}, {"max_search_distance": 3},
                                    {"max_search_distance": 3, "force_fill": True}])
def test_idw_matches_xdem_tpu(kwargs):
    """scipy.ndimage on both sides: equal to the bit, dtype kept; tensors are accepted."""
    rng = np.random.default_rng(2)
    arr = rng.normal(10, 1, (50, 50)).astype(np.float32)
    arr[20:25, 20:25] = np.nan
    arr[5:30, 35:48] = np.nan
    arr[:3] = np.nan
    want = jv.idw_interpolation(arr, **kwargs)
    got = tv.idw_interpolation(arr, **kwargs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tv.idw_interpolation(torch.from_numpy(arr), **kwargs), want)
    assert np.isfinite(got[22, 22]) and abs(got[22, 22] - 10) < 3


def test_idw_force_fill_uses_the_valid_median():
    arr = np.full((40, 40), 5.0)
    arr[10:30, 10:30] = np.nan
    assert np.isnan(tv.idw_interpolation(arr, max_search_distance=3)).any()
    out = tv.idw_interpolation(arr, max_search_distance=3, force_fill=True)
    assert np.isfinite(out).all() and out[20, 20] == pytest.approx(5.0)


def _assert_masked_equal(got, want, tol=1e-9):
    assert isinstance(got, np.ma.MaskedArray)
    np.testing.assert_array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
    np.testing.assert_allclose(got.filled(0.0), want.filled(0.0), rtol=tol, atol=tol)


@pytest.mark.parametrize("count_threshold", [1, 30, None])
def test_hypsometric_interpolation_matches_xdem_tpu(count_threshold):
    """Masked arrays with the same mask and values within 1e-9; the filled void follows the
    ramp's law to 0.3 m."""
    ref, dh = _ramp()
    mask = np.ones(ref.shape, bool)
    mask[:, :5] = False
    voided = dh.copy()
    voided[40:60, 40:80] = np.nan
    want = jv.hypsometric_interpolation(voided, ref, mask, count_threshold=count_threshold)
    got = tv.hypsometric_interpolation(voided, ref, mask, count_threshold=count_threshold)
    _assert_masked_equal(got, want)
    assert got.filled(np.nan)[50, 60] == pytest.approx(-20 + 0.015 * ref[50, 60], abs=0.3)
    from_tensors = tv.hypsometric_interpolation(torch.from_numpy(voided), torch.from_numpy(ref),
                                                torch.from_numpy(mask), count_threshold=count_threshold)
    _assert_masked_equal(from_tensors, want)


def test_local_hypsometric_interpolation_matches_xdem_tpu():
    """Two features, one void, one feature below min_coverage: 1e-9, fill value kept."""
    ref, dh = _ramp()
    mask = np.zeros(ref.shape, bool)
    mask[10:60, 10:70] = True
    mask[70:110, 80:140] = True
    mask[112:118, 5:40] = True
    voided = np.where(mask, dh, np.nan)
    voided[30:40, 30:50] = np.nan
    voided[112:118, 5:38] = np.nan
    want = jv.local_hypsometric_interpolation(voided, ref, mask, nodata=-42.0)
    got = tv.local_hypsometric_interpolation(voided, ref, mask, nodata=-42.0)
    _assert_masked_equal(got, want)
    assert got.fill_value == -42.0
    assert np.isfinite(got.filled(np.nan)[35, 40])
    assert np.isnan(got.filled(np.nan)[115, 10])


@pytest.mark.parametrize("signal_from", ["none", "dict", "frame"])
@pytest.mark.parametrize("idealized", [False, True])
def test_norm_regional_interpolation_matches_xdem_tpu(signal_from, idealized):
    """The regional signal as None, the port's dict or xdem_tpu's frame: 1e-9."""
    ref, dh = _ramp()
    gid = np.zeros(ref.shape, int)
    gid[10:60, 10:70] = 1
    gid[70:110, 80:140] = 2
    voided = np.where(gid > 0, dh, np.nan)
    voided[20:30, 20:40] = np.nan
    frame = jv.get_regional_hypsometric_signal(dh, ref, gid)
    signal = {"none": None, "dict": tv.get_regional_hypsometric_signal(dh, ref, gid), "frame": frame}[signal_from]
    want = jv.norm_regional_hypsometric_interpolation(
        voided, ref, gid, regional_signal=None if signal_from == "none" else frame, idealized_ddem=idealized)
    got = tv.norm_regional_hypsometric_interpolation(voided, ref, gid, regional_signal=signal,
                                                     idealized_ddem=idealized)
    _assert_masked_equal(got, want)
    assert np.isfinite(got.filled(np.nan)[gid > 0]).mean() > 0.9


def test_norm_regional_min_elevation_range():
    """A glacier whose valid pixels touch too few bins is skipped (tests/test_volume.py:387)."""
    rng = np.random.default_rng(5)
    ref = np.tile(np.linspace(100.0, 1100.0, 100), (100, 1))
    idx = np.zeros((100, 100), int)
    idx[10:90, 10:90] = 1
    ddem = rng.normal(-2.0, 0.1, (100, 100))
    voided = ddem.copy()
    voided[:, 18:] = np.nan
    signal = tv.get_regional_hypsometric_signal(ddem, ref, idx)
    for rng_min, skipped in ((0.5, True), (0.05, False)):
        out = tv.norm_regional_hypsometric_interpolation(voided, ref, idx, min_coverage=0.0,
                                                         regional_signal=signal, min_elevation_range=rng_min)
        want = jv.norm_regional_hypsometric_interpolation(
            voided, ref, idx, min_coverage=0.0, regional_signal=jv.get_regional_hypsometric_signal(ddem, ref, idx),
            min_elevation_range=rng_min)
        assert bool(out.mask[50, 50]) is skipped
        _assert_masked_equal(out, want)


def test_volume_change_from_tables():
    """Sum of value x area over the bins: the port's tables give xdem_tpu's volume to 1e-12."""
    ref, dh, ours, theirs = _binned_pair(bins=100.0)
    ours_v = float(np.nansum(tv.interpolate_hypsometric_bins(ours)["value"]
                             * tv.calculate_hypsometry_area(ours, ref, 20.0)["area"]))
    theirs_v = float((jv.interpolate_hypsometric_bins(theirs)["value"]
                      * jv.calculate_hypsometry_area(theirs, ref, 20.0)).sum())
    assert ours_v == pytest.approx(theirs_v, rel=1e-12)
    assert ours_v == pytest.approx(float(np.sum(dh)) * 400.0, rel=2e-2)
