"""xdem_tpu_torch.spatialstats against xdem_tpu.spatialstats on the same seeded inputs.

Where xdem_tpu draws with jax.random (the heteroscedasticity subsample, the device ring
draw), its draw is injected into the port, so the comparison is of the statistics, not of
the generators. Tolerances are stated per test: host numpy code is held to 1e-12 or
equality, float32 device code to 1e-6 relative, pair sums (summed in another order) to
1e-5, n_eff to 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from scipy import ndimage

import xdem_tpu.spatialstats as jss
import xdem_tpu_torch.spatialstats as tss
from xdem_tpu.ops import reductions as jred
from xdem_tpu_torch.ops import reductions as tred
from xdem_tpu_torch.parallel import make_mesh

MODELS = ("spherical", "gaussian", "exponential", "cubic", "stable", "matern")


def _field(shape=(150, 150), smooth_px=3.0, sigma=2.0, seed=5, holes=True):
    """Gaussian-smoothed white noise (known Gaussian covariance), optionally with NaN holes."""
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.normal(size=shape), smooth_px)
    f = f / f.std() * sigma
    if holes:
        f[20:35, 40:70] = np.nan
        f[:, -3:] = np.nan
    return f.astype(np.float32)


def _jax_draw(seed, arr, *args):
    """xdem_tpu's device ring draw, as the port's `_draw_rings_from_arr` returns it."""
    ija, ijb = jss._draw_rings_from_arr(np.uint32(seed), jnp.asarray(arr.cpu().numpy()), *args)
    return torch.from_numpy(np.array(ija)).long(), torch.from_numpy(np.array(ijb)).long()


# ---------------------------------------------------------------------- reductions


def test_nanstd_and_masked_nmad_match_xdem_tpu():
    """Tolerance 1e-6 relative (float32 reductions in another order)."""
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, size=(40, 50)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    valid = rng.random(x.shape) < 0.7
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(tred.nanstd(xt)), float(jred.nanstd(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(tred.nanstd(xt, 0).numpy(), np.asarray(jred.nanstd(jnp.asarray(x), 0)), rtol=1e-6)
    np.testing.assert_allclose(float(tred.masked_nmad(xt, torch.from_numpy(valid))),
                               float(jred.masked_nmad(jnp.asarray(x), jnp.asarray(valid))), rtol=1e-6)


# ---------------------------------------------------------------------- variogram models


@pytest.mark.parametrize("model", MODELS)
def test_model_gamma_matches_xdem_tpu(model):
    """numpy forms to 1e-12; the torch form (float64) to 1e-12 for the non-Bessel models."""
    h = np.concatenate([[0.0], np.geomspace(0.1, 5e4, 200)])
    want = jss._model_gamma(h, model, 1500.0, 2.5, 1.5)
    np.testing.assert_allclose(tss._model_gamma(h, model, 1500.0, 2.5, 1.5), want, rtol=1e-12, atol=1e-12)
    if model != "matern":
        got = tss._model_gamma(torch.from_numpy(h), model, 1500.0, 2.5, 1.5, xp=torch).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_model_name_normalization():
    for name in ("Sph", "spherical", "GAU", "Exponential", "cub", "sta", "Mat"):
        assert tss._get_variogram_model_name(name) == jss._get_variogram_model_name(name)
    with pytest.raises(ValueError, match="not recognized"):
        tss._get_variogram_model_name("linear")


@pytest.mark.parametrize("as_frame", [False, True])
def test_variogram_functions_accept_tables_and_frames(as_frame):
    """get_variogram_model_func / covariance / correlation to 1e-12; a pandas frame made for
    xdem_tpu is read through its columns."""
    params = {"model": np.array(["gaussian", "spherical"]), "range": np.array([300.0, 4000.0]),
              "psill": np.array([0.7, 0.3])}
    frame = pd.DataFrame(params)
    ours = frame if as_frame else params
    h = np.linspace(0.0, 1e4, 101)
    for name in ("get_variogram_model_func", "covariance_from_variogram", "correlation_from_variogram"):
        np.testing.assert_allclose(getattr(tss, name)(ours)(h), getattr(jss, name)(frame)(h), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad,match", [
    ({"model": ["gaussian"], "range": [1.0]}, "must contain"),
    ({"model": ["gaussian"], "range": [-1.0], "psill": [1.0]}, "non-negative"),
    ({"model": ["linear"], "range": [1.0], "psill": [1.0]}, "not recognized"),
])
def test_invalid_variogram_parameters_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        tss.correlation_from_variogram(bad)


# ---------------------------------------------------------------------- binning


def _binning_inputs(n=6000, seed=1):
    rng = np.random.default_rng(seed)
    slope = rng.uniform(0, 60, n)
    curv = rng.normal(0, 2, n)
    vals = rng.normal(0, 1, n) * (1 + slope / 20)
    vals[rng.random(n) < 0.05] = np.nan
    curv[rng.random(n) < 0.02] = np.nan
    return vals, slope, curv


@pytest.mark.parametrize("nvars", [1, 2, 3])
def test_nd_binning_matches_xdem_tpu(nvars):
    """Host numpy on both sides: counts identical, statistics and edges equal."""
    vals, slope, curv = _binning_inputs()
    var = [slope, curv, slope * 0.5 + curv][:nvars]
    names = ["slope", "curv", "mix"][:nvars]
    ours = tss.nd_binning(vals, var, names, list_var_bins=6)
    theirs = jss.nd_binning(vals, var, names, list_var_bins=6)
    assert len(ours["count"]) == len(theirs)
    np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    np.testing.assert_array_equal(ours["nd"], theirs["nd"].values)
    for stat in ("nanmedian", "nmad"):
        np.testing.assert_array_equal(ours[stat], theirs[stat].values.astype(np.float64))
    for n in names:
        has = theirs[n].notna().values
        iv = pd.IntervalIndex(theirs[n][has])
        np.testing.assert_array_equal(ours[f"{n}_left"][has], iv.left.values)
        np.testing.assert_array_equal(ours[f"{n}_right"][has], iv.right.values)
        assert np.isnan(ours[f"{n}_left"][~has]).all()


@pytest.mark.parametrize("method,min_count", [("linear", 100), ("nearest", 100), ("linear", None)])
def test_interp_nd_binning_matches_xdem_tpu(method, min_count):
    """Same grid, in-fill and extrapolation: values equal to 1e-12 inside, outside and at NaN."""
    vals, slope, curv = _binning_inputs()
    names = ["slope", "curv"]
    ours = tss.interp_nd_binning(tss.nd_binning(vals, [slope, curv], names), names, "nmad",
                                 interpolate_method=method, min_count=min_count)
    theirs = jss.interp_nd_binning(jss.nd_binning(vals, [slope, curv], names), names, "nmad",
                                   interpolate_method=method, min_count=min_count)
    for a, b in zip(ours.mids_ext, theirs.mids_ext):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.grid_ext, theirs.grid_ext)
    xs = np.array([-10.0, 0.0, 15.5, 33.0, 59.0, 90.0, np.nan])
    ys = np.array([-9.0, -2.0, 0.1, 1.7, 5.0, 0.0, 1.0])
    np.testing.assert_allclose(ours(xs, ys), theirs(xs, ys), rtol=1e-12, equal_nan=True)


def test_interp_nd_binning_numeric_mid_columns():
    """The doctest form: numeric mid-value columns, as a dict."""
    fun = tss.interp_nd_binning({"var1": [1, 2, 3, 1, 2, 3, 1, 2, 3], "var2": [1, 1, 1, 2, 2, 2, 3, 3, 3],
                                 "statistic": [1, 2, 3, 4, 5, 6, 7, 8, 9]},
                                list_var_names=["var1", "var2"], statistic="statistic", min_count=None)
    assert (float(fun((2, 2))), float(fun((1.5, 1.5))), float(fun((-1, 1)))) == (5.0, 3.0, 1.0)
    with pytest.raises(ValueError, match="does not exist"):
        tss.interp_nd_binning({"var1": [1.0], "statistic": [1.0]}, ["var9"], "statistic", min_count=None)


def test_get_perbin_nd_binning_matches_xdem_tpu():
    vals, slope, curv = _binning_inputs()
    names = ["slope", "curv"]
    ours = tss.get_perbin_nd_binning(tss.nd_binning(vals, [slope, curv], names), [slope, curv], names,
                                     min_count=30)
    theirs = jss.get_perbin_nd_binning(jss.nd_binning(vals, [slope, curv], names), [slope, curv], names,
                                       min_count=30)
    np.testing.assert_array_equal(ours, theirs)


def test_interp_grid_device_matches_xdem_tpu():
    """NaN coordinates, out-of-hull and in-grid points: 1e-6 relative."""
    vals, slope, curv = _binning_inputs()
    fun = tss.interp_nd_binning(tss.nd_binning(vals, [slope, curv], ["s", "c"]), ["s", "c"], "nmad")
    rng = np.random.default_rng(3)
    x = rng.uniform(-20, 80, (37, 41)).astype(np.float32)
    y = rng.uniform(-8, 8, (37, 41)).astype(np.float32)
    x[0, :5] = np.nan
    y[1, :3] = np.nan
    got = tss._interp_grid_device(fun.mids_ext, fun.grid_ext, [torch.from_numpy(x), torch.from_numpy(y)]).numpy()
    want = np.asarray(jss._interp_grid_device(tuple(np.asarray(m, np.float32) for m in fun.mids_ext),
                                              np.asarray(fun.grid_ext, np.float32), [jnp.asarray(x), jnp.asarray(y)]))
    torch_port_helpers.assert_same_nan(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, fun(x, y), rtol=1e-5, equal_nan=True)  # the host interpolator


# ---------------------------------------------------------------------- heteroscedasticity


@pytest.fixture(scope="module")
def jax_gathered():
    """A stable sample gathered by xdem_tpu's own device prepare (count < valid pixels)."""
    rng = np.random.default_rng(4)
    shape = (120, 130)
    slope = np.abs(rng.normal(20, 10, shape)).astype(np.float32)
    curv = rng.normal(0, 1, shape).astype(np.float32)
    dh = (rng.normal(0, 1, shape) * (0.5 + slope / 30)).astype(np.float32)
    dh[rng.random(shape) < 0.05] = np.nan
    curv[:3] = np.nan
    inc = rng.random(shape) < 0.8
    g = jss._hetero_prepare_device(jnp.asarray(dh), (jnp.asarray(slope), jnp.asarray(curv)), jnp.asarray(inc),
                                   jnp.zeros((1, 1), bool), np.uint32(7), 9000, True, False)
    return np.array(g), (slope, curv)


def test_hetero_bin_tables_match_xdem_tpu(jax_gathered):
    """On xdem_tpu's gathered sample: counts identical, medians and NMADs to 1e-6 relative."""
    g, _ = jax_gathered
    n_bins = 10
    packed = np.asarray(jss._hetero_bin_tables_device(jnp.asarray(g), n_bins), np.float32)
    tables, gmin, gmax = tss._hetero_bin_tables_device(torch.from_numpy(g), n_bins)
    np.testing.assert_array_equal(np.r_[gmin.numpy(), gmax.numpy()], packed[-4:])
    off = 0
    for counts, med, spread in tables:
        tot = counts.numel()
        np.testing.assert_array_equal(counts.numpy(), packed[off:off + tot].view(np.int32))
        np.testing.assert_allclose(med.numpy(), packed[off + tot:off + 2 * tot], rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(spread.numpy(), packed[off + 2 * tot:off + 3 * tot], rtol=1e-6, equal_nan=True)
        off += 3 * tot
    assert off == len(packed) - 4


def test_hetero_scale_and_sigma_match_xdem_tpu(jax_gathered):
    """Scale to 1e-6 relative, the sigma raster to 1e-6 relative, identical NaN masks."""
    g, (slope, curv) = jax_gathered
    tables, gmin, gmax = tss._hetero_bin_tables_device(torch.from_numpy(g), 10)
    df = tss._table_from_device_bins(tables, gmin, gmax, 10, ["slope", "curv"], "nmad")
    fun = tss.interp_nd_binning(df, ["slope", "curv"], "nmad", min_count=100)
    scale, sig = tss._scale_and_sigma_device(torch.from_numpy(g), fun.mids_ext, fun.grid_ext, 7.0,
                                             [torch.from_numpy(slope), torch.from_numpy(curv)])
    mids = tuple(np.asarray(m, np.float32) for m in fun.mids_ext)
    jscale, jsig = jss._scale_and_sigma_device(jnp.asarray(g), mids, np.asarray(fun.grid_ext, np.float32),
                                               np.float32(7.0), (jnp.asarray(slope), jnp.asarray(curv)))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    torch_port_helpers.assert_same_nan(sig, np.asarray(jsig))
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=1e-6, equal_nan=True)


def test_hetero_table_matches_xdem_tpu_frame():
    """The table of the device path equals the frame xdem_tpu builds from the same sample
    (counts identical, edges and statistics to 1e-6), with every valid pixel sampled."""
    rng = np.random.default_rng(8)
    shape = (90, 100)
    slope = np.abs(rng.normal(20, 10, shape)).astype(np.float32)
    curv = rng.normal(0, 1, shape).astype(np.float32)
    dh = (rng.normal(0, 1, shape) * (0.5 + slope / 30)).astype(np.float32)
    mask = rng.random(shape) < 0.9
    from xdem_tpu.georef import Affine as JAffine
    from xdem_tpu.raster import Raster

    t = JAffine.from_origin(0, 0, 20, 20)
    _, jdf, jfun = jss.infer_heteroscedasticity_from_stable(
        Raster(dh, t, 32633), [jnp.asarray(slope), jnp.asarray(curv)], stable_mask=mask,
        list_var_names=["slope", "curv"], subsample=10**6, random_state=3)
    sig, df, fun = tss.infer_heteroscedasticity_from_stable(
        torch.from_numpy(dh), [torch.from_numpy(slope), torch.from_numpy(curv)], stable_mask=mask,
        list_var_names=["slope", "curv"], subsample=10**6, random_state=3)
    np.testing.assert_array_equal(df["count"], jdf["count"].values)
    for col in ("nanmedian", "nmad"):
        np.testing.assert_allclose(df[col], jdf[col].values, rtol=1e-6, equal_nan=True)
    iv = pd.IntervalIndex(jdf["slope"][jdf["slope"].notna()])
    np.testing.assert_allclose(df["slope_left"][jdf["slope"].notna().values], iv.left.values, rtol=1e-12)
    np.testing.assert_allclose(fun.scale, jfun.scale, rtol=1e-6)
    assert sig.shape == shape and sig.dtype == torch.float32


def test_hetero_custom_statistic_runs_on_the_host_sample():
    """A custom spread statistic bins the gathered sample on the host: same as xdem_tpu's
    host estimate on that sample (1e-12), sigma still a tensor."""
    rng = np.random.default_rng(9)
    slope = torch.from_numpy(np.abs(rng.normal(20, 10, (60, 70))).astype(np.float32))
    dh = torch.from_numpy(rng.normal(0, 1, (60, 70)).astype(np.float32))

    def iqr(x):
        return float(np.subtract(*np.nanpercentile(x, [75, 25])))

    sig, df, fun = tss.infer_heteroscedasticity_from_stable(dh, [slope], spread_statistic=iqr, subsample=10**6,
                                                            random_state=0, min_count=10)
    assert "iqr" in df and isinstance(sig, torch.Tensor)
    _, jfun = jss._estimate_model_heteroscedasticity(dh.numpy().astype(np.float64).ravel(),
                                                     [slope.numpy().astype(np.float64).ravel()], ["var1"],
                                                     spread_statistic=iqr, min_count=10)
    np.testing.assert_allclose(fun.scale, jfun.scale, rtol=1e-12)


def test_hetero_host_path_matches_xdem_tpu():
    """numpy inputs take the host path on both sides (numpy draw): equal to 1e-12."""
    rng = np.random.default_rng(10)
    slope = np.abs(rng.normal(20, 10, (50, 60)))
    dh = rng.normal(0, 1, (50, 60)) * (0.5 + slope / 30)
    mask = rng.random((50, 60)) < 0.8
    err, df, _ = tss.infer_heteroscedasticity_from_stable(dh, [slope], stable_mask=mask, subsample=2000,
                                                          random_state=5, min_count=10)
    jerr, jdf, _ = jss.infer_heteroscedasticity_from_stable(dh, [slope], stable_mask=mask, subsample=2000,
                                                            random_state=5, min_count=10)
    np.testing.assert_array_equal(df["count"], jdf["count"].values)
    np.testing.assert_allclose(err, jerr, rtol=1e-12)


# ---------------------------------------------------------------------- variogram


@pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd"])
@pytest.mark.parametrize("route", ["flat", "chunked"])
def test_grid_variogram_on_xdem_tpu_draw(monkeypatch, estimator, route):
    """The device grid mode on xdem_tpu's ring draw: counts identical, gamma to 1e-5
    relative, in the one-pass and in the chunked route. Cressie raises a mean to the fourth
    power, so xdem_tpu's float32 sums (~3e-6 off at 3e4 terms per bin) put its gamma ~1e-5
    from the exact value: Cressie is held to 5e-5 here and to 1e-9 of an exact float64
    evaluation in test_pair_estimators_are_exact."""
    field = _field()
    if route == "chunked":
        monkeypatch.setattr(jss, "_PAIR_CHUNK_BUDGET", 5_000)
        monkeypatch.setattr(tss, "_PAIR_CHUNK_BUDGET", 5_000)
    monkeypatch.setattr(tss, "_draw_rings_from_arr", _jax_draw)
    kw = dict(gsd=10.0, subsample=700, random_state=42, estimator=estimator)
    ours = tss.sample_empirical_variogram(torch.from_numpy(field), **kw)
    theirs = jss.sample_empirical_variogram(jnp.asarray(field), **kw)
    np.testing.assert_array_equal(ours["lags"], theirs["lags"].values)
    np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    assert ours["count"].sum() > 10_000
    rtol = 5e-5 if estimator == "cressie" else 1e-5
    np.testing.assert_allclose(ours["exp"], theirs["exp"].values, rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd"])
def test_pair_estimators_are_exact(estimator):
    """_binned_pair_core against a float64 numpy evaluation of the same float32 pairs:
    counts identical, gamma to 1e-9 relative (Dowd: 1e-6, its median is of float32 values)."""
    rng = np.random.default_rng(6)
    diffs = torch.from_numpy(rng.normal(0, 2, 200_000).astype(np.float32))
    dists = torch.from_numpy(rng.uniform(0, 1000, 200_000).astype(np.float32))
    diffs[::97] = torch.nan
    edges = np.array([0.0, 10.0, 50.0, 200.0, 700.0, 900.0], dtype=np.float32)
    gamma, counts = tss._binned_pair_core(diffs, dists, torch.from_numpy(edges), estimator, 5)
    d, h = np.abs(diffs.numpy().astype(np.float64)), dists.numpy()
    ok = np.isfinite(d) & (h <= edges[-1])
    b = np.clip(np.searchsorted(edges, h, side="right") - 1, 0, 4)
    for k in range(5):
        x = d[ok & (b == k)]
        assert counts[k] == len(x)
        n = len(x)
        want = {"matheron": np.sum(x**2) / (2 * n),
                "cressie": np.mean(np.sqrt(x)) ** 4 / (0.457 + 0.494 / n + 0.045 / n**2) / 2,
                "dowd": 2.198 * np.median(x) ** 2 / 2}[estimator]
        np.testing.assert_allclose(float(gamma[k]), want, rtol=1e-6 if estimator == "dowd" else 1e-9)


@pytest.mark.parametrize("estimator", ["matheron", "dowd"])
def test_flat_and_chunked_routes_agree(monkeypatch, estimator):
    """The port's own draw: identical counts, gamma to 1e-4 between the two routes."""
    field = torch.from_numpy(_field())
    kw = dict(gsd=10.0, subsample=700, random_state=1, estimator=estimator)
    flat = tss.sample_empirical_variogram(field, **kw)
    monkeypatch.setattr(tss, "_PAIR_CHUNK_BUDGET", 5_000)
    chunked = tss.sample_empirical_variogram(field, **kw)
    np.testing.assert_array_equal(chunked["count"], flat["count"])
    np.testing.assert_allclose(chunked["exp"], flat["exp"], rtol=1e-4, equal_nan=True)


@pytest.mark.parametrize("mode", ["grid", "coords"])
@pytest.mark.parametrize("chunked", [False, True])
def test_host_modes_match_xdem_tpu(monkeypatch, mode, chunked):
    """numpy grid and explicit-coordinate modes draw with numpy as xdem_tpu does: counts
    identical, gamma to 1e-5 relative, n_variograms=2 averaged the same way."""
    field = _field(shape=(80, 90)).astype(np.float64)
    if chunked:
        monkeypatch.setattr(jss, "_PAIR_CHUNK_BUDGET", 5_000)
        monkeypatch.setattr(tss, "_PAIR_CHUNK_BUDGET", 5_000)
    if mode == "grid":
        kw = dict(values=field, gsd=10.0)
    else:
        x, y = np.meshgrid(np.arange(80) * 10.0, np.arange(90) * 10.0, indexing="ij")
        kw = dict(values=field.ravel(), coords=np.column_stack([x.ravel(), y.ravel()]))
    common = dict(subsample=300, random_state=3, n_variograms=2, estimator="matheron")
    ours = tss.sample_empirical_variogram(**kw, **common)
    theirs = jss.sample_empirical_variogram(**kw, **common)
    np.testing.assert_array_equal(ours["count"], theirs["count"].values)
    np.testing.assert_allclose(ours["exp"], theirs["exp"].values, rtol=1e-5, equal_nan=True)
    # err_exp is the spread of two gammas: held to 1e-5 of the largest gamma.
    np.testing.assert_allclose(ours["err_exp"], theirs["err_exp"].values, rtol=0,
                               atol=1e-5 * np.nanmax(theirs["exp"].values), equal_nan=True)


def test_own_ring_draw_properties():
    """The port's device draw: indices on valid pixels or -1, the centre disk first in ijb,
    the annuli growing by sqrt(2)."""
    field = torch.from_numpy(_field())
    valid = torch.isfinite(field)
    ija, ijb = tss._draw_rings_from_arr(11, field, 20, 30, 10, 150, 150, 2.5, 240)
    assert ija.shape == (20, 30, 2) and ijb.shape == (20, 330, 2)
    assert torch.equal(ijb[:, :30], ija)
    ok = ijb[..., 0] >= 0
    assert ok.float().mean() > 0.5
    assert bool(valid[ijb[..., 0][ok], ijb[..., 1][ok]].all())
    assert bool(((ijb[..., 0] >= 0) == (ijb[..., 1] >= 0)).all())
    ija2, _ = tss._draw_rings_from_arr(11, field, 20, 30, 10, 150, 150, 2.5, 240)
    assert torch.equal(ija, ija2)


def test_fit_sum_model_variogram_matches_xdem_tpu():
    """On xdem_tpu's empirical variogram (a frame), parameters to 1e-6 relative."""
    emp = jss.sample_empirical_variogram(_field(holes=False).astype(np.float64), gsd=10.0, subsample=700,
                                         random_state=42, n_variograms=3)
    _, jparams = jss.fit_sum_model_variogram(["gaussian", "spherical"], emp)
    fun, params = tss.fit_sum_model_variogram(["Gau", "sph"], emp)
    assert list(params["model"]) == list(jparams["model"])
    np.testing.assert_allclose(params["range"], jparams["range"].values, rtol=1e-6)
    np.testing.assert_allclose(params["psill"], jparams["psill"].values, rtol=1e-6)
    np.testing.assert_allclose(fun(emp["lags"].values), jss.get_variogram_model_func(jparams)(emp["lags"].values),
                               rtol=1e-6)


# ---------------------------------------------------------------------- n_eff


PARAMS = {"model": np.array(["gaussian", "spherical"]), "range": np.array([120.0, 900.0]),
          "psill": np.array([0.6, 0.4])}


def _coords_errors(n=1500, seed=2):
    rng = np.random.default_rng(seed)
    coords = np.column_stack([4e5 + rng.uniform(0, 3000, n), 8.6e6 + rng.uniform(0, 3000, n)])
    return coords, rng.uniform(0.5, 2.0, n)


@pytest.mark.parametrize("models", [("gaussian", "spherical"), ("exponential", "cubic"), ("matern",)])
def test_neff_exact_and_hugonnet_match_xdem_tpu(models):
    """n_eff at UTM-magnitude coordinates to 1e-4 relative (float32 sums in another order)."""
    params = {"model": np.array(models), "range": np.array([150.0, 800.0][:len(models)]),
              "psill": np.array([0.7, 0.3][:len(models)])}
    frame = pd.DataFrame(params)
    coords, errors = _coords_errors(n=600 if models == ("matern",) else 1500)
    np.testing.assert_allclose(tss.neff_exact(coords, errors, params), jss.neff_exact(coords, errors, frame),
                               rtol=1e-4)
    np.testing.assert_allclose(tss.neff_hugonnet_approx(coords, errors, params, subsample=300, random_state=4),
                               jss.neff_hugonnet_approx(coords, errors, frame, subsample=300, random_state=4),
                               rtol=1e-4)


def test_chunked_rho_sum_is_chunk_invariant():
    """Many small chunks (Kahan-summed) against one: 1e-5 relative."""
    coords, errors = _coords_errors(n=700)
    c = tss._centred_f32(coords)
    e = errors.astype(np.float32)
    one = tss._chunked_weighted_rho_sum(c, e, c, e, PARAMS)
    many = tss._chunked_weighted_rho_sum(c, e, c, e, PARAMS, target_elems=64 * 700)
    np.testing.assert_allclose(many, one, rtol=1e-5)


def test_circular_neff_and_error_propagation_match_xdem_tpu():
    """Closed-form and numerical disk n_eff, and spatial_error_propagation of numeric areas
    (errors as a tensor or an array), to 1e-4 relative."""
    frame = pd.DataFrame(PARAMS)
    for area in (1e4, 1e6, 5e7):
        np.testing.assert_allclose(tss.neff_circular_approx_theoretical(area, PARAMS),
                                   jss.neff_circular_approx_theoretical(area, frame), rtol=1e-12)
        np.testing.assert_allclose(tss.number_effective_samples(area, PARAMS),
                                   jss.number_effective_samples(area, frame), rtol=1e-12)
    sig = np.random.default_rng(0).uniform(0.5, 3.0, (60, 70)).astype(np.float32)
    sig[:4] = np.nan
    want = jss.spatial_error_propagation([1e4, 1e6], sig, frame)
    np.testing.assert_allclose(tss.spatial_error_propagation([1e4, 1e6], torch.from_numpy(sig), PARAMS), want,
                               rtol=1e-4)
    np.testing.assert_allclose(tss.spatial_error_propagation([1e4, 1e6], sig, frame), want, rtol=1e-4)


# ---------------------------------------------------------------------- refusals


class _VectorLike:
    """Stands in for a Vector: it has bounds and create_mask (rasterized only on a Raster's
    grid, so a bare tensor with one is refused as xdem_tpu refuses it)."""

    bounds = (0.0, 0.0, 100.0, 100.0)

    def create_mask(self, *args, **kwargs):
        return None


_MESH2 = make_mesh(devices=[torch.device("cpu")] * 2)


@pytest.mark.parametrize("call,exc,match", [
    (lambda f: tss.sample_empirical_variogram(f, gsd=10.0, n_jobs=2), NotImplementedError, "n_jobs"),
    (lambda f: tss.sample_empirical_variogram(f, gsd=10.0, subsample_method="pdist_disk", mesh=_MESH2),
     ValueError, "cdist_equidistant"),
    (lambda f: tss.sample_empirical_variogram(f, gsd=10.0, subsample_method="cdist_point", mesh=_MESH2),
     ValueError, "cdist_equidistant"),
    (lambda f: tss.sample_empirical_variogram(torch.where(torch.arange(f.numel()).reshape(f.shape) == 0, f, torch.nan),
                                              gsd=10.0, subsample_method="pdist_ring"),
     ValueError, "Not enough valid points"),
    (lambda f: tss.sample_empirical_variogram(f, gsd=10.0, subsample_method="nope"), TypeError, "must be one of"),
    (lambda f: tss._binned_pair_core(f, f, torch.tensor([0.0, 1.0]), "genton", 1), ValueError, "not supported"),
    (lambda f: tss.sample_empirical_variogram(f, gsd=10.0, estimator="median"), ValueError, "not supported"),
    (lambda f: tss.sample_empirical_variogram(f), ValueError, "ground sampling distance"),
    (lambda f: tss.infer_spatial_correlation_from_stable(f, ["gaussian"], stable_mask=_VectorLike(), gsd=10.0),
     ValueError, "raster is needed"),
    (lambda f: tss.infer_heteroscedasticity_from_stable(f, [f], stable_mask=_VectorLike(), subsample=100),
     ValueError, "raster is needed"),
    (lambda f: tss.infer_heteroscedasticity_from_stable(f.numpy(), [f.numpy()], subsample=100, mesh=_MESH2),
     ValueError, "device path"),
    (lambda f: tss.spatial_error_propagation(["1 km2"], f, PARAMS), ValueError, "Area must be"),
    (lambda f: tss.number_effective_samples("1 km2", PARAMS), ValueError, "Area must be"),
    (lambda f: tss.neff_exact(np.zeros((3, 2)), np.ones(3), dict(PARAMS, range=-PARAMS["range"]), mesh=_MESH2),
     ValueError, "non-negative"),
])
def test_refusals(call, exc, match):
    with pytest.raises(exc, match=match):
        call(torch.from_numpy(_field(shape=(40, 40))))


def test_pair_count_limit_refuses():
    with pytest.raises(ValueError, match="per-bin count limit"):
        tss._check_pair_count(2**31)
    tss._check_pair_count(55_193_600)
    assert math.isclose(tss._PAIR_CHUNK_BUDGET, jss._PAIR_CHUNK_BUDGET)


# ---------------------------------------------------------------------- Genton


def test_genton_flat_path_matches_xdem_tpu(monkeypatch):
    """The Qn of at most 400 pairs per bin, drawn with np.random.default_rng(0) on both
    sides: counts identical, gamma within 1e-6 relative (observed equal), for the host grid,
    the device grid (with xdem_tpu's ring draw) and explicit coordinates."""
    f = _field()
    kw = dict(gsd=10.0, subsample=400, random_state=42, estimator="genton")
    monkeypatch.setattr(tss, "_draw_rings_from_arr", _jax_draw)
    for ours, theirs in ((f, f), (torch.from_numpy(f), jnp.asarray(f))):
        got = tss.sample_empirical_variogram(ours, **kw)
        want = jss.sample_empirical_variogram(theirs, **kw)
        np.testing.assert_array_equal(got["count"], want["count"].values)
        assert (got["count"] > 400).any()
        np.testing.assert_allclose(got["exp"], want["exp"].values, rtol=1e-6, equal_nan=True)
    ii, jj = np.meshgrid(np.arange(40) * 10.0, np.arange(45) * 10.0, indexing="ij")
    coords = np.column_stack([ii.ravel(), jj.ravel()])
    vals = f[:40, :45].ravel().astype(np.float64)
    kw1 = dict(coords=coords, subsample=100, random_state=1, estimator="genton")
    got, want = tss.sample_empirical_variogram(vals, **kw1), jss.sample_empirical_variogram(vals, **kw1)
    np.testing.assert_array_equal(got["count"], want["count"].values)
    np.testing.assert_allclose(got["exp"], want["exp"].values, rtol=1e-6, equal_nan=True)


def test_genton_reservoir_is_chunk_invariant_and_matches_xdem_tpu():
    """The chunked reservoir keeps the same 400 values per bin for any chunk size
    (tests/test_spatialstats.py's case), and they are xdem_tpu's: counts and reservoir
    contents identical, gamma within 1e-6 relative."""
    rng = np.random.default_rng(3)
    R, N, M = 8, 20, 60
    za = rng.normal(0, 2, (R, N)).astype(np.float32)
    zb = rng.normal(0, 2, (R, M)).astype(np.float32)
    ca = rng.uniform(0, 800, (R, N, 2)).astype(np.float32)
    cb = rng.uniform(0, 800, (R, M, 2)).astype(np.float32)
    za[2, 10:] = np.nan
    edges = np.array([0.0, 100.0, 300.0, 700.0, 1500.0], np.float32)
    results = []
    for chunk in (2, 8, 3):
        pad = (-R) % chunk

        def pn(a):
            return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=np.nan)

        res, cnt = tss._pairs_genton_reservoir_chunked(*(torch.from_numpy(pn(a)) for a in (za, zb, ca, cb)),
                                                       torch.from_numpy(edges), 4, chunk)
        jres, jcnt = jss._pairs_genton_reservoir_chunked(*(jnp.asarray(pn(a)) for a in (za, zb, ca, cb)),
                                                         jnp.asarray(edges), 4, chunk)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(np.sort(res.numpy(), axis=1), np.sort(np.asarray(jres), axis=1))
        gamma = tss._genton_qn_from_reservoir(res.numpy().astype(np.float64), cnt.numpy())
        want = jss._genton_qn_from_reservoir(np.asarray(jres, np.float64), np.asarray(jcnt))
        np.testing.assert_allclose(gamma, want, rtol=1e-6, equal_nan=True)
        results.append(gamma)
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_array_equal(results[0], results[2])


def test_genton_global_pair_zero_kept():
    """With fewer pairs than the cap the reservoir holds every valid pair, the pair at global
    index 0 included (its key is not the padding's 0): gamma is the full-sample Qn."""
    rng = np.random.default_rng(7)
    za, zb = rng.normal(0, 1, (2, 3)).astype(np.float32), rng.normal(0, 1, (2, 3)).astype(np.float32)
    ca, cb = rng.uniform(0, 50, (2, 3, 2)).astype(np.float32), rng.uniform(0, 50, (2, 3, 2)).astype(np.float32)
    d = (za[:, :, None] - zb[:, None, :]).ravel().astype(np.float64)
    res, cnt = tss._pairs_genton_reservoir_chunked(*(torch.from_numpy(a) for a in (za, zb, ca, cb)),
                                                   torch.tensor([0.0, 100.0]), 1, 1)
    assert int(cnt[0]) == len(d) and int(torch.isfinite(res[0]).sum()) == len(d)
    assert float(za[0, 0] - zb[0, 0]) in res[0].tolist()
    gamma = tss._genton_qn_from_reservoir(res.numpy().astype(np.float64), cnt.numpy())
    assert gamma[0] == pytest.approx(tss._genton_qn_gamma(d), rel=1e-6)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_genton_chunked_variogram_matches_xdem_tpu(monkeypatch, as_tensor):
    """Past the pair budget the variogram goes through the reservoir: counts identical to the
    flat path's and to xdem_tpu's, gamma within 1e-6 relative of xdem_tpu's chunked result."""
    f = _field()
    kw = dict(gsd=10.0, subsample=300, random_state=42, estimator="genton")
    flat = tss.sample_empirical_variogram(f, **kw)
    monkeypatch.setattr(tss, "_PAIR_CHUNK_BUDGET", 5_000)
    monkeypatch.setattr(jss, "_PAIR_CHUNK_BUDGET", 5_000)
    if as_tensor:
        monkeypatch.setattr(tss, "_draw_rings_from_arr", _jax_draw)
        got = tss.sample_empirical_variogram(torch.from_numpy(f), **kw)
        want = jss.sample_empirical_variogram(jnp.asarray(f), **kw)
    else:
        got = tss.sample_empirical_variogram(f, **kw)
        want = jss.sample_empirical_variogram(f, **kw)
        np.testing.assert_array_equal(got["count"], flat["count"])
    np.testing.assert_array_equal(got["count"], want["count"].values)
    np.testing.assert_allclose(got["exp"], want["exp"].values, rtol=1e-6, equal_nan=True)


# ---------------------------------------------------------------------- point, disk and ring subsamples


@pytest.mark.parametrize("estimator,tol", [("dowd", 1e-6), ("matheron", 5e-5), ("cressie", 5e-5), ("genton", 1e-6)])
@pytest.mark.parametrize("method", ["cdist_point", "pdist_point", "pdist_disk", "pdist_ring"])
def test_point_subsamples_match_xdem_tpu(method, estimator, tol):
    """numpy draws on both sides, so the samples are the same ones: counts identical; Dowd
    and Genton (order statistics) 1e-6, Matheron and Cressie (float64 sums here, float32
    there) 5e-5. A tensor grid gives what the numpy grid gives."""
    f = _field()
    kw = dict(gsd=10.0, subsample=250, subsample_method=method, estimator=estimator, random_state=4)
    want = jss.sample_empirical_variogram(f, **kw)
    got = tss.sample_empirical_variogram(f, **kw)
    np.testing.assert_array_equal(got["count"], want["count"].values)
    np.testing.assert_array_equal(got["lags"], want["lags"].values)
    np.testing.assert_allclose(got["exp"], want["exp"].values, rtol=tol, equal_nan=True)
    from_tensor = tss.sample_empirical_variogram(torch.from_numpy(f), **kw)
    np.testing.assert_array_equal(from_tensor["count"], got["count"])
    np.testing.assert_array_equal(from_tensor["exp"], got["exp"])


@pytest.mark.parametrize("method", ["cdist_point", "pdist_disk"])
def test_point_subsamples_on_explicit_coordinates(method):
    """1-D values with coordinates, two variograms: counts identical, Dowd 1e-6, and the
    spread between the runs (err_exp) 1e-5."""
    f = _field()
    ii, jj = np.meshgrid(np.arange(60) * 10.0, np.arange(70) * 10.0, indexing="ij")
    coords = np.column_stack([ii.ravel(), jj.ravel()])
    vals = f[:60, :70].ravel().astype(np.float64)
    kw = dict(coords=coords, subsample=150, subsample_method=method, n_variograms=2, random_state=9)
    want = jss.sample_empirical_variogram(vals, **kw)
    got = tss.sample_empirical_variogram(vals, **kw)
    np.testing.assert_array_equal(got["count"], want["count"].values)
    np.testing.assert_allclose(got["exp"], want["exp"].values, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got["err_exp"], want["err_exp"].values, rtol=1e-5, equal_nan=True)


def test_valid_points_map_positions_without_a_coordinate_array():
    """Positions among the valid pixels map to (row * gsd, col * gsd) and to the values, as
    the flattened coordinate array of xdem_tpu's host path would give them."""
    f = _field(shape=(30, 40))
    pts = tss._ValidPoints(torch.from_numpy(f), gsd=10.0)
    valid = np.isfinite(f.ravel())
    x, y = np.meshgrid(np.arange(30) * 10.0, np.arange(40) * 10.0, indexing="ij")
    coords_v = np.column_stack([x.ravel(), y.ravel()])[valid]
    assert len(pts) == valid.sum()
    pos = np.array([0, 5, len(pts) - 1, 123])
    np.testing.assert_array_equal(pts.coords_at(pos).numpy(), coords_v[pos])
    np.testing.assert_array_equal(pts.values_at(pos).numpy(), f.ravel()[valid][pos])
    np.testing.assert_array_equal(pts.coords_at().numpy(), coords_v)


# ---------------------------------------------------------------------- plots


@pytest.fixture
def agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


@pytest.mark.parametrize("as_frame", [False, True], ids=["dict", "frame"])
@pytest.mark.parametrize("split", [None, [0.0, 100.0, 500.0]], ids=["one-panel", "split"])
def test_plot_variogram_writes_a_file(tmp_path, agg, as_frame, split):
    f = _field()
    emp = tss.sample_empirical_variogram(f, gsd=10.0, subsample=200, n_variograms=2, random_state=1)
    fun, _params = tss.fit_sum_model_variogram(["gaussian"], emp)
    table = pd.DataFrame(emp) if as_frame else emp
    out = tmp_path / "variogram.png"
    axes = tss.plot_variogram(table, list_fit_fun=[fun], list_fit_fun_label=["fit"], xscale_range_split=split,
                              xlabel="lag (m)", ylabel="var", out_fname=str(out))
    assert out.stat().st_size > 1000
    assert len(axes) == 3 if split else axes is not None
    single = {k: v for k, v in emp.items() if k != "err_exp"}
    assert tss.plot_variogram(single, xscale="log", xlim=(10, 2000), ylim=(0, 10)) is not None


@pytest.mark.parametrize("as_frame", [False, True], ids=["dict", "frame"])
def test_plot_binning_writes_files(tmp_path, agg, as_frame):
    """1-D and 2-D binning plots from the port's table (edge columns) and from xdem_tpu's
    frame (a column of intervals)."""
    vals, slope, curv = _binning_inputs()
    if as_frame:
        table = jss.nd_binning(vals, [slope, curv], ["slope", "curv"], list_var_bins=6)
    else:
        table = tss.nd_binning(vals, [slope, curv], ["slope", "curv"], list_var_bins=6)
    out1, out2 = tmp_path / "b1.png", tmp_path / "b2.png"
    ax = tss.plot_1d_binning(table, "slope", "nmad", label_var="slope (deg)", label_statistic="NMAD",
                             out_fname=str(out1))
    line = ax.get_lines()[0]
    assert len(line.get_xdata()) == 6 and np.isfinite(line.get_ydata()).all()
    tss.plot_2d_binning(table, "slope", "curv", "nmad", min_count=5, vmin=0.0, vmax=5.0, out_fname=str(out2))
    assert out1.stat().st_size > 1000 and out2.stat().st_size > 1000
    fig, own = agg.subplots()
    assert tss.plot_1d_binning(table, "curv", "nanmedian", ax=own) is own
    with pytest.raises(ValueError, match="No 2-D binning"):
        tss.plot_2d_binning({k: v[table["nd"] == 1] for k, v in table.items()} if not as_frame
                            else table[table["nd"] == 1], "slope", "curv", "nmad")


def test_interval_mids_parses_interval_strings():
    """A frame read back from CSV holds '[a, b)' strings: the mids are parsed from them."""
    frame = {"slope": np.array(["[0.0, 10.0)", "[10.0, 30.0)", "nan"], dtype=object)}
    np.testing.assert_array_equal(tss._interval_mids(frame, "slope"), [5.0, 20.0, np.nan])
