"""The port's fits (xdem_tpu_torch.fit), bias corrections (Deramp, DirectionalBias,
TerrainBias, BiasCorr) and pipelines against xdem_tpu on a seeded 128^2 pair.

Both packages draw the same numpy subsample and bin with the same edges, so the bin tables'
counts are held identical; fitted parameters within 1e-4 of their largest magnitude (the LM
polish runs in float32 on both sides, in another order of operations); applies to 1e-3 m on
the finite pixels with identical NaN masks. The terrain attribute of TerrainBias is passed
through ``bias_vars=`` where xdem_tpu and the port must see the same array: the maximum
curvature of a smooth DEM is float32 rounding noise that depends on the order of reduction.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_np

from xdem_tpu import coreg as jcoreg
from xdem_tpu import examples
from xdem_tpu import fit as jfit
from xdem_tpu import terrain as jterrain
from xdem_tpu.georef import Affine as JaxAffine
from xdem_tpu_torch import coreg, fit
from xdem_tpu_torch.georef import Affine

RES = 20.0
N = 128
ORIGIN = (5e5, 8e6, RES, RES)
TRANSFORM = Affine.from_origin(*ORIGIN)
JAX_TRANSFORM = JaxAffine.from_origin(*ORIGIN)
SUB = 5000


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12), (got, want)


def _apply_close(got, want, atol=1e-3):
    g = to_np(got[0] if isinstance(got, tuple) else got)
    w = np.asarray(want[0] if isinstance(want, tuple) else want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """A spectral DEM and the same minus a ramp, an along-track sinusoid at 30 degrees and a
    curvature-correlated field, with a NaN hole; and the DEM's maximum curvature."""
    ref = examples.synthetic_dem_array(shape=(N, N), resolution=RES, seed=4)
    yy, xx = np.mgrid[0:N, 0:N]
    ramp = 6e-5 * (xx - 64) ** 2 - 2e-2 * (yy - 50) + 1.0
    curv = np.array(jterrain.get_terrain_attribute(ref, "max_curvature", resolution=RES))
    cf = np.clip(curv / np.nanpercentile(np.abs(curv), 99), -1, 1)
    along = xx * RES * np.cos(np.pi / 6) + (N - yy) * RES * np.sin(np.pi / 6)
    tba = (ref - ramp - np.sin(2 * np.pi * along / 900.0) - cf).astype(np.float32)
    tba[30:36, 40:60] = np.nan
    return ref, tba, curv.astype(np.float32)


# ------------------------------------------------------------------ fit.py


def test_models_and_losses_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-3, 3, 200), rng.uniform(-3, 3, 200)
    p1, p2, ps = [0.5, -1.0, 0.25], list(rng.normal(size=9)), [1.5, 2.0, 0.3, 0.4, 0.7, 1.0]
    for got, want in (
        (fit.polynomial_1d(x, *p1), jfit.polynomial_1d(x, *p1)),
        (fit.polynomial_2d((x, y), *p2), jfit.polynomial_2d((x, y), *p2)),
        (fit.sumsin_1d(x, *ps), jfit.sumsin_1d(x, *ps)),
    ):
        np.testing.assert_array_equal(got, want)
    xt, yt = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y.astype(np.float32))
    xj, yj = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    for got, want in (
        (fit.polynomial_1d(xt, *p1), jfit.polynomial_1d(xj, *p1)),
        (fit.polynomial_2d((xt, yt), *p2), jfit.polynomial_2d((xj, yj), *p2)),
        (fit.sumsin_1d(xt, *ps), jfit.sumsin_1d(xj, *ps)),
    ):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    z = rng.normal(size=50) * 2
    for name in ("rmse", "huber_loss", "soft_loss"):
        assert getattr(fit, name)(z) == getattr(jfit, name)(z)
        assert getattr(fit, name)(z, z / 2) == getattr(jfit, name)(z, z / 2)
    with pytest.raises(TypeError, match="scale"):
        fit.soft_loss(z, 0.5)


@pytest.mark.parametrize("model", ["polynomial_1d", "polynomial_2d", "sumsin_1d"])
def test_curve_fit_lm_matches_jax(model):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 4, 400)
    y2 = rng.uniform(0, 4, 400)
    if model == "polynomial_1d":
        xdata, truth, p0 = x, [1.0, -0.5, 0.2], [0.0, 0.0, 0.0]
    elif model == "polynomial_2d":
        xdata, truth, p0 = (x, y2), [0.5, 0.1, -0.2, 0.3], [0.0] * 4
    else:
        xdata, truth, p0 = x, [2.0, 3.0, 0.5], [1.5, 2.8, 0.3]
    yv = getattr(fit, model)(xdata, *truth) + rng.normal(0, 0.05, 400)
    yv[::37] = np.nan
    want = jfit.curve_fit_lm(getattr(jfit, model), xdata if model == "polynomial_2d" else jnp.asarray(xdata),
                             jnp.asarray(yv), p0=p0)
    got = fit.curve_fit_lm(getattr(fit, model), xdata, yv, p0=p0)
    assert got.dtype == np.float64
    _close(got, want)
    np.testing.assert_allclose(got, truth, atol=0.05)


def test_levenberg_marquardt_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 3, 300).astype(np.float32)
    y = (2.0 * np.exp(-0.7 * x) + rng.normal(0, 0.01, 300)).astype(np.float32)
    xt, yt, xj, yj = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    got = fit.levenberg_marquardt(lambda p: p[0] * torch.exp(-p[1] * xt) - yt, np.array([1.0, 0.1]))
    want = jfit.levenberg_marquardt(lambda p: p[0] * jnp.exp(-p[1] * xj) - yj, jnp.array([1.0, 0.1]))
    _close(to_np(got[0]), np.asarray(want[0]))
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-4)


@pytest.mark.parametrize("linear_pkg,estimator", [("scipy", "Huber"), ("sklearn", "Linear"), ("sklearn", "Huber")])
def test_robust_polynomial_fit_matches_jax(linear_pkg, estimator):
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, 800)
    y = 0.5 - x + 0.3 * x**2 + rng.normal(0, 0.1, 800)
    y[:20] += 15  # outliers
    kw = dict(linear_pkg=linear_pkg, estimator_name=estimator, random_state=4, subsample=600)
    got, want = fit.robust_norder_polynomial_fit(x, y, **kw), jfit.robust_norder_polynomial_fit(x, y, **kw)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    if linear_pkg == "scipy":
        np.testing.assert_array_equal(fit._irls_polyfit(x, y, 3, sigma=np.full(800, 0.5)),
                                      jfit._irls_polyfit(x, y, 3, sigma=np.full(800, 0.5)))


def test_sumsin_fit_matches_jax():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 5000, 1500))
    y = 2.0 * np.sin(2 * np.pi * x / 800 + 0.4) + 0.5 * np.sin(2 * np.pi * x / 170 + 1.0) + rng.normal(0, 0.05, 1500)
    wl = np.geomspace(50, 5000, 64)
    rss, sol = fit._periodogram_best_wavelength(x, y, wl)
    jrss, jsol = jfit._periodogram_best_wavelength(x, y, wl)
    np.testing.assert_array_equal(rss, jrss)
    np.testing.assert_array_equal(sol, jsol)
    got, n = fit.robust_nfreq_sumsin_fit(x, y, random_state=1, hop_length=20.0)
    want, jn = jfit.robust_nfreq_sumsin_fit(x, y, random_state=1, hop_length=20.0)
    assert n == jn
    _close(got, want)
    np.testing.assert_allclose(got[:2], [2.0, 800.0], rtol=0.02)


def test_the_sum_of_sines_closed_form_jacobian_equals_jacfwd():
    """The polish's residual is sumsin_1d's to the bit in float32, and its closed-form
    Jacobian is torch.func.jacfwd's to float64 rounding."""
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 1.4e5, 100))
    y = 1.5 * np.sin(2 * np.pi * x / 2e4) + rng.normal(0, 0.05, 100)
    p = torch.tensor([1.4, 2.1e4, 0.1, 0.6, 6.4e3, 1.1, 0.1, 3e3, 0.2], dtype=torch.float64)
    residual, jacobian = fit._sumsin_residual_and_jacobian(torch.from_numpy(x), torch.from_numpy(y))
    want = torch.func.jacfwd(residual)(p)
    assert torch.allclose(jacobian(p), want, rtol=1e-12, atol=1e-12 * float(want.abs().max()))
    xt, yt, pt = torch.from_numpy(x).float(), torch.from_numpy(y).float(), p.float()
    residual32, _ = fit._sumsin_residual_and_jacobian(xt, yt)
    assert torch.equal(residual32(pt), fit.sumsin_1d(xt, *pt) - yt)


@pytest.mark.parametrize("rows", ["spread", "one row"])
def test_deramp_normal_equations_equal_the_least_squares(rows):
    """Deramp's normal equations give np.linalg.lstsq's coefficients, the minimum-norm ones
    where every pick lies in one row (the monomials in y then repeat those in 1)."""
    rng = np.random.default_rng(8)
    n = 20000
    cc = rng.integers(0, 4000, n).astype(np.float64)
    rr = rng.integers(0, 3000, n).astype(np.float64) if rows == "spread" else np.full(n, 1234.0)
    u, v = cc / 2000 - 1, rr / 1500 - 1
    dh = 2.5 * (u**2 - v**2) + 2.5 * u * v + rng.normal(0, 0.3, n)
    step = coreg.Deramp(subsample=n)
    step._bin_or_and_fit_biasvars(dh, {"xx": cc, "yy": rr})
    got = step.meta["outputs"]["fitorbin"]["fit_params"]
    sx, sy = cc.max(), rr.max()
    A = np.stack([(cc / sx) ** i * (rr / sy) ** j for i in range(3) for j in range(3)], axis=1)
    want = np.linalg.lstsq(A, dh, rcond=None)[0] / np.array([sx**i * sy**j for i in range(3) for j in range(3)])
    _close(got, want, rel=1e-9)


# ------------------------------------------------------------------ bias corrections


def _bias_case(name, mode):
    kw = dict(fit_or_bin=mode, subsample=SUB)
    if name == "DirectionalBias":
        kw["angle"] = 30
    if name == "TerrainBias" and mode != "bin":
        kw["fit_func"] = "norder_polynomial"
    return kw


def test_rotated_coordinates_match_jax():
    """The rotated grid of DirectionalBias: whole grid, at drawn pixels, and made on the
    device from pixel indices (float32) for the apply."""
    from xdem_tpu.coreg import biascorr as jbiascorr

    from xdem_tpu_torch.coreg import biascorr

    shape = (37, 53)
    want = jbiascorr._get_xy_rotated(shape, JAX_TRANSFORM, 30.0)
    got = biascorr._get_xy_rotated(shape, TRANSFORM, 30.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rr, cc = np.array([0, 5, 36]), np.array([52, 7, 0])
    np.testing.assert_array_equal(biascorr._rotated_at(rr, cc, shape, TRANSFORM, 30.0)[0], want[0][rr, cc])
    dev = coreg.DirectionalBias(angle=30)._apply_vars(torch.zeros(shape), TRANSFORM, None)["angle"]
    np.testing.assert_allclose(to_np(dev), want[0], rtol=1e-6, atol=1e-2)


@pytest.mark.parametrize("mode", ["fit", "bin", "bin_and_fit"])
@pytest.mark.parametrize("name", ["Deramp", "DirectionalBias", "TerrainBias"])
def test_bias_corrections_match_jax(pair, name, mode):
    ref, tba, curv = pair
    kw = _bias_case(name, mode)
    bv = {"max_curvature": curv} if name == "TerrainBias" else None
    j = getattr(jcoreg, name)(**kw)
    want = j.fit_and_apply(ref, tba, bias_vars=bv, transform=JAX_TRANSFORM, random_state=3)
    p = getattr(coreg, name)(**kw)
    got = p.fit_and_apply(ref, tba, bias_vars=bv, transform=TRANSFORM, random_state=3)
    assert p.meta["outputs"]["random"] == j.meta["outputs"]["random"]
    fj, fp = j.meta["outputs"]["fitorbin"], p.meta["outputs"]["fitorbin"]
    if mode != "bin":
        _close(fp["fit_params"], fj["fit_params"])
    if mode != "fit":
        np.testing.assert_array_equal(np.asarray(fp["bin_dataframe"]["count"]),
                                      np.asarray(fj["bin_dataframe"]["count"]))
    assert isinstance(got, tuple) and got[1] == TRANSFORM and got[0].dtype == torch.float32
    _apply_close(got, want)
    before, after = np.nanvar(ref - tba), np.nanvar(ref - to_np(got[0]))
    assert after < before


def test_generic_biascorr_per_bin_and_names(pair):
    ref, tba, curv = pair
    var = {"v": np.linspace(-1, 1, N * N, dtype=np.float32).reshape(N, N)}
    kw = dict(fit_or_bin="bin", bin_sizes={"v": 12}, bin_apply_method="per_bin", bias_var_names=["v"], subsample=SUB)
    j = jcoreg.BiasCorr(**kw).fit(ref, tba, bias_vars=var, transform=JAX_TRANSFORM, random_state=2)
    p = coreg.BiasCorr(**kw).fit(ref, tba, bias_vars=var, transform=TRANSFORM, random_state=2)
    _apply_close(p.apply(tba, bias_vars=var, transform=TRANSFORM), j.apply(tba, bias_vars=var, transform=JAX_TRANSFORM))
    with pytest.raises(ValueError, match="bias_var_names"):
        coreg.BiasCorr(bias_var_names=["w"]).fit(ref, tba, bias_vars=var, transform=TRANSFORM)
    with pytest.raises(ValueError, match="fit_or_bin"):
        coreg.BiasCorr(fit_or_bin="both")


def test_terrain_bias_computes_its_attribute_and_removes_the_field(pair):
    """Without bias_vars the attribute is computed inside (the plain version of the K1
    kernel on the CPU): the correction removes most of the curvature-correlated field."""
    ref, _, curv = pair
    cf = np.clip(curv / np.nanpercentile(np.abs(curv), 99), -1, 1).astype(np.float32)
    out, _ = coreg.TerrainBias().fit_and_apply(ref, ref - cf, transform=TRANSFORM, random_state=1)
    assert np.nanvar(ref - to_np(out)) < 0.1 * np.nanvar(cf)


# ------------------------------------------------------------------ pipelines and saved states


def _pipeline(pkg):
    return pkg.CoregPipeline([pkg.VerticalShift(), pkg.Deramp(subsample=SUB),
                              pkg.DirectionalBias(angle=30, fit_or_bin="fit", subsample=SUB),
                              pkg.TerrainBias("slope", bin_sizes=20, subsample=SUB)])


def test_pipeline_fit_and_apply_matches_jax(pair):
    ref, tba, _ = pair
    j, p = _pipeline(jcoreg), _pipeline(coreg)
    want = j.fit_and_apply(ref, tba, transform=JAX_TRANSFORM, random_state=6)
    got = p.fit_and_apply(ref, tba, transform=TRANSFORM, random_state=6)
    for sj, sp in zip(j, p):
        for key in ("affine", "fitorbin"):
            if key in sj.meta["outputs"]:
                oj, op = sj.meta["outputs"][key], sp.meta["outputs"][key]
                if key == "affine":
                    assert op["shift_z"] == pytest.approx(oj["shift_z"], abs=1e-5)
                elif oj["fit_params"] is not None:
                    _close(op["fit_params"], oj["fit_params"])
    _apply_close(got, want)
    assert np.nanvar(ref - to_np(got[0])) < 0.2 * np.nanvar(ref - tba)


@pytest.mark.parametrize("name", ["Deramp", "DirectionalBias", "TerrainBias"])
def test_jax_saved_bias_states_load_and_apply(pair, tmp_path, name):
    ref, tba, curv = pair
    kw = _bias_case(name, "fit")
    bv = {"max_curvature": curv} if name == "TerrainBias" else None
    j = getattr(jcoreg, name)(**kw).fit(ref, tba, bias_vars=bv, transform=JAX_TRANSFORM, random_state=7)
    j.save(str(tmp_path / "s.pkl"))
    p = coreg.Coreg.load(str(tmp_path / "s.pkl"))
    assert type(p) is getattr(coreg, name) and p._fit_called
    fb = p.meta["inputs"]["fitorbin"]
    assert fb["fit_func"] is getattr(fit, j.meta["inputs"]["fitorbin"]["fit_func"].__name__)
    _apply_close(p.apply(tba, bias_vars=bv, transform=TRANSFORM), j.apply(tba, bias_vars=bv, transform=JAX_TRANSFORM))


def test_jax_saved_pipeline_loads_and_applies(pair, tmp_path):
    ref, tba, _ = pair
    j = jcoreg.CoregPipeline([jcoreg.DhMinimize(subsample=2000), jcoreg.Deramp(subsample=SUB)])
    j.fit(ref, tba, transform=JAX_TRANSFORM, random_state=8)
    j.save(str(tmp_path / "pipe.pkl"))
    p = coreg.Coreg.load(str(tmp_path / "pipe.pkl"))
    assert [type(s) for s in p] == [coreg.DhMinimize, coreg.Deramp]
    _apply_close(p.apply(tba, transform=TRANSFORM), j.apply(tba, transform=JAX_TRANSFORM))


def test_binned_states_need_pandas_from_jax_and_round_trip_from_the_port(pair, tmp_path):
    """xdem_tpu stores a bin table as a pandas frame, which the port cannot unpickle: the
    error names pandas. The port's own binned TerrainBias saves and loads bit for bit."""
    ref, tba, curv = pair
    bv = {"max_curvature": curv}
    j = jcoreg.TerrainBias(subsample=SUB).fit(ref, tba, bias_vars=bv, transform=JAX_TRANSFORM, random_state=9)
    j.save(str(tmp_path / "j.pkl"))
    with pytest.raises(pickle.UnpicklingError, match="pandas"):
        coreg.Coreg.load(str(tmp_path / "j.pkl"))
    p = coreg.TerrainBias(subsample=SUB).fit(ref, tba, bias_vars=bv, transform=TRANSFORM, random_state=9)
    p.save(str(tmp_path / "p.pkl"))
    again = coreg.Coreg.load(str(tmp_path / "p.pkl"))
    first, second = p.apply(tba, bias_vars=bv, transform=TRANSFORM)[0], again.apply(tba, bias_vars=bv,
                                                                                    transform=TRANSFORM)[0]
    assert torch.equal(torch.isnan(first), torch.isnan(second))
    assert torch.equal(torch.nan_to_num(first), torch.nan_to_num(second))


def test_blockwise_names_raise_naming_raster():
    """The blockwise names are ported: each builds with xdem_tpu's signature, and a bias
    correction is refused as a blockwise step as xdem_tpu refuses it."""
    import inspect

    for name in ("BlockwiseCoreg", "BlockwiseNuthKaab", "MultiprocConfig"):
        assert list(inspect.signature(getattr(coreg, name)).parameters) == \
            list(inspect.signature(getattr(jcoreg, name)).parameters), name
    assert coreg.BlockwiseNuthKaab().block_size_fit == 500 and coreg.MultiprocConfig().chunk_size == 500
    for mod in (coreg, jcoreg):
        with pytest.raises(ValueError, match="only supports affine"):
            mod.BlockwiseCoreg(mod.TerrainBias())
