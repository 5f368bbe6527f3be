"""The port's coregistration (xdem_tpu_torch.coreg) and tensor ops against xdem_tpu.

Tolerances: order statistics and the matrix toolbox exactly; interpolation to 1e-6 of the
values; the Nuth & Kääb solver with identical injected samples to 1e-3 m; a whole fit to
1 % of each shift against xdem_tpu (bench.py's coreg parity bound) and 5 % against the
truth; vertical shifts to 1e-6 m.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates
from torch_port_helpers import to_np

from xdem_tpu import coreg as jcoreg
from xdem_tpu import examples
from xdem_tpu.coreg import affine as jaffine
from xdem_tpu.coreg import base as jbase
from xdem_tpu.georef import Affine as JaxAffine
from xdem_tpu.ops import interp as jinterp
from xdem_tpu.ops import reductions as jred
from xdem_tpu_torch import coreg
from xdem_tpu_torch.coreg import affine, base
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.ops import interp, reductions, transfer
from xdem_tpu_torch.parallel import make_mesh

RES = 20.0
SHIFT = (6.0, -3.0, 1.5)  # (east, north, up) metres the terrain is moved by in tba
ORIGIN = (5e5, 8e6, RES, RES)
TRANSFORM = Affine.from_origin(*ORIGIN)
JAX_TRANSFORM = JaxAffine.from_origin(*ORIGIN)


def _pair(n=256, seed=4, shift=SHIFT):
    """A seeded spectral DEM and a copy with its terrain moved by `shift` (bilinear), with
    a NaN hole in the moved copy."""
    ref = examples.synthetic_dem_array(shape=(n, n), resolution=RES, seed=seed)
    dx, dy, dz = shift
    cg, rg = np.meshgrid(np.arange(n) - dx / RES, np.arange(n) + dy / RES)
    tba = map_coordinates(ref.astype(np.float64), [rg, cg], order=1, mode="constant", cval=np.nan) + dz
    tba[40:50, 100:130] = np.nan
    return ref, tba.astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_nk(pair):
    ref, tba = pair
    c = jcoreg.NuthKaab()
    c.fit(ref, tba, transform=JAX_TRANSFORM, crs=32633, random_state=42)
    return c


# ------------------------------------------------------------------ reductions and interpolation


@pytest.mark.parametrize("case", ["random_with_empty_bins", "even_counts", "one_bin", "all_invalid"])
def test_binned_median_matches_jax(case):
    rng = np.random.default_rng(7)
    n, n_bins = 501, 12
    y = rng.normal(size=n).astype(np.float32)
    bins = rng.integers(0, n_bins, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    if case == "random_with_empty_bins":
        bins[bins == 5] = 6
        y[~valid] = np.nan
    elif case == "even_counts":
        bins = np.repeat(np.arange(n_bins), 4)[: n].astype(np.int32)
        y, valid = y[: bins.size], np.ones(bins.size, bool)
    elif case == "one_bin":
        bins[:] = 3
    else:
        valid[:] = False
    want = np.asarray(jaffine._binned_median(jnp.asarray(y), jnp.asarray(bins), jnp.asarray(valid), n_bins))
    got = to_np(affine._binned_median(torch.from_numpy(y), torch.from_numpy(bins), torch.from_numpy(valid), n_bins))
    np.testing.assert_array_equal(got, want)


def test_median_is_the_middle_pair_mean():
    x = torch.tensor([4.0, 1.0, float("nan"), 3.0, 2.0])
    assert float(reductions.masked_median(x, torch.isfinite(x))) == 2.5 == float(jaffine._masked_median(jnp.asarray(to_np(x))))
    assert float(reductions.masked_median(x, x > 1.5)) == 3.0
    assert float(reductions.nanmedian(torch.tensor([1.0, float("inf"), 2.0, float("nan")]))) == 2.0


@pytest.mark.parametrize("fn", ["nanmedian", "nmad"])
def test_reductions_match_jax(fn):
    x = np.random.default_rng(3).standard_t(3, size=1001).astype(np.float32)
    x[::17] = np.nan
    want = float(getattr(jred, fn)(jnp.asarray(x)))
    got = float(getattr(reductions, fn)(torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("method", ["linear", "nearest", "cubic"])
def test_interp_rowcol_matches_jax(method):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(31, 29)).astype(np.float32).cumsum(0)
    data[10, 12] = np.nan
    rows = rng.uniform(-2, 33, 2000).astype(np.float32)
    cols = rng.uniform(-2, 31, 2000).astype(np.float32)
    rows[:5] = [0.0, 30.0, 10.0, 9.5, 29.6]
    cols[:5] = [0.0, 28.0, 12.0, 11.5, 27.2]
    want = np.asarray(jinterp.interp_rowcol(jnp.asarray(data), jnp.asarray(rows), jnp.asarray(cols), method=method))
    got = to_np(interp.interp_rowcol(torch.from_numpy(data), torch.from_numpy(rows), torch.from_numpy(cols), method))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_interp_points_matches_jax(method):
    """World coordinates through the inverse transform, then interp_rowcol: float32, 1e-5 of
    the data's magnitude; points outside the grid are NaN in both."""
    rng = np.random.default_rng(2)
    data = rng.normal(100.0, 10.0, (30, 40)).astype(np.float32)
    transform = (20.0, 0.0, 5e5, 0.0, -20.0, 8e6)
    x = (5e5 + rng.uniform(-30, 830, 200)).astype(np.float32)
    y = (8e6 - rng.uniform(-30, 630, 200)).astype(np.float32)
    want = np.asarray(jinterp.interp_points(jnp.asarray(data), transform, jnp.asarray(x), jnp.asarray(y), method=method))
    got = to_np(interp.interp_points(torch.from_numpy(data), transform, torch.from_numpy(x), torch.from_numpy(y), method))
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(got).any() and np.isfinite(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 100.0, equal_nan=True)
    from xdem_tpu_torch import ops
    assert ops.interp_points is interp.interp_points


def test_grid_coords_match_jax():
    t = JAX_TRANSFORM
    want = jinterp.grid_coords((7, 9), t)
    got = interp.grid_coords((7, 9), TRANSFORM, dtype=torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_transfer_helpers():
    m = np.ma.masked_array(np.arange(6, dtype=np.int16).reshape(2, 3), mask=[[0, 1, 0], [0, 0, 1]])
    u = transfer.unmask(m)
    assert u.dtype == np.float32 and np.isnan(u[0, 1]) and u[1, 0] == 3
    mask = transfer.device_mask(np.eye(3, dtype=bool), (3, 3), "cpu")
    assert mask.dtype == torch.bool and bool(mask[1, 1]) and not bool(mask[0, 1])
    assert bool(transfer.device_mask(None, (2, 2), "cpu").all())
    with pytest.raises(ValueError, match="shape"):
        transfer.device_mask(np.ones((2, 2), bool), (3, 3), "cpu")


# ------------------------------------------------------------------ Nuth & Kääb


def test_slope_aspect_valid_match_jax(pair):
    ref, tba = pair
    inlier = np.ones(ref.shape, bool)
    inlier[:20, :20] = False
    want = jaffine._nk_slope_aspect_valid(jnp.asarray(ref), jnp.asarray(tba), jnp.asarray(inlier))
    got = affine._nk_slope_aspect_valid(torch.from_numpy(ref), torch.from_numpy(tba), torch.from_numpy(inlier))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    # 1e-4 relative: the centring means (jnp.nanmean, torch.nanmean) round differently and
    # the central differences cancel about two digits of it (measured 2e-5).
    for g, w in zip(got[:2], want[:2]):
        g, w = to_np(g), np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-4, atol=1e-5)


def test_solver_matches_jax_on_injected_samples(pair):
    """Identical (pts_z, rows, cols, slope, aspect) into both solvers: the RNG streams of
    the two packages differ, so the subsample is drawn once, here, with numpy."""
    ref, tba = pair
    st, asp, valid = (np.asarray(v) for v in jaffine._nk_slope_aspect_valid(
        jnp.asarray(ref), jnp.asarray(tba), jnp.ones(ref.shape, bool)))
    idx = np.random.default_rng(0).choice(np.flatnonzero(valid), 20000, replace=False)
    rr, cc = np.unravel_index(idx, ref.shape)
    args = [ref[rr, cc], rr.astype(np.float32), cc.astype(np.float32), tba, st[rr, cc], asp[rr, cc]]
    for bin_before_fit in (True, False):
        want = jaffine._nuth_kaab_solve(*(jnp.asarray(a) for a in args), RES, RES, 0.001,
                                        max_iterations=10, n_bins=72, bin_before_fit=bin_before_fit)
        got = affine._nuth_kaab_solve(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), RES, RES, 0.001,
                                      max_iterations=10, n_bins=72, bin_before_fit=bin_before_fit)
        assert got[4] == int(want[4])
        assert got[0] == pytest.approx(float(want[0]), abs=1e-3)
        assert got[1] == pytest.approx(float(want[1]), abs=1e-3)
        assert got[2] == pytest.approx(float(want[2]), abs=1e-3)


@pytest.mark.parametrize("initial_shift", [None, (4.0, -2.0)])
def test_nuth_kaab_fit_matches_jax_and_truth(pair, jax_nk, initial_shift):
    ref, tba = pair
    if initial_shift is None:
        want = jax_nk.to_translations()
    else:
        j = jcoreg.NuthKaab(initial_shift=initial_shift)
        j.fit(ref, tba, transform=JAX_TRANSFORM, crs=32633, random_state=42)
        want = j.to_translations()
    c = coreg.NuthKaab(initial_shift=initial_shift)
    assert c.fit(ref, tba, transform=TRANSFORM, crs="EPSG:32633", random_state=42) is c
    got = c.to_translations()
    dx, dy, dz = SHIFT
    for g, w, truth in zip(got[:2], want[:2], (-dx, -dy)):
        assert g == pytest.approx(w, rel=0.01)
        assert g == pytest.approx(truth, abs=0.05 * np.hypot(dx, dy))
        assert w == pytest.approx(truth, abs=0.05 * np.hypot(dx, dy))
    assert got[2] == pytest.approx(-dz, abs=0.1)
    assert c.meta["outputs"]["iterative"]["last_iteration"] >= 3


def test_fit_and_apply_removes_the_shift(pair):
    ref, tba = pair
    aligned, tr = coreg.NuthKaab().fit_and_apply(ref, tba, transform=TRANSFORM, crs=32633, random_state=1)
    assert tr == TRANSFORM and isinstance(aligned, torch.Tensor)
    before, after = ref - tba, ref - to_np(aligned)
    assert np.nanvar(after) < 0.01 * np.nanvar(before)


def test_fractional_subsample_and_inlier_mask(pair):
    ref, tba = pair
    mask = np.ones(ref.shape, bool)
    mask[:64] = False
    c = coreg.NuthKaab(subsample=0.5).fit(ref, tba, inlier_mask=mask, transform=TRANSFORM, crs=32633, random_state=3)
    n_valid = int((np.isfinite(tba) & mask).sum())
    assert abs(c.meta["outputs"]["random"]["subsample_final"] - n_valid // 2) <= n_valid // 50
    assert c.to_translations()[0] == pytest.approx(-SHIFT[0], abs=0.05 * np.hypot(*SHIFT[:2]))


def test_vertical_shift_matches_jax(pair):
    ref, tba = pair
    for kw in ({}, dict(subsample=0.5), dict(vshift_reduc_func=np.mean)):
        j = jcoreg.VerticalShift(**kw).fit(ref, tba, transform=JAX_TRANSFORM, random_state=9)
        p = coreg.VerticalShift(**kw).fit(ref, tba, transform=TRANSFORM, random_state=9)
        assert p.meta["outputs"]["affine"]["shift_z"] == pytest.approx(j.meta["outputs"]["affine"]["shift_z"], abs=1e-6)
        assert p.meta["outputs"]["random"] == j.meta["outputs"]["random"]


def test_geographic_and_unported_crs_raise(pair):
    ref, tba = pair
    with pytest.raises(NotImplementedError, match="projected"):
        coreg.NuthKaab().fit(ref, tba, transform=TRANSFORM, crs=4326)
    # A PROJ string goes through the CRS engine: a geographic one meets the same guard, as in
    # xdem_tpu; what is no CRS at all raises CRS's error.
    with pytest.raises(NotImplementedError, match="projected"):
        coreg.NuthKaab().fit(ref, tba, transform=TRANSFORM, crs="+proj=longlat")
    with pytest.raises(NotImplementedError, match="projected"):
        jcoreg.NuthKaab().fit(ref, tba, transform=JAX_TRANSFORM, crs="+proj=longlat")
    with pytest.raises(TypeError, match="Cannot build a CRS"):
        coreg.NuthKaab().fit(ref, tba, transform=TRANSFORM, crs=3.5)


@pytest.mark.parametrize("kwargs,err", [
    (dict(), ValueError),
    (dict(transform=TRANSFORM, weights=np.ones(3)), NotImplementedError),
    (dict(transform=TRANSFORM, mesh=make_mesh(devices=[torch.device("cpu")] * 4)), None),
    (dict(transform=TRANSFORM, bias_vars={"x": np.ones((256, 256), np.float32)}), None),
])
def test_fit_refuses_what_is_not_ported(pair, kwargs, err):
    """What is not ported raises; bias_vars= is ported, and an affine method ignores it as
    xdem_tpu does; mesh= is ported, and the sharded fit is the single-device fit to the bit."""
    ref, tba = pair
    if err is None:
        got = coreg.NuthKaab().fit(ref, tba, random_state=42, **kwargs).to_translations()
        jkw = {k: v for k, v in kwargs.items() if k != "mesh"}
        want = jcoreg.NuthKaab().fit(ref, tba, random_state=42, **dict(jkw, transform=JAX_TRANSFORM))
        np.testing.assert_allclose(got[:2], want.to_translations()[:2], rtol=0.01)
        if "mesh" in kwargs:
            one = coreg.NuthKaab().fit(ref, tba, random_state=42, transform=TRANSFORM).to_translations()
            np.testing.assert_array_equal(got, one)
    else:
        with pytest.raises(err):
            coreg.NuthKaab().fit(ref, tba, **kwargs)
    with pytest.raises(NotImplementedError, match="2-D"):
        coreg.NuthKaab().fit(ref[None], tba, transform=TRANSFORM)


# ------------------------------------------------------------------ matrices and apply


def test_matrix_toolbox_matches_jax():
    m = coreg.matrix_from_translations_rotations(1.5, -2.0, 3.0, 2.0, -1.0, 0.5)
    np.testing.assert_array_equal(m, jbase.matrix_from_translations_rotations(1.5, -2.0, 3.0, 2.0, -1.0, 0.5))
    assert coreg.translations_rotations_from_matrix(m) == jbase.translations_rotations_from_matrix(m)
    np.testing.assert_array_equal(coreg.invert_matrix(m), jbase.invert_matrix(m))
    bad = np.eye(4)
    bad[0, 0] = 2.0
    with pytest.raises(ValueError, match="orthogonal"):
        base._check_matrix(bad)


def test_apply_matrix_translation_tiers(pair):
    ref, _ = pair
    t = TRANSFORM
    z, tr = coreg.apply_matrix(ref, coreg.matrix_from_translations_rotations(t_z=5.0), transform=t)
    assert tr == t and float((z - torch.from_numpy(ref)).abs().sub(5.0).abs().max()) < 1e-4
    _, tr = coreg.apply_matrix(ref, coreg.matrix_from_translations_rotations(40.0, -20.0, 2.0),
                               transform=t, resample=False)
    assert (tr.c, tr.f) == (t.c + 40.0, t.f - 20.0)
    want = jbase.apply_matrix(ref, jbase.matrix_from_translations_rotations(10.0, 6.0, 1.0),
                              transform=JAX_TRANSFORM)
    got = coreg.apply_matrix(ref, coreg.matrix_from_translations_rotations(10.0, 6.0, 1.0), transform=t)
    assert tuple(got[1]) == tuple(want[1])
    g, w = to_np(got[0]), np.asarray(want[0])
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-6, atol=1e-4)
    # A rotation goes to the regrid tiers, as in xdem_tpu (about the grid's centre, so the
    # heights stay small enough for a 1e-3 m bound in float32).
    rot, c = coreg.matrix_from_translations_rotations(alpha=1.0), (t.c + 128 * RES, t.f - 128 * RES, 0.0)
    g = to_np(coreg.apply_matrix(ref, rot, centroid=c, transform=t)[0])
    w = np.asarray(jbase.apply_matrix(ref, rot, centroid=c, transform=JAX_TRANSFORM)[0])
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=0, atol=1e-3)


# ------------------------------------------------------------------ fitted state


def test_jax_save_loads_into_port_and_applies_the_same(pair, jax_nk, tmp_path):
    ref, tba = pair
    path = tmp_path / "nk.pkl"
    jax_nk.save(str(path))
    loaded = coreg.Coreg.load(str(path))
    assert type(loaded) is coreg.NuthKaab
    assert loaded.meta["outputs"] == jax_nk.meta["outputs"]
    assert loaded.meta["inputs"]["fitorbin"]["bin_statistic"] is np.nanmedian
    np.testing.assert_array_equal(loaded.to_matrix(), jax_nk.to_matrix())
    want, want_t = jax_nk.apply(tba, transform=JAX_TRANSFORM)
    got, got_t = loaded.apply(tba, transform=TRANSFORM)
    assert tuple(got_t) == tuple(want_t)
    g, w = to_np(got), np.asarray(want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=1e-6, atol=1e-4)


def test_vertical_shift_state_round_trips(pair, tmp_path):
    ref, tba = pair
    j = jcoreg.VerticalShift(vshift_reduc_func=np.nanmedian).fit(ref, tba, transform=JAX_TRANSFORM)
    j.save(str(tmp_path / "vs.pkl"))
    p = coreg.Coreg.load(str(tmp_path / "vs.pkl"))
    assert type(p) is coreg.VerticalShift
    assert p.meta["inputs"]["affine"]["vshift_reduc_func"] is np.nanmedian
    p.save(str(tmp_path / "vs2.pkl"))
    again = coreg.Coreg.load(str(tmp_path / "vs2.pkl"))
    assert again.meta == p.meta and again._fit_called
    fm = coreg.VerticalShift.from_meta(j.meta)
    assert fm.to_matrix()[2, 3] == pytest.approx(j.to_matrix()[2, 3])


def test_load_refuses_foreign_callables_and_code(tmp_path):
    meta = {"inputs": {"affine": {"vshift_reduc_func": {"__callable__": "xdem_tpu.ops.reductions.nmad"}}},
            "outputs": {"affine": {"shift_z": 1.0}}}
    path = tmp_path / "a.pkl"
    path.write_bytes(pickle.dumps({"class": "VerticalShift", "meta": meta, "fit_called": True}))
    loaded = coreg.Coreg.load(str(path))
    assert loaded.meta["inputs"]["affine"]["vshift_reduc_func"] is None
    path.write_bytes(pickle.dumps({"class": "BlockwiseNuthKaab", "meta": meta, "fit_called": True}))
    with pytest.raises(NotImplementedError, match="BlockwiseNuthKaab"):
        coreg.Coreg.load(str(path))
    path.write_bytes(pickle.dumps({"class": "VerticalShift", "meta": {"x": jcoreg.VerticalShift}, "fit_called": True}))
    with pytest.raises(pickle.UnpicklingError, match="Refusing"):
        coreg.Coreg.load(str(path))
