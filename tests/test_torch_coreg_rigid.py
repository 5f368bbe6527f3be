"""The port's rigid coregistration (DhMinimize, ICP, CPD, LZD), the rotation tiers of
apply_matrix and the three repaired faults of Coreg, against xdem_tpu on a seeded 256^2 pair.

Both packages draw the same numpy subsample, so the fits are held tightly: matrices within
1e-4 of their largest entry, and equal iteration counts when the solver loops are fed
identical inputs. One count differs by design: xdem_tpu's Nelder-Mead is one jitted XLA
program, which contracts the simplex arithmetic (a * b + c into fused multiply-adds), and
on this pair it takes 51 iterations where the port, like xdem_tpu with jit disabled, takes
41. The port is held to the unjitted reference exactly and to the jitted one at 1 % of the
shift (bench.py's coreg bound). Applies: <= 1e-3 m on the finite pixels, identical NaN masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.spatial
import torch
from torch_port_helpers import to_np

from xdem_tpu import coreg as jcoreg
from xdem_tpu import examples
from xdem_tpu.coreg import affine as jaffine
from xdem_tpu.coreg import base as jbase
from xdem_tpu.georef import Affine as JaxAffine
from xdem_tpu_torch import coreg
from xdem_tpu_torch.coreg import affine, base
from xdem_tpu_torch.georef import Affine

RES = 20.0
N = 256
ORIGIN = (5e5, 8e6, RES, RES)
TRANSFORM = Affine.from_origin(*ORIGIN)
JAX_TRANSFORM = JaxAffine.from_origin(*ORIGIN)
TRUTH = (20, 5, 0.1, 0.1, 0.05, 0.01)  # tx, ty, tz (m), rotations about x, y, z (degrees)
SUB = 20000


def _matrix_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (got, want)


def _apply_close(got, want, atol=1e-3):
    g, w = to_np(got), np.asarray(want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """A spectral DEM and the same moved by TRUTH about its lower-left corner at the mean
    height (xdem_tpu's tier 3), with a NaN hole in the moved copy."""
    ref = examples.synthetic_dem_array(shape=(N, N), resolution=RES, seed=4)
    c1 = (ORIGIN[0], ORIGIN[1] - N * RES, float(np.nanmean(ref)))
    tba = np.asarray(jbase.apply_matrix(ref, jbase.matrix_from_translations_rotations(*TRUTH), centroid=c1,
                                        transform=JAX_TRANSFORM)[0]).astype(np.float32)
    tba[100:110, 30:60] = np.nan
    return ref, tba


def _fit_both(name, pair, **kw):
    ref, tba = pair
    fit_kw = dict(random_state=42, subsample=kw.pop("subsample", SUB))
    j = getattr(jcoreg, name)(**kw).fit(ref, tba, transform=JAX_TRANSFORM, **fit_kw)
    p = getattr(coreg, name)(**kw).fit(ref, tba, transform=TRANSFORM, **fit_kw)
    return j, p


def _count_kdtree_queries(monkeypatch):
    calls = []
    query = scipy.spatial.KDTree.query

    def counted(self, *a, **k):
        calls.append(1)
        return query(self, *a, **k)

    monkeypatch.setattr(scipy.spatial.KDTree, "query", counted)
    return calls


# ------------------------------------------------------------------ subsampling


SUBSAMPLE_CASES = {
    "unmasked": dict(),
    "masked": dict(mask="array"),
    "host aux": dict(aux="host"),
    "callable aux": dict(aux="callable"),
    "every pixel": dict(mask="array", subsample=1.0),
    "tensor mask": dict(mask="tensor"),
}


@pytest.mark.parametrize("seed", ["int", "numpy int", "generator"])
def test_a_repeated_draw_picks_numpys_pixels(seed):
    """Drawing twice over as many valid entries with one integer seed reuses the first
    choice (one numpy draw), and each draw is numpy's choice over the valid positions; a
    Generator is drawn from anew each time."""
    rng = np.random.default_rng(4)
    valid = torch.from_numpy(rng.random(30000) < 0.7)
    idx = np.flatnonzero(valid.numpy())
    make = {"int": lambda: 11, "numpy int": lambda: np.int64(11), "generator": lambda: np.random.default_rng(11)}[seed]
    affine._choice.cache_clear()
    first, count = affine._draw_valid(valid, 5000, make())
    again, _ = affine._draw_valid(valid, 5000, make())
    want = idx[np.random.default_rng(11).choice(len(idx), 5000, replace=False)]
    assert count == 5000
    np.testing.assert_array_equal(first.numpy(), want)
    np.testing.assert_array_equal(again.numpy(), want)
    info = affine._choice.cache_info()
    assert (info.misses, info.hits) == ((0, 0) if seed == "generator" else (1, 1))


@pytest.mark.parametrize("case", list(SUBSAMPLE_CASES))
def test_subsample_pair_values_identical_to_jax(pair, case):
    """The port's grid draw picks xdem_tpu's pixels, in its order, with its values: an aux
    grid on the device or the host, or a function of (rows, cols) (xdem_tpu takes that
    function's float64 grid), and an inlier mask as a numpy array or a bool tensor."""
    ref, tba = pair
    kw = SUBSAMPLE_CASES[case]
    mask = None
    if "mask" in kw:
        mask = np.ones(ref.shape, bool)
        mask[:40] = False
        mask[200:, 100:120] = False
    given_mask = torch.from_numpy(mask) if kw.get("mask") == "tensor" else mask
    aux = np.array(jnp.gradient(jnp.asarray(ref))[0])
    if kw.get("aux") == "callable":
        aux = np.add.outer(np.arange(N) * 0.5, np.arange(N) * -0.25)
        want_aux, got_aux = aux, lambda rr, cc: rr * 0.5 - cc * 0.25
    elif kw.get("aux") == "host":
        want_aux = got_aux = aux
    else:
        want_aux, got_aux = jnp.asarray(aux), torch.from_numpy(aux)
    sub = kw.get("subsample", 5000)
    want = jaffine._subsample_pair_values(ref, tba, mask, JAX_TRANSFORM, sub, 7, aux_vars={"g": want_aux})
    got = affine._subsample_pair_values(torch.from_numpy(ref), torch.from_numpy(tba), given_mask, TRANSFORM, sub, 7,
                                        aux_vars={"g": got_aux})
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[4]["g"], want[4]["g"])
    sub = kw.get("subsample", 0.3)
    sj = jaffine._subsample_pair(ref, tba, mask, JAX_TRANSFORM, sub, 7, aux_vars={"g": want_aux})
    sp = affine._subsample_pair(torch.from_numpy(ref), torch.from_numpy(tba), given_mask, TRANSFORM, sub, 7,
                                aux_vars={"g": got_aux})
    assert sp["count"] == sj["count"]
    for k in ("pts_z", "rows", "cols"):
        np.testing.assert_array_equal(to_np(sp[k]), sj[k])
    np.testing.assert_array_equal(sp["aux"]["g"], np.asarray(sj["aux"]["g"]))
    if case == "every pixel":
        valid = np.isfinite(ref) & np.isfinite(tba) & mask
        assert sp["count"] == valid.sum()
        np.testing.assert_array_equal(to_np(sp["rows"]), np.nonzero(valid)[0])


def test_standardize_and_point_helpers_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(3, 500)) * 100, rng.normal(size=(3, 500)) * 100
    for g, w in zip(affine._standardize_epc(a, b), jaffine._standardize_epc(a, b)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    m = coreg.matrix_from_translations_rotations(3, -2, 1, 0.4, 0.2, -0.3)
    np.testing.assert_array_equal(affine._apply_matrix_pts_mat(a, m, invert=True),
                                  jaffine._apply_matrix_pts_mat(a, m, invert=True))
    got = base._apply_matrix_pts_arr(a[0], a[1], a[2], m, centroid=(1.0, 2.0, 3.0))
    want = jbase._apply_matrix_pts_arr(a[0], a[1], a[2], m, centroid=(1.0, 2.0, 3.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ DhMinimize


def test_dh_minimize_solver_matches_jax(pair):
    ref, tba = pair
    sub = jaffine._subsample_pair(ref, tba, None, JAX_TRANSFORM, 5000, 3)
    args = [sub["pts_z"], sub["rows"], sub["cols"], np.array(sub["raster"])]
    got = affine._dh_minimize_nm_device(*(torch.from_numpy(np.array(a)) for a in args), RES, RES, False)
    with jax.disable_jit():
        eager = jaffine._dh_minimize_nm_device(*(jnp.asarray(a) for a in args), RES, RES, False)
    assert got[2] == int(eager[2])
    np.testing.assert_allclose(to_np(got[0]), np.asarray(eager[0]), rtol=1e-4)
    assert float(got[3]) == pytest.approx(float(eager[3]), abs=1e-4)
    jitted = jaffine._dh_minimize_nm_device(*(jnp.asarray(a) for a in args), RES, RES, False)
    np.testing.assert_allclose(to_np(got[0]), np.asarray(jitted[0]), rtol=0.01)


def test_dh_minimize_fit_matches_jax(pair):
    j, p = _fit_both("DhMinimize", pair)
    assert p.meta["outputs"]["random"] == j.meta["outputs"]["random"]
    for k in ("shift_x", "shift_y", "shift_z"):
        assert p.meta["outputs"]["affine"][k] == pytest.approx(j.meta["outputs"]["affine"][k], rel=0.01)


def test_dh_minimize_host_minimizer_matches_jax(pair):
    from scipy.optimize import minimize

    j, p = _fit_both("DhMinimize", pair, fit_minimizer=minimize, subsample=3000)
    for k in ("shift_x", "shift_y", "shift_z"):
        assert p.meta["outputs"]["affine"][k] == pytest.approx(j.meta["outputs"]["affine"][k], rel=1e-3, abs=1e-3)


# ------------------------------------------------------------------ ICP


@pytest.mark.parametrize("method", ["point-to-plane", "point-to-point"])
def test_icp_kdtree_matches_jax(pair, method, monkeypatch):
    calls = _count_kdtree_queries(monkeypatch)
    j = jcoreg.ICP(method=method, nn_method="kdtree").fit(pair[0], pair[1], transform=JAX_TRANSFORM,
                                                           random_state=42, subsample=SUB)
    n_jax = len(calls)
    p = coreg.ICP(method=method, nn_method="kdtree").fit(pair[0], pair[1], transform=TRANSFORM,
                                                         random_state=42, subsample=SUB)
    assert len(calls) - n_jax == n_jax
    _matrix_close(p.to_matrix(), j.to_matrix())
    assert p.meta["outputs"]["affine"]["centroid"] == j.meta["outputs"]["affine"]["centroid"]
    assert p.meta["outputs"]["random"] == j.meta["outputs"]["random"]


@pytest.mark.parametrize("picky", [True, False])
def test_icp_brute_solver_matches_jax(pair, picky):
    ref, tba = pair
    norms = [np.array(v) for v in jaffine._icp_norms(ref, JAX_TRANSFORM)]
    pn = affine._icp_norms_device(torch.from_numpy(ref), RES, RES)
    for g, w in zip(pn, norms):
        np.testing.assert_allclose(to_np(g), w, rtol=1e-5, atol=1e-6)
    sr, st, x, y, aux = jaffine._subsample_pair_values(
        ref, tba, None, JAX_TRANSFORM, 3000, 5, aux_vars={k: jnp.asarray(v) for k, v in zip("xyz", norms)})
    r, t, _, _ = jaffine._standardize_epc(np.vstack((x, y, sr)), np.vstack((x, y, st)))
    args = [r.T.astype(np.float32), t.T.astype(np.float32), np.stack([aux[k] for k in "xyz"], 1).astype(np.float32)]
    want = jaffine._icp_solve_device(*(jnp.asarray(a) for a in args), np.float32(1e-4), 20, picky=picky)
    got = affine._icp_solve_device(*(torch.from_numpy(a) for a in args), np.float32(1e-4), 20, picky=picky)
    assert got[1] == int(want[1])
    _matrix_close(to_np(got[0]), np.asarray(want[0]))


def test_icp_brute_fit_matches_jax(pair):
    j, p = _fit_both("ICP", pair, nn_method="brute", subsample=3000)
    _matrix_close(p.to_matrix(), j.to_matrix())


def test_brute_nearest_ties_and_matches_kdtree():
    """Coordinates on a 1/8 lattice keep every squared distance exact in float32, so the
    brute search and the float64 KD-tree see the same distances; where they pick different
    points, the two are at exactly the same distance and the brute pick is the lower index."""
    rng = np.random.default_rng(0)
    ref = (rng.integers(0, 800, (5000, 3)) / 8).astype(np.float32)
    ref[4000] = ref[17]  # a duplicated point
    q = (rng.integers(0, 800, (3000, 3)) / 8).astype(np.float32)
    q[0] = ref[17]
    idx, dist = affine._brute_nearest(torch.from_numpy(ref), torch.from_numpy(q))
    idx, dist = to_np(idx), to_np(dist)
    want_d, want_i = scipy.spatial.KDTree(ref.astype(np.float64)).query(q.astype(np.float64))
    assert idx[0] == 17 and dist[0] == 0.0
    np.testing.assert_allclose(dist, want_d, rtol=1e-6)
    differ = idx != want_i
    assert np.all(idx[differ] < want_i[differ])
    jidx, _ = jaffine._brute_nearest(jnp.asarray(ref), jnp.asarray(q), chunk=1024)
    np.testing.assert_array_equal(idx, np.asarray(jidx))


@pytest.mark.parametrize("rblk", [1, 7, 1024, 5000])
def test_the_aten_scan_does_not_depend_on_the_block_size(rblk):
    """The ATen scan gives the first of the least squared distances whatever its block size (one
    point, a ragged 7, a block that divides nothing, one block larger than the cloud): numpy's
    float32 distances in the same order and its argmin, index and bits. The card's kernel splits
    the reference cloud otherwise and relies on this."""
    rng = np.random.default_rng(21)  # integer points of a 21^3 lattice, half-integer queries: exact ties
    ref = rng.integers(0, 21, (2000, 3)).astype(np.float32)
    q = (rng.integers(0, 41, (600, 3)) / 2).astype(np.float32)
    idx, d2 = affine._nn_scan_aten(torch.from_numpy(ref), rblk=rblk)(torch.from_numpy(q))
    diff = q[:, None, :] - ref[None, :, :]
    sq = diff * diff
    want_all = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    want_i = want_all.argmin(axis=1)
    want_d = want_all[np.arange(len(q)), want_i]
    assert idx.dtype == torch.int64 and d2.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(d2.numpy().view(np.int32), want_d.view(np.int32))
    assert (want_all == want_d[:, None]).sum(axis=1).max() > 1  # ties were there to break


def test_picky_matches_pandas_idxmin():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(3)
    ind = rng.integers(0, 50, 400)
    dists = np.round(rng.uniform(0, 5, 400), 1)  # ties
    want = pd.DataFrame({"ind": ind, "dists": dists}).groupby("ind")["dists"].idxmin().values
    np.testing.assert_array_equal(affine._picky_first_per_match(ind, dists), want)


def test_icp_auto_is_kdtree_on_the_cpu_and_brute_refuses_callables(pair):
    from scipy.optimize import least_squares

    ref, tba = pair
    with pytest.raises(ValueError, match="host"):
        coreg.ICP(nn_method="brute", fit_minimizer=least_squares).fit(ref, tba, transform=TRANSFORM)
    j, p = _fit_both("ICP", pair, fit_minimizer=least_squares, subsample=2000, max_iterations=3)
    _matrix_close(p.to_matrix(), j.to_matrix(), rel=1e-3)


# ------------------------------------------------------------------ CPD and LZD


def test_cpd_matches_jax(pair):
    """The default fit reaches the float32 noise floor of the EM objective q (|dq| ~ 1e-2
    against a tolerance of 0.01 / std_fac = 7e-6 on this pair), so its stop is decided by
    rounding: xdem_tpu runs all 100 iterations and the port stops at 13, when two values
    of q happen to be equal. R and t have converged long before, so the matrices agree to
    1e-4. The iteration counts are held equal at a tolerance the EM meets before the noise
    floor (1.0 in standardised units: 11 iterations in both)."""
    ref, tba = pair
    j, p = _fit_both("CPD", pair, subsample=500)
    _matrix_close(p.to_matrix(), j.to_matrix())
    sr, st, x, y, _ = jaffine._subsample_pair_values(ref, tba, None, JAX_TRANSFORM, 500, 42)
    r, t, _, fac = jaffine._standardize_epc(np.vstack((x, y, sr)), np.vstack((x, y, st)))
    X, Y = r.T.astype(np.float32), t.T.astype(np.float32)
    diff2 = float(np.mean(np.sum(Y * Y, 1)) + np.mean(np.sum(X * X, 1)) - 2 * np.mean(Y @ X.mean(0)))
    want = jaffine._cpd_solve(jnp.asarray(X), jnp.asarray(Y), 0.0, diff2, 0.001 / fac, 1.0, 100, False)
    got = affine._cpd_solve(torch.from_numpy(X), torch.from_numpy(Y), 0.0, diff2, 0.001 / fac, 1.0, 100, False)
    assert got[2] == int(want[2]) < 100 and got[3] == bool(want[3])
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]), atol=1e-5)


@pytest.mark.parametrize("only_translation", [False, True])
def test_lzd_matches_jax(pair, only_translation):
    ref, tba = pair
    j, p = _fit_both("LZD", pair, only_translation=only_translation)
    _matrix_close(p.to_matrix(), j.to_matrix())
    assert p.meta["outputs"]["affine"]["centroid"] == j.meta["outputs"]["affine"]["centroid"]
    gy, gx = np.gradient(ref)
    rng = np.random.default_rng(0)
    pts = [rng.uniform(-2000, 2000, 4000).astype(np.float32) for _ in range(2)]
    pts.append(rng.uniform(-50, 50, 4000).astype(np.float32))
    pts[2][:7] = np.nan
    inv = [1 / RES, 0.0, 127.5, 0.0, -1 / RES, 127.5]
    grids = [ref, (gx / RES).astype(np.float32), (-gy / RES).astype(np.float32)]
    want = jaffine._lzd_solve_device(*(jnp.asarray(g) for g in grids), *(jnp.asarray(v) for v in pts),
                                     jnp.float32(600.0), jnp.asarray(np.float32(inv)), jnp.float32(0.001), 200,
                                     only_translation=only_translation)
    got = affine._lzd_solve_device(*(torch.from_numpy(np.ascontiguousarray(g)) for g in grids),
                                   *(torch.from_numpy(v) for v in pts), 600.0, inv, 0.001, 200,
                                   only_translation=only_translation)
    assert got[1] == int(want[1]) and got[3] == float(want[3])
    _matrix_close(to_np(got[0]), np.asarray(want[0]))


def test_rigid_recovery_and_apply(pair):
    """LZD recovers the truth re-expressed about its own centroid, and its apply removes
    most of the dh variance (the checks of the rigid-recovery tests of xdem_tpu)."""
    ref, tba = pair
    c = coreg.LZD()
    out, tr = c.fit_and_apply(ref, tba, transform=TRANSFORM, subsample=SUB, random_state=42)
    assert tr == TRANSFORM
    c1 = (ORIGIN[0], ORIGIN[1] - N * RES, float(np.nanmean(ref)))
    c2 = c.meta["outputs"]["affine"]["centroid"]
    M = coreg.matrix_from_translations_rotations(*TRUTH)
    d = np.asarray(c1) - np.asarray(c2)
    M[:3, 3] = M[:3, 3] + d - M[:3, :3] @ d
    got = coreg.translations_rotations_from_matrix(coreg.invert_matrix(c.to_matrix()))
    want = coreg.translations_rotations_from_matrix(M)
    np.testing.assert_allclose(got[:3], want[:3], atol=1.0)
    np.testing.assert_allclose(got[3:], want[3:], atol=5e-3)
    assert np.nanvar((ref - to_np(out)) / np.nanstd(ref - tba)) < 0.05


# ------------------------------------------------------------------ apply_matrix rotation tiers


@pytest.mark.parametrize("case", ["tier3", "tier3_no_centroid", "tier3_forced_translation", "tier4"])
def test_apply_matrix_rotation_tiers_match_jax(pair, case):
    ref, _ = pair
    ref = ref.copy()
    ref[60:64, 70:90] = np.nan
    kw = {}
    if case == "tier3":
        m, kw = coreg.matrix_from_translations_rotations(*TRUTH), dict(centroid=(5.001e5, 7.996e6, 500.0))
    elif case == "tier3_no_centroid":
        m = coreg.matrix_from_translations_rotations(-30, 12, 2, 0.3, -0.2, 0.4)
    elif case == "tier3_forced_translation":
        m, kw = coreg.matrix_from_translations_rotations(15, -7, 1), dict(force_regrid_method="iterative")
    else:
        m = coreg.matrix_from_translations_rotations(5, 5, 0, 25.0, 0.0, 3.0)
    want, wt = jbase.apply_matrix(ref, m, transform=JAX_TRANSFORM, **kw)
    got, gt = coreg.apply_matrix(ref, m, transform=TRANSFORM, **kw)
    assert tuple(gt) == tuple(wt) and got.dtype == torch.float32
    _apply_close(got, want)


def test_apply_matrix_refuses_point_clouds():
    """Point clouds are ported: an EPC is moved in float64 as xdem_tpu moves it (1e-6 m); a
    1-D array, which is neither a grid nor a point cloud, is refused."""
    from xdem_tpu import epc as jepc
    from xdem_tpu_torch import EPC

    rng = np.random.default_rng(0)
    x, y, z = 5e5 + rng.uniform(0, 5e3, 500), 8e6 - rng.uniform(0, 5e3, 500), rng.uniform(0, 900, 500)
    m = coreg.matrix_from_translations_rotations(*TRUTH)
    got = coreg.apply_matrix(EPC(x=x, y=y, z=z, crs=32633), m, centroid=(5e5, 8e6, 400.0))
    want = jbase.apply_matrix(jepc.EPC(x=x, y=y, z=z, crs=32633), m, centroid=(5e5, 8e6, 400.0))
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(to_np(getattr(got, k)), getattr(want, k), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="point cloud, a data frame or a 2-D grid"):
        coreg.apply_matrix(np.zeros((10, 3)).ravel(), np.eye(4), transform=TRANSFORM)


# ------------------------------------------------------------------ repaired faults of Coreg


def test_fault1_initial_shift_is_added_to_a_fitted_matrix(pair):
    """Coreg.fit re-adds the initial shift to a fitted matrix, not only to shift_x/y/z."""
    ref, tba = pair
    kw = dict(initial_shift=(10.0, -5.0), subsample=SUB)
    j = jcoreg.LZD(**kw).fit(ref, tba, transform=JAX_TRANSFORM, crs=32633, random_state=42)
    p = coreg.LZD(**kw).fit(ref, tba, transform=TRANSFORM, crs=32633, random_state=42)
    aff = p.meta["outputs"]["affine"]
    # shift_x/y got the initial shift back; so must the matrix they are read from.
    assert aff["matrix"][0, 3] == pytest.approx(aff["shift_x"], abs=1e-9)
    assert aff["matrix"][1, 3] == pytest.approx(aff["shift_y"], abs=1e-9)
    _matrix_close(p.to_matrix(), j.to_matrix())


def test_fault2_apply_uses_the_fitted_centroid(pair):
    """Coreg.apply's matrix fallback applies the rotation about the fitted centroid."""
    ref, _ = pair
    m = coreg.matrix_from_translations_rotations(3.0, -2.0, 1.0, 0.2, -0.1, 0.3)
    centroid = (5.02e5, 7.997e6, 480.0)
    j = jcoreg.AffineCoreg(matrix=m)
    j._meta["outputs"]["affine"]["centroid"] = centroid
    p = coreg.AffineCoreg(matrix=m)
    p._meta["outputs"]["affine"]["centroid"] = centroid
    got, _ = p.apply(ref, transform=TRANSFORM)
    _apply_close(got, j.apply(ref, transform=JAX_TRANSFORM)[0])
    _apply_close(got, coreg.apply_matrix(ref, m, centroid=centroid, transform=TRANSFORM)[0], atol=0)
    about_origin = to_np(coreg.apply_matrix(ref, m, transform=TRANSFORM)[0])
    assert np.isfinite(to_np(got)).mean() > 0.9 and np.isfinite(about_origin).mean() < 0.1


def test_fault3_bias_vars_add_and_pipeline_states(pair, tmp_path):
    """fit/apply take bias_vars=, `+` composes a pipeline, and Coreg.load reads pipelines."""
    ref, tba = pair
    var = np.linspace(-1, 1, ref.size, dtype=np.float32).reshape(ref.shape)
    kw = dict(bias_vars={"v": var}, transform=TRANSFORM, random_state=1)
    bc = coreg.BiasCorr(bias_var_names=["v"], subsample=5000).fit(ref, ref - 2.0 * var, **kw)
    out, _ = bc.apply(ref, **kw)
    assert float(np.nanmax(np.abs(to_np(out) - ref - 2.0 * var))) < 1e-3
    pipe = coreg.VerticalShift() + coreg.DhMinimize(subsample=3000)
    assert isinstance(pipe, coreg.CoregPipeline) and [type(s) for s in pipe] == [coreg.VerticalShift, coreg.DhMinimize]
    jpipe = jcoreg.VerticalShift() + jcoreg.DhMinimize(subsample=3000)
    jpipe.fit(ref, tba, transform=JAX_TRANSFORM, random_state=2)
    jpipe.save(str(tmp_path / "pipe.pkl"))
    loaded = coreg.Coreg.load(str(tmp_path / "pipe.pkl"))
    assert isinstance(loaded, coreg.CoregPipeline) and loaded._fit_called
    np.testing.assert_array_equal(loaded.to_matrix(), jpipe.to_matrix())
    _apply_close(loaded.apply(tba, transform=TRANSFORM)[0], jpipe.apply(tba, transform=JAX_TRANSFORM)[0])


# ------------------------------------------------------------------ states saved by xdem_tpu


@pytest.mark.parametrize("name,kw", [("DhMinimize", dict(subsample=3000)), ("ICP", dict(subsample=3000)),
                                     ("CPD", dict(subsample=300)), ("LZD", dict(subsample=5000))])
def test_jax_saved_rigid_states_load_and_apply(pair, tmp_path, name, kw):
    ref, tba = pair
    j = getattr(jcoreg, name)(**kw).fit(ref, tba, transform=JAX_TRANSFORM, random_state=5)
    j.save(str(tmp_path / "s.pkl"))
    p = coreg.Coreg.load(str(tmp_path / "s.pkl"))
    assert type(p) is getattr(coreg, name) and p._fit_called
    np.testing.assert_array_equal(p.to_matrix(), j.to_matrix())
    _apply_close(p.apply(tba, transform=TRANSFORM)[0], j.apply(tba, transform=JAX_TRANSFORM)[0])
    p.save(str(tmp_path / "again.pkl"))
    again = coreg.Coreg.load(str(tmp_path / "again.pkl"))
    np.testing.assert_array_equal(again.to_matrix(), p.to_matrix())
