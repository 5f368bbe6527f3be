"""Blockwise coregistration of xdem_tpu_torch against xdem_tpu's and a float64 oracle.

- The batched Nuth & Kääb solve: with xdem_tpu's per-tile picks injected, the tile shifts
  equal xdem_tpu's vmapped ones within 5e-4 m (1e-4 of the shift: the two compilers round
  float32 differently), and every tile's shift equals the port's own
  single-tile solve on that tile within 1e-5 px with the same number of iterations (tiles
  stop after 3, 4 or 5 steps, one tile has fewer valid pixels than picks and one none). The
  pair is a spectral DEM with 40 m of 0.4-0.5 km relief added, moved by (0.23, -0.31) px, so
  that every tile converges: a tile that oscillates without converging (a 2.5 km crop of one
  hillside) amplifies the last-bit differences between a matrix-vector and a batched matrix
  product, the one place where the two solves round differently.
- The RANSAC: this package's own (numpy, RANSACRegressor's rules) against xdem_tpu's
  (scikit-learn) on a plane with noise and 10 % gross outliers, to 1e-9 of the coefficients'
  magnitude (both find the same consensus set), and every small-sample branch.
- The warp: apply against a float64 oracle (numpy coordinates, scipy's order-1
  map_coordinates) within 1e-5 of the mean magnitude; against xdem_tpu within the bound its
  float32 coordinates allow (derived in the test); apply_tiled read back equal to apply.
- The generic BlockwiseCoreg(NuthKaab()) per-tile loop against xdem_tpu's, each tile's
  subsample holding all its valid pixels (so the draw is the same set in both).
"""

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap, shared setup)
from scipy.ndimage import map_coordinates
from scipy.ndimage import shift as nd_shift

import jax
import jax.numpy as jnp
import xdem_tpu
from xdem_tpu import coreg as jcoreg
from xdem_tpu.coreg import affine as jaffine
from xdem_tpu.coreg import blockwise as jblockwise
from xdem_tpu_torch import DEM, coreg
from xdem_tpu_torch.coreg import affine, blockwise
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.io import read_raster
from xdem_tpu_torch.parallel import make_mesh

RES = 20.0
ORIGIN = (502810.0, 8674030.0)  # the examples' upper-left corner: float32 northings round to 1 m
N, BS, K = 512, 128, 4000
SHIFT_PX = (0.23, -0.31)  # (rows, cols) the to-be-aligned terrain moved by
VSHIFT = 1.5


@pytest.fixture(scope="module")
def arrays():
    from xdem_tpu import examples as jex

    ref = jex.synthetic_dem_array(shape=(N, N), resolution=RES, seed=11).astype(np.float64)
    rr, cc = np.mgrid[0:N, 0:N]
    ref = ref + 40 * np.sin(2 * np.pi * cc / 23) * np.sin(2 * np.pi * rr / 17)
    tba = nd_shift(ref, SHIFT_PX, order=3, mode="nearest") + VSHIFT
    ref, tba = ref.astype(np.float32), tba.astype(np.float32)
    tba[0:128, 128:228] = np.nan  # tile (0, 1): 3584 valid pixels, fewer than K picks
    tba[256:384, 384:512] = np.nan  # tile (2, 3): none, gated as empty
    tba[400:405, 20:30] = np.nan
    return ref, tba


@pytest.fixture(scope="module")
def dems(arrays):
    ref, tba = arrays
    t = Affine.from_origin(*ORIGIN, RES, RES)
    jt = xdem_tpu.georef.Affine.from_origin(*ORIGIN, RES, RES)
    return (DEM.from_array(ref, t, 32633), DEM.from_array(tba, t, 32633)), \
        (xdem_tpu.DEM.from_array(ref, jt, 32633), xdem_tpu.DEM.from_array(tba, jt, 32633))


def _jax_picks(jref, jtba, seed):
    """xdem_tpu's per-tile picks: its valid mask and its split keys, as its fused program
    draws them."""
    _, _, valid = jaffine._nk_slope_aspect_valid(jnp.asarray(jref.data), jnp.asarray(jtba.data),
                                                 jnp.ones(jref.shape, bool))
    n = N // BS
    vt = np.asarray(valid).reshape(n, BS, n, BS).transpose(0, 2, 1, 3).reshape(n * n, -1)
    keys = jax.random.split(jax.random.PRNGKey(seed), n * n)
    idx, ok = jax.vmap(lambda k, v: jaffine._topk_subsample(k, v, K))(keys, jnp.asarray(vt))
    return torch.from_numpy(np.array(idx, np.int64)), torch.from_numpy(np.array(ok))


@pytest.fixture
def injected(dems, monkeypatch):
    (_, _), (jref, jtba) = dems
    idx, ok = _jax_picks(jref, jtba, 42)
    monkeypatch.setattr(blockwise, "_tile_picks", lambda valid, count, seed: (idx.to(valid.device), ok.to(valid.device)))


# ---------------------------------------------------------------------- the batched solve

def test_batched_solve_equals_the_single_tile_solve(dems, injected):
    (ref, tba), _ = dems
    n = N // BS
    inp = blockwise._blockwise_nuth_kaab_inputs(ref.data, tba.data, torch.ones((N, N), dtype=torch.bool), 42, BS, n,
                                                n, K)
    assert inp["n_valid"].tolist()[1] == 3584 < K and inp["n_valid"].tolist()[11] == 0
    assert int(torch.isnan(inp["pts_z"][1]).sum()) == K - 3584  # the overflow picks are poisoned
    sx, sy, vs, stat, it = affine._nuth_kaab_solve_batched(inp["pts_z"], inp["rows"], inp["cols"], inp["rasters"],
                                                           inp["slope_tan"], inp["aspect"], RES, RES, 0.001)
    assert len(set(it.tolist())) >= 3  # tiles stop at different steps: finished ones are frozen
    for t in range(n * n):
        s = affine._nuth_kaab_solve(inp["pts_z"][t], inp["rows"][t], inp["cols"][t], inp["rasters"][t],
                                    inp["slope_tan"][t], inp["aspect"][t], RES, RES, 0.001)
        assert s[4] == int(it[t]), t
        assert abs(s[0] - float(sx[t])) / RES <= 1e-5 and abs(s[1] - float(sy[t])) / RES <= 1e-5, (t, s, sx[t], sy[t])
        assert s[2] == pytest.approx(float(vs[t]), abs=1e-5) or (np.isnan(s[2]) and np.isnan(float(vs[t])))


def test_batched_solve_stops_at_max_iterations_and_takes_one_tile():
    g = torch.Generator().manual_seed(0)
    ras = torch.rand((1, 40, 40), generator=g) * 100
    rows, cols = torch.rand((1, 500), generator=g) * 30 + 5, torch.rand((1, 500), generator=g) * 30 + 5
    z = affine._interp_tiles(ras, rows, cols) + 1.0
    st, asp = torch.rand((1, 500), generator=g) + 0.1, torch.rand((1, 500), generator=g) * 6.28
    out = affine._nuth_kaab_solve_batched(z, rows, cols, ras, st, asp, RES, RES, 0.0, max_iterations=4)
    single = affine._nuth_kaab_solve(z[0], rows[0], cols[0], ras[0], st[0], asp[0], RES, RES, 0.0, max_iterations=4)
    assert int(out[4][0]) == single[4] == 4
    np.testing.assert_allclose([float(v[0]) for v in out[:3]], single[:3], rtol=1e-6, atol=1e-6)


def test_blockwise_nuth_kaab_matches_xdem_tpus_vmapped_fit(dems, injected):
    (ref, tba), (jref, jtba) = dems
    p = coreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=42).fit(ref, tba)
    j = jcoreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=42).fit(jref, jtba)
    for a in ("x_coords", "y_coords"):
        np.testing.assert_array_equal(getattr(p, a), getattr(j, a))
    for a in ("shifts_x", "shifts_y", "shifts_z"):
        got, want = getattr(p, a), getattr(j, a)
        assert np.array_equal(np.isnan(got), np.isnan(want)), a
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4, err_msg=a)
    assert np.isnan(p.shifts_x[11])  # the empty tile is gated
    # The sign flip: the fitted translations move the to-be-aligned terrain back.
    np.testing.assert_allclose(np.nanmedian(p.shifts_x), -SHIFT_PX[1] * RES, rtol=0.05)
    np.testing.assert_allclose(np.nanmedian(p.shifts_y), SHIFT_PX[0] * RES, rtol=0.05)
    np.testing.assert_allclose(np.nanmedian(p.shifts_z), -VSHIFT, rtol=0.05)  # ref - tba
    assert p.meta["outputs"]["0_1"]["shift_x"] == p.shifts_x[1] and p.meta["outputs"]["n_diverged"] == 0
    assert p.shape_tiling_grid == j.shape_tiling_grid == (4, 4)


def test_blockwise_nuth_kaab_own_draw_recovers_the_shift(dems):
    (ref, tba), _ = dems
    p = coreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=7).fit(ref, tba)
    np.testing.assert_allclose(np.nanmedian(p.shifts_x), -SHIFT_PX[1] * RES, rtol=0.05)
    np.testing.assert_allclose(np.nanmedian(p.shifts_y), SHIFT_PX[0] * RES, rtol=0.05)
    with pytest.raises(ValueError, match="smaller than block_size_fit"):
        coreg.BlockwiseNuthKaab(block_size_fit=1024).fit(ref, tba)
    # mesh= splits the tile axis over 8 CPU shards (padded with NaN tiles): tiles are
    # independent, so every tile's shift is the single-device one.
    q = coreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=7,
                                mesh=make_mesh(devices=[torch.device("cpu")] * 8)).fit(ref, tba)
    for k in ("shifts_x", "shifts_y", "shifts_z"):
        np.testing.assert_array_equal(getattr(q, k), getattr(p, k))


# ---------------------------------------------------------------------- RANSAC

def _plane_tiles(seed=0, n=20, outliers=0.1):
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(ORIGIN[0] + 500 * np.arange(n), ORIGIN[1] - 500 * np.arange(n))
    x, y = x.ravel(), y.ravel()
    z = 1e-4 * (x - ORIGIN[0]) + 2e-4 * (ORIGIN[1] - y) + 3.0 + rng.normal(0, 0.01, x.size)
    bad = rng.random(x.size) < outliers
    z[bad] += rng.choice([-1, 1], int(bad.sum())) * rng.uniform(2.5, 4.0, int(bad.sum()))
    z[::37] = np.nan
    return x, y, z


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_matches_scikit_learns(seed):
    x, y, z = _plane_tiles(seed)
    got = coreg.BlockwiseCoreg._ransac(x, y, z)
    want = jblockwise.BlockwiseCoreg._ransac(x, y, z)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(got[:2], (1e-4, -2e-4), rtol=0.05)


@pytest.mark.parametrize("case", ["all_nan", "few_tiles", "one_row", "one_column", "single_after_filter",
                                  "constant", "no_points"])
def test_ransac_small_sample_branches_match(case):
    x, y, z = _plane_tiles(3, n=4)
    if case == "all_nan":
        z[:] = np.nan
    elif case == "few_tiles":
        x, y, z = x[:5], y[:5], z[:5]
    elif case == "one_row":
        y = np.full_like(y, y[0])
    elif case == "one_column":
        x = np.full_like(x, x[0])
    elif case == "single_after_filter":
        x, y, z = x[:7], y[:7], np.array([1.0, np.nan, np.nan, np.nan, np.nan, np.nan, np.nan])
    elif case == "constant":
        z = np.full_like(z, 2.5)
    else:
        x = np.full_like(x, np.nan)
    if case == "no_points":
        for cls in (coreg.BlockwiseCoreg, jblockwise.BlockwiseCoreg):
            with pytest.raises(ValueError, match="No valid points"):
                cls._ransac(x, y, z)
        return
    got, want = coreg.BlockwiseCoreg._ransac(x, y, z), jblockwise.BlockwiseCoreg._ransac(x, y, z)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_gate_diverged_tiles_matches():
    rng = np.random.default_rng(0)
    for kw in (dict(), dict(shape=(1000, 1300), tiling=(2, 3))):
        sh = [rng.normal(0, 8000, 6) for _ in range(3)]
        ours, theirs = [s.copy() for s in sh], [s.copy() for s in sh]
        got = blockwise._gate_diverged_tiles(*ours, 500, RES, RES, **kw)
        want = jblockwise._gate_diverged_tiles(*theirs, 500, RES, RES, **kw)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- the warp

@pytest.fixture(scope="module")
def planes(dems):
    """A fitted blockwise object whose tile shifts lie on known planes (metres over km)."""
    (ref, tba), (jref, jtba) = dems
    p = coreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=1).fit(ref, tba)
    j = jcoreg.BlockwiseNuthKaab(block_size_fit=BS, subsample_per_tile=K, random_state=1).fit(jref, jtba)
    dx, dy = p.x_coords - ORIGIN[0], ORIGIN[1] - p.y_coords
    for obj in (p, j):
        obj.shifts_x = 5.0 + 1e-3 * dx - 5e-4 * dy
        obj.shifts_y = -3.0 + 4e-4 * dx + 1e-3 * dy
        obj.shifts_z = 1.0 + 2e-4 * dx
    return p, j


def _oracle(elev: np.ndarray, transform, coeffs, apply_z: bool) -> np.ndarray:
    """The warp in float64 on the host: numpy coordinates, scipy's bilinear interpolation."""
    h, w = elev.shape
    rr, cc = np.mgrid[0:h, 0:w].astype(np.float64)
    a, b, c, d, e, f = tuple(transform)
    x, y = a * (cc + 0.5) + b * (rr + 0.5) + c, d * (cc + 0.5) + e * (rr + 0.5) + f
    (ax, bx, cx), (ay, by, cy), (az, bz, cz) = coeffs
    sx, sy = x - (ax * x + bx * y + cx), y - (ay * x + by * y + cy)
    inv = transform.invert()
    src_c = inv.a * sx + inv.b * sy + inv.c - 0.5
    src_r = inv.d * sx + inv.e * sy + inv.f - 0.5
    out = map_coordinates(elev.astype(np.float64), [src_r, src_c], order=1, mode="constant", cval=np.nan)
    out[(src_r < 0) | (src_r > h - 1) | (src_c < 0) | (src_c > w - 1)] = np.nan
    return out + (az * x + bz * y + cz if apply_z else 0.0)


def test_apply_matches_the_float64_oracle(dems, planes):
    (_, tba), _ = dems
    p, _ = planes
    coeffs = p.ransac_all()
    np.testing.assert_allclose([c[0] for c in coeffs], [1e-3, 4e-4, 2e-4], rtol=1e-6)
    got = p.apply(tba)
    assert isinstance(got, DEM) and got.data.dtype == torch.float32 and tuple(got.transform) == tuple(tba.transform)
    want = _oracle(tba.get_nanarray(), tba.transform, coeffs, True)
    g = got.get_nanarray()
    assert np.array_equal(np.isnan(g), np.isnan(want))
    dev = np.abs(g - want)[np.isfinite(want)].max() / np.abs(want[np.isfinite(want)]).mean()
    assert dev <= 1e-5, dev


def test_apply_matches_xdem_tpu_within_its_float32_coordinates(dems, planes):
    """xdem_tpu forms the pixel-centre coordinates, the shifted ones and the source pixel
    positions in float32. At this grid's northings (8.67e6 m) a float32 ulp is 1 m, so its
    source positions can be off by half an ulp of each of the three roundings of the
    northing side (y, y - sy, and the row from it) and of the easting side: 0.5 * (1 + 1) m
    / 20 m + 0.5 * ulp32(row constant) px, and by as much on the columns. The bound is that
    position error times the largest change between neighbouring pixels, plus a float32 ulp
    of the values."""
    (_, tba), (_, jtba) = dems
    p, j = planes
    got, want = p.apply(tba).get_nanarray(), np.asarray(j.apply(jtba).data)
    t, inv = tba.transform, tba.transform.invert()
    ulp = lambda v: float(np.spacing(np.float32(abs(v))))  # noqa: E731
    x_far, y_far = t.c + N * RES, t.f
    px = (0.5 * (2 * ulp(y_far)) / RES + 0.5 * ulp(inv.f)) + (0.5 * (2 * ulp(x_far)) / RES + 0.5 * ulp(inv.c))
    z = tba.get_nanarray().astype(np.float64)
    step = np.nanmax(np.abs(np.diff(z, axis=0))) + np.nanmax(np.abs(np.diff(z, axis=1)))
    bound = px * step + ulp(np.nanmax(np.abs(z)))
    both = np.isfinite(got) & np.isfinite(want)
    assert both.mean() > 0.85  # 11 % of the to-be-aligned DEM is NaN
    assert np.abs(got - want)[both].max() <= bound, (np.abs(got - want)[both].max(), bound)
    assert px > 0.01  # the float32 rounding is not small here: the port does not copy it


def test_apply_tiled_equals_apply(dems, planes, tmp_path):
    (_, tba), _ = dems
    p, _ = planes
    path = p.apply_tiled(tba, out_path=str(tmp_path / "aligned.tif"), tile_rows=100)
    whole = p.apply(tba).get_nanarray()
    back = read_raster(path)
    assert tuple(back.transform) == tuple(tba.transform) and back.crs == tba.crs
    np.testing.assert_array_equal(back.get_nanarray(), whole)
    with pytest.raises(ValueError, match="No output destination"):
        p.apply_tiled(tba)
    q = coreg.BlockwiseCoreg(coreg.NuthKaab(), parent_path=str(tmp_path / "out"))
    assert q.output_path_aligned == tmp_path / "out" / "aligned_dem.tif"


# ---------------------------------------------------------------------- the generic loop

def test_generic_blockwise_coreg_matches_xdem_tpu(dems):
    (ref, tba), (jref, jtba) = dems
    p = coreg.BlockwiseCoreg(coreg.NuthKaab(), block_size_fit=200).fit(ref, tba)
    j = jcoreg.BlockwiseCoreg(jcoreg.NuthKaab(), block_size_fit=200).fit(jref, jtba)
    assert p.shape_tiling_grid == j.shape_tiling_grid == (3, 3)
    np.testing.assert_array_equal(p.x_coords, j.x_coords)
    for a in ("shifts_x", "shifts_y", "shifts_z"):
        got, want = getattr(p, a), getattr(j, a)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=a)
    aligned = p.fit_and_apply(ref, tba)
    before = np.nanstd(ref.get_nanarray() - tba.get_nanarray())
    after = np.nanstd(ref.get_nanarray() - aligned.get_nanarray())
    assert after < 0.2 * before


def test_constructor_and_config_checks_match_xdem_tpu(tmp_path):
    for mod in (coreg, jcoreg):
        with pytest.raises(ValueError, match="instantiated"):
            mod.BlockwiseCoreg(mod.NuthKaab)
        with pytest.raises(ValueError, match="only supports affine"):
            mod.BlockwiseCoreg(mod.Deramp())
        with pytest.raises(ValueError, match="translation-only"):
            mod.BlockwiseCoreg(mod.ICP())
        with pytest.raises(ValueError, match="at most one"):
            mod.BlockwiseCoreg(mod.NuthKaab(), mp_config=mod.MultiprocConfig(outfile=str(tmp_path / "a.tif")),
                               parent_path=str(tmp_path))
        with pytest.raises(ValueError, match="cluster"):
            mod.MultiprocConfig(cluster=object())
    cfg = coreg.MultiprocConfig(chunk_size=256, outfile=str(tmp_path / "sub" / "b.tif"))
    bw = coreg.BlockwiseCoreg(coreg.NuthKaab(vertical_shift=False), mp_config=cfg)
    assert bw.block_size_fit == bw.block_size_apply == 256 and (tmp_path / "sub").is_dir()
    assert bw.output_path_aligned == tmp_path / "sub" / "b.tif" and bw.apply_z_correction is False
    assert coreg.BlockwiseCoreg(coreg.ICP(only_translation=True)).apply_z_correction is True
