"""The hand-written CUDA kernels K1, K2, K3 against their plain PyTorch versions on the card,
the uncertainty path's device functions on the card against the CPU, and the volume, texture
shading, convolution, patches and Genton paths on the card against the CPU at 512^2, and the
DEM path (reprojection, the vertical CRS, a DEM's attributes), the raster-point fits, the
matrix apply to an EPC and the batched blockwise Nuth & Kääb solve (the card's picks solved
on both) on the card against the CPU, and mesh= over four shards of one card against the
whole-array planes and the single-device fits. K1, K2 and K3 are also checked on every
visible card, and mesh= over every card keeps each block on its card.

These tests need an NVIDIA GPU (they carry the `cuda` marker and skip elsewhere). They
import neither JAX nor xdem_tpu, so on a machine with a card but no JAX they run with
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

Tolerance: K1, K2 and K3 are held to the bit (identical NaN masks, max abs error 0): the
kernels are built with -fmad=false and add in the plain versions' order. So is tier 3's
fixed-point step kernel (csrc/regrid.cu), against the ATen loop on the same card, and ICP's
nearest-neighbour scan (csrc/nn_scan.cu), indices and squared distances, against the ATen scan.
"""

import math
import warnings

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_same_nan, cuda_device, scaled_dev  # noqa: F401

from xdem_tpu_torch import _build, coreg, terrain
from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.terrain import cuda_kernels as ck
from xdem_tpu_torch.terrain import surfit, window

pytestmark = pytest.mark.cuda


def _dem(device, shape=(301, 389), seed=0, holes=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).cumsum(0).cumsum(1)
    z = (z - z.min()) / (z.max() - z.min()) * 1000.0
    if holes:
        z[40:47, 60:75] = np.nan
        z[100, 100] = np.inf
        z[:, -2:] = np.nan
    return torch.from_numpy(z.astype(np.float32)).to(device)


def _close(got, want, name):
    assert_same_nan(got.cpu(), want.cpu(), name)
    period = 2 * math.pi if name == "aspect" else None
    assert scaled_dev(got.cpu(), want.cpu(), circular=period) <= 1e-3, name


def _bit_equal(got, want, name):
    assert_same_nan(got.cpu(), want.cpu(), name)
    num = ~torch.isnan(want)
    assert int(torch.isfinite(want).sum()) > 1000, name
    assert torch.equal(got[num], want[num]), (name, float((got[num] - want[num]).abs().max()))


_ALL10 = surfit.SURFACE_FIT_ATTRS
_MIXED = ("min_curvature", "hillshade", "planform_curvature", "slope", "flowline_curvature", "aspect", "slope")
K1_CASES = [
    # (fit, curvature method, attributes, hillshade z factor, width, center)
    ("Horn", "geometric", _ALL10[:3], 1.0, 389, None),
    ("Horn", "geometric", _ALL10[:3], 1.0, 388, None),
    ("ZevenbergThorne", "directional", _ALL10, 1.0, 389, None),
    ("ZevenbergThorne", "geometric", _ALL10, 1.0, 388, None),
    ("Florinsky", "geometric", _ALL10, 2.0, 389, None),
    ("Florinsky", "geometric", _ALL10, 1.0, 388, None),
    ("Florinsky", "directional", _ALL10[::-1], 1.0, 388, 431.3),
    ("Florinsky", "geometric", ("slope", "max_curvature"), 1.0, 389, None),
    ("Florinsky", "geometric", ("slope", "max_curvature"), 1.0, 388, "tensor"),
    ("Florinsky", "geometric", ("max_curvature",), 1.0, 389, None),
    ("Florinsky", "geometric", ("max_curvature",), 1.0, 388, None),
    ("Florinsky", "geometric", _MIXED, 2.0, 389, None),
    ("Florinsky", "directional", _MIXED, 1.0, 388, None),
]


@pytest.mark.parametrize("fit,curv,attrs,zf,width,center", K1_CASES,
                         ids=[f"{c[0]}-{c[1]}-{len(c[2])}-{c[3]}-{c[4]}-{c[5]}" for c in K1_CASES])
def test_surface_fit_kernel_matches_plain(cuda_device, fit, curv, attrs, zf, width, center):
    """K1 equals its plain version to the bit on every fit and curvature method, on the ragged
    width 389 (scalar stores) and on 388 (vector stores), for the two- and one-attribute
    requests, a request out of the table's order that names slope twice, and `center=` given
    as a float or a tensor (without it, the plain version is given the centre kernel's value). The DEM holds a NaN hole, a NaN border, an inf and a -inf pixel
    and a flat patch (where the sign of a zero derivative decides the aspect)."""
    dem = _dem(cuda_device)
    dem[170, 230] = -math.inf
    dem[200:230, 20:60] = 512.0
    dem = dem[:, :width].contiguous()
    if center == "tensor":
        center = torch.tensor(400.0, device=cuda_device)
    kw = dict(surface_fit=fit, curv_method=curv, hillshade_z_factor=zf, center=center)
    ck.reset_launch_counts()
    got = ck.surface_attributes(dem, 20.0, attrs, **kw)
    assert ck.LAUNCHES["surface_fit"] == 1 and ck.CALL_LAUNCHES["center"] == (center is None) and got.is_cuda
    if center is None:  # the plain version takes the wrapper's centre, as the card's callers give it
        kw["center"] = ck.dem_center(dem)
    want = surfit.surface_attributes(dem, 20.0, attrs, **kw)
    for i, a in enumerate(attrs):
        _bit_equal(got[i], want[i], a)


_WA = window.WINDOWED_ATTRS
K2_CASES = [
    # (window, TRI method, attributes, width)
    *((3, tri, _WA, width) for tri in ("Riley", "Wilson") for width in (389, 388)),
    *((3, "Riley", (a,), width) for a in _WA for width in (389, 388)),
    (3, "Wilson", _WA[1:2], 388),
    (3, "Wilson", _WA[::-1], 389),
    (3, "Riley", ("rugosity", "roughness", "topographic_position_index", "roughness"), 388),
    (5, "Riley", _WA[:3], 389),
    (6, "Riley", _WA[:3], 388),
    (21, "Wilson", _WA[:3], 389),
    (4, "Wilson", ("roughness", "topographic_position_index"), 388),
]


@pytest.mark.parametrize("w,tri,attrs,width", K2_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'+'.join(a[:5] for a in c[2])}-{c[3]}" for c in K2_CASES])
def test_windowed_kernel_matches_plain(cuda_device, w, tri, attrs, width):
    """K2 equals its plain version to the bit on the 3 x 3 instances (Riley and Wilson, with and
    without rugosity, each attribute alone, a request out of the table's order, one that names
    roughness twice) and on runtime windows over a shared tile, on the ragged width 389
    (scalar stores) and on 388 (vector stores). The DEM holds a NaN hole, a NaN border, an
    inf and a -inf pixel and a flat patch."""
    dem = _dem(cuda_device)
    dem[170, 230] = -math.inf
    dem[200:230, 20:60] = 512.0
    dem = dem[:, :width].contiguous()
    ck.reset_launch_counts()
    got = ck.windowed_indexes(dem, 20.0, attrs, w, tri)
    assert ck.LAUNCHES["windowed"] == 1 and got.is_cuda
    want = window.windowed_indexes(dem, 20.0, attrs, w, tri)
    for i, a in enumerate(attrs):
        _bit_equal(got[i], want[i], a)


@pytest.mark.parametrize("w", [5, 8, 13, 21, "last shared", "first global"])
def test_fractal_kernel_matches_plain(cuda_device, w):
    """K3 equals its plain version to the bit (max abs error 0, identical NaN masks) on every
    route: compile-time windows (5, 13, 21), runtime planes (8 and the last window whose planes
    fit in shared memory) and global reads (the next window). The 301 x 389 DEM is no multiple
    of either tile and holds NaN holes, a NaN border, an inf and a -inf centre pixel."""
    top = _build.load().fractal_max_shared_window()
    w = {"last shared": top, "first global": top + 1}.get(w, w)
    dem = _dem(cuda_device)
    dem[170, 230] = -math.inf
    ck.reset_launch_counts()
    got = ck.fractal_roughness(dem, w)
    assert ck.LAUNCHES["fractal"] == 1
    want = window.fractal_roughness(dem, w)
    assert_same_nan(got.cpu(), want.cpu(), f"w={w}")
    num = ~torch.isnan(want)
    assert int(torch.isfinite(want).sum()) > 1000
    assert torch.equal(got[num], want[num]), float((got[num] - want[num]).abs().max())


@pytest.mark.parametrize("route", ["last shared", "first global"])
def test_large_windows_take_the_global_memory_path(cuda_device, route):
    """The last window whose tile fits in shared memory, and the next, which reads the raster
    directly: both equal the plain version to the bit."""
    top = _build.load().windowed_max_shared_window()
    w = top + (route == "first global")
    dem = _dem(cuda_device, shape=(300, 310), holes=False)
    dem[3, 4], dem[295, 300] = math.nan, math.inf
    attrs = window.WINDOWED_ATTRS[:3]
    ck.reset_launch_counts()
    got = ck.windowed_indexes(dem, 1.0, attrs, w, "Riley")
    assert ck.LAUNCHES["windowed"] == 1
    want = window.windowed_indexes(dem, 1.0, attrs, w, "Riley")
    for i, a in enumerate(attrs):
        _bit_equal(got[i], want[i], a)


def test_large_fractal_windows_take_the_global_memory_path(cuda_device):
    """w = 229 is far past the last window whose box-maxima planes fit in shared memory, so K3
    reads the raster directly; same results as the plain version on the pixels the window fits."""
    dem = _dem(cuda_device, shape=(260, 270), holes=False)
    ck.reset_launch_counts()
    got = ck.fractal_roughness(dem, 229)
    assert ck.LAUNCHES["fractal"] == 1
    # The window of pixel r reads rows r - 114 .. r + 113: 33 x 43 pixels see no edge.
    assert int(torch.isfinite(got).sum()) == (260 - 227) * (270 - 227)
    _close(got, window.fractal_roughness(dem, 229), "fractal_roughness")


@pytest.mark.parametrize("w", [3, 4])
def test_small_fractal_windows_raise_on_the_card(cuda_device, w):
    """Windows below 5 warn and then raise on a CUDA tensor (the CPU path runs them)."""
    dem = _dem(cuda_device)
    with pytest.warns(UserWarning, match="larger or equal to 5"), pytest.raises(ValueError, match=">= 5"):
        terrain.get_terrain_attribute(dem, "fractal_roughness", window_size_fractal=w)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    dem = _dem(cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ck.surface_attributes(dem.double(), 20.0, ("slope",))
    with pytest.raises(ValueError, match="contiguous"):
        ck.windowed_indexes(dem.t(), 20.0, ("roughness",))
    with pytest.raises(ValueError, match=">= 5"):
        ck.fractal_roughness(dem, 4)
    with pytest.raises(ValueError, match="3x3"):
        ck.windowed_indexes(dem, 20.0, ("rugosity",), 5)


def test_dispatcher_on_the_card_matches_the_cpu(cuda_device):
    dem = _dem(cuda_device)
    attrs = ["slope", "aspect", "hillshade", "max_curvature", "topographic_position_index",
             "terrain_ruggedness_index", "roughness", "rugosity", "fractal_roughness"]
    ck.reset_launch_counts()
    got = terrain.get_terrain_attribute(dem, attrs, resolution=20.0)
    assert all(v > 0 for v in ck.LAUNCHES.values())
    want = terrain.get_terrain_attribute(dem.cpu(), attrs, resolution=20.0)
    for a, g, w in zip(attrs, got, want):
        assert g.is_cuda
        assert_same_nan(g.cpu(), w, a)
        rel = scaled_dev(g.cpu(), w, circular=360.0 if a == "aspect" else None, pct=99.0)
        assert rel <= 1e-3, a


def test_nuth_kaab_on_the_card(cuda_device):
    # A periodic 1/f^2.7 spectral DEM, so that rolling it is an exact translation.
    n = 512
    rng = np.random.default_rng(2)
    f = np.hypot(np.fft.fftfreq(n)[:, None], np.fft.rfftfreq(n)[None, :])
    f[0, 0] = 1.0
    spec = f**-2.7 * np.exp(2j * np.pi * rng.random(f.shape))
    spec[0, 0] = 0.0
    z = np.fft.irfft2(spec, s=(n, n))
    ref = ((z - z.min()) / (z.max() - z.min()) * 1000.0).astype(np.float32)
    tba = np.roll(ref, (1, -2), axis=(0, 1)) + 1.0  # terrain moved 1 px south, 2 px west
    t = Affine.from_origin(5e5, 8e6, 20.0, 20.0)
    c = coreg.NuthKaab(subsample=20000).fit(torch.from_numpy(ref).to(cuda_device),
                                            torch.from_numpy(tba).to(cuda_device),
                                            transform=t, crs=32633, random_state=1)
    tx, ty, tz = c.to_translations()
    assert tx == pytest.approx(40.0, abs=2.5) and ty == pytest.approx(20.0, abs=2.5)
    assert tz == pytest.approx(-1.0, abs=0.2)


# ---------------------------------------------------------------------- uncertainty path
# The same functions on the card and on the CPU with identical inputs (the draws are made
# once and moved): counts identical, medians/NMADs and sigma to 1e-6, gamma and the n_eff
# sum to 1e-5 relative.


def _hetero_sample(device, n=200_000, seed=3):
    rng = np.random.default_rng(seed)
    slope = np.abs(rng.normal(20, 10, n))
    curv = rng.normal(0, 1, n)
    dh = rng.normal(0, 1, n) * (0.5 + slope / 30)
    dh[rng.random(n) < 0.05] = np.nan
    g = np.stack([dh, slope, curv]).astype(np.float32)
    return torch.from_numpy(g).to(device)


def test_hetero_tables_and_sigma_on_the_card(cuda_device):
    from xdem_tpu_torch import spatialstats as ss

    g = _hetero_sample(cuda_device)
    got, gmin, gmax = ss._hetero_bin_tables_device(g, 10)
    want, wmin, wmax = ss._hetero_bin_tables_device(g.cpu(), 10)
    assert torch.equal(gmin.cpu(), wmin) and torch.equal(gmax.cpu(), wmax)
    for (c, m, s), (wc, wm, ws) in zip(got, want):
        assert c.is_cuda and torch.equal(c.cpu(), wc)
        np.testing.assert_allclose(m.cpu().numpy(), wm.numpy(), rtol=1e-6, equal_nan=True)
        np.testing.assert_allclose(s.cpu().numpy(), ws.numpy(), rtol=1e-6, equal_nan=True)
    df = ss._table_from_device_bins(want, wmin, wmax, 10, ["slope", "curv"], "nmad")
    fun = ss.interp_nd_binning(df, ["slope", "curv"], "nmad")
    full = [g[1].reshape(400, 500), g[2].reshape(400, 500)]
    scale, sig = ss._scale_and_sigma_device(g, fun.mids_ext, fun.grid_ext, 7.0, full)
    wscale, wsig = ss._scale_and_sigma_device(g.cpu(), fun.mids_ext, fun.grid_ext, 7.0, [f.cpu() for f in full])
    assert sig.is_cuda
    np.testing.assert_allclose(float(scale), float(wscale), rtol=1e-6)
    assert_same_nan(sig.cpu(), wsig)
    np.testing.assert_allclose(sig.cpu().numpy(), wsig.numpy(), rtol=1e-6, equal_nan=True)


def test_interp_grid_on_the_card(cuda_device):
    from xdem_tpu_torch import spatialstats as ss

    rng = np.random.default_rng(1)
    mids = [np.linspace(-5, 65, 12), np.linspace(-3, 3, 12)]
    grid = rng.uniform(0.5, 3.0, (12, 12))
    x = torch.from_numpy(rng.uniform(-20, 80, (300, 310)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-5, 5, (300, 310)).astype(np.float32))
    x[0, :9] = torch.nan
    got = ss._interp_grid_device(mids, grid, [x.to(cuda_device), y.to(cuda_device)])
    want = ss._interp_grid_device(mids, grid, [x, y])
    assert_same_nan(got.cpu(), want)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd"])
def test_variogram_estimators_on_the_card(cuda_device, estimator):
    """Flat and chunked grid variograms on one ring draw, card against CPU."""
    from xdem_tpu_torch import spatialstats as ss

    arr = _dem("cpu", shape=(300, 320)) / 100.0
    ija, ijb = ss._draw_rings_from_arr(5, arr, 30, 60, 10, 300, 320, 1.5, 480)
    edges = [0.0]
    while edges[-1] < 8000:
        edges.append(max(np.sqrt(2) * edges[-1], np.sqrt(2) * 20.0))
    edges = torch.tensor(np.array(edges, np.float32))
    n = len(edges) - 1
    want_g, want_c = ss._grid_variogram_device(arr, ija, ijb, 20.0, edges, estimator, n)
    assert int(want_c.sum()) > 100_000
    on = [t.to(cuda_device) for t in (arr, ija, ijb, edges)]
    flat = ss._grid_variogram_device(on[0], on[1], on[2], 20.0, on[3], estimator, n)
    # Chunks of 7 runs: the 30 runs are padded to 35 with empty (-1) runs.
    ija_p = torch.cat([on[1], torch.full((5, *ija.shape[1:]), -1, device=cuda_device)])
    ijb_p = torch.cat([on[2], torch.full((5, *ijb.shape[1:]), -1, device=cuda_device)])
    chunked = ss._grid_variogram_device_chunked(on[0], ija_p, ijb_p, 20.0, on[3], estimator, n, 7)
    for g, c in (flat, chunked):
        assert g.is_cuda and torch.equal(c.cpu(), want_c)
        np.testing.assert_allclose(g.cpu().numpy(), want_g.numpy(), rtol=1e-5, equal_nan=True)


def test_neff_sum_on_the_card(cuda_device):
    from xdem_tpu_torch import spatialstats as ss

    rng = np.random.default_rng(2)
    c = torch.from_numpy(rng.uniform(-1500, 1500, (5000, 2)).astype(np.float32))
    e = torch.from_numpy(rng.uniform(0.5, 2.0, 5000).astype(np.float32))
    params = {"model": ["gaussian", "spherical"], "range": [120.0, 900.0], "psill": [0.6, 0.4]}
    want = ss._chunked_weighted_rho_sum(c, e, c[:1000], e[:1000], params, target_elems=1 << 20)
    got = ss._chunked_weighted_rho_sum(c.to(cuda_device), e.to(cuda_device), c[:1000].to(cuda_device),
                                       e[:1000].to(cuda_device), params, target_elems=1 << 20)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_estimate_uncertainty_on_the_card(cuda_device):
    """The whole path on a CUDA tensor: K1 launches, sigma stays on the card."""
    from xdem_tpu_torch import uncertainty

    dem = _dem(cuda_device, shape=(400, 420), holes=False)
    other = dem + 0.004 * _dem(cuda_device, shape=(400, 420), seed=1, holes=False)
    ck.reset_launch_counts()
    sig, rho = uncertainty.estimate_uncertainty(dem, other, transform=Affine.from_origin(0, 0, 20, 20),
                                                subsample=1000, random_state=42)
    assert ck.LAUNCHES["surface_fit"] == 1
    assert sig.is_cuda and float(torch.isfinite(sig).float().mean()) > 0.98
    assert rho(np.array([0.0]))[0] == pytest.approx(1.0)


# ---------------------------------------------------------------------- coregistration path
# Card against CPU (or scipy) with identical inputs: the rigid fits draw their subsample on
# the host with numpy, so both devices see the same points.


def test_brute_nearest_on_the_card_equals_kdtree(cuda_device):
    """2e4 query points against 2e4 reference points: the blocked direct-difference argmin
    on the card picks, index for index, what scipy's float64 KD-tree picks."""
    from scipy.spatial import KDTree

    from xdem_tpu_torch.coreg import affine

    rng = np.random.default_rng(11)
    ref = rng.uniform(0, 1000, (20_000, 3)).astype(np.float32)
    q = rng.uniform(0, 1000, (20_000, 3)).astype(np.float32)
    idx, dist = affine._brute_nearest(torch.from_numpy(ref).to(cuda_device), torch.from_numpy(q).to(cuda_device))
    want_d, want_i = KDTree(ref.astype(np.float64)).query(q.astype(np.float64))
    assert idx.is_cuda
    np.testing.assert_array_equal(idx.cpu().numpy(), want_i)
    np.testing.assert_allclose(dist.cpu().numpy(), want_d, rtol=1e-5)


def _standardised(a):
    return ((a - a.mean(axis=0)) / a.std()).astype(np.float32)


def _cell_clouds(rng, n):
    """The rigid cell's scan: n pixels of a 1e5 m tile, the reference's heights and the same
    pixels moved by 3 m and raised 0.4 m, each standardised."""
    xy = rng.uniform(0, 1e5, (n, 2))
    z = 500 + 100 * np.sin(xy[:, :1] / 7e3)
    return _standardised(np.hstack([xy, z + rng.normal(0, 1, (n, 1))])), _standardised(np.hstack([xy + 3.0, z + 0.4]))


def _tie_clouds(rng):
    """Integer reference points on a 21^3 lattice, one duplicated, and half-integer queries:
    exact distances and many queries equidistant from several points."""
    ref = rng.integers(0, 21, (5000, 3)).astype(np.float32)
    ref[4000] = ref[17]
    ref[1], ref[2] = (0, 0, 0), (1, 0, 0)
    q = (rng.integers(0, 41, (3000, 3)) / 2).astype(np.float32)
    q[0], q[1] = ref[17], (0.5, 0, 0)
    return ref, q


NN_CASES = {
    # name: rng -> (reference cloud, queries)
    "the cell's 5e4 x 5e4": lambda rng: _cell_clouds(rng, 50_000),
    "20 001 points, 7 queries": lambda rng: (rng.normal(size=(20_001, 3)).astype(np.float32),
                                             rng.normal(size=(7, 3)).astype(np.float32)),
    "one reference point": lambda rng: (rng.normal(size=(1, 3)).astype(np.float32),
                                        rng.normal(size=(300, 3)).astype(np.float32)),
    "ties to the lower index": _tie_clouds,
    "a shard padded with the pad coordinate": lambda rng: (
        np.vstack([rng.normal(size=(1000, 3)), np.full((24, 3), 1e15)]).astype(np.float32),
        rng.normal(size=(2500, 3)).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(NN_CASES))
def test_nn_scan_kernel_equals_the_aten_scan_to_the_bit(cuda_device, case):
    """ICP's scan kernel (csrc/nn_scan.cu) gives the ATen scan's indices and squared distances
    on the same card to the bit, in one launch: at the rigid cell's size, on a cloud whose
    length is no multiple of any tile, on one point, where ties go to the lower index (a
    duplicated point, equidistant queries) and on a shard padded with ``_NN_PAD_COORD``."""
    from xdem_tpu_torch.coreg import affine, base

    ref, q = (torch.from_numpy(a).to(cuda_device) for a in NN_CASES[case](np.random.default_rng(5)))
    launches = base.LAUNCHES["nn_scan"]
    got_i, got_d = affine._nn_planes_scan(ref)(q)
    assert base.LAUNCHES["nn_scan"] == launches + 1
    want_i, want_d = affine._nn_scan_aten(ref)(q)
    assert got_i.is_cuda and got_i.dtype == torch.int64 and got_d.dtype == torch.float32
    assert torch.equal(got_i, want_i), int((got_i != want_i).sum())
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32)), int((got_d != want_d).sum())
    if case == "ties to the lower index":
        assert got_i[:2].tolist() == [17, 1] and got_d[:2].tolist() == [0.0, 0.25]


def test_nn_scan_of_a_cloud_that_is_not_float32_raises_on_the_card(cuda_device):
    from xdem_tpu_torch.coreg import affine

    with pytest.raises(ValueError, match="float32"):
        affine._nn_planes_scan(torch.zeros((10, 3), dtype=torch.float64, device=cuda_device))


def test_icp_with_the_scan_kernel_equals_icp_with_the_aten_scan(cuda_device, monkeypatch):
    """ICP on the card gives the same matrix bits, statistic and steps with the scan kernel as
    with the ATen scan in its place; the kernel launches once a step, and each ``coreg.icp.nn``
    span counts it as ``kernel``."""
    from xdem_tpu_torch import profiler
    from xdem_tpu_torch.coreg import affine, base

    rng = np.random.default_rng(9)
    ref, _ = _cell_clouds(rng, 20_000)
    motion = coreg.matrix_from_translations_rotations(0.02, -0.01, 0.01, 0.5, 0.2, 0.1).astype(np.float32)
    tba = ref @ motion[:3, :3].T + motion[:3, 3] + rng.normal(0, 1e-3, ref.shape).astype(np.float32)
    norms = rng.normal(size=ref.shape)
    norms = (norms / np.linalg.norm(norms, axis=1, keepdims=True)).astype(np.float32)
    clouds = [torch.from_numpy(a).to(cuda_device) for a in (ref, tba, norms)]
    launches = base.LAUNCHES["nn_scan"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():  # torch 2.11 warns at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=acts):
            by_kernel = affine._icp_solve_device(*clouds, np.float32(1e-5), max_iterations=20)
            torch.cuda.synchronize(cuda_device)
    steps = by_kernel[1]
    assert steps >= 3 and base.LAUNCHES["nn_scan"] - launches == steps
    scans = [r.counters for r in profiler.spans() if r.name == "xdem_tpu_torch.coreg.icp.nn"]
    assert scans == [{"kernel": 1, "pairs": 20_000 * 20_000}] * steps
    monkeypatch.setattr(affine, "_nn_planes_scan", affine._nn_scan_aten)
    by_aten = affine._icp_solve_device(*clouds, np.float32(1e-5), max_iterations=20)
    assert base.LAUNCHES["nn_scan"] - launches == steps
    assert by_kernel[1:] == by_aten[1:]
    assert torch.equal(by_kernel[0], by_aten[0]), (by_kernel[0] - by_aten[0]).abs().max()


def test_tier3_apply_on_the_card_matches_the_cpu(cuda_device):
    dem = _dem("cpu", shape=(512, 512))
    t = Affine.from_origin(5e5, 8e6, 20.0, 20.0)
    m = coreg.matrix_from_translations_rotations(20, 5, 0.1, 0.1, 0.05, 0.01)
    centroid = (5e5, 8e6 - 512 * 20.0, 500.0)
    got, _ = coreg.apply_matrix(dem.to(cuda_device), m, centroid=centroid, transform=t)
    want, _ = coreg.apply_matrix(dem, m, centroid=centroid, transform=t)
    assert got.is_cuda
    assert_same_nan(got.cpu(), want, "tier 3")
    fin = torch.isfinite(want)
    assert float((got.cpu()[fin] - want[fin]).abs().max()) <= 1e-3


def _smooth_dem(device, shape):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]] / max(shape)
    z = 300 * np.sin(3 * xx + 1) * np.cos(2 * yy) + 200 * xx * yy
    return torch.from_numpy(z.astype(np.float32)).to(device)


def _counted_regrid(dem, resampling="linear", aten=False):
    """Tier 3 of the (20, 5, 0.1) m, (0.1, 0.05, 0.01) degree motion about the tile's centre at
    500 m, with the ATen passes in place of the card's step kernel where `aten`: the regridded
    DEM, the kernel's launches and the ATen loop's interpolations."""
    from xdem_tpu_torch.coreg import base

    calls = {"aten": 0}
    interp = base.interp_rowcol

    def interp_counted(*args, **kwargs):
        calls["aten"] += 1
        return interp(*args, **kwargs)

    h, w = dem.shape
    t = Affine.from_origin(5e5, 8e6, 20.0, 20.0)
    m = coreg.matrix_from_translations_rotations(20, 5, 0.1, 0.1, 0.05, 0.01)
    launches = base.LAUNCHES["regrid_step"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "interp_rowcol", interp_counted)
        if aten:
            mp.setattr(base, "_regrid_step_on_card", base._regrid_step_aten)
        out, _ = coreg.apply_matrix(dem, m, centroid=(5e5 + w * 10.0, 8e6 - h * 10.0, 500.0), transform=t,
                                    resampling=resampling)
    calls["kernel"] = base.LAUNCHES["regrid_step"] - launches
    return out, calls


REGRID_CASES = {
    # name: (DEM, steps the loop takes)
    "512 with voids": (lambda dev: _dem(dev, shape=(512, 512)), 3),
    "777 x 1301": (lambda dev: _dem(dev, shape=(777, 1301), seed=1), 20),
    "3000, every step": (lambda dev: _dem(dev, shape=(3000, 3000), seed=2), 20),
    "smooth, stops at the tolerance": (lambda dev: _smooth_dem(dev, (128, 128)), 2),
    "a view that is not contiguous": (lambda dev: _dem(dev, shape=(512, 520))[:, :515], 3),
}


@pytest.mark.parametrize("case", list(REGRID_CASES))
def test_regrid_kernel_equals_the_aten_loop_to_the_bit(cuda_device, case):
    """Tier 3's step kernel (csrc/regrid.cu) gives the ATen loop's regrid on the same card to the
    bit, NaNs in the same places, in as many steps: on a DEM with NaN and inf voids and a NaN
    border, on a non-square odd-sized one, on one whose residual never reaches the tolerance, on
    a smooth one that stops at it, and on a view that is not contiguous (copied, then launched)."""
    make, steps = REGRID_CASES[case]
    dem = make(cuda_device)
    got, by_kernel = _counted_regrid(dem)
    want, by_aten = _counted_regrid(dem, aten=True)
    assert by_kernel == {"kernel": steps, "aten": 0} and by_aten == {"kernel": 0, "aten": steps}
    assert got.is_cuda and got.is_contiguous()
    _bit_equal(got, want, case)


@pytest.mark.parametrize("resampling", ["nearest", "cubic"])
def test_regrid_without_linear_resampling_takes_the_aten_loop_on_the_card(cuda_device, resampling):
    dem = _dem(cuda_device, shape=(512, 512))
    got, calls = _counted_regrid(dem, resampling)
    want, _ = _counted_regrid(dem, resampling, aten=True)
    assert calls["kernel"] == 0 and calls["aten"] >= 1
    _bit_equal(got, want, resampling)


def test_regrid_of_a_dem_that_is_not_float32_raises_on_the_card(cuda_device):
    from xdem_tpu_torch.coreg import base

    dem = _dem(cuda_device, shape=(128, 128)).double()
    with pytest.raises(ValueError, match="float32"):
        base._iterate_affine_regrid_small_rotations(dem, Affine.from_origin(5e5, 8e6, 20.0, 20.0),
                                                    coreg.matrix_from_translations_rotations(1, 0, 0, 0.1, 0, 0),
                                                    None)


def test_the_regrid_span_counts_a_kernel_a_step_on_the_card(cuda_device):
    """Inside a recorded ``coreg.regrid`` span the card's float32 DEM counts ``kernel`` once a
    step, as many as ``steps``; the ATen passes in the kernel's place count none."""
    from xdem_tpu_torch import profiler

    dem = _dem(cuda_device, shape=(777, 1301), seed=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():  # torch 2.11 warns at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=acts):
            for aten in (False, True):
                _counted_regrid(dem, aten=aten)
            torch.cuda.synchronize(cuda_device)
    on_card, aten = [r.counters for r in profiler.spans() if r.name == "xdem_tpu_torch.coreg.regrid"]
    assert on_card == {"steps": 20, "kernel": 20}
    assert aten == {"steps": 20}


def test_rigid_fits_on_the_card_match_the_cpu(cuda_device):
    """ICP (brute), LZD, CPD and DhMinimize fitted on the card and on the CPU from one draw.
    CPD runs 8 EM steps: on this pair its variance keeps shrinking towards the float32 noise
    floor, where the card's and the CPU's matmul roundings decide the step at which it stops
    (measured: the card's EM collapsed at step 13, the CPU's ran all 100)."""
    dem = _dem("cpu", shape=(512, 512), holes=False)
    t = Affine.from_origin(5e5, 8e6, 20.0, 20.0)
    m = coreg.matrix_from_translations_rotations(20, 5, 0.1, 0.1, 0.05, 0.01)
    tba, _ = coreg.apply_matrix(dem, m, centroid=(5e5, 8e6 - 512 * 20.0, 500.0), transform=t)
    for c, sub in ((coreg.ICP(nn_method="brute"), 5000), (coreg.LZD(), 50000), (coreg.CPD(max_iterations=8), 1000),
                   (coreg.DhMinimize(), 50000)):
        kw = dict(transform=t, subsample=sub, random_state=3)
        on_card = c.copy().fit(dem.to(cuda_device), tba.to(cuda_device), **kw).to_matrix()
        on_cpu = c.copy().fit(dem, tba, **kw).to_matrix()
        assert np.abs(on_card - on_cpu).max() <= 1e-4 * np.abs(on_cpu).max(), type(c).__name__


def test_grid_draw_on_the_card_equals_the_cpu_and_keeps_the_mask_on_the_card(cuda_device, tmp_path):
    """The raster-raster draw on the card picks the CPU's pixels, in its order, with its values
    to the bit, and inside its ``coreg.draw`` span no device-to-host copy is larger than the
    picks (their int64 positions, or the two grids' float32 values at them): the joint finite
    mask stays on the card."""
    import json

    from xdem_tpu_torch import profiler
    from xdem_tpu_torch.coreg import affine

    ref = _dem("cpu", shape=(1024, 1024), seed=2)
    tba = ref + 0.5
    tba[300:340, 500:620] = np.nan
    inlier = torch.ones(ref.shape, dtype=torch.bool)
    inlier[:, :90] = False
    inlier[700:760] = False
    count = 20000

    def draw(grids, mask):
        return affine._draw_pixels({**grids, "x": lambda rr, cc: cc * 10.0 + 0.25}, mask, count, 5)

    want = draw({"__ref__": ref, "__tba__": tba}, inlier)
    on_card = {"__ref__": ref.to(cuda_device), "__tba__": tba.to(cuda_device)}
    mask = inlier.to(cuda_device)
    draw(on_card, mask)
    torch.cuda.synchronize(cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():  # torch 2.11 warns at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=acts) as prof:
            got = draw(on_card, mask)
            torch.cuda.synchronize(cuda_device)
    assert got[2] == want[2] == count
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert got[3][k].dtype == want[3][k].dtype, k
        np.testing.assert_array_equal(got[3][k], want[3][k], err_msg=k)
    assert [r.name for r in profiler.spans()] == ["xdem_tpu_torch.coreg.draw"]
    prof.export_chrome_trace(str(tmp_path / "draw.json"))
    with open(tmp_path / "draw.json") as f:
        events = json.load(f)["traceEvents"]
    to_host = [e["args"]["bytes"] for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    assert to_host and max(to_host) <= 8 * count, to_host


def test_icp_auto_takes_the_brute_search_on_the_card(cuda_device, monkeypatch):
    from xdem_tpu_torch.coreg import affine

    calls = []
    solve = affine._icp_solve_device
    monkeypatch.setattr(affine, "_icp_solve_device", lambda *a, **k: calls.append(1) or solve(*a, **k))
    dem = _dem(cuda_device, shape=(256, 256), holes=False)
    coreg.ICP(subsample=3000).fit(dem, dem + 1.0, transform=Affine.from_origin(0, 0, 20, 20), random_state=1)
    assert calls == [1]


def test_bias_pipeline_on_the_card_launches_k1(cuda_device):
    dem = _dem(cuda_device, shape=(300, 320), holes=False)
    yy = torch.arange(300, dtype=torch.float32, device=cuda_device)[:, None].expand(300, 320)
    tba = dem + 1e-4 * (yy - 150) ** 2
    pipe = coreg.CoregPipeline([coreg.Deramp(subsample=20000), coreg.TerrainBias(subsample=20000)])
    ck.reset_launch_counts()
    out, _ = pipe.fit_and_apply(dem, tba, transform=Affine.from_origin(0, 0, 20, 20), random_state=2)
    assert out.is_cuda and ck.LAUNCHES["surface_fit"] >= 2
    assert float(torch.nanmean((dem - out) ** 2)) < 0.1 * float(torch.nanmean((dem - tba) ** 2))


def test_median_binning_on_the_card_equals_nd_binning(cuda_device):
    """The one-variable median binning of a bias correction, on the card, gives the host
    nd_binning's table to the bit; Deramp's normal equations on the card give the host's
    coefficients to 1e-12 of their largest magnitude."""
    from xdem_tpu_torch import spatialstats

    rng = np.random.default_rng(9)
    n = 500_000
    vals = np.round(rng.normal(0.0, 2.0, n), 3)
    var = rng.uniform(-0.02, 0.05, n)
    vals[rng.random(n) < 0.01] = np.nan
    want = spatialstats.nd_binning(vals, [var], ["v"], 100, statistics=("count", np.nanmedian))
    got = spatialstats._nd_binning_median_1d(vals, var, "v", 100, cuda_device)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    cc, rr = rng.integers(0, 10000, n), rng.integers(0, 10000, n)
    fits = []
    for device in (cuda_device, None):
        step = coreg.Deramp(subsample=n)
        step._bin_or_and_fit_biasvars(np.nan_to_num(vals), {"xx": cc, "yy": rr}, device=device)
        fits.append(step.meta["outputs"]["fitorbin"]["fit_params"])
    assert np.abs(fits[0] - fits[1]).max() <= 1e-12 * np.abs(fits[1]).max()


# ---------------------------------------------------------------------- volume, texture, patches, Genton


def _volume_rasters(device, n=512, seed=0):
    """An elevation field, white noise with 10 % voids, and dh = -12 + 0.01 z + noise."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, n)).cumsum(0).cumsum(1)
    z = ((z - z.min()) / (z.max() - z.min()) * 1000.0).astype(np.float32)
    noise = rng.normal(0.0, 0.5, (n, n)).astype(np.float32)
    noise[rng.random((n, n)) < 0.1] = np.nan
    dh = (-12.0 + 0.01 * z + noise).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (z, noise, dh))


@pytest.mark.parametrize("kind,bins", [("fixed", 50.0), ("count", 20), ("quantile", 20)])
def test_hypsometric_binning_on_the_card_matches_the_cpu(cuda_device, kind, bins):
    """Counts and NaN pattern identical, values within 1e-4 of their mean magnitude."""
    from xdem_tpu_torch import volume

    z, _noise, dh = _volume_rasters(cuda_device)
    z[40:50, 60:90] = float("nan")
    got = volume.hypsometric_binning(dh, z, bins=bins, kind=kind)
    want = volume.hypsometric_binning(dh.cpu(), z.cpu(), bins=bins, kind=kind)
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["bin_left"], want["bin_left"])
    assert np.array_equal(np.isnan(got["value"]), np.isnan(want["value"]))
    ok = np.isfinite(want["value"])
    assert np.abs(got["value"] - want["value"])[ok].max() <= 1e-4 * np.abs(want["value"][ok]).mean()


def test_regional_signal_on_the_card_matches_the_cpu(cuda_device):
    """Counts identical, median 1e-5, std 1e-4 (absolute, on a normalized signal)."""
    from xdem_tpu_torch import volume

    z, _noise, dh = _volume_rasters(cuda_device)
    idx = torch.arange(512, device=cuda_device)
    gid = (idx[:, None] // 128) * 4 + idx[None, :] // 128 + 1
    gid[:, ::128] = 0
    got = volume.get_regional_hypsometric_signal(dh, z, gid)
    want = volume.get_regional_hypsometric_signal(dh.cpu(), z.cpu(), gid.cpu())
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["median"], want["median"], atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(got["std"], want["std"], atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("shape", [(512, 512), (300, 1100)], ids=["no-pad", "padded"])
def test_texture_shading_on_the_card_matches_the_cpu(cuda_device, shape):
    """Within 1e-3 of the mean magnitude with an identical NaN mask, and K1 once for the slope
    asked for beside it."""
    z = _dem(cuda_device, shape=shape, holes=False)
    z[40:47, 60:75] = float("nan")
    ck.reset_launch_counts()
    slope, tex = terrain.get_terrain_attribute(z, ["slope", "texture_shading"], resolution=20.0)
    assert ck.LAUNCHES["surface_fit"] == 1 and tex.is_cuda and slope.is_cuda
    want = terrain.texture_shading(z.cpu())
    assert_same_nan(tex.cpu(), want, "texture_shading")
    assert scaled_dev(tex.cpu(), want) <= 1e-3


def _cudnn_flags():
    flags = {"allow_tf32": torch.backends.cudnn.allow_tf32}
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        flags["conv.fp32_precision"] = conv.fp32_precision
    return flags


def test_convolutions_on_the_card_match_scipy_in_float64(cuda_device):
    """convolution and mean_filter_nan on the card against scipy.ndimage.convolve in float64:
    1e-5 of the mean magnitude, NaN footprints and counts exact, whatever cuDNN's float32
    precision flags say (they are left as found: the port calls no library convolution)."""
    from scipy import ndimage

    import xdem_tpu_torch.spatialstats as ss

    z, noise, _dh = _volume_rasters(cuda_device)
    z[40:44, 60:65] = float("nan")
    flags = _cudnn_flags()
    kernels = np.random.default_rng(3).normal(size=(2, 5, 4))
    got = ss.convolution(z[None], kernels)[0].cpu().numpy()
    mean, cnts, nb = ss.mean_filter_nan(noise, 32)
    assert _cudnn_flags() == flags
    z64 = z.cpu().numpy().astype(np.float64)
    for g, kern in zip(got, kernels):
        want = ndimage.convolve(z64, kern, mode="constant", cval=0.0)
        assert np.array_equal(np.isnan(g), np.isnan(want))
        ok = np.isfinite(want)
        assert np.abs(g - want)[ok].max() <= 1e-5 * np.abs(want[ok]).mean()
    n64 = noise.cpu().numpy().astype(np.float64)
    ok = np.isfinite(n64)
    kernel = ss._mean_filter_kernel(32, "circular").astype(np.float64)
    assert nb == int(kernel.sum())
    cnt64 = ndimage.convolve(ok.astype(np.float64), kernel, mode="constant", cval=0.0)
    mean64 = ndimage.convolve(np.where(ok, n64, 0.0), kernel, mode="constant", cval=0.0) / np.maximum(cnt64, 1)
    np.testing.assert_array_equal(cnts.cpu().numpy(), cnt64)
    has = cnt64 > 0
    assert np.abs(mean.cpu().numpy() - mean64)[has].max() <= 1e-5 * np.abs(mean64[has]).mean()


def test_patches_method_on_the_card_matches_the_cpu(cuda_device):
    """Statistic within 1e-4 relative; nb_indep_patches and exact_areas identical."""
    import xdem_tpu_torch.spatialstats as ss

    _z, noise, _dh = _volume_rasters(cuda_device)
    areas = [math.pi * (k * 10.0) ** 2 for k in (6, 20)]
    got = ss.patches_method(noise, areas=areas, gsd=20.0)
    want = ss.patches_method(noise.cpu(), areas=areas, gsd=20.0)
    np.testing.assert_allclose(got["nmad"], want["nmad"], rtol=1e-4)
    np.testing.assert_array_equal(got["nb_indep_patches"], want["nb_indep_patches"])
    np.testing.assert_array_equal(got["exact_areas"], want["exact_areas"])


@pytest.mark.parametrize("method", ["cdist_equidistant", "cdist_point", "pdist_point", "pdist_disk", "pdist_ring"])
def test_genton_on_the_card_matches_the_cpu(cuda_device, monkeypatch, method):
    """From one ring draw (the point methods draw with numpy): counts identical, gamma 1e-5."""
    import xdem_tpu_torch.spatialstats as ss

    _z, noise, _dh = _volume_rasters(cuda_device)
    drawn = []
    orig = ss._draw_rings_from_arr

    def replay(seed, arr, *args):
        if not drawn:
            drawn.append(orig(seed, arr, *args))
        return tuple(t.to(arr.device) for t in drawn[0])

    monkeypatch.setattr(ss, "_draw_rings_from_arr", replay)
    kw = dict(gsd=20.0, subsample=400, estimator="genton", subsample_method=method, random_state=7)
    got = ss.sample_empirical_variogram(noise, **kw)
    want = ss.sample_empirical_variogram(noise.cpu(), **kw)
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["exp"], want["exp"], rtol=1e-5, equal_nan=True)


# ---------------------------------------------------------------------- Raster and DEM


def _card_dem(cuda_device):
    """The examples' test DEM on the card and on the CPU."""
    from xdem_tpu_torch import examples

    dem = examples.get_ref_dem_test()
    return dem.copy(new_array=dem.data.to(cuda_device)), dem.copy(new_array=dem.data.cpu())


@pytest.mark.parametrize("method", ["nearest", "bilinear", "cubic"])
@pytest.mark.parametrize("target", ["sub_pixel", "utm32", "laea"])
def test_reproject_on_the_card_matches_the_cpu(cuda_device, method, target):
    """float64 coordinates on both devices: within 1e-6 of the mean magnitude, NaN masks equal
    but for a pixel or two whose centre lies within float64 rounding of the source's edge."""
    gpu, cpu = _card_dem(cuda_device)
    if target == "sub_pixel":
        got, want = (d.reproject(d.translate(7.4, -12.2), resampling=method) for d in (gpu, cpu))
    else:
        crs = 32632 if target == "utm32" else 3035
        got, want = (d.reproject(crs=crs, resampling=method) for d in (gpu, cpu))
    assert got.data.is_cuda and tuple(got.transform) == tuple(want.transform) and got.shape == want.shape
    g, w = got.get_nanarray(), want.get_nanarray()
    assert (np.isnan(g) != np.isnan(w)).sum() <= 2
    assert scaled_dev(g, w) <= 1e-6


def test_to_vcrs_on_the_card_matches_the_cpu(cuda_device):
    gpu, cpu = _card_dem(cuda_device)
    for d in (gpu, cpu):
        d.set_vcrs("EGM96")
    got, want = gpu.to_vcrs("Ellipsoid"), cpu.to_vcrs("Ellipsoid")
    assert got.data.is_cuda and got.vcrs_name == want.vcrs_name == "Ellipsoid"
    np.testing.assert_allclose(got.get_nanarray(), want.get_nanarray(), rtol=0, atol=1e-6)


def test_dem_attributes_on_the_card_equal_the_array_path(cuda_device):
    """A DEM's 14 attributes on the card launch K1, K2 and K3 and equal the array path's bits."""
    gpu, _ = _card_dem(cuda_device)
    suite = ["slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature", "planform_curvature",
             "flowline_curvature", "max_curvature", "min_curvature", "topographic_position_index",
             "terrain_ruggedness_index", "roughness", "rugosity", "fractal_roughness"]
    ck.reset_launch_counts()
    got = gpu.get_terrain_attribute(suite)
    assert ck.LAUNCHES == {"surface_fit": 1, "windowed": 1, "fractal": 1}
    want = terrain.get_terrain_attribute(gpu.data, suite, resolution=gpu.res)
    for a, g, w in zip(suite, got, want):
        assert g.data.is_cuda and g.nodata == -99999 and tuple(g.transform) == tuple(gpu.transform)
        _bit_equal(g.data, w, a)


def _points_on(pc, device):
    from xdem_tpu_torch import EPC

    return EPC(x=pc.x.to(device), y=pc.y.to(device), z=pc.z.to(device), crs=pc.crs)


def _card_point_pair(cuda_device):
    """The examples' 512 x 640 crop (Nuth & Kääb converges there) and 30 000 points of its
    to-be-aligned DEM, on the card and on the CPU."""
    from xdem_tpu_torch import examples

    crop = ((0, 512), (0, 640))
    ref, tba = examples.get_ref_dem().icrop(*crop), examples.get_tba_dem().icrop(*crop)
    pts = tba.to_pointcloud(subsample=30_000, random_state=1)
    return {d.type: (ref.copy(new_array=ref.data.to(d)), tba.copy(new_array=tba.data.to(d)), _points_on(pts, d))
            for d in (cuda_device, torch.device("cpu"))}


@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
def test_raster_point_fits_on_the_card_match_the_cpu(cuda_device, order):
    """One numpy draw of the points on both devices (only the valid count reaches the host):
    Nuth & Kääb and LZD matrices within 1e-4 of their largest entry."""
    on = _card_point_pair(cuda_device)
    for name, kw in (("NuthKaab", {}), ("LZD", {"subsample": 5000})):
        fits = []
        for dev in ("cuda", "cpu"):
            ref, tba, pts = on[dev]
            a, b = (ref, pts) if order == "rst-pts" else (ref.to_pointcloud(subsample=30_000, random_state=2), tba)
            fits.append(getattr(coreg, name)(**kw).fit(a, b, random_state=42).to_matrix())
        assert np.abs(fits[0] - fits[1]).max() <= 1e-4 * np.abs(fits[1]).max(), (name, fits)


def test_apply_matrix_of_an_epc_on_the_card_matches_the_cpu(cuda_device):
    on = _card_point_pair(cuda_device)
    m = coreg.matrix_from_translations_rotations(20, 5, 0.1, 0.1, 0.05, 0.01)
    got, want = (coreg.apply_matrix(on[d][2], m, centroid=(5.03e5, 8.67e6, 300.0)) for d in ("cuda", "cpu"))
    assert got.x.is_cuda and got.x.dtype == torch.float64
    for k in ("x", "y", "z"):
        assert float((getattr(got, k).cpu() - getattr(want, k)).abs().max()) <= 1e-6, k


def test_batched_nuth_kaab_on_the_card_matches_the_cpu_with_the_cards_picks(cuda_device):
    """The card draws each tile's picks; the CPU solves the same picks: tile shifts within
    1e-4 m, iteration counts equal; the warp by the planes within 1e-5 of the mean magnitude."""
    from scipy.ndimage import shift as nd_shift

    from xdem_tpu_torch import DEM
    from xdem_tpu_torch.coreg import affine, blockwise

    n, bs, k = 512, 128, 4000
    z = _dem("cpu", shape=(n, n), seed=4, holes=False).double().numpy()
    rr, cc = np.mgrid[0:n, 0:n]
    ref = z + 40 * np.sin(2 * np.pi * cc / 23) * np.sin(2 * np.pi * rr / 17)
    tba = (nd_shift(ref, (0.23, -0.31), order=3, mode="nearest") + 1.5).astype(np.float32)
    ref = ref.astype(np.float32)
    tba[0:128, 128:228] = np.nan
    inp = blockwise._blockwise_nuth_kaab_inputs(torch.from_numpy(ref).to(cuda_device),
                                                torch.from_numpy(tba).to(cuda_device),
                                                torch.ones((n, n), dtype=torch.bool, device=cuda_device), 42, bs,
                                                n // bs, n // bs, k)
    args = [inp[key] for key in ("pts_z", "rows", "cols", "rasters", "slope_tan", "aspect")]
    gpu = affine._nuth_kaab_solve_batched(*args, 20.0, 20.0, 0.001)
    cpu = affine._nuth_kaab_solve_batched(*(a.cpu() for a in args), 20.0, 20.0, 0.001)
    assert gpu[0].is_cuda and torch.equal(gpu[4].cpu(), cpu[4])
    for g, c in zip(gpu[:2], cpu[:2]):
        assert float((g.cpu() - c).abs().max()) <= 1e-4
    t = Affine.from_origin(502810.0, 8674030.0, 20.0, 20.0)
    fitted = coreg.BlockwiseNuthKaab(block_size_fit=bs, subsample_per_tile=k, random_state=1).fit(
        DEM.from_array(ref, t, 32633), DEM.from_array(tba, t, 32633))
    dem_gpu = DEM.from_array(torch.from_numpy(tba).to(cuda_device), t, 32633)
    dem_cpu = DEM.from_array(torch.from_numpy(tba), t, 32633)
    warped = [fitted.apply(d).get_nanarray() for d in (dem_gpu, dem_cpu)]
    assert np.array_equal(np.isnan(warped[0]), np.isnan(warped[1]))
    assert scaled_dev(warped[0], warped[1]) <= 1e-5


def test_batched_nuth_kaab_waits_for_the_card_once_a_step(cuda_device):
    """The batched solve reads one value back per step ("all tiles done"): CUDA's sync debug
    mode reports no more synchronizing calls than steps."""
    import warnings

    from xdem_tpu_torch.coreg import affine

    g = torch.Generator(device=cuda_device).manual_seed(0)
    t, k = 16, 4000
    ras = torch.rand((t, 64, 64), generator=g, device=cuda_device) * 100
    rows = torch.rand((t, k), generator=g, device=cuda_device) * 50 + 5
    cols = torch.rand((t, k), generator=g, device=cuda_device) * 50 + 5
    z = affine._interp_tiles(ras, rows, cols) + 1.0
    st = torch.rand((t, k), generator=g, device=cuda_device) + 0.1
    asp = torch.rand((t, k), generator=g, device=cuda_device) * 6.28
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")  # also keeps the mode's own "prototype feature" notice
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = affine._nuth_kaab_solve_batched(z, rows, cols, ras, st, asp, 20.0, 20.0, 0.001)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    assert 0 < len(syncs) <= int(out[4].max()), [str(w.message) for w in syncs]


# ---------------------------------------------------------------------- out of core, dDEM, workflows

_TILED = ("slope", "aspect", "hillshade", "max_curvature", "topographic_position_index", "roughness",
          "fractal_roughness")


def test_tiled_on_the_card_equals_the_whole_array(cuda_device, tmp_path):
    """Bands of 512 rows of a 2047 x 2061 DEM with NaN holes: each kernel launches once a band;
    the windowed and fractal attributes equal the whole array's to the bit; the surface-fit
    attributes, whose bands are centred on their own means, differ by float32 rounding: slope
    and hillshade within 1e-3 of their mean magnitude, aspect 0.1 deg where the slope is 1 deg or
    more, the maximum curvature within 1e-3 + 1e-4 of its value, NaN masks identical."""
    from xdem_tpu_torch import io

    dem = _dem(cuda_device, shape=(2047, 2061), seed=11)
    dem[torch.isinf(dem)] = torch.nan  # the GeoTIFF writer stores any non-finite value as nodata
    kw = dict(resolution=20.0, window_size=5, window_size_fractal=13)
    ck.reset_launch_counts()
    paths = terrain.get_terrain_attribute(dem, list(_TILED), tiled=terrain.TilingConfig(tile_rows=512, outdir=str(tmp_path)),
                                          **kw)
    assert ck.LAUNCHES == {"surface_fit": 4, "windowed": 4, "fractal": 4}
    whole = terrain.get_terrain_attribute(dem, list(_TILED), **kw)
    slope = whole[0]
    for a, p, w in zip(_TILED, paths, whole):
        g = io.read_raster(p).data.to(cuda_device)
        assert_same_nan(g.cpu(), w.cpu(), a)
        both = torch.isfinite(g) & torch.isfinite(w)
        if a in ("topographic_position_index", "roughness", "fractal_roughness"):
            _bit_equal(g, w, a)
        elif a == "aspect":
            d = (g - w).abs()
            d = torch.where(both & (slope >= 1.0), torch.minimum(d, 360 - d), 0.0)
            assert float(d.max()) <= 0.1, a
        elif a == "max_curvature":
            assert bool(((g - w).abs() <= 1e-3 + 1e-4 * w.abs())[both].all()), a
        else:
            assert scaled_dev(g.cpu(), w.cpu()) <= 1e-3, a


def test_ddem_collection_on_the_card_matches_the_cpu(cuda_device):
    """subtract_dems with a cubic reprojection, the hypsometric gap filling and the dh series
    on the card against the CPU, from one set of DEMs."""
    import datetime

    from xdem_tpu_torch import DEM, DEMCollection, Vector

    rng = np.random.default_rng(12)
    base = np.add.outer(np.linspace(1500, 300, 256), np.linspace(0, 200, 300)).astype(np.float32)
    older = (base + 5 + rng.normal(0, 0.1, base.shape)).astype(np.float32)
    older[60:80, 60:90] = np.nan
    t = Affine.from_origin(5000, 9000, 20, 20)
    ring = [[np.array([[5400.0, 8600.0], [9000.0, 8600.0], [9000.0, 5000.0], [5400.0, 5000.0]])]]
    on = []
    for d in (cuda_device, torch.device("cpu")):
        dems = [DEM(torch.from_numpy(base).to(d), t, 32633),
                DEM(torch.from_numpy(older).to(d), t.translation(7.4, -12.2), 32633)]
        col = DEMCollection(dems, timestamps=[datetime.date(2020, 8, 1), datetime.date(2010, 8, 1)],
                            outlines=Vector(ring, crs=32633), reference_dem=0)
        col.subtract_dems()
        filled = col.interpolate_ddems("local_hypsometric")
        assert col.ddems[0].data.device.type == d.type
        on.append((col.get_dh_series()["dh"], [torch.from_numpy(np.asarray(f, np.float64)) for f in filled]))
    (dh_g, f_g), (dh_c, f_c) = on
    assert np.isfinite(dh_c).all() and np.abs(dh_g - dh_c).max() <= 1e-5 * np.abs(dh_c).mean()
    for g, c in zip(f_g, f_c):
        assert_same_nan(g, c, "filled")
        if float(c.abs().nan_to_num().max()) > 0:
            assert scaled_dev(g, c) <= 1e-4


def test_topo_on_the_card_launches_each_kernel(cuda_device, tmp_path):
    from xdem_tpu_torch import Raster
    from xdem_tpu_torch.workflows import Topo

    path = str(tmp_path / "dem.tif")
    Raster(_dem(cuda_device, shape=(512, 520), seed=13, holes=False), Affine.from_origin(0, 20000, 20, 20), 32633).save(path)
    ck.reset_launch_counts()
    Topo({"inputs": {"path_to_elev": path},
          "terrain_attributes": ["slope", "aspect", "max_curvature", "terrain_ruggedness_index", "fractal_roughness"],
          "outputs": {"path": str(tmp_path / "out"), "level": 1}}).run()
    assert ck.LAUNCHES == {"surface_fit": 3, "windowed": 1, "fractal": 1}
    assert (tmp_path / "out" / "tables" / "fractal_roughness_stats.csv").exists()


# ---------------------------------------------------------------------- the mesh on one card


def test_sharded_suite_on_the_card_launches_each_kernel_once_a_shard(cuda_device):
    """mesh= over four shards of one card: K1, K2 and K3 launch once per shard and the planes
    equal the whole-array planes to the bit."""
    from xdem_tpu_torch.parallel import make_mesh

    dem = _dem(cuda_device)
    attrs = ["slope", "aspect", "hillshade", "max_curvature", "topographic_position_index",
             "terrain_ruggedness_index", "roughness", "rugosity", "fractal_roughness"]
    whole = terrain.get_terrain_attribute(dem, attrs, resolution=20.0)
    for shape in ((2, 2), (1, 4)):
        ck.reset_launch_counts()
        got = terrain.get_terrain_attribute(dem, attrs, resolution=20.0,
                                            mesh=make_mesh(devices=[cuda_device] * 4, shape=shape))
        assert dict(ck.LAUNCHES) == {"surface_fit": 4, "windowed": 4, "fractal": 4}
        for a, g, w in zip(attrs, got, whole):
            assert all(b.device == cuda_device for row in g.blocks for b in row)
            _bit_equal(g.to(cuda_device), w, a)


def _cards():
    """Every visible card (counted when the test runs, never at import)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_each_kernel_matches_plain_on_every_card(cuda_device):
    """K1, K2 and K3 launch on each visible card (its own stream, its context) and equal their
    plain versions there to the bit (K1's given the centre kernel's value on that card)."""
    attrs = ("slope", "aspect", "hillshade", "max_curvature", "profile_curvature")
    for dev in _cards():
        dem = _dem(dev)
        ck.reset_launch_counts()
        k1 = ck.surface_attributes(dem, 20.0, attrs)
        k2 = ck.windowed_indexes(dem, 20.0, _WA, 3)
        k3 = ck.fractal_roughness(dem, 13)
        assert dict(ck.LAUNCHES) == {"surface_fit": 1, "windowed": 1, "fractal": 1}, dev
        assert k1.device == k2.device == k3.device == dev
        center = ck.dem_center(dem)
        for got, want, names in ((k1, surfit.surface_attributes(dem, 20.0, attrs, center=center), attrs),
                                 (k2, window.windowed_indexes(dem, 20.0, _WA, 3), _WA),
                                 (k3[None], window.fractal_roughness(dem, 13)[None], ("fractal_roughness",))):
            for i, a in enumerate(names):
                _bit_equal(got[i], want[i], f"{a} on {dev}")


def test_mesh_over_every_card_keeps_each_block_on_its_card(cuda_device):
    """mesh= over every visible card (one block a card; on one card four blocks of it): the
    blocks stay on their cards and the assembled planes equal the whole-array planes."""
    from xdem_tpu_torch.parallel import make_mesh

    cards = _cards()
    devices = cards if len(cards) > 1 else [cuda_device] * 4
    mesh = make_mesh(devices=devices)
    dem = _dem(cuda_device)
    attrs = ["slope", "max_curvature", "terrain_ruggedness_index", "rugosity", "fractal_roughness"]
    whole = terrain.get_terrain_attribute(dem, attrs, resolution=20.0)
    ck.reset_launch_counts()
    got = terrain.get_terrain_attribute(dem, attrs, resolution=20.0, mesh=mesh)
    assert dict(ck.LAUNCHES) == {k: len(devices) for k in ("surface_fit", "windowed", "fractal")}
    for a, g, w in zip(attrs, got, whole):
        for iy, row in enumerate(g.blocks):
            for ix, b in enumerate(row):
                assert b.device == mesh.devices[iy, ix], a
        _bit_equal(g.to(cuda_device), w, a)


def test_sharded_fits_on_the_card_equal_the_single_device_fits(cuda_device):
    from xdem_tpu_torch.parallel import make_mesh

    ref = _dem(cuda_device, shape=(384, 384), holes=False)
    tba = torch.roll(ref, (1, -2), dims=(0, 1)) + 1.0
    t = Affine.from_origin(5e5, 8e6, 20.0, 20.0)
    mesh = make_mesh(devices=[cuda_device] * 4)
    kw = dict(transform=t, crs=32633, random_state=1)
    for make in (lambda: coreg.VerticalShift(), lambda: coreg.NuthKaab(subsample=20000),
                 lambda: coreg.DhMinimize(subsample=20000), lambda: coreg.ICP(subsample=3000, nn_method="brute")):
        np.testing.assert_array_equal(make().fit(ref, tba, mesh=mesh, **kw).to_matrix(),
                                      make().fit(ref, tba, **kw).to_matrix())


def test_the_centre_span_times_dem_center_on_its_stream(cuda_device):
    """`terrain.center`'s stream time, from the span's own events, is within 2x of CUDA events
    around `cuda_kernels.dem_center` alone (medians of five calls at 16384^2, where the card's work
    outlasts the host's launches under the profiler: one pass over 1.07 GB takes ~0.35 ms on an
    H100, the host ~0.13 ms a call; at 8192^2 the pass takes less than the host)."""
    from xdem_tpu_torch import profiler

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    dem = torch.rand((16384, 16384), generator=gen, device=cuda_device) * 1000.0
    dem[100:120, 200:260] = float("nan")
    ck.dem_center(dem)
    alone = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ck.dem_center(dem)
        end.record()
        end.synchronize()
        alone.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():  # torch 2.11 warns at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=acts):
            for _ in range(5):
                ck.dem_center(dem)
            torch.cuda.synchronize(cuda_device)
    spans = [r for r in profiler.spans() if r.name == "xdem_tpu_torch.terrain.center"]
    assert len(spans) == 5 and all(set(r.ms) == {dem.device.index} for r in spans)
    traced = float(np.median([r.ms[dem.device.index] for r in spans]))
    assert 0.5 <= traced / float(np.median(alone)) <= 2.0, ([r.ms for r in spans], alone)


def _float64_centre(d: torch.Tensor) -> float:
    """The mean of the finite values in float64, chunk by chunk (no float64 copy of a big DEM)."""
    flat, total, count = d.reshape(-1), 0.0, 0
    for part in flat.split(1 << 28):
        valid = torch.isfinite(part)
        total += float(torch.where(valid, part, 0.0).double().sum())
        count += int(valid.sum())
    return total / count if count else 0.0


def _within_an_ulp(got: torch.Tensor, want: float) -> bool:
    w = np.float32(want)
    return got.dtype == torch.float32 and got.shape == () and abs(float(got) - float(w)) <= float(np.spacing(abs(w)))


@pytest.mark.parametrize("shape,offset", [((301, 389), 0), ((300, 1002), 0), ((300, 1002), 1), ((2048, 3001), 3)],
                         ids=["odd width", "width not a multiple of 4", "view at an offset", "many blocks, offset"])
def test_the_centre_kernel_is_the_float64_mean_within_an_ulp(cuda_device, shape, offset):
    """On the card the centre kernel is the float64 mean of the finite pixels rounded to float32, within
    one float32 ulp, on DEMs with NaN and +-inf voids, at widths that leave a ragged tail of
    16-byte vectors and on a contiguous view that starts off a 16-byte boundary."""
    base = _dem(cuda_device, shape=(shape[0] + 1, shape[1]), seed=3)
    base[7, 11], base[20, 3] = -math.inf, math.inf
    n = shape[0] * shape[1]
    dem = base.reshape(-1)[offset:offset + n].reshape(shape)
    assert dem.is_contiguous() and (dem.data_ptr() % 16 == 0) == (offset == 0)
    assert _within_an_ulp(ck.dem_center(dem), _float64_centre(dem))


def test_the_centre_kernel_of_nothing_finite_is_zero(cuda_device):
    for dem in (torch.full((33, 47), math.nan, device=cuda_device),
                torch.tensor([[math.inf, -math.inf, math.nan]], device=cuda_device),
                torch.empty((0, 5), device=cuda_device)):
        got = ck.dem_center(dem)
        assert got.is_cuda and got.shape == () and float(got) == 0.0 and not math.copysign(1.0, float(got)) < 0


def test_the_centre_kernel_gives_the_same_bits_every_call(cuda_device):
    dem = _dem(cuda_device, shape=(1500, 2001), seed=5)
    first = ck.dem_center(dem)
    assert all(torch.equal(ck.dem_center(dem).view(torch.int32), first.view(torch.int32)) for _ in range(20))


def test_the_centre_kernel_sums_past_two_to_the_31_values(cuda_device):
    """A DEM of more than 2^31 float32 values (8.6 GB) is summed whole: 64-bit indices."""
    n = 2**31 + 4099
    if torch.cuda.mem_get_info(cuda_device)[0] < 4 * n + (4 << 30):
        pytest.skip("the card has no room for a DEM of more than 2^31 values")
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    dem = torch.rand(n, generator=gen, device=cuda_device).add_(1.0).mul_(500.0)
    dem[1 << 31:].fill_(4000.0)  # the values past 2^31 move the mean by 6e-3 m, ~100 ulps of it
    dem[:1000].fill_(math.nan)
    dem[-7:].fill_(math.inf)
    dem = dem[1:].reshape(1, -1)  # an unaligned view, as large
    want = _float64_centre(dem)
    assert _within_an_ulp(ck.dem_center(dem), want)
    del dem


def test_the_centre_span_counts_the_kernel_once_a_call(cuda_device):
    """Inside a recorded span the card's float32 centre counts `kernel` once a call, and
    CALL_LAUNCHES with it; the plain version on the card counts nothing, and the wrapper refuses a
    float64 DEM on the card."""
    from xdem_tpu_torch import profiler

    dem = _dem(cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ck.reset_launch_counts()
    with warnings.catch_warnings():  # torch 2.11 warns at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=acts):
            for _ in range(3):
                ck.dem_center(dem)
            surfit.dem_center(dem)
            torch.cuda.synchronize(cuda_device)
    spans = [r for r in profiler.spans() if r.name == "xdem_tpu_torch.terrain.center"]
    assert [r.counters for r in spans] == [{"kernel": 1}] * 3 + [{}]
    assert ck.CALL_LAUNCHES == {"center": 3} and ck.LAUNCHES == {"surface_fit": 0, "windowed": 0, "fractal": 0}
    with pytest.raises(ValueError, match="float32"):
        ck.dem_center(dem.double())
