"""Raster-point coregistration of xdem_tpu_torch against xdem_tpu's, on the 512 x 640 crop of
the examples (Nuth & Kääb oscillates on the 256^2 test pair) and clouds drawn from its DEMs.

Both packages draw the points' subsample with numpy from one seed, so the picks are the same
bits (the port computes the points' validity on the device and brings only the valid count
to the host) and the fits are held tightly: shifts and matrices within 1e-3 of their largest
entry (plus 1 mm) for every affine method in both orders of the pair, the bias corrections'
applied fields within 1e-3 m. Also: the subsample and its validity rules (a point whose
bilinear footprint touches nodata is excluded), the half-pixel shift of a "Point" raster,
two point clouds refused as xdem_tpu refuses them, and the matrix apply to an EPC within
1e-6 m of xdem_tpu's points.
"""

import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap, shared setup)
from torch_port_helpers import to_np

from xdem_tpu import coreg as jcoreg
from xdem_tpu import examples as jex
from xdem_tpu.coreg import affine as jaffine
from xdem_tpu.coreg import base as jbase
from xdem_tpu_torch import EPC, PointCloud, coreg, examples
from xdem_tpu_torch.config import config_context
from xdem_tpu_torch.coreg import affine, base

CROP = ((0, 512), (0, 640))
N_POINTS = 30_000


@pytest.fixture(scope="module")
def grids():
    ours = tuple(d.icrop(*CROP) for d in (examples.get_ref_dem(), examples.get_tba_dem()))
    theirs = tuple(d.icrop(*CROP) for d in (jex.get_ref_dem(), jex.get_tba_dem()))
    return ours, theirs


@pytest.fixture(scope="module")
def clouds(grids):
    """Points of the to-be-aligned DEM and of the reference DEM, in both packages."""
    (ref, tba), (jref, jtba) = grids
    return ((tba.to_pointcloud(subsample=N_POINTS, random_state=1), ref.to_pointcloud(subsample=N_POINTS, random_state=2)),
            (jtba.to_pointcloud(subsample=N_POINTS, random_state=1), jref.to_pointcloud(subsample=N_POINTS, random_state=2)))


def _pairs(grids, clouds, order):
    """(reference, to-be-aligned) of a raster-point pair in both packages."""
    (ref, tba), (jref, jtba) = grids
    (tba_pts, ref_pts), (jtba_pts, jref_pts) = clouds
    if order == "rst-pts":
        return (ref, tba_pts), (jref, jtba_pts)
    return (ref_pts, tba), (jref_pts, jtba)


def _close(got, want, rel=1e-3, atol=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + atol, (got, want)


# ---------------------------------------------------------------------- subsample

@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
@pytest.mark.parametrize("masked", [False, True])
def test_subsample_pair_identical_to_jax(grids, clouds, order, masked):
    (a, b), (ja, jb) = _pairs(grids, clouds, order)
    grid = b.data if order == "pts-rst" else a.data
    t = grids[0][0].transform
    mask = np.ones(grid.shape, bool)
    if masked:
        mask[100:300, 200:400] = False
    aux = {"slope": np.gradient(to_np(grid).astype(np.float64))[0]}
    g, j = (x.data if hasattr(x, "transform") else x for x in (a, b)), (x.data if hasattr(x, "transform") else x for x in (ja, jb))
    got = affine._subsample_pair(*g, mask, t, 5000, 42, aux_vars={k: torch.from_numpy(v) for k, v in aux.items()})
    want = jaffine._subsample_pair(*j, mask, jbase.Affine(*t), 5000, 42, aux_vars=aux)
    assert got["count"] == want["count"] and got["invert"] == want["invert"] == (order == "rst-pts")
    for k in ("pts_z", "rows", "cols"):
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(to_np(got["aux"]["slope"]), want["aux"]["slope"])


@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
def test_subsample_pair_values_identical_to_jax(grids, clouds, order):
    (a, b), (ja, jb) = _pairs(grids, clouds, order)
    t = grids[0][0].transform
    grid = b.data if order == "pts-rst" else a.data
    mask = np.ones(grid.shape, bool)
    mask[:, :50] = False
    aux = {"curv": to_np(grid).astype(np.float32) * 0.01}
    g = [x.data if hasattr(x, "transform") else x for x in (a, b)]
    j = [x.data if hasattr(x, "transform") else x for x in (ja, jb)]
    got = affine._subsample_pair_values(*g, mask, t, 4000, 7, aux_vars={"curv": torch.from_numpy(aux["curv"])})
    want = jaffine._subsample_pair_values(*j, mask, jbase.Affine(*t), 4000, 7, aux_vars=aux)
    for gv, wv in zip(got[:4], want[:4]):
        np.testing.assert_allclose(gv, wv, rtol=1e-7, atol=0)
    np.testing.assert_allclose(got[4]["curv"], want[4]["curv"], rtol=1e-6)


def test_point_near_nodata_edge_excluded(grids):
    """A point whose bilinear footprint touches nodata does not pass the validity test."""
    ref = grids[0][0]
    rst = ref.data.clone()
    rst[50, 60] = torch.nan
    t = ref.transform
    x_in, y_in = t.xy(np.array([49.6]), np.array([59.6]))
    x_ok, y_ok = t.xy(np.array([49.6]), np.array([57.4]))
    pts = PointCloud(np.concatenate([x_in, x_ok]), np.concatenate([y_in, y_ok]), np.array([1000.0, 1000.0]), crs=ref.crs)
    sub = affine._subsample_pair(pts, rst, None, t, subsample=10, random_state=0)
    assert sub["count"] == 1
    assert float(sub["rows"][0]) == pytest.approx(49.6, abs=1e-3)
    assert float(sub["cols"][0]) == pytest.approx(57.4, abs=1e-3)
    with pytest.raises(ValueError, match="No valid points"):
        affine._subsample_pair(pts.translate(1e6, 0.0), rst, None, t, subsample=10, random_state=0)


# ---------------------------------------------------------------------- the fits

AFFINE = {
    "VerticalShift": dict(),
    "NuthKaab": dict(),
    "DhMinimize": dict(subsample=3000),
    "ICP": dict(subsample=5000),
    "CPD": dict(subsample=800),
    "LZD": dict(subsample=5000),
}


@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
@pytest.mark.parametrize("name", list(AFFINE))
def test_affine_fits_match_xdem_tpu(grids, clouds, name, order):
    (a, b), (ja, jb) = _pairs(grids, clouds, order)
    p = getattr(coreg, name)(**AFFINE[name]).fit(a, b, random_state=42)
    j = getattr(jcoreg, name)(**AFFINE[name]).fit(ja, jb, random_state=42)
    _close(p.to_matrix(), j.to_matrix())
    assert p.meta["outputs"]["random"]["subsample_final"] == j.meta["outputs"]["random"]["subsample_final"]
    if name in ("VerticalShift", "NuthKaab"):  # the pair is the examples' TBA_SHIFT apart in both orders
        assert p.to_matrix()[2, 3] == pytest.approx(-examples.TBA_SHIFT[2], abs=0.1)


BIAS = {
    "Deramp": lambda m: m.Deramp(subsample=8000),
    "DirectionalBias": lambda m: m.DirectionalBias(angle=30, subsample=8000),
    "TerrainBias": lambda m: m.TerrainBias(terrain_attribute="slope", subsample=8000),
}


def _grid_side_slope(grids, order):
    """xdem_tpu's slope of the grid side of the pair, as the bias variable of both packages:
    a float32 ulp of slope moves a point across one of the 100 bin edges, which moves that
    bin's median by centimetres."""
    jgrid = grids[1][0] if order == "rst-pts" else grids[1][1]
    s = np.array(jgrid.slope().data)
    return {"slope": torch.from_numpy(s)}, {"slope": s}


@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
@pytest.mark.parametrize("name", list(BIAS))
def test_bias_corrections_match_xdem_tpu(grids, clouds, name, order):
    """Each correction fits a raster-point pair (its variables read on the grid side, and at
    the points by bilinear interpolation) and its field over the grid equals xdem_tpu's within
    1e-3 m."""
    (a, b), (ja, jb) = _pairs(grids, clouds, order)
    bv, jbv = _grid_side_slope(grids, order) if name == "TerrainBias" else (None, None)
    p = BIAS[name](coreg).fit(a, b, bias_vars=bv, random_state=3)
    j = BIAS[name](jcoreg).fit(ja, jb, bias_vars=jbv, random_state=3)
    assert p.meta["outputs"]["random"]["subsample_final"] == j.meta["outputs"]["random"]["subsample_final"]
    grid, jgrid = grids[0][1], grids[1][1]
    got, want = p.apply(grid, bias_vars=bv).get_nanarray(), np.asarray(j.apply(jgrid, bias_vars=jbv).data)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], rtol=0, atol=1e-3)
    assert np.nanmax(np.abs(got - grid.get_nanarray())) > 1e-3  # the correction is not empty
    with pytest.raises(NotImplementedError, match="rasters"):
        p.apply(clouds[0][0])


@pytest.mark.parametrize("order", ["rst-pts", "pts-rst"])
def test_terrain_bias_reads_the_grid_sides_attribute(grids, clouds, order):
    """Without bias_vars, TerrainBias computes its attribute on the grid side of the pair
    (through K1, whose plain version runs here): the fit equals the one given that slope."""
    (a, b), _ = _pairs(grids, clouds, order)
    grid = a if order == "rst-pts" else b
    p = coreg.TerrainBias(terrain_attribute="slope", subsample=8000).fit(a, b, random_state=3)
    q = coreg.TerrainBias(terrain_attribute="slope", subsample=8000).fit(a, b, bias_vars={"slope": grid.slope().data},
                                                                       random_state=3)
    got, want = (c.meta["outputs"]["fitorbin"]["bin_dataframe"] for c in (p, q))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_point_raster_half_pixel_shift_matches_xdem_tpu(grids, clouds):
    """A "Point" raster in a raster-point pair gets a working transform moved by half a
    pixel (the gathers assume pixel centres), as in xdem_tpu; a raster-raster pair does not."""
    (ref, _), (jref, _) = grids
    (tba_pts, _), (jtba_pts, _) = clouds
    pt, jpt = ref.copy(), jref.copy()
    pt.set_area_or_point("Point")
    jpt.set_area_or_point("Point")
    *_, t, _, aop = base._preprocess_coreg_fit(pt, tba_pts, None, None)
    *_, jt, _, jaop = jbase._preprocess_coreg_fit(jpt, jtba_pts, None, None)
    # set_area_or_point moved the raster's georeferencing by half a pixel; the fit moves the
    # working transform back onto the pixel centres' convention of the gathers.
    assert tuple(pt.transform) == tuple(ref.transform.translation(10.0, -10.0))
    assert aop == jaop == "Point" and tuple(t) == tuple(jt) == tuple(pt.transform.translation(-10.0, 10.0))
    with config_context(shift_area_or_point=False):
        assert tuple(base._preprocess_coreg_fit(pt, tba_pts, None, None)[3]) == tuple(pt.transform)
    p = coreg.NuthKaab().fit(pt, tba_pts, random_state=42)
    j = jcoreg.NuthKaab().fit(jpt, jtba_pts, random_state=42)
    _close(p.to_matrix(), j.to_matrix())
    with config_context(shift_area_or_point=False):
        unshifted = coreg.NuthKaab().fit(pt, tba_pts, random_state=42)
    assert abs(p.to_matrix()[0, 3] - unshifted.to_matrix()[0, 3]) > 1.0  # half a 20 m pixel moves the fit


def test_points_in_another_crs_are_moved_to_the_rasters(grids, clouds):
    (ref, _), (jref, _) = grids
    (tba_pts, _), (jtba_pts, _) = clouds
    p = coreg.VerticalShift().fit(ref, tba_pts.to_crs(32632), random_state=1)
    j = jcoreg.VerticalShift().fit(jref, jtba_pts.to_crs(32632), random_state=1)
    assert p.to_matrix()[2, 3] == pytest.approx(j.to_matrix()[2, 3], abs=1e-4)


@pytest.mark.parametrize("name", ["VerticalShift", "NuthKaab", "DhMinimize", "ICP", "LZD", "Deramp"])
def test_two_point_clouds_raise_as_in_xdem_tpu(clouds, name):
    (a, b), (ja, jb) = clouds
    with pytest.raises(NotImplementedError) as ours:
        getattr(coreg, name)().fit(b, a)
    with pytest.raises(NotImplementedError) as theirs:
        getattr(jcoreg, name)().fit(jb, ja)
    assert type(ours.value).__name__ == type(theirs.value).__name__ == "NotImplementedCoregFit"
    assert str(ours.value) == str(theirs.value)
    t, jt = examples.get_ref_dem_test().transform, jex.get_ref_dem_test().transform
    for ours_fn, theirs_fn, args in ((affine.nuth_kaab, jaffine.nuth_kaab, (1e-3, 10, 5000, 0)),
                                     (affine.lzd, jaffine.lzd, (5000, 0))):
        with pytest.raises(TypeError, match="two point clouds") as ours:
            ours_fn(b, a, None, t, None, *args)
        with pytest.raises(TypeError, match="two point clouds") as theirs:
            theirs_fn(jb, ja, None, jt, None, *args)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------- applies to points

@pytest.mark.parametrize("name", list(AFFINE))
def test_apply_to_an_epc_matches_xdem_tpu(grids, clouds, name):
    """Each fitted affine method moves an EPC, in float64 on its device, to xdem_tpu's points
    within 1e-6 m (the same matrix handed to both)."""
    (ref, _), (jref, _) = grids
    (tba_pts, _), (jtba_pts, _) = clouds
    p = getattr(coreg, name)(**AFFINE[name]).fit(ref, tba_pts, random_state=42)
    j = getattr(jcoreg, name)(**AFFINE[name]).fit(jref, jtba_pts, random_state=42)
    j._meta["outputs"]["affine"] = dict(p.meta["outputs"]["affine"])  # one matrix, one centroid
    got, want = p.apply(tba_pts), j.apply(jtba_pts)
    assert isinstance(got, EPC) and got.x.dtype == torch.float64
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(to_np(getattr(got, k)), np.asarray(getattr(want, k)), rtol=0, atol=1e-6)


def test_apply_matrix_to_points_and_frames_matches_xdem_tpu(clouds):
    (pts, _), (jpts, _) = clouds
    m = coreg.matrix_from_translations_rotations(3.0, -2.0, 1.0, 0.2, -0.1, 0.3)
    c = (float(pts.x.mean()), float(pts.y.mean()), 300.0)
    for kw in (dict(), dict(centroid=c), dict(centroid=c, invert=True)):
        got, want = coreg.apply_matrix(pts, m, **kw), jbase.apply_matrix(jpts, m, **kw)
        for k in ("x", "y", "z"):
            np.testing.assert_allclose(to_np(getattr(got, k)), getattr(want, k), rtol=0, atol=1e-6)
    frame = pd.DataFrame({"X": to_np(pts.x), "Y": to_np(pts.y), "h": to_np(pts.z)})
    got, want = coreg.apply_matrix(frame, m, z_name="h", centroid=c), jbase.apply_matrix(frame, m, z_name="h", centroid=c)
    for k in ("X", "Y", "h"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="z_name"):
        coreg.apply_matrix(frame, m)


def test_initial_shift_and_pipeline_on_points_match_xdem_tpu(grids, clouds):
    (ref, _), (jref, _) = grids
    (tba_pts, _), (jtba_pts, _) = clouds
    p = coreg.NuthKaab(initial_shift=(5.0, -3.0)).fit(ref, tba_pts, random_state=42)
    j = jcoreg.NuthKaab(initial_shift=(5.0, -3.0)).fit(jref, jtba_pts, random_state=42)
    _close(p.to_matrix(), j.to_matrix())
    p = (coreg.VerticalShift() + coreg.NuthKaab()).fit(ref, tba_pts, random_state=42)
    j = (jcoreg.VerticalShift() + jcoreg.NuthKaab()).fit(jref, jtba_pts, random_state=42)
    _close(p.to_matrix(), j.to_matrix())
    moved = p.apply(tba_pts)
    assert isinstance(moved, EPC)
    np.testing.assert_allclose(to_np(moved.z - tba_pts.z), p.to_matrix()[2, 3], atol=1e-6)
