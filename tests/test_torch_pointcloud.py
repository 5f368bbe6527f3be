"""xdem_tpu_torch's PointCloud and EPC against xdem_tpu's, on seeded clouds of <= 1e5 points.

Files (LAS, npz, text) written by either package read back in the other to the same points
and EPSG; the points' CRS transform within 1e-8 m (torch's and numpy's libm differ by an ulp,
test_torch_raster.py); the vertical CRS transform within 1e-4 m; gridding, rasterizing,
cropping, subsampling and statistics equal to xdem_tpu's; the objects' entry points
(Raster/DEM.to_pointcloud, examples.get_epc, EPC.coregister_3d, DEM.estimate_uncertainty of
an EPC or a frame with per-point, grid, Raster and Vector stable masks: sigma within 5e-3 at
p99.9 and 1e-2 at most of its mean, rho within 5e-3) and the constructor's dispatch by type.
"""

import contextlib
import inspect

import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap, shared setup)
from torch_port_helpers import to_np

import xdem_tpu
from xdem_tpu import coreg as jcoreg
from xdem_tpu import epc as jepc
from xdem_tpu import examples as jex
from xdem_tpu import pointcloud as jpc
from xdem_tpu_torch import DEM, EPC, PointCloud, Raster, coreg, epc, examples
from xdem_tpu_torch.georef import Affine

N_POINTS = 20_000
ORIGIN = (5e5, 8e6)


def _xyz(n=N_POINTS, seed=0):
    rng = np.random.default_rng(seed)
    x = ORIGIN[0] + rng.uniform(0, 5000, n)
    y = ORIGIN[1] - rng.uniform(0, 4000, n)
    z = 300 + 50 * np.sin(x / 700.0) + 30 * np.cos(y / 500.0) + rng.normal(0, 0.5, n)
    z[::97] = np.nan
    return x, y, z


@pytest.fixture(scope="module")
def clouds():
    x, y, z = _xyz()
    return PointCloud(x, y, z, crs=32633, device="cpu"), jpc.PointCloud(x, y, z, crs=32633)


def _same_points(ours, theirs, atol=0.0):
    for a in ("x", "y", "z"):
        np.testing.assert_allclose(to_np(getattr(ours, a)), np.asarray(getattr(theirs, a)), rtol=0, atol=atol)


# ---------------------------------------------------------------------- the container

def test_points_are_float64_tensors_on_one_device(clouds):
    ours, theirs = clouds
    for a in ("x", "y", "z"):
        t = getattr(ours, a)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float64 and t.device == ours.device
    assert len(ours) == len(theirs) == ours.point_count == ours.nb_points
    assert ours.bounds == theirs.bounds
    np.testing.assert_array_equal(to_np(ours.ds), theirs.ds)
    assert ours.info() == theirs.info()
    # A tensor keeps its device; host data goes to the device asked for.
    assert PointCloud(torch.zeros(3), torch.zeros(3), torch.zeros(3), crs=32633).device.type == "cpu"


def test_constructors_copy_subset_and_translate_match(clouds):
    ours, theirs = clouds
    arr = np.column_stack([to_np(ours.x), to_np(ours.y), to_np(ours.z)])[:50]
    for build in ("from_array", "from_array_T", "from_tuples", "from_xyz"):
        if build == "from_array":
            o, t = PointCloud.from_array(arr, 32633), jpc.PointCloud.from_array(arr, 32633)
        elif build == "from_array_T":
            o, t = PointCloud.from_array(torch.from_numpy(arr.T.copy()), 32633), jpc.PointCloud.from_array(arr.T, 32633)
        elif build == "from_tuples":
            o, t = PointCloud.from_tuples(map(tuple, arr), 32633), jpc.PointCloud.from_tuples(map(tuple, arr), 32633)
        else:
            o, t = PointCloud.from_xyz(*arr.T, 32633), jpc.PointCloud.from_xyz(*arr.T, 32633)
        _same_points(o, t)
    with pytest.raises(ValueError, match="Expected an"):
        PointCloud.from_array(np.zeros((4, 4)), 32633)
    with pytest.raises(ValueError, match="same shape"):
        PointCloud(np.zeros(3), np.zeros(3), np.zeros(4), crs=32633)
    new = np.arange(len(ours), dtype=np.float64)
    _same_points(ours.copy(new_array=new), theirs.copy(new_array=new))
    with pytest.raises(ValueError, match="new_array must have shape"):
        ours.copy(new_array=np.zeros(3))
    keep = np.arange(len(ours)) % 3 == 0
    _same_points(ours.subset(keep), theirs.subset(keep))
    _same_points(ours.subset(torch.arange(10)), theirs.subset(np.arange(10)))
    _same_points(ours.translate(1.5, -2.0, 0.25), theirs.translate(1.5, -2.0, 0.25))
    c = ours.copy()
    c.z[0] = -1.0
    assert float(ours.z[0]) != -1.0  # copies do not share storage


@pytest.mark.parametrize("sub,seed", [(0.1, 3), (500, 11), (1, 0)])
def test_subsample_draws_the_same_points(clouds, sub, seed):
    ours, theirs = clouds
    _same_points(ours.subsample(sub, random_state=seed), theirs.subsample(sub, random_state=seed))


def test_crop_and_get_stats_match(clouds):
    ours, theirs = clouds
    box = (ORIGIN[0] + 1000, ORIGIN[1] - 3000, ORIGIN[0] + 4000, ORIGIN[1] - 500)
    _same_points(ours.crop(box), theirs.crop(box))
    raster = Raster(np.zeros((10, 10), np.float32), Affine.from_origin(ORIGIN[0] + 200, ORIGIN[1] - 100, 100, 100), 32633)
    jraster = xdem_tpu.Raster(np.zeros((10, 10), np.float32),
                              xdem_tpu.georef.Affine.from_origin(ORIGIN[0] + 200, ORIGIN[1] - 100, 100, 100), 32633)
    _same_points(ours.crop(raster), theirs.crop(jraster))
    assert ours.get_stats() == theirs.get_stats()
    assert ours.get_stats("nmad") == theirs.get_stats("nmad")
    assert ours.get_stats(["LE90", "90thpercentile", "sumofsquares"]) == \
        theirs.get_stats(["LE90", "90thpercentile", "sumofsquares"])


# ---------------------------------------------------------------------- CRS

def test_to_crs_matches_xdem_tpu(clouds):
    ours, theirs = clouds
    for dst in (32632, 4326, 3413):
        got, want = ours.to_crs(dst), theirs.to_crs(dst)
        assert got.crs == want.crs.to_epsg() and got.x.device == ours.device
        tol = 1e-12 if dst == 4326 else 1e-8  # degrees, metres
        np.testing.assert_allclose(to_np(got.x), want.x, rtol=0, atol=tol)
        np.testing.assert_allclose(to_np(got.y), want.y, rtol=0, atol=tol)
        np.testing.assert_array_equal(to_np(got.z), want.z)
    _same_points(ours.reproject(32632), theirs.reproject(32632), atol=1e-8)


@pytest.mark.parametrize("src,dst", [("EGM96", "Ellipsoid"), ("Ellipsoid", "EGM08")])
def test_to_vcrs_matches_xdem_tpu(clouds, src, dst):
    x, y, z = (to_np(v) for v in (clouds[0].x, clouds[0].y, clouds[0].z))
    ours, theirs = EPC(x=x, y=y, z=z, crs=32633, vcrs=src), jepc.EPC(x=x, y=y, z=z, crs=32633, vcrs=src)
    assert ours.vcrs_name == theirs.vcrs_name and ours.vcrs_grid == theirs.vcrs_grid and ours.ccrs == theirs.ccrs
    got, want = ours.to_vcrs(dst), theirs.to_vcrs(dst)
    assert got.vcrs_name == want.vcrs_name and got.z.dtype == torch.float64
    np.testing.assert_allclose(to_np(got.z), want.z, rtol=0, atol=1e-4)
    assert np.nanmin(np.abs(to_np(got.z) - z)) > 1.0  # the geoid lies ~30 m above the ellipsoid here
    assert ours.to_vcrs(dst, inplace=True) is None
    assert torch.equal(torch.nan_to_num(ours.z), torch.nan_to_num(got.z)) and ours.vcrs_name == got.vcrs_name
    with pytest.warns(UserWarning, match="same"):
        assert ours.to_vcrs(dst) is None
    with pytest.raises(ValueError, match="no vertical CRS"):
        EPC(x=x, y=y, z=z, crs=32633).to_vcrs(dst)


# ---------------------------------------------------------------------- gridding

GRID = Affine.from_origin(ORIGIN[0], ORIGIN[1], 50, 50)
JGRID = xdem_tpu.georef.Affine.from_origin(ORIGIN[0], ORIGIN[1], 50, 50)
SHAPE = (90, 110)


@pytest.mark.parametrize("resampling", ["mean", "linear"])
def test_grid_matches_xdem_tpu(clouds, resampling):
    ours, theirs = clouds
    got = ours.grid(transform=GRID, shape=SHAPE, resampling=resampling)
    want = theirs.grid(transform=JGRID, shape=SHAPE, resampling=resampling)
    assert isinstance(got, Raster) and got.data.dtype == torch.float32
    np.testing.assert_array_equal(got.get_nanarray(), np.asarray(want.data))
    # A degenerate cloud (no triangulation) falls back to the binned mean in both.
    few = ours.subset(np.arange(2))
    np.testing.assert_array_equal(few.grid(transform=GRID, shape=SHAPE).get_nanarray(),
                                  np.asarray(theirs.subset(np.arange(2)).grid(transform=JGRID, shape=SHAPE).data))


@pytest.mark.parametrize("statistic", ["mean", "count", "min", "max"])
def test_rasterize_matches_xdem_tpu(clouds, statistic):
    ours, theirs = clouds
    got = ours.rasterize(transform=GRID, shape=SHAPE, statistic=statistic)
    want = theirs.rasterize(transform=JGRID, shape=SHAPE, statistic=statistic)
    np.testing.assert_array_equal(got.get_nanarray(), np.asarray(want.data))
    ref = Raster(np.zeros(SHAPE, np.float32), GRID, 32633)
    np.testing.assert_array_equal(ours.rasterize(ref, statistic=statistic).get_nanarray(), got.get_nanarray())
    with pytest.raises(ValueError, match="statistic must be"):
        ours.rasterize(transform=GRID, shape=SHAPE, statistic="median")


# ---------------------------------------------------------------------- files

@pytest.mark.parametrize("ext", ["las", "npz", "csv", "txt"])
def test_files_written_by_either_package_read_back_in_the_other(clouds, tmp_path, ext):
    x, y, z = (to_np(v) for v in (clouds[0].x, clouds[0].y, clouds[0].z))
    ok = np.isfinite(z)  # LAS stores scaled integers: no NaN
    ours, theirs = EPC(x=x[ok], y=y[ok], z=z[ok], crs=32633), jepc.EPC(x=x[ok], y=y[ok], z=z[ok], crs=32633)
    p_ours, p_theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"theirs.{ext}")
    epc.write_epc(p_ours, ours)
    jepc.write_epc(p_theirs, theirs)
    if ext in ("las", "npz"):
        assert open(p_ours, "rb").read() == open(p_theirs, "rb").read()
    crs = None if ext in ("las", "npz") else 32633
    for path in (p_ours, p_theirs):
        got, want = epc.read_epc(path, crs=crs), jepc.read_epc(path, crs=crs)
        assert isinstance(got, EPC) and got.crs == want.crs.to_epsg() == 32633
        _same_points(got, want)
        atol = 1e-3 if ext == "las" else 1e-9  # LAS keeps millimetres
        np.testing.assert_allclose(to_np(got.x), x[ok], rtol=0, atol=atol)
        np.testing.assert_allclose(to_np(got.z), z[ok], rtol=0, atol=atol)
    _same_points(EPC(p_ours, crs=crs), jepc.EPC(p_ours, crs=crs))
    ours.to_file(str(tmp_path / f"again.{ext}"))
    _same_points(epc.read_epc(str(tmp_path / f"again.{ext}"), crs=crs), epc.read_epc(p_ours, crs=crs))


def test_file_refusals_match_xdem_tpu(tmp_path):
    pts = EPC(x=[1.0, 2.0], y=[3.0, 4.0], z=[5.0, 6.0], crs=32633)
    jpts = jepc.EPC(x=[1.0, 2.0], y=[3.0, 4.0], z=[5.0, 6.0], crs=32633)
    for mod, p in ((epc, pts), (jepc, jpts)):
        with pytest.raises(ValueError, match="Unsupported output format"):
            mod.write_epc(str(tmp_path / "a.ply"), p)
        with pytest.raises(OSError, match="LAZ"):
            mod.read_epc(str(tmp_path / "a.laz"))
        mod.write_epc(str(tmp_path / "a.csv"), p)
        with pytest.raises(ValueError, match="carry no CRS"):
            mod.read_epc(str(tmp_path / "a.csv"))
    bad = tmp_path / "bad.las"
    bad.write_bytes(b"NOTLAS" + bytes(300))
    with pytest.raises(OSError, match="not a LAS file"):
        epc.read_epc(str(bad))
    with pytest.raises(FileNotFoundError):
        EPC(str(tmp_path / "missing.las"))


# ---------------------------------------------------------------------- EPC dispatch

def test_epc_constructor_dispatch_matches_xdem_tpu(clouds):
    x, y, z = (to_np(v) for v in (clouds[0].x, clouds[0].y, clouds[0].z))
    frame = pd.DataFrame({"x": x, "y": y, "h": z})
    _same_points(EPC(frame, "h", crs=32633), jepc.EPC(frame, "h", crs=32633))
    assert EPC(frame, data_column="h", crs=32633).data_column == "h"
    with pytest.raises(ValueError, match="carries no CRS"):
        EPC(frame, "h")
    with pytest.raises(ValueError, match="columns"):
        EPC(frame, crs=32633)
    wrapped = EPC(EPC(x=x, y=y, z=z, crs=32633, vcrs="EGM96"))
    assert wrapped.vcrs_name == "EGM96"
    with pytest.raises(ValueError, match="does not reproject"):
        EPC(clouds[0], crs=4326)
    _same_points(EPC(x, y, z, crs=32633), jepc.EPC(x, y, z, crs=32633))
    _same_points(EPC(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), crs=32633), clouds[1])
    with pytest.raises(TypeError, match="First argument"):
        EPC(3.0)


def test_public_names_and_signatures_match_xdem_tpu():
    for ours, theirs in ((PointCloud, jpc.PointCloud), (EPC, jepc.EPC)):
        for name, member in inspect.getmembers(theirs):
            if name.startswith("_") or not callable(member):
                continue
            assert hasattr(ours, name), name
            assert list(inspect.signature(getattr(ours, name)).parameters) == \
                list(inspect.signature(member).parameters), name
    for name in ("read_epc", "write_epc"):
        assert list(inspect.signature(getattr(epc, name)).parameters) == \
            list(inspect.signature(getattr(jepc, name)).parameters)


# ---------------------------------------------------------------------- entry points

def test_raster_and_dem_to_pointcloud_match_xdem_tpu():
    ours, theirs = examples.get_ref_dem_test(), jex.get_ref_dem_test()
    ours.set_vcrs("EGM96")
    theirs.set_vcrs("EGM96")
    for kw in (dict(), dict(subsample=700, random_state=4), dict(subsample=0.05, random_state=1),
               dict(force_pixel_offset="ul", subsample=300, random_state=2)):
        got, want = ours.to_pointcloud(**kw), theirs.to_pointcloud(**kw)
        assert isinstance(got, EPC) and got.vcrs_name == want.vcrs_name == "EGM96" and got.crs == want.crs.to_epsg()
        _same_points(got, want)
        r, jr = Raster(ours.data, ours.transform, ours.crs), xdem_tpu.Raster(theirs.data, theirs.transform, theirs.crs)
        got, want = r.to_pointcloud(**kw), jr.to_pointcloud(**kw)
        assert type(got) is PointCloud and got.data_column == want.data_column
        _same_points(got, want)
    assert isinstance(ours, DEM)


def test_examples_get_epc_matches_xdem_tpu(tmp_path):
    got, want = examples.get_epc(), jex.get_epc()
    assert isinstance(got, EPC) and len(got) == 50_000 and got.crs == want.crs.to_epsg()
    _same_points(got, want)
    path = examples.get_path("longyearbyen_epc", output_dir=str(tmp_path))
    _same_points(epc.read_epc(path), jepc.read_epc(path))
    _same_points(epc.read_epc(path), want)


def test_epc_coregister_3d_moves_the_points_as_xdem_tpu():
    """The EPC is the to-be-aligned side: Nuth & Kääb against the reference DEM moves its
    points by the fitted shift, within 1e-6 m of xdem_tpu's (both draw one numpy subsample)."""
    crop = ((0, 512), (0, 640))
    ref, jref = examples.get_ref_dem().icrop(*crop), jex.get_ref_dem().icrop(*crop)
    tba, jtba = examples.get_tba_dem().icrop(*crop), jex.get_tba_dem().icrop(*crop)
    pts, jpts = tba.to_pointcloud(subsample=30_000, random_state=5), jtba.to_pointcloud(subsample=30_000, random_state=5)
    nk, jnk = coreg.NuthKaab(), jcoreg.NuthKaab()
    moved, jmoved = pts.coregister_3d(ref, nk, random_state=42), jpts.coregister_3d(jref, jnk, random_state=42)
    got, want = np.array(nk.to_translations()), np.array(jnk.to_translations())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert isinstance(moved, EPC)
    np.testing.assert_allclose(to_np(moved.x) - to_np(pts.x), got[0], atol=1e-6)
    _same_points(moved, jmoved, atol=1e-3)


# ---------------------------------------------------------------------- uncertainty at points

UNC_LAGS = np.array([20.0, 200.0, 2000.0])


@pytest.fixture(scope="module")
def unc_inputs():
    ref, jref = examples.get_ref_dem_test(), jex.get_ref_dem_test()
    tba, jtba = examples.get_tba_dem_test(), jex.get_tba_dem_test()
    r0, r1, c0, c1 = examples._TEST_ICROP
    grid_mask = ~examples.get_glacier_mask()[r0:r1, c0:c1]
    return (ref, tba.to_pointcloud(subsample=20_000, random_state=3)), \
        (jref, jtba.to_pointcloud(subsample=20_000, random_state=3)), grid_mask


def _stable_forms(kind, ours, theirs, grid_mask):
    (ref, pts), (jref, _) = ours, theirs
    if kind == "grid":
        return grid_mask, grid_mask
    if kind == "points":
        rows, cols = jref.transform.rowcol(to_np(pts.x), to_np(pts.y))
        per_point = grid_mask[np.clip(np.round(rows).astype(int), 0, ref.height - 1),
                              np.clip(np.round(cols).astype(int), 0, ref.width - 1)]
        return torch.from_numpy(per_point), per_point
    if kind == "raster":
        return Raster(grid_mask.astype(np.float32), ref.transform, ref.crs), \
            xdem_tpu.Raster(grid_mask.astype(np.float32), jref.transform, jref.crs)
    return examples.get_glacier_outlines(), jex.get_glacier_outlines()


@pytest.mark.parametrize("approach,stable", [("H2022", "grid"), ("H2022", "vector"), ("R2009", "points"),
                                             ("Basic", "raster"), ("R2009", "frame")])
def test_estimate_uncertainty_of_points_matches_xdem_tpu(unc_inputs, approach, stable):
    """DEM.estimate_uncertainty(other=EPC): dh read at the points, the H2022 variables (K1's
    plain version here) interpolated there, the error function evaluated over the grid, and
    the variogram over the points' coordinates. Every draw is numpy's from one seed, so no
    draw is injected: sigma within 5e-3 (p99.9) and 1e-2 (max) of its mean, rho within 5e-3."""
    ours, theirs, grid_mask = unc_inputs
    (ref, pts), (jref, jpts) = ours, theirs
    other, jother = pts, jpts
    if stable == "frame":
        other = jother = pd.DataFrame({"E": to_np(pts.x), "N": to_np(pts.y), "h": to_np(pts.z)})
        mask, jmask = grid_mask, grid_mask
    else:
        mask, jmask = _stable_forms(stable, ours, theirs, grid_mask)
    kw = dict(approach=approach, subsample=2000, random_state=42, z_name="h" if stable == "frame" else "z")
    with pytest.warns(UserWarning) if approach == "Basic" else contextlib.nullcontext():
        sig, rho = ref.estimate_uncertainty(other, stable_terrain=mask, **kw)
    with pytest.warns(UserWarning) if approach == "Basic" else contextlib.nullcontext():
        jsig, jrho = jref.estimate_uncertainty(jother, stable_terrain=jmask, **kw)
    assert isinstance(sig, Raster) and sig.shape == ref.shape and sig.data.dtype == torch.float32
    torch_port_helpers.assert_same_nan(sig.data, np.asarray(jsig.data), "sigma")
    assert torch_port_helpers.scaled_dev(sig.data, np.asarray(jsig.data), pct=99.9) <= 5e-3
    assert torch_port_helpers.scaled_dev(sig.data, np.asarray(jsig.data)) <= 1e-2
    np.testing.assert_allclose(rho(UNC_LAGS), jrho(UNC_LAGS), rtol=0, atol=5e-3)
    assert rho(np.array([0.0]))[0] == pytest.approx(1.0)
