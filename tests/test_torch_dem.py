"""xdem_tpu_torch's DEM against xdem_tpu's, on the examples' 256 x 256 test crop.

The examples, the 16 terrain wrappers (1e-3 of the mean magnitude with identical NaN masks,
the four gradient-denominator curvatures at their 99th percentile, ROADMAP.md's terrain
tolerance), the vertical CRS transform (1e-4 m), coregister_3d with the glacier outlines as
inlier mask (shifts within 1 % of xdem_tpu's, also for a to-be-aligned DEM on a grid moved
by a fraction of a pixel), estimate_uncertainty of two DEMs with xdem_tpu's ring draw
injected (sigma and rho within 5e-3), and the public names and signatures.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers
from torch_port_helpers import assert_plane_close, scaled_dev

import xdem_tpu
import xdem_tpu.spatialstats as jss
import xdem_tpu_torch
import xdem_tpu_torch.spatialstats as tss
from xdem_tpu import coreg as jcoreg
from xdem_tpu import examples as jex
from xdem_tpu_torch import DEM, Raster, coreg, examples, terrain

RES = 20.0
WRAPPERS = ["slope", "aspect", "hillshade", "curvature", "profile_curvature", "tangential_curvature",
            "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
            "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
            "fractal_roughness", "texture_shading"]
SUITE = [w for w in WRAPPERS if w not in ("curvature", "texture_shading")]
LAGS = np.array([20.0, 200.0, 2000.0])
SUB_PIXEL = (0.37 * RES, -0.61 * RES)  # a grid origin moved by (0.37, -0.61) px


@pytest.fixture(scope="module")
def pair():
    return examples.get_ref_dem_test(), examples.get_tba_dem_test()


@pytest.fixture(scope="module")
def jpair():
    return jex.get_ref_dem_test(), jex.get_tba_dem_test()


def _np(x):
    return x.get_nanarray() if isinstance(x, Raster) else np.asarray(x.data)


# ---------------------------------------------------------------------- examples and files

def test_examples_equal_xdem_tpus(pair, jpair, tmp_path):
    for ours, theirs in zip(pair, jpair):
        assert isinstance(ours, DEM) and ours.data.dtype == torch.float32
        np.testing.assert_array_equal(ours.get_nanarray(), _np(theirs))
        assert tuple(ours.transform) == tuple(theirs.transform) and ours.crs == theirs.crs.to_epsg()
    np.testing.assert_array_equal(examples.get_glacier_mask(), jex.get_glacier_mask())
    for a, b in zip(examples.get_glacier_outlines().polygons, jex.get_glacier_outlines().polygons):
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
    # The file names: generated into a directory given by the caller, read back by both packages.
    for name in ("longyearbyen_ref_dem", "longyearbyen_glacier_mask"):
        path = examples.get_path_test(name, output_dir=str(tmp_path))
        np.testing.assert_array_equal(DEM(path).get_nanarray(), _np(xdem_tpu.DEM(path)))
    outlines = examples.get_path("longyearbyen_glacier_outlines", output_dir=str(tmp_path))
    np.testing.assert_array_equal(xdem_tpu_torch.Vector(outlines).create_mask(pair[0]).numpy(),
                                  xdem_tpu.Vector(outlines).create_mask(jpair[0]))
    # The coregistered DEM and the dDEM: Nuth & Kaab with xdem_tpu's settings, whose subsample is
    # torch's draw and not jax.random's, so the fit agrees with xdem_tpu's to the 1 % tolerance.
    ref, tba, stable = examples.get_ref_dem(), examples.get_tba_dem(), ~examples.get_glacier_mask()
    nk = coreg.NuthKaab(offset_threshold=0.005)
    aligned = nk.fit_and_apply(ref, tba, inlier_mask=stable, random_state=42)
    jnk = jcoreg.NuthKaab(offset_threshold=0.005).fit(jex.get_ref_dem(), jex.get_tba_dem(), inlier_mask=stable,
                                                       random_state=42)
    np.testing.assert_allclose(nk.to_translations(), jnk.to_translations(), rtol=0.01)
    full = DEM(examples.get_path("longyearbyen_tba_dem_coreg", output_dir=str(tmp_path)))
    np.testing.assert_array_equal(full.get_nanarray(), aligned.get_nanarray())
    r0, r1, c0, c1 = examples._TEST_ICROP
    ddem = DEM(examples.get_path_test("longyearbyen_ddem", output_dir=str(tmp_path)))
    np.testing.assert_array_equal(ddem.get_nanarray(), (ref - aligned).icrop((r0, r1), (c0, c1)).get_nanarray())
    # The example point cloud: the same points as xdem_tpu's, in its npz layout.
    from xdem_tpu import epc as jepc
    from xdem_tpu_torch import EPC, epc

    ours, theirs = examples.get_epc(), jex.get_epc()
    assert isinstance(ours, EPC)
    np.testing.assert_array_equal(ours.z.cpu().numpy(), theirs.z)
    path = examples.get_path_test("longyearbyen_epc", output_dir=str(tmp_path))
    np.testing.assert_array_equal(epc.read_epc(path).x.cpu().numpy(), jepc.read_epc(path).x)


def test_dem_file_round_trip_keeps_vcrs_and_bits(pair, tmp_path):
    ref = pair[0].copy()
    ref.set_vcrs("EGM96")
    path = str(tmp_path / "ref.tif")
    ref.save(path)
    ours, theirs = DEM(path), xdem_tpu.DEM(path)
    np.testing.assert_array_equal(ours.get_nanarray(), ref.get_nanarray())
    assert ours.vcrs_name == theirs.vcrs_name == "EGM96" and ours.vcrs_grid == theirs.vcrs_grid
    assert ours.info(stats=True, verbose=False) == theirs.info(stats=True, verbose=False)
    pts, jpts = ours.to_pointcloud(subsample=50, random_state=1), theirs.to_pointcloud(subsample=50, random_state=1)
    assert type(pts).__name__ == "EPC" and pts.vcrs_name == jpts.vcrs_name == "EGM96"
    np.testing.assert_array_equal(pts.z.cpu().numpy(), jpts.z)
    np.testing.assert_array_equal(ours.to_pointcloud(as_array=True, subsample=50, random_state=1),
                                  theirs.to_pointcloud(as_array=True, subsample=50, random_state=1))


# ---------------------------------------------------------------------- terrain

@pytest.mark.parametrize("name", WRAPPERS)
def test_terrain_wrappers_match_xdem_tpu(pair, jpair, name):
    got, want = getattr(pair[0], name)(), getattr(jpair[0], name)()
    assert isinstance(got, Raster) and got.nodata == want.nodata == -99999
    assert tuple(got.transform) == tuple(want.transform) and got.crs == pair[0].crs
    assert got.data.dtype == torch.float32 and got.data.device == pair[0].data.device
    if name in torch_port_helpers.GRADIENT_DENOMINATOR:
        # |grad z|^3 denominators: at the crop's near-flat pixels each package's own float32
        # mean-centring moves these by up to 0.6 of their mean magnitude, so the percentile
        # ROADMAP.md allows for the curvatures of the spectral DEMs holds them.
        torch_port_helpers.assert_same_nan(got.data, _np(want), name)
        assert scaled_dev(got.data, _np(want), pct=99.0) <= 1e-3
    else:
        assert_plane_close(got.data, _np(want), name, tol=1e-3, circular=360.0 if name == "aspect" else None)


def test_dem_attributes_equal_the_array_path(pair):
    """A DEM's attributes are the array path's, bit for bit: the wrapping adds nothing."""
    ref = pair[0]
    got = ref.get_terrain_attribute(SUITE)
    want = terrain.get_terrain_attribute(ref.data, SUITE, resolution=ref.res)
    for a, g, w in zip(SUITE, got, want):
        assert torch.equal(torch.isnan(g.data), torch.isnan(w)), a
        assert torch.equal(torch.nan_to_num(g.data), torch.nan_to_num(w)), a


def test_geographic_dem_warns_as_xdem_tpu(pair):
    arr = pair[0].get_nanarray()[:64, :64]
    t = (1e-4, 0.0, 15.6, 0.0, -1e-4, 78.2)
    for cls in (DEM, xdem_tpu.DEM):
        dem = cls.from_array(arr, transform=t if cls is DEM else xdem_tpu.georef.Affine(*t), crs=4326)
        with pytest.warns(UserWarning, match="not in a projected CRS"):
            dem.slope()


# ---------------------------------------------------------------------- vertical CRS

@pytest.mark.parametrize("src,dst", [("EGM96", "Ellipsoid"), ("Ellipsoid", "EGM08"), ("EGM08", "EGM96")])
def test_to_vcrs_matches_xdem_tpu(pair, jpair, src, dst):
    ours, theirs = pair[0].copy(), jpair[0].copy()
    ours.set_vcrs(src)
    theirs.set_vcrs(src)
    got, want = ours.to_vcrs(dst), theirs.to_vcrs(dst)
    assert got.vcrs_name == want.vcrs_name and got.data.dtype == torch.float32
    np.testing.assert_allclose(got.get_nanarray(), _np(want), rtol=0, atol=1e-4)
    if "Ellipsoid" in (src, dst):  # the geoid lies ~30 m above the ellipsoid here
        assert np.abs(got.get_nanarray() - ours.get_nanarray())[32:-32, 32:-32].min() > 1.0
    assert ours.to_vcrs(dst, inplace=True) is None
    assert torch.equal(ours.data, got.data) and ours.vcrs_name == got.vcrs_name


def test_to_vcrs_in_row_bands_equals_one_band(pair, monkeypatch):
    import xdem_tpu_torch.dem as tdem
    import xdem_tpu_torch.raster as traster

    dem = pair[0].copy()
    dem.set_vcrs("EGM96")
    whole = dem.to_vcrs("Ellipsoid")
    bands, row_bands = [], tdem.row_bands
    monkeypatch.setattr(traster, "BAND_PIXELS", 37 * dem.shape[1])
    monkeypatch.setattr(tdem, "row_bands", lambda shape: (bands.append(b) or b for b in row_bands(shape)))
    assert torch.equal(torch.nan_to_num(dem.to_vcrs("Ellipsoid").data), torch.nan_to_num(whole.data))
    assert len(bands) > 1 and bands[0] == (0, 37) and bands[-1][1] == dem.shape[0]


def test_to_vcrs_refusals_match_xdem_tpu(pair, jpair):
    for dem in (pair[0].copy(), jpair[0].copy()):
        with pytest.raises(ValueError, match="no vertical CRS"):
            dem.to_vcrs("Ellipsoid")
        dem.set_vcrs("Ellipsoid")
        with pytest.warns(UserWarning, match="same"):
            assert dem.to_vcrs("Ellipsoid") is None


# ---------------------------------------------------------------------- coregistration

# Nuth & Kääb does not converge on the 256 x 256 test pair (it oscillates by ~0.25 px after
# 10 iterations, and after 50 is still 0.6 m from the shift), so a fit there depends on any
# change of its inputs; on this 512 x 640 crop of the examples it converges in 4 iterations.
COREG_CROP = ((0, 512), (0, 640))


@pytest.fixture(scope="module")
def coreg_pair():
    return tuple(d.icrop(*COREG_CROP) for d in (examples.get_ref_dem(), examples.get_tba_dem()))


@pytest.fixture(scope="module")
def jcoreg_pair():
    return tuple(d.icrop(*COREG_CROP) for d in (jex.get_ref_dem(), jex.get_tba_dem()))


def _shifted_grid(dem):
    """`dem` resampled onto its own grid moved by SUB_PIXEL (bilinear)."""
    return dem.reproject(dem.translate(*SUB_PIXEL))


def _as_xdem_tpu(dem):
    """The port's DEM as xdem_tpu's, bits and grid."""
    return xdem_tpu.DEM.from_array(dem.get_nanarray(), transform=xdem_tpu.georef.Affine(*dem.transform),
                                   crs=dem.crs.to_epsg())


@pytest.mark.parametrize("grid", ["same", "sub_pixel"])
def test_coregister_3d_with_outlines_matches_xdem_tpu(coreg_pair, jcoreg_pair, grid):
    """Shifts within 1 % of xdem_tpu's. For a to-be-aligned DEM on a grid moved by a fraction
    of a pixel, coregister_3d first reprojects it onto the reference grid: xdem_tpu is given
    the port's reprojected copy (held to a float64 oracle in test_torch_raster.py), because
    its own reprojection rounds the destination northings to float32 (1 m at 8.67e6 m), which
    moved its fit here by ~0.6 m north; the port's fit stays within 1 % of the same-grid fit."""
    (ref, tba), (jref, jtba) = coreg_pair, jcoreg_pair
    inlier = ~examples.get_glacier_outlines().create_mask(ref)
    jinlier = ~jex.get_glacier_outlines().create_mask(jref)
    assert isinstance(inlier, torch.Tensor) and inlier.dtype == torch.bool
    np.testing.assert_array_equal(inlier.numpy(), jinlier)
    if grid == "sub_pixel":
        tba = _shifted_grid(tba)
        assert tba.shape != ref.shape or not tba.transform.almost_equals(ref.transform)
        jtba = _as_xdem_tpu(tba.reproject(ref))
    nk, jnk = coreg.NuthKaab(), jcoreg.NuthKaab()
    aligned = tba.coregister_3d(ref, nk, inlier_mask=inlier, random_state=42)
    jaligned = jtba.coregister_3d(jref, jnk, inlier_mask=jinlier, random_state=42)
    got, want = np.array(nk.to_translations()), np.array(jnk.to_translations())
    assert np.all(np.abs(got - want) <= 0.01 * np.abs(want)), (got, want)
    if grid == "sub_pixel":
        same = coreg.NuthKaab().fit(ref, coreg_pair[1], inlier_mask=inlier, random_state=42).to_translations()
        assert np.hypot(*(got[:2] - np.array(same[:2]))) <= 0.01 * np.hypot(*same[:2])
    # The truth: the tba terrain was moved by TBA_SHIFT, so the fit is its opposite.
    np.testing.assert_allclose(got, -np.array(examples.TBA_SHIFT), rtol=0.05)
    # The aligned DEM keeps the to-be-aligned DEM's own grid.
    assert isinstance(aligned, DEM) and aligned.shape == tba.shape and jaligned.shape == jtba.shape
    np.testing.assert_allclose(tuple(aligned.transform), tuple(tba.transform), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tuple(jaligned.transform), tuple(jtba.transform), rtol=0, atol=1e-6)
    # On stable terrain the 2.35 m offset goes and the spread (NMAD) halves.
    stable = inlier.numpy()
    before, after = ((ref.get_nanarray() - d.reproject(ref).get_nanarray())[stable] for d in (tba, aligned))
    nmad = [1.4826 * np.nanmedian(np.abs(d - np.nanmedian(d))) for d in (before, after)]
    assert abs(np.nanmedian(before)) > 2.0 and abs(np.nanmedian(after)) < 0.05 and nmad[1] < 0.6 * nmad[0], nmad


def test_coreg_takes_raster_and_vector_inlier_masks(coreg_pair, jcoreg_pair):
    """A Raster inlier mask on another grid is read by nearest neighbour on the reference's,
    and a Vector is rasterized there, as xdem_tpu does."""
    (ref, tba), (jref, jtba) = coreg_pair, jcoreg_pair
    stable = ~examples.get_glacier_outlines().create_mask(ref)
    moved = ref.translate(3 * RES, -2 * RES)
    mask_r = ref.copy(new_array=stable.to(torch.float32)).reproject(moved, resampling="nearest")
    jmask_r = jref.copy(new_array=np.asarray(stable.numpy(), np.float32)).reproject(
        jref.translate(3 * RES, -2 * RES), resampling="nearest")
    np.testing.assert_array_equal(mask_r.get_nanarray(), _np(jmask_r))
    by_raster = coreg.NuthKaab().fit(ref, tba, inlier_mask=mask_r, random_state=3).to_translations()
    jby_raster = jcoreg.NuthKaab().fit(jref, jtba, inlier_mask=jmask_r, random_state=3).to_translations()
    np.testing.assert_allclose(by_raster, jby_raster, rtol=0.01)
    # Regridded back by nearest neighbour, the mask is the boolean one, less its moved-out edge.
    base = stable.numpy().copy()
    base[:, :3] = base[:2, :] = False  # the moved grid starts 3 px east and 2 px south
    by_array = coreg.NuthKaab().fit(ref, tba, inlier_mask=base, random_state=3).to_translations()
    np.testing.assert_allclose(by_raster, by_array, rtol=1e-6)
    vs = coreg.VerticalShift().fit(ref, tba, inlier_mask=examples.get_glacier_outlines(), random_state=3)
    jvs = jcoreg.VerticalShift().fit(jref, jtba, inlier_mask=jex.get_glacier_outlines(), random_state=3)
    assert vs.to_translations()[2] == pytest.approx(jvs.to_translations()[2], rel=1e-5)


def test_apply_returns_a_dem_like_xdem_tpus(coreg_pair, jcoreg_pair):
    """One fitted matrix applied to a DEM: a translation moves the grid (tier 2, resampled back
    onto the input grid with `resample`), as in xdem_tpu, to its float32 coordinates."""
    (ref, tba), (jref, jtba) = coreg_pair, jcoreg_pair
    jnk = jcoreg.NuthKaab().fit(jref, jtba, random_state=42)
    nk = coreg.AffineCoreg.from_matrix(jnk.to_matrix())
    for resample in (True, False):
        got, want = nk.apply(tba, resample=resample), jnk.apply(jtba, resample=resample)
        assert isinstance(got, DEM) and got.shape == want.shape
        np.testing.assert_allclose(tuple(got.transform), tuple(want.transform), rtol=0, atol=1e-6)
        both = np.isfinite(got.get_nanarray()) & np.isfinite(_np(want))
        assert both.mean() > 0.9
        # xdem_tpu's float32 northings (1 m at 8.67e6 m) at the crop's steepest slope
        bound = float(np.spacing(np.float32(8.67e6))) * np.nanmax(np.abs(np.gradient(ref.get_nanarray(), RES)))
        assert np.abs(got.get_nanarray() - _np(want))[both].max() <= bound
    out = (coreg.NuthKaab() + coreg.VerticalShift()).fit_and_apply(ref, tba, random_state=42)
    assert isinstance(out, DEM) and out.shape == ref.shape


# ---------------------------------------------------------------------- uncertainty

def _xdem_tpu_device_draw(seed, arr, *args):
    ija, ijb = jss._draw_rings_from_arr(np.uint32(seed), jnp.asarray(arr.cpu().numpy()), *args)
    return torch.from_numpy(np.array(ija)).long(), torch.from_numpy(np.array(ijb)).long()


@pytest.mark.parametrize("case", ["same_grid", "other_on_a_shifted_grid", "vector_stable"])
def test_estimate_uncertainty_of_two_dems_matches_xdem_tpu(monkeypatch, pair, jpair, case):
    """For `other` on a shifted grid the port reprojects it onto the DEM's; xdem_tpu is given
    that reprojected copy (its own float32 northings move dh by up to ~0.5 m x the slope)."""
    (ref, tba), (jref, jtba) = pair, jpair
    stable, jstable = ~examples.get_glacier_outlines().create_mask(ref), ~jex.get_glacier_outlines().create_mask(jref)
    if case == "other_on_a_shifted_grid":
        tba = _shifted_grid(tba)
        jtba = _as_xdem_tpu(tba.reproject(ref))
    if case == "vector_stable":  # a Vector's inside is the stable terrain
        stable, jstable = examples.get_glacier_outlines(), jex.get_glacier_outlines()
    kw = dict(subsample=3000, random_state=42)
    monkeypatch.setattr(tss, "_draw_rings_from_arr", _xdem_tpu_device_draw)
    sig, rho = ref.estimate_uncertainty(tba, stable_terrain=stable, **kw)
    jsig, jrho = jref.estimate_uncertainty(jtba, stable_terrain=jstable, **kw)
    assert isinstance(sig, Raster) and tuple(sig.transform) == tuple(ref.transform) and sig.shape == ref.shape
    torch_port_helpers.assert_same_nan(sig.data, _np(jsig), "sigma")
    assert scaled_dev(sig.data, _np(jsig), pct=99.9) <= 5e-3
    assert scaled_dev(sig.data, _np(jsig)) <= 1e-2
    np.testing.assert_allclose(rho(LAGS), jrho(LAGS), rtol=0, atol=5e-3)


# ---------------------------------------------------------------------- the surface

_SURFACE = [("DEM", "DEM"), ("Raster", "Raster"), ("Vector", "Vector"), ("georef.CRS", "CRS"),
            ("io", None), ("vcrs", None), ("examples", None), ("config", None)]


def _resolve(pkg: str, dotted: str):
    """A module of `pkg`, or a class of it (`Name` at the top level, `module.Name` below)."""
    mod, _, attr = dotted.rpartition(".")
    if not attr[0].isupper():
        return importlib.import_module(f"{pkg}.{dotted}")
    return getattr(importlib.import_module(f"{pkg}.{mod}") if mod else importlib.import_module(pkg), attr)


@pytest.mark.parametrize("jname,top", _SURFACE)
def test_public_names_and_signatures_match_xdem_tpu(jname, top):
    """Every public name of xdem_tpu's class or module is in the port's, with the same
    parameters (names a module imports from elsewhere are not its own)."""
    theirs, ours = _resolve("xdem_tpu", jname), _resolve("xdem_tpu_torch", jname)
    if top is not None:
        assert getattr(xdem_tpu_torch, top) is ours
    members = vars(theirs).items() if inspect.ismodule(theirs) else inspect.getmembers(theirs)
    for name, obj in members:
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.ismodule(theirs) and getattr(obj, "__module__", theirs.__name__) != theirs.__name__:
            continue
        assert hasattr(ours, name), f"{jname}.{name} is missing"
        if inspect.isfunction(obj) or inspect.ismethod(obj):
            want = list(inspect.signature(obj).parameters)
            assert list(inspect.signature(getattr(ours, name)).parameters) == want, name


def test_config_matches_xdem_tpu():
    jcfg = importlib.import_module("xdem_tpu.config")
    for key in ("resampling", "warn_area_or_point", "shift_area_or_point"):
        assert xdem_tpu_torch.config[key] == jcfg.config[key]
    with xdem_tpu_torch.config_context(resampling="nearest"):
        assert xdem_tpu_torch.config["resampling"] == "nearest"
    assert xdem_tpu_torch.config["resampling"] == jcfg.config["resampling"]
    with pytest.raises(KeyError, match="Unknown config key"):
        xdem_tpu_torch.config["prefer_pallas"] = True
    with pytest.raises(ValueError, match="resampling must be"):
        xdem_tpu_torch.config["resampling"] = "sinc"
