"""xdem_tpu_torch's geospatial substrate and Raster against xdem_tpu, on small seeded inputs.

CRS parsing and identity, the projection kernels on tensors (``projections.TORCH``) against
numpy, GeoTIFF files read across the two packages, reprojection against a float64 host oracle
and against xdem_tpu, crops, point lookups, statistics, subsamples, Vector masks, and the
Raster/Vector inputs of spatialstats and volume.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from scipy import ndimage

import xdem_tpu.spatialstats as jss
import xdem_tpu.volume as jvol
from xdem_tpu import examples as jex
from xdem_tpu import georef as jgeo
from xdem_tpu import io as jio
from xdem_tpu.raster import Raster as JRaster
from xdem_tpu.vector import Vector as JVector
from xdem_tpu_torch import georef as tgeo
from xdem_tpu_torch import io as tio
from xdem_tpu_torch import projections as tproj
from xdem_tpu_torch import spatialstats as tss
from xdem_tpu_torch import terrain as tterrain
from xdem_tpu_torch import volume as tvol
from xdem_tpu_torch.raster import Raster
from xdem_tpu_torch.vector import Vector

RES = 20.0
ORIGIN = (502810.0, 8674030.0)  # the examples' upper-left corner (UTM 33N)


def _dem(shape=(96, 112), seed=11, hole=True) -> np.ndarray:
    dem = jex.synthetic_dem_array(shape=shape, resolution=RES, seed=seed)
    if hole:
        dem[20:27, 30:41] = np.nan
    return dem


def _pair(shape=(96, 112), **kw):
    arr = _dem(shape, **kw)
    t = tgeo.Affine.from_origin(*ORIGIN, RES, RES)
    return (Raster(arr, t, 32633, nodata=-9999.0),
            JRaster(arr, jgeo.Affine(*t), 32633, nodata=-9999.0))


# ---------------------------------------------------------------------- CRS

_CRS_INPUTS = [32633, "EPSG:4326", 2154, 3413, 3857, 27700, 2056, 5514, 3035, 28992, 4087,
               "+proj=utm +zone=33 +datum=WGS84",
               "+proj=lcc +lat_1=49 +lat_2=44 +lat_0=46.5 +lon_0=3 +x_0=700000 +y_0=6600000 +ellps=GRS80",
               "+proj=longlat +datum=WGS84 +no_defs", "+proj=stere +lat_0=90 +lat_ts=70 +lon_0=-45 +datum=WGS84",
               "wkt:32633", "wkt:2154", "wkt:4326", "wkt:3413"]


def _crs_input(v):
    return jgeo.CRS(int(v[4:])).to_wkt() if isinstance(v, str) and v.startswith("wkt:") else v


@pytest.mark.parametrize("value", _CRS_INPUTS)
def test_crs_matches_xdem_tpu(value):
    value = _crs_input(value)
    ours, theirs = tgeo.CRS(value), jgeo.CRS(value)
    assert ours.to_epsg() == theirs.to_epsg()
    assert ours.is_projected == theirs.is_projected and ours.is_geographic == theirs.is_geographic
    assert ours.to_wkt() == theirs.to_wkt()
    assert ours.to_proj4() == theirs.to_proj4()
    assert repr(ours) == repr(theirs) and ours.units == theirs.units and ours.name == theirs.name
    assert ours._key == theirs._key and hash(ours) == hash(tgeo.CRS(ours))
    # Equality across the input forms, and through the WKT round trip
    assert ours == tgeo.CRS(ours.to_wkt())
    if theirs.to_epsg() is not None:
        assert ours == theirs.to_epsg() and ours == f"EPSG:{theirs.to_epsg()}"


def test_crs_inequality_and_helpers():
    assert tgeo.CRS(32633) != tgeo.CRS(32632)
    assert tgeo.CRS("+proj=utm +zone=33 +datum=WGS84") == 32633
    assert tgeo.suggest_utm_crs(15.6, 78.2) == tgeo.CRS(32633) == jgeo.suggest_utm_crs(15.6, 78.2).to_epsg()
    assert tgeo.suggest_utm_crs(-70.0, -33.0).to_epsg() == 32719
    assert tgeo.is_projected("+proj=longlat +datum=WGS84") is False
    assert tgeo.epsg_code("+proj=lcc +lat_1=49 +lat_2=44 +lat_0=46.5 +lon_0=3 +ellps=GRS80") is None


# ---------------------------------------------------------------------- projections

def _family_codes() -> dict:
    fam = {}
    for code in sorted(tproj._EPSG_DEFS):
        raw = tproj.epsg_def(code)
        if raw is not None:
            fam.setdefault(tproj.normalize_def(raw)["proj"], code)
    return fam


FAMILIES = _family_codes()


def test_every_projection_family_has_a_case():
    assert set(FAMILIES) == set(tproj._FORWARD)


def _lonlat_near(p: dict, n: int = 60) -> tuple[np.ndarray, np.ndarray]:
    """Seeded points within a few degrees of a projection's centre."""
    rng = np.random.default_rng(3)
    lat0 = p.get("lat_0") or p.get("lat_ts") or 0.5 * (p.get("lat_1", 0.0) + p.get("lat_2", 0.0))
    if abs(lat0) >= 89.0:  # polar: a ring of latitudes off the pole
        lat = np.sign(lat0) * rng.uniform(70.0, 85.0, n)
        lon = p.get("lon_0", 0.0) + rng.uniform(-60.0, 60.0, n)
    else:
        lat = np.clip(lat0 + rng.uniform(-1.5, 1.5, n), -80.0, 80.0)
        lon = p.get("lon_0", 0.0) + rng.uniform(-2.0, 2.0, n)
    return lon, lat


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_projection_kernels_on_tensors_match_numpy(family):
    """Forward and inverse of every family on float64 CPU tensors (projections.TORCH) equal the
    numpy kernels to 1e-8 m and 1e-12 deg, and transform_points equals xdem_tpu's. torch's and
    numpy's sin, atan, log, ... differ by an ulp here and there, and a chain of them turns that
    into up to 36 ulp of the easting (8.4e-9 m in Krovak at 1.3e6 m): 1e-9 m would be one ulp
    at the examples' northing, which only the same libm could hold."""
    code = FAMILIES[family]
    p = tproj.normalize_def(tproj.epsg_def(code))
    lon, lat = _lonlat_near(p)
    x_np, y_np = tproj.projdef_from_wgs84(p, lon, lat, xp=np)
    assert np.isfinite(x_np).all() and np.isfinite(y_np).all()
    x_t, y_t = tproj.projdef_from_wgs84(p, torch.from_numpy(lon), torch.from_numpy(lat), xp=tproj.TORCH)
    assert x_t.dtype == torch.float64
    np.testing.assert_allclose(x_t.numpy(), x_np, rtol=0, atol=1e-8)
    np.testing.assert_allclose(y_t.numpy(), y_np, rtol=0, atol=1e-8)
    lon_t, lat_t = tproj.projdef_to_wgs84(p, torch.from_numpy(x_np), torch.from_numpy(y_np), xp=tproj.TORCH)
    lon_np, lat_np = tproj.projdef_to_wgs84(p, x_np, y_np, xp=np)
    np.testing.assert_allclose(lon_t.numpy(), lon_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lat_t.numpy(), lat_np, rtol=0, atol=1e-12)
    # Against xdem_tpu, through the public transform both ways.
    for src, dst, a, b in ((4326, code, lon, lat), (code, 4326, x_np, y_np)):
        got = tgeo.transform_points(src, dst, torch.from_numpy(a), torch.from_numpy(b), xp=tproj.TORCH)
        want = jgeo.transform_points(src, dst, a, b)
        tol = 1e-12 if dst == 4326 else 1e-8
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=tol)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=tol)


def test_torch_namespace_takes_numbers_and_mixed_arguments():
    ns = tproj.TORCH
    assert ns.sqrt(0.5) == pytest.approx(np.sqrt(0.5)) and isinstance(ns.sqrt(0.5), float)
    t = torch.arange(4)  # an integer tensor computes in float64
    assert ns.sin(t).dtype == torch.float64
    assert torch.equal(ns.maximum(1.5, t), torch.tensor([1.5, 1.5, 2.0, 3.0], dtype=torch.float64))
    assert torch.equal(ns.clip(t, 1.0, 2.0), torch.tensor([1.0, 1.0, 2.0, 2.0], dtype=torch.float64))
    assert torch.equal(ns.where(t > 1, t, 0.5), torch.tensor([0.5, 0.5, 2.0, 3.0], dtype=torch.float64))
    assert torch.equal(ns.arctan2(1.0, torch.ones(2, dtype=torch.float64)),
                       torch.full((2,), np.pi / 4, dtype=torch.float64))
    assert ns.clip(3.0, torch.tensor(0.0), 1.0).item() == 1.0


# ---------------------------------------------------------------------- GeoTIFF

def _raster_fields(r):
    return (r.get_nanarray(), tuple(r.transform), r.crs.to_epsg(), r.nodata, r.area_or_point, dict(r.tags))


def _same_file_read(path):
    ours, theirs = tio.read_raster(path), jio.read_raster(path)
    a, b = _raster_fields(ours), _raster_fields(theirs)
    np.testing.assert_array_equal(a[0], b[0])  # NaN positions and bits
    assert a[0].dtype == b[0].dtype == np.float32
    assert a[1:] == b[1:]
    return ours


@pytest.mark.parametrize("writer", ["port", "xdem_tpu"])
@pytest.mark.parametrize("area_or_point", ["Area", "Point"])
def test_geotiff_written_by_either_package_reads_the_same(tmp_path, writer, area_or_point):
    arr = _dem((40, 52))
    t = (RES, 0.0, ORIGIN[0], 0.0, -RES, ORIGIN[1])
    path = str(tmp_path / "dem.tif")
    if writer == "port":
        Raster(arr, t, 32633, nodata=-9999.0, area_or_point=area_or_point, tags={"PRODUCT": "x"}).save(path)
    else:
        JRaster(arr, jgeo.Affine(*t), 32633, nodata=-9999.0, area_or_point=area_or_point,
                tags={"PRODUCT": "x"}).save(path)
    r = _same_file_read(path)
    assert r.nodata == -9999.0 and r.area_or_point == area_or_point and r.tags == {"PRODUCT": "x"}
    np.testing.assert_array_equal(r.get_nanarray(), arr)


def test_geotiff_custom_crs_round_trips(tmp_path):
    crs = "+proj=lcc +lat_1=49 +lat_2=44 +lat_0=46.5 +lon_0=3 +x_0=700000 +y_0=6600000 +ellps=GRS80"
    path = str(tmp_path / "lcc.tif")
    Raster(_dem((20, 24)), (RES, 0, 7e5, 0, -RES, 6.6e6), crs).save(path)
    r = _same_file_read(path)
    assert r.crs == tgeo.CRS(crs) and jio.read_raster(path).crs == jgeo.CRS(crs)


def test_geotiff_lzw_from_libtiff(tmp_path):
    from PIL import Image

    data = np.round(_dem((37, 45), hole=False) * 4) / 4  # quantized: long LZW chains
    path = str(tmp_path / "lzw.tif")
    Image.fromarray(data.astype(np.float32), mode="F").save(path, compression="tiff_lzw")
    r = _same_file_read(path)
    np.testing.assert_array_equal(r.get_nanarray(), data.astype(np.float32))


def _write_tiled_deflate(path, arr: np.ndarray, tile: int = 16) -> None:
    """A tiled, DEFLATE-compressed float32 TIFF (tags 322-325), written by hand."""
    h, w = arr.shape
    tiles = []
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            block = np.zeros((tile, tile), np.float32)
            part = arr[r0:r0 + tile, c0:c0 + tile]
            block[:part.shape[0], :part.shape[1]] = part
            tiles.append(zlib.compress(block.astype("<f4").tobytes()))
    n = len(tiles)
    tags = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 32), (259, 3, 1, 8), (262, 3, 1, 1),
            (277, 3, 1, 1), (322, 3, 1, tile), (323, 3, 1, tile), (324, 4, n, None), (325, 4, n, None),
            (339, 3, 1, 3)]
    ifd_size = 2 + 12 * len(tags) + 4
    arrays_at = 8 + ifd_size
    data_at = arrays_at + 8 * n
    offsets, pos = [], data_at
    for t in tiles:
        offsets.append(pos)
        pos += len(t)
    out = bytearray(b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", len(tags)))
    for tag, typ, cnt, val in tags:
        if tag == 324:
            out += struct.pack("<HHII", tag, typ, cnt, arrays_at)
        elif tag == 325:
            out += struct.pack("<HHII", tag, typ, cnt, arrays_at + 4 * n)
        elif typ == 3:
            out += struct.pack("<HHIHH", tag, typ, cnt, val, 0)
        else:
            out += struct.pack("<HHII", tag, typ, cnt, val)
    out += struct.pack("<I", 0)
    out += struct.pack(f"<{n}I", *offsets) + struct.pack(f"<{n}I", *[len(t) for t in tiles])
    out += b"".join(tiles)
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_geotiff_tiled_deflate(tmp_path):
    arr = _dem((37, 45))
    path = str(tmp_path / "tiled.tif")
    _write_tiled_deflate(path, arr)
    r = _same_file_read(path)
    np.testing.assert_array_equal(r.get_nanarray(), arr)


@pytest.mark.parametrize("writer", ["port", "xdem_tpu"])
def test_bigtiff_streaming_writer_across_packages(tmp_path, writer):
    arr = _dem((50, 30))
    t = tgeo.Affine.from_origin(*ORIGIN, RES, RES)
    path = str(tmp_path / "big.tif")
    mod = tio if writer == "port" else jio
    with mod.StreamingRasterWriter(path, arr.shape, mod.Affine(*t), crs=32633, rows_per_strip=7,
                                   bigtiff=True) as w:
        for r0 in (28, 0, 14):  # out of order
            w.write_rows(r0, arr[r0:r0 + 14 if r0 < 28 else None])
    with open(path, "rb") as f:
        assert f.read(4) == b"II+\x00"
    r = _same_file_read(path)
    np.testing.assert_array_equal(r.get_nanarray(), arr)
    for lo, n in ((0, 50), (5, 13), (41, 20)):
        np.testing.assert_array_equal(tio.read_rows(path, lo, n), jio.read_rows(path, lo, n))
        np.testing.assert_array_equal(tio.read_rows(path, lo, n), arr[lo:lo + n])


def test_codec_builds_under_the_package_build_dir():
    lib = tio.build_library()
    assert lib.parent.parent.name == "_build" and lib.exists()
    assert tio.library_path() == lib


def test_raster_path_constructor_downsample_and_nodata(tmp_path):
    arr = _dem((40, 52))
    path = str(tmp_path / "d.tif")
    JRaster(arr, jgeo.Affine.from_origin(*ORIGIN, RES, RES), 32633).save(path)
    for kw in ({}, {"downsample": 3}, {"nodata": float(arr[5, 5])}):
        ours, theirs = Raster(path, **kw), JRaster(path, **kw)
        np.testing.assert_array_equal(ours.get_nanarray(), np.asarray(theirs.data))
        assert tuple(ours.transform) == tuple(theirs.transform) and ours.nodata == theirs.nodata


# ---------------------------------------------------------------------- reprojection

def _oracle(raster: Raster, dst_crs, dst_transform, dst_shape, method: str) -> np.ndarray:
    """float64 host reprojection: the port's projections with numpy, then scipy's order-1
    map_coordinates for bilinear (NaN-aware: any NaN neighbour or a position outside the
    grid gives NaN), or numpy nearest / Keys cubic convolution."""
    data = raster.get_nanarray().astype(np.float64)
    h, w = dst_shape
    rr, cc = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    x, y = dst_transform.xy(rr, cc)
    sx, sy = tgeo.transform_points(dst_crs, raster.crs, x, y)
    rows, cols = raster.transform.rowcol(sx, sy)
    H, W = data.shape
    if method == "linear":
        vals = ndimage.map_coordinates(np.nan_to_num(data), [rows, cols], order=1, mode="nearest")
        bad = ndimage.map_coordinates(np.isnan(data).astype(np.float64), [rows, cols], order=1, mode="nearest")
        inside = (rows >= 0) & (rows <= H - 1) & (cols >= 0) & (cols <= W - 1)
        return np.where(inside & (bad == 0), vals, np.nan)
    if method == "nearest":
        ri, ci = np.round(rows).astype(int), np.round(cols).astype(int)
        inside = (rows >= -0.5) & (rows <= H - 0.5) & (cols >= -0.5) & (cols <= W - 0.5)
        return np.where(inside, data[np.clip(ri, 0, H - 1), np.clip(ci, 0, W - 1)], np.nan)

    def keys(t):
        a, at = -0.5, np.abs(t)
        return np.where(at <= 1, (a + 2) * at**3 - (a + 3) * at**2 + 1,
                        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0))

    r0, c0 = np.floor(rows).astype(int), np.floor(cols).astype(int)
    out = np.zeros_like(rows)
    for dr in range(-1, 3):
        for dc in range(-1, 3):
            v = data[np.clip(r0 + dr, 0, H - 1), np.clip(c0 + dc, 0, W - 1)]
            out += keys(rows - r0 - dr) * keys(cols - c0 - dc) * v
    inside = (rows >= 1) & (rows <= H - 2) & (cols >= 1) & (cols <= W - 2)
    return np.where(inside, out, np.nan)


def _float32_coordinate_bound(raster: Raster, xs: np.ndarray, ys: np.ndarray, k: float) -> float:
    """Largest elevation change that xdem_tpu's float32 destination coordinates can cause: k
    float32 roundings of the largest coordinate (one ulp at the examples' northing of 8.67e6 m
    is 1 m), each at the DEM's largest gradient along that axis, plus four ulps of the
    largest elevation for the float32 interpolation."""
    z = raster.get_nanarray().astype(np.float64)
    gy = np.nanmax(np.abs(np.diff(z, axis=0))) / RES
    gx = np.nanmax(np.abs(np.diff(z, axis=1))) / RES
    ulp = lambda v: float(np.spacing(np.float32(np.nanmax(np.abs(v)))))  # noqa: E731
    return k * (gx * ulp(xs) + gy * ulp(ys)) + 4 * ulp(z)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("target", ["same_crs_shifted", "utm32", "laea"])
def test_reproject_against_float64_oracle_and_xdem_tpu(method, target):
    ours, theirs = _pair()
    if target == "same_crs_shifted":
        dst = ours.translate(0.37 * RES, -0.61 * RES)
        got, want_j = ours.reproject(dst, resampling=method), theirs.reproject(
            theirs.translate(0.37 * RES, -0.61 * RES), resampling=method)
        k = 2.0  # the destination centre's y, then the inverse affine's row
    else:
        crs = 32632 if target == "utm32" else 3035
        got, want_j = ours.reproject(crs=crs, resampling=method), theirs.reproject(crs=crs, resampling=method)
        k = 16.0  # the projection chain in float32: a few roundings of each coordinate per step
    assert got.shape == want_j.shape and tuple(got.transform) == tuple(want_j.transform)
    assert got.crs == tgeo.CRS(want_j.crs.to_wkt())
    assert got.data.dtype == torch.float32 and got.data.device == ours.data.device
    oracle = _oracle(ours, got.crs, got.transform, got.shape, method)
    g = got.get_nanarray()
    both = np.isfinite(g) & np.isfinite(oracle)
    assert both.mean() > 0.5
    # NaN masks agree with the oracle's except at positions within float64 rounding of an edge
    assert (np.isnan(g) != np.isnan(oracle)).mean() <= 1e-3
    scale = np.abs(oracle[both]).mean()
    assert np.abs(g[both] - oracle[both]).max() <= 1e-5 * scale
    # Against xdem_tpu: its float32 coordinates bound the deviation (see the helper).
    j = np.asarray(want_j.data)
    both = np.isfinite(g) & np.isfinite(j)
    xs, ys = got.coords()
    bound = _float32_coordinate_bound(ours, xs, ys, k)
    if method == "nearest":  # a rounding can pick the neighbouring pixel
        diff = np.abs(g[both] - j[both])
        assert np.mean(diff > bound) <= 0.01
    else:
        assert np.abs(g[both] - j[both]).max() <= bound
    assert (np.isnan(g) != np.isnan(j)).mean() <= 0.01


def test_reproject_in_row_bands_equals_one_band(monkeypatch):
    import xdem_tpu_torch.raster as traster

    ours, _ = _pair()
    whole = ours.reproject(crs=3035)
    bands, row_bands = [], traster.row_bands
    monkeypatch.setattr(traster, "BAND_PIXELS", 500)
    monkeypatch.setattr(traster, "row_bands", lambda shape: (bands.append(b) or b for b in row_bands(shape)))
    banded = ours.reproject(crs=3035)
    assert len(bands) > 1 and bands[-1][1] == whole.shape[0]
    assert torch.equal(torch.isnan(whole.data), torch.isnan(banded.data))
    assert torch.equal(torch.nan_to_num(whole.data), torch.nan_to_num(banded.data))


def test_reproject_explicit_grid_and_silent_warning():
    ours, theirs = _pair()
    kw = dict(res=33.0, bounds=(503000.0, 8672500.0, 504900.0, 8673900.0))
    got, want = ours.reproject(**kw), theirs.reproject(**kw)
    assert got.shape == want.shape and tuple(got.transform) == tuple(want.transform)
    with pytest.warns(UserWarning, match="identical to the input"):
        ours.reproject(ours, silent=False)


@pytest.mark.parametrize("mode", ["match_pixel", "match_extent"])
def test_crop_matches_xdem_tpu(mode):
    ours, theirs = _pair()
    box = (ORIGIN[0] + 213.0, ORIGIN[1] - 1500.0, ORIGIN[0] + 1700.0, ORIGIN[1] - 300.0)
    got, want = ours.crop(box, mode=mode), theirs.crop(box, mode=mode)
    assert got.shape == want.shape and tuple(got.transform) == tuple(want.transform)
    if mode == "match_pixel":
        np.testing.assert_array_equal(got.get_nanarray(), np.asarray(want.data))
    else:
        bound = _float32_coordinate_bound(ours, *got.coords(), 2.0)
        j = np.asarray(want.data)
        both = np.isfinite(j) & np.isfinite(got.get_nanarray())
        assert np.abs(got.get_nanarray()[both] - j[both]).max() <= bound
    icrop = ours.icrop((10, 50), (7, 60))
    np.testing.assert_array_equal(icrop.get_nanarray(), np.asarray(theirs.icrop((10, 50), (7, 60)).data))


@pytest.mark.parametrize("area_or_point", ["Area", "Point"])
def test_point_lookups_match_xdem_tpu(area_or_point):
    ours, theirs = _pair()
    ours.area_or_point = theirs.area_or_point = area_or_point
    rng = np.random.default_rng(0)
    x = ORIGIN[0] + rng.uniform(-100, 112 * RES + 100, 300)
    y = ORIGIN[1] - rng.uniform(-100, 96 * RES + 100, 300)
    np.testing.assert_array_equal(ours.value_at_coords(x, y), theirs.value_at_coords(x, y))
    assert ours.value_at_coords(float(x[0]), float(y[0])) == theirs.value_at_coords(float(x[0]), float(y[0])) \
        or np.isnan(theirs.value_at_coords(float(x[0]), float(y[0])))
    for method in ("nearest", "linear", "cubic"):
        got = ours.interp_points((x, y), method=method).numpy()
        want = np.asarray(theirs.interp_points((x, y), method=method))
        both = np.isfinite(got) & np.isfinite(want)
        if method == "nearest":
            # The pixel that holds the float64 point; xdem_tpu's the same, except where its
            # float32 position (the northing to 1 m, then the inverse affine in float32: ~0.1 px)
            # falls on the other side of a pixel edge.
            np.testing.assert_array_equal(got, ours.value_at_coords(x, y))
            xs, ys = ours._shifted_points(x, y, None)
            rows, cols = ours.transform.rowcol(xs, ys)
            edge = np.minimum(np.abs(rows - np.floor(rows) - 0.5), np.abs(cols - np.floor(cols) - 0.5))
            far = both & (edge > 2 * float(np.spacing(np.float32(y.max()))) / RES)
            assert np.array_equal(got[far], want[far]) and far.sum() > 100
        else:
            assert np.abs(got[both] - want[both]).max() <= _float32_coordinate_bound(ours, x, y, 2.0)
    np.testing.assert_array_equal(ours.xy2ij(x, y), theirs.xy2ij(x, y))
    np.testing.assert_array_equal(ours.coords(grid=False)[0], theirs.coords(grid=False)[0])


def test_stats_subsample_and_arithmetic_match_xdem_tpu():
    ours, theirs = _pair()
    assert ours.get_stats() == theirs.get_stats()
    names = ["mean", "Standard deviation", "le90", "90thpercentile", "sumofsquares", "validcount"]
    assert ours.get_stats(names) == theirs.get_stats(names)
    assert ours.get_stats("nmad") == theirs.get_stats("nmad")
    for sub, seed in ((0.2, 4), (150, 9), (1, 3)):
        np.testing.assert_array_equal(ours.subsample(sub, random_state=seed), theirs.subsample(sub, random_state=seed))
        for a, b in zip(ours.subsample(sub, random_state=seed, return_indices=True),
                        theirs.subsample(sub, random_state=seed, return_indices=True)):
            np.testing.assert_array_equal(a, b)
    for op in (lambda r: (r * 2 - 5) / 3, lambda r: abs(-r) ** 0.5, lambda r: 10 - r):
        np.testing.assert_allclose(op(ours).get_nanarray(), np.asarray(op(theirs).data), rtol=1e-6)
    mask = ours > 500.0
    assert mask.data.dtype == torch.bool
    np.testing.assert_array_equal(mask.get_nanarray(), np.asarray((theirs > 500.0).data))
    np.testing.assert_array_equal(ours.to_pointcloud(as_array=True, subsample=40, random_state=2),
                                  theirs.to_pointcloud(as_array=True, subsample=40, random_state=2))
    pts, jpts = ours.to_pointcloud(subsample=40, random_state=2), theirs.to_pointcloud(subsample=40, random_state=2)
    assert type(pts).__name__ == "PointCloud" and pts.x.dtype == torch.float64
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(pts, k).cpu().numpy(), getattr(jpts, k))


def test_set_mask_nodata_and_area_or_point_match_xdem_tpu():
    ours, theirs = _pair()
    m = np.zeros(ours.shape, np.float32)
    m[3:9, 4:20] = 1.0
    m[0, 0] = np.nan
    ours.set_mask(m)
    theirs.set_mask(m)
    np.testing.assert_array_equal(ours.get_nanarray(), np.asarray(theirs.data))
    v = float(ours.get_nanarray()[40, 40])
    ours.set_nodata(v)
    theirs.set_nodata(v)
    np.testing.assert_array_equal(ours.get_nanarray(), np.asarray(theirs.data))
    ours.set_area_or_point("Point")
    theirs.set_area_or_point("Point")
    assert tuple(ours.transform) == tuple(theirs.transform)
    np.testing.assert_array_equal(ours.proximity().get_nanarray(), np.asarray(theirs.proximity().data))


# ---------------------------------------------------------------------- vectors

def _vectors():
    ring = np.array([[ORIGIN[0] + 100, ORIGIN[1] - 150], [ORIGIN[0] + 1500, ORIGIN[1] - 130],
                     [ORIGIN[0] + 1300, ORIGIN[1] - 1600], [ORIGIN[0] + 250, ORIGIN[1] - 1400]])
    hole = np.array([[ORIGIN[0] + 600, ORIGIN[1] - 600], [ORIGIN[0] + 900, ORIGIN[1] - 610],
                     [ORIGIN[0] + 800, ORIGIN[1] - 900]])
    tri = np.array([[ORIGIN[0] + 1700, ORIGIN[1] - 100], [ORIGIN[0] + 2100, ORIGIN[1] - 900],
                    [ORIGIN[0] + 1650, ORIGIN[1] - 1700]])
    props = [{"name": "a", "area": 3.0}, {"name": "b", "area": 1.0}]
    return (Vector([[ring, hole], [tri]], crs=32633, properties=props),
            JVector([[ring, hole], [tri]], crs=32633, properties=props))


def test_vector_masks_equal_xdem_tpu_bit_for_bit(tmp_path):
    ours, theirs = _vectors()
    r, jr = _pair()
    got = ours.create_mask(r)
    assert got.dtype == torch.bool and got.device == r.data.device
    np.testing.assert_array_equal(got.numpy(), theirs.create_mask(jr))
    rot = tgeo.Affine(RES, 3.0, ORIGIN[0], 2.0, -RES, ORIGIN[1])  # rotated: the per-pixel test
    np.testing.assert_array_equal(ours.create_mask(transform=rot, shape=(90, 110)).numpy(),
                                  theirs.create_mask(transform=jgeo.Affine(*rot), shape=(90, 110)))
    # The examples' glacier outlines on the examples' grid, and in another CRS.
    ours_o = Vector(jex.get_glacier_outlines().polygons, crs=32633)
    jref = jex.get_ref_dem()
    grid = dict(transform=tgeo.Affine(*jref.transform), shape=jref.shape)
    np.testing.assert_array_equal(ours_o.create_mask(**grid).numpy(), jex.get_glacier_outlines().create_mask(jref))
    np.testing.assert_array_equal(ours_o.to_crs(32632).create_mask(crs=32633, **grid).numpy(),
                                  jex.get_glacier_outlines().to_crs(32632).create_mask(jref))
    np.testing.assert_array_equal(ours.rasterize(r).get_nanarray(), np.asarray(theirs.rasterize(jr).data))
    path = str(tmp_path / "v.geojson")
    ours.save(path)
    back = JVector(path)
    np.testing.assert_array_equal(Vector(path).create_mask(r).numpy(), back.create_mask(jr))
    assert [p["name"] for p in ours.query("area > 2").properties] == ["a"]
    assert len(ours.query("name == 'b' or area > 5")) == len(theirs.query("name == 'b' or area > 5")) == 1
    assert ours.crop(r).bounds == theirs.crop(jr).bounds


def test_polygonize_round_trips_through_create_mask():
    r, _ = _pair()
    m = (r.get_nanarray() > 450).astype(np.float32)
    mask_r = r.copy(new_array=m)
    back = mask_r.polygonize(1).create_mask(mask_r).numpy()
    np.testing.assert_array_equal(back, m > 0)


# ---------------------------------------------------------------------- spatialstats and volume

PARAMS = {"model": np.array(["gaussian", "spherical"]), "range": np.array([120.0, 900.0]),
          "psill": np.array([0.4, 0.6]), "smooth": np.array([np.nan, np.nan])}


def test_spatialstats_raster_and_vector_inputs():
    """A Raster with a Vector mask gives what its tensor with the rasterized mask gives (that
    path is held against xdem_tpu in test_torch_spatialstats.py), and a sigma Raster."""
    r, jr = _pair((80, 90))
    noise = np.random.default_rng(2).normal(0, 1.5, r.shape).astype(np.float32)
    dh = r.copy(new_array=noise)
    slope = tterrain.slope(r)
    vec, _ = _vectors()
    stable = ~vec.create_mask(r)
    sig_r, df_r, _ = tss.infer_heteroscedasticity_from_stable(dh, [slope], unstable_mask=vec, subsample=2000,
                                                              random_state=3)
    sig_t, df_t, _ = tss.infer_heteroscedasticity_from_stable(dh.data, [slope.data], stable_mask=stable,
                                                              subsample=2000, random_state=3)
    assert isinstance(sig_r, Raster) and tuple(sig_r.transform) == tuple(r.transform)
    assert torch.equal(torch.nan_to_num(sig_r.data), torch.nan_to_num(sig_t))
    emp_r, _, _ = tss.infer_spatial_correlation_from_stable(dh, ["gaussian"], unstable_mask=vec, subsample=300,
                                                            random_state=4)
    emp_t, _, _ = tss.infer_spatial_correlation_from_stable(dh.data, ["gaussian"], stable_mask=stable, gsd=RES,
                                                            subsample=300, random_state=4)
    np.testing.assert_array_equal(emp_r["exp"], emp_t["exp"])
    pr = tss.patches_method(dh, areas=[4000.0], stable_mask=stable.numpy())
    pt = tss.patches_method(dh.data, areas=[4000.0], gsd=RES, stable_mask=stable.numpy())
    np.testing.assert_array_equal(pr["nmad"], pt["nmad"])
    with pytest.raises(ValueError, match="raster is needed"):
        tss.infer_spatial_correlation_from_stable(dh.data, ["gaussian"], stable_mask=vec, gsd=RES)


def _mask_forms(r):
    """(mask, expected bool array) for every form a mask may take on the grid of `r`."""
    vec, _ = _vectors()
    inside = vec.create_mask(r).numpy()
    ma = np.ma.masked_array(inside, mask=np.zeros_like(inside))
    ma.mask[:5] = True
    moved = r.translate(3 * RES, -2 * RES)
    on_moved = r.copy(new_array=torch.from_numpy(inside.astype(np.float32))).reproject(moved, resampling="nearest")
    shifted = inside.copy()
    shifted[:, :3] = shifted[:2, :] = False  # the moved grid starts 3 px east and 2 px south
    expect_ma = inside.copy()
    expect_ma[:5] = False
    return {"vector": (vec, inside), "raster_same_grid": (r.copy(new_array=torch.from_numpy(inside.astype(np.float32))), inside),
            "raster_other_grid": (on_moved, shifted), "masked_array": (ma, expect_ma), "numpy": (inside, inside),
            "tensor": (torch.from_numpy(inside), inside)}


@pytest.mark.parametrize("form", ["vector", "raster_same_grid", "raster_other_grid", "masked_array", "numpy", "tensor"])
def test_mask_on_takes_every_mask_form(form):
    from xdem_tpu_torch.raster import mask_on

    r, _ = _pair((80, 90))
    m, want = _mask_forms(r)[form]
    got = mask_on(m, r, r.shape, "cpu")
    assert got.dtype == torch.bool and tuple(got.shape) == r.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert mask_on(None, r, r.shape, "cpu") is None
    if form == "vector":
        with pytest.raises(ValueError, match="raster is needed"):
            mask_on(m, None, r.shape, "cpu")
    if form == "numpy":
        with pytest.raises(ValueError, match="does not match"):
            mask_on(m[1:], r, r.shape, "cpu")


def test_raster_mask_on_another_grid_is_regridded_everywhere():
    """spatialstats and estimate_uncertainty read a Raster mask on another grid by nearest
    neighbour on the values' grid, as coregistration does: the same result as its regridded
    boolean array."""
    from xdem_tpu_torch.uncertainty import estimate_uncertainty

    r, _ = _pair((80, 90))
    dh = r.copy(new_array=np.random.default_rng(2).normal(0, 1.5, r.shape).astype(np.float32))
    m, want = _mask_forms(r)["raster_other_grid"]
    emp_r, _, _ = tss.infer_spatial_correlation_from_stable(dh, ["gaussian"], stable_mask=m, subsample=300,
                                                            random_state=4)
    emp_a, _, _ = tss.infer_spatial_correlation_from_stable(dh, ["gaussian"], stable_mask=want, subsample=300,
                                                            random_state=4)
    np.testing.assert_array_equal(emp_r["exp"], emp_a["exp"])
    other = r.copy(new_array=r.data + dh.data)
    kw = dict(approach="R2009", subsample=300, random_state=5)
    sig_r, rho_r = estimate_uncertainty(r, other, stable_terrain=m, **kw)
    sig_a, rho_a = estimate_uncertainty(r, other, stable_terrain=want, **kw)
    assert torch.equal(sig_r.data, sig_a.data)
    np.testing.assert_array_equal(rho_r(np.array([20.0, 200.0])), rho_a(np.array([20.0, 200.0])))


def test_vector_areas_match_xdem_tpu():
    import pandas as pd

    ours, theirs = _vectors()
    r, jr = _pair((80, 90))
    sig = r.copy(new_array=np.abs(r.get_nanarray() / 400.0).astype(np.float32))
    jsig = jr.copy(new_array=np.asarray(sig.get_nanarray()))
    jparams = pd.DataFrame(PARAMS)
    for kw in ({"rasterize_resolution": 60.0}, {"rasterize_resolution": r}):
        jkw = {"rasterize_resolution": jr} if kw["rasterize_resolution"] is r else kw
        got = tss.number_effective_samples(ours, PARAMS, random_state=5, **kw)
        want = jss.number_effective_samples(theirs, jparams, random_state=5, **jkw)
        assert got == pytest.approx(want, rel=1e-6)
    got = tss.spatial_error_propagation([ours, 5e5], sig, PARAMS, rasterize_resolution=60.0, random_state=6)
    want = jss.spatial_error_propagation([theirs, 5e5], jsig, jparams, rasterize_resolution=60.0, random_state=6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.warns(UserWarning, match="rasterization resolution"):
        tss.number_effective_samples(ours, PARAMS)


def test_volume_takes_rasters():
    r, jr = _pair((80, 90))
    dh = r.copy(new_array=(-(r.get_nanarray() - 100) / 100).astype(np.float32))
    got = tvol.hypsometric_binning(dh, r, bins=50.0)
    want = jvol.hypsometric_binning(dh.get_nanarray(), jr.get_nanarray(), bins=50.0)
    np.testing.assert_array_equal(got["count"], want["count"].to_numpy())
    np.testing.assert_allclose(got["value"], want["value"].to_numpy(), rtol=0,
                               atol=1e-4 * np.abs(want["value"].to_numpy()).mean())
    gid = r.copy(new_array=np.where(np.arange(90)[None, :] < 45, 1.0, 2.0) * np.ones((80, 1)))
    sig = tvol.get_regional_hypsometric_signal(dh, r, gid)
    sig_a = tvol.get_regional_hypsometric_signal(dh.data, r.data, gid.data.to(torch.int64))
    for col in ("median", "count"):
        np.testing.assert_array_equal(sig[col], sig_a[col])
