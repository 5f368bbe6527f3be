"""Out-of-core terrain attributes of xdem_tpu_torch against its whole-array result and xdem_tpu's.

The cases of tests/test_terrain.py:404-462 (not the mesh= case, which xdem_tpu's parallel/
owns): row bands streamed to GeoTIFFs equal the whole-array attributes, at band seams (the
halo) and raster edges (NaN padding). Each band is centred on its own mean before the surface
fit, as in xdem_tpu, so the surface-fit attributes are held to xdem_tpu's tolerance for this
comparison (rtol 1e-4, atol 1e-3; aspect 0.1 deg) and the windowed and fractal attributes,
which read no centre, to the bit. Against xdem_tpu's own tiled files the terrain tolerance
applies: 1e-3 of the mean magnitude with identical NaN masks. The routing of ``tiled=`` and
``mp_config=`` and every refusal carry xdem_tpu's messages.
"""

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from torch_port_helpers import assert_plane_close

from xdem_tpu import examples as jex
from xdem_tpu import terrain as jterrain
from xdem_tpu.io import read_raster as jread_raster
from xdem_tpu.parallel import mesh as jmesh
from xdem_tpu.terrain import tiled as jtiled
from xdem_tpu_torch import Affine, Raster, io, terrain
from xdem_tpu_torch.terrain import tiled
from xdem_tpu_torch.parallel import make_mesh

ATTRS = ["slope", "aspect", "hillshade", "max_curvature", "topographic_position_index", "roughness",
         "fractal_roughness"]
KW = dict(resolution=20.0, surface_fit="Florinsky", window_size=5, window_size_fractal=13)
SURFACE_FIT = ("slope", "aspect", "hillshade", "max_curvature")


@pytest.fixture(scope="module")
def dem():
    """xdem_tpu's test DEM: odd-sized, so the last band is partial, with a NaN hole."""
    dem = jex.synthetic_dem_array(shape=(257, 257), seed=8)
    dem[40:45, 60:70] = np.nan
    return dem


@pytest.fixture(scope="module")
def ours(dem, tmp_path_factory):
    out = tmp_path_factory.mktemp("ours")
    paths = terrain.tiled_terrain_attribute(dem, ATTRS, terrain.TilingConfig(tile_rows=64, outdir=str(out)), **KW)
    return [io.read_raster(p).data.numpy() for p in paths]


def _against_whole(got, whole, attrs):
    for a, g, w in zip(attrs, got, whole):
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(np.isnan(g), np.isnan(w)), f"{a}: NaN masks differ"
        both = np.isfinite(g)
        if a == "aspect":
            d = np.abs(g[both] - w[both])
            assert np.minimum(d, 360 - d).max() < 0.1, a
        elif a in SURFACE_FIT:
            np.testing.assert_allclose(g[both], w[both], rtol=1e-4, atol=1e-3, err_msg=a)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{a}: not the whole-array result to the bit")


def test_tiled_equals_whole_array(dem, ours):
    _against_whole(ours, terrain.get_terrain_attribute(dem, ATTRS, **KW), ATTRS)


def test_tiled_matches_xdem_tpus_tiled(dem, ours, tmp_path):
    paths = jtiled.tiled_terrain_attribute(dem, ATTRS, jtiled.TilingConfig(tile_rows=64, outdir=str(tmp_path)), **KW)
    for a, g, p in zip(ATTRS, ours, paths):
        want = np.asarray(jread_raster(p).data)
        if a == "aspect":
            assert_plane_close(np.deg2rad(g), np.deg2rad(want), a, tol=1e-3, circular=2 * np.pi)
        else:
            assert_plane_close(g, want, a, tol=1e-3)


@pytest.mark.parametrize("kind", ["tensor", "raster", "striped_file", "compressed_file"])
def test_every_input_kind_gives_the_arrays_bands(dem, ours, kind, tmp_path):
    """A CPU tensor, a Raster (its georeferencing reaches the files), an uncompressed striped
    GeoTIFF read band by band and a DEFLATE GeoTIFF decoded once give the array's bits."""
    t = Affine.from_origin(5e5, 8.67e6, 20.0, 20.0)
    src = {"tensor": torch.from_numpy(dem), "raster": Raster(dem, t, 32633)}.get(kind)
    if kind == "striped_file":
        src = str(tmp_path / "src.tif")
        with io.StreamingRasterWriter(src, dem.shape, t, crs=32633) as wtr:
            wtr.write_rows(0, dem)
    elif kind == "compressed_file":
        src = str(tmp_path / "src.tif")
        Raster(dem, t, 32633).save(src)
        with pytest.raises(OSError):
            io.read_rows(src, 0, 1)
    kw = dict(KW, resolution=None) if kind != "tensor" else KW
    paths = terrain.tiled_terrain_attribute(src, ATTRS, terrain.TilingConfig(tile_rows=64, outdir=str(tmp_path / "o")), **kw)
    for a, p, want in zip(ATTRS, paths, ours):
        r = io.read_raster(p)
        np.testing.assert_array_equal(r.data.numpy(), want, err_msg=a)
        if kind != "tensor":
            assert r.crs == 32633 and tuple(r.transform) == tuple(t)


def test_tiled_from_streamed_file_matches_xdem_tpu(tmp_path):
    """Path input (tests/test_terrain.py:436): georeferencing from the file, slope against the
    whole array, and xdem_tpu's file read back by the port."""
    dem = jex.synthetic_dem_array(shape=(200, 200), seed=9)
    t = Affine(20.0, 0.0, 5e5, 0.0, -20.0, 8.67e6)
    src = str(tmp_path / "src.tif")
    with io.StreamingRasterWriter(src, dem.shape, t, crs=32633) as wtr:
        wtr.write_rows(0, dem)
    (path,) = terrain.tiled_terrain_attribute(src, "slope", terrain.TilingConfig(tile_rows=96, outdir=str(tmp_path / "o")))
    (jpath,) = jtiled.tiled_terrain_attribute(src, "slope", jtiled.TilingConfig(tile_rows=96, outdir=str(tmp_path / "j")))
    got = io.read_raster(path)
    assert got.crs == 32633 and tuple(got.transform) == tuple(t)
    _against_whole([got.data.numpy()], [terrain.get_terrain_attribute(dem, "slope", resolution=20.0)], ["slope"])
    assert_plane_close(got.data.numpy(), np.asarray(jread_raster(jpath).data), "slope", tol=1e-3)


def test_routing_through_get_terrain_attribute(dem, ours, tmp_path):
    """tiled= and an mp_config with tile_rows (its alias) route to tiled_terrain_attribute."""
    for name, kw in (("tiled", "tiled"), ("alias", "mp_config")):
        cfg = terrain.TilingConfig(tile_rows=64, outdir=str(tmp_path / name))
        paths = terrain.get_terrain_attribute(dem, ATTRS, **{kw: cfg}, **KW)
        assert paths == [cfg.path_for(a) for a in ATTRS]
        for p, want in zip(paths, ours):
            np.testing.assert_array_equal(io.read_raster(p).data.numpy(), want)


@pytest.mark.parametrize("case", ["frequency", "unknown", "out_dtype", "no_outdir", "process_pool", "both"])
def test_refusals_match_xdem_tpu(case, tmp_path):
    arr = np.zeros((32, 32), np.float32)

    def call(pkg, cfg_cls):
        cfg = cfg_cls(outdir=str(tmp_path))
        if case == "frequency":
            return pkg.tiled_terrain_attribute(arr, "texture_shading", cfg)
        if case == "unknown":
            return pkg.tiled_terrain_attribute(arr, ["slope", "slop"], cfg)
        if case == "out_dtype":
            return pkg.get_terrain_attribute(arr, "slope", resolution=1.0, tiled=cfg, out_dtype=np.float64)
        if case == "no_outdir":
            return pkg.tiled_terrain_attribute(arr, "slope", cfg_cls(), resolution=1.0)
        if case == "process_pool":
            return pkg.get_terrain_attribute(arr, "slope", resolution=1.0, mp_config=object())
        return pkg.get_terrain_attribute(arr, "slope", resolution=1.0, tiled=cfg, mp_config=cfg)

    with pytest.raises(ValueError) as theirs:
        call(jterrain, jtiled.TilingConfig)
    with pytest.raises(ValueError) as got:
        call(terrain, terrain.TilingConfig)
    assert str(got.value) == str(theirs.value)


def test_mesh_stays_refused(tmp_path):
    """tiled= (out-of-core streaming) and mesh= (device sharding) are exclusive, with
    xdem_tpu's ValueError."""
    arr = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError) as theirs:
        jterrain.get_terrain_attribute(arr, "slope", resolution=1.0, mesh=jmesh.make_mesh(2),
                                       tiled=jtiled.TilingConfig(outdir=str(tmp_path)))
    with pytest.raises(ValueError) as got:
        terrain.get_terrain_attribute(arr, "slope", resolution=1.0, mesh=make_mesh(devices=[torch.device("cpu")] * 2),
                                      tiled=terrain.TilingConfig(outdir=str(tmp_path)))
    assert str(got.value) == str(theirs.value)


@pytest.mark.parametrize("attrs", [["slope"], ["slope", "roughness"], ["fractal_roughness"], ["rugosity"],
                                   ["terrain_ruggedness_index", "hillshade"]])
@pytest.mark.parametrize("fit", ["Florinsky", "Horn"])
def test_halo_and_paths_match_xdem_tpu(attrs, fit, tmp_path):
    assert tiled._halo_for(attrs, fit, 7, 11) == jtiled._halo_for(attrs, fit, 7, 11)
    ours = terrain.TilingConfig(outdir=str(tmp_path), out_paths={"slope": str(tmp_path / "s.tif")})
    theirs = jtiled.TilingConfig(outdir=str(tmp_path), out_paths={"slope": str(tmp_path / "s.tif")})
    assert [ours.path_for(a) for a in attrs] == [theirs.path_for(a) for a in attrs]
    assert terrain.TilingConfig().tile_rows == jtiled.TilingConfig().tile_rows == 1024


def test_band_memory_is_one_band(dem, tmp_path, monkeypatch):
    """Every band handed to the attributes has one shape, tile_rows plus the halo on each side,
    and the source is read once per band."""
    shapes, reads = [], []
    orig_band, orig_rows = tiled._band_on, tiled._RowSource.rows

    def band_on(*args):
        out = orig_band(*args)
        shapes.append(tuple(out.shape))
        return out

    def rows(self, r0, n):
        reads.append((r0, n))
        return orig_rows(self, r0, n)

    monkeypatch.setattr(tiled, "_band_on", band_on)
    monkeypatch.setattr(tiled._RowSource, "rows", rows)
    terrain.tiled_terrain_attribute(dem, ["slope", "fractal_roughness"], terrain.TilingConfig(tile_rows=64, outdir=str(tmp_path)),
                                    resolution=20.0)
    assert shapes == [(64 + 2 * 6, 257)] * 5 and len(reads) == 5
    assert reads[0] == (0, 70) and reads[-1] == (250, 7)
