"""xdem_tpu_torch.parallel.sharded: mesh= results left on their mesh, and the CPU only when asked.

A ``mesh=`` terrain call returns ShardedArray planes, one block per shard on that shard's
device, and assembles nothing until the caller asks (``numpy()``, ``to(device)``,
``window()``). Its meshes here are CPU shards (``make_mesh(devices=[torch.device("cpu")] * n)``),
xdem_tpu's the 8 virtual CPU devices of tests/conftest.py. Tolerances: assembled planes equal
the port's single-device planes to the bit (NaN masks included); against
``xdem_tpu.parallel.sharded_stencil`` and xdem_tpu's sharded surface fit, 1e-3 of the mean
magnitude (ROADMAP), with identical NaN masks. The callers that need whole planes (the
uncertainty call, TerrainBias, the DEM methods, the cluster's stencil) give the results they
gave before results stayed on the mesh: equal to their single-device results to the bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, example_dem

from xdem_tpu.parallel import halo as jhalo
from xdem_tpu.parallel import mesh as jmesh
from xdem_tpu_torch import DEM, Affine, _device, coreg, examples, terrain, uncertainty
from xdem_tpu_torch.parallel import ShardedArray, halo, make_mesh, sharded
from xdem_tpu_torch.terrain import terrain as terrain_mod

CPU = torch.device("cpu")
SUITE = ["slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
         "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
         "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
         "fractal_roughness"]


def cpu_mesh(n: int, shape=None):
    return make_mesh(devices=[CPU] * n, shape=shape)


def _bits(got, want, name=""):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w, equal_nan=True), f"{name}: not equal to the bit"


@pytest.fixture(scope="module")
def dem():
    return example_dem(shape=(83, 101), seed=5)


@pytest.fixture
def no_assembly(monkeypatch):
    """Any gathering of blocks into one tensor fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plane was assembled on one device")

    monkeypatch.setattr(sharded, "_assemble", refuse)


# ---------------------------------------------------------------------- the result type


@pytest.mark.parametrize("n,shape", [(4, (2, 2)), (8, (2, 4)), (8, (8, 1)), (4, (1, 4))])
def test_suite_stays_on_the_mesh_block_by_block(n, shape, dem, no_assembly):
    """Each plane is a ShardedArray of the raster's shape; block (iy, ix) lies on its shard's
    device and covers its part of the raster (the last row and column trimmed of the
    padding), and no full-size plane is built."""
    mesh = cpu_mesh(n, shape)
    planes = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=mesh)
    h, w = dem.shape
    bh, bw = -(-h // shape[0]), -(-w // shape[1])
    for p in planes:
        assert isinstance(p, ShardedArray) and p.shape == dem.shape and p.dtype == torch.float32
        assert p.block_shape == (bh, bw) and p.mesh is not None
        for iy, row in enumerate(p.blocks):
            for ix, b in enumerate(row):
                assert b.device == mesh.devices[iy, ix]
                assert tuple(b.shape) == (min(bh, h - iy * bh), min(bw, w - ix * bw))
    assert sum(b.shape[0] for b in (row[0] for row in planes[0].blocks)) == h
    assert sum(b.shape[1] for b in planes[0].blocks[0]) == w


@pytest.mark.parametrize("n", [4, 8])
def test_assembled_planes_equal_the_whole_array(n, dem):
    """numpy(), to(device), np.asarray and a window across every seam give the single-device
    planes to the bit."""
    whole = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0)
    planes = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=cpu_mesh(n))
    for a, p, w in zip(SUITE, planes, whole):
        _bits(p.numpy(), w, a)
    _bits(planes[0].to(CPU), whole[0], "to(cpu)")
    _bits(np.asarray(planes[1]), whole[1], "__array__")
    _bits(planes[2].window(slice(30, 61), slice(20, 77)), whole[2][30:61, 20:77], "window")
    _bits(planes[3].window(slice(None), slice(90, None), CPU), whole[3][:, 90:], "edge window")


def test_stacks_index_and_map_on_the_mesh(dem):
    mesh = cpu_mesh(4)
    stack = halo.sharded_surface_attributes(torch.from_numpy(dem), 20.0, mesh, ("slope", "aspect"))
    assert stack.shape == (2, *dem.shape) and len(stack) == 2
    want = terrain.get_terrain_attribute(dem, ["slope", "aspect"], resolution=20.0, degrees=False)
    for got, w in zip(stack, want):
        _bits(got.numpy(), w)
    _bits(stack[-1].map(torch.rad2deg).numpy(), torch.rad2deg(want[1]))
    with pytest.raises(IndexError):
        stack[2]
    with pytest.raises(TypeError):
        len(stack[0])


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_stencil_matches_xdem_tpu(n, dem):
    """The same halo-1 stencil through both packages' sharded_stencil, and both packages'
    sharded surface fits (1e-3, the curvatures at the percentile rule)."""
    nan = float("nan")

    def lap_t(b):
        return torch.nn.functional.pad(b[:-2, 1:-1] + b[2:, 1:-1] + b[1:-1, :-2] + b[1:-1, 2:] - 4 * b[1:-1, 1:-1],
                                       (1, 1, 1, 1), value=nan)

    def lap_j(b):
        return jnp.pad(b[:-2, 1:-1] + b[2:, 1:-1] + b[1:-1, :-2] + b[1:-1, 2:] - 4 * b[1:-1, 1:-1], 1,
                       constant_values=nan)

    ours = halo.sharded_stencil(lap_t, torch.from_numpy(dem), 1, cpu_mesh(n))
    theirs = jhalo.sharded_stencil(lap_j, jnp.asarray(dem), 1, jmesh.make_mesh(n))
    assert isinstance(ours, ShardedArray)
    assert_plane_close(ours.numpy(), np.asarray(theirs), "laplacian", tol=1e-3)
    attrs = ("slope", "aspect", "max_curvature", "profile_curvature")
    ours = halo.sharded_surface_attributes(torch.from_numpy(dem), 20.0, cpu_mesh(n), attrs)
    theirs = jhalo.sharded_surface_attributes(jnp.asarray(dem), 20.0, jmesh.make_mesh(n), attrs)
    for i, a in enumerate(attrs):
        assert_plane_close(ours[i].numpy(), np.asarray(theirs)[i], a, tol=1e-3,
                           circular=2 * np.pi if a == "aspect" else None)


def test_to_refuses_what_the_device_cannot_hold(dem, monkeypatch):
    """A card short of the bytes refuses before allocating, naming them; the host is not
    checked (it fails as numpy would)."""
    plane = terrain.get_terrain_attribute(dem, "slope", resolution=20.0, mesh=cpu_mesh(4))
    assert plane.nbytes == dem.size * 4
    monkeypatch.setattr(sharded, "_free_bytes", lambda device: plane.nbytes - 1)
    with pytest.raises(MemoryError, match=f"needs {plane.nbytes} bytes"):
        plane.to(torch.device("cuda", 0))
    with pytest.raises(MemoryError, match=f"needs {plane.nbytes} bytes"):
        plane.to("cuda:1")
    assert plane.numpy().shape == dem.shape and plane.to(CPU).shape == dem.shape
    assert plane.window(slice(0, 10), slice(0, 10)).shape == (10, 10)  # a window needs no room for all


def test_blocks_hold_only_their_interior(dem):
    """Each block of a mesh= plane owns storage of its own size: no halo-padded stack (nor
    K1's radian planes) stays alive behind the planes."""
    for p in terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=cpu_mesh(4)):
        for row in p._blocks:
            for b in row:
                assert b.is_contiguous() and b.untyped_storage().nbytes() == b.numel() * b.element_size()


def test_the_dem_is_cut_once_per_call(dem, monkeypatch):
    """Three stencil families (K1, K2, K3 and rugosity's own 3 x 3 pass: four) share one
    scatter of the DEM; each exchanges only its own halo."""
    cuts, exchanges = [], []
    real_shard, real_exchange = terrain_mod.shard, halo._exchange
    monkeypatch.setattr(terrain_mod, "shard", lambda arr, mesh: cuts.append(arr.shape) or real_shard(arr, mesh))
    monkeypatch.setattr(halo, "_exchange", lambda src, h: exchanges.append(h) or real_exchange(src, h))
    terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=cpu_mesh(4))
    assert cuts == [dem.shape] and exchanges == [2, 1, 6]
    cuts.clear(), exchanges.clear()
    terrain.get_terrain_attribute(dem, ["slope", "roughness", "rugosity", "fractal_roughness"], resolution=20.0,
                                  window_size=5, window_size_fractal=13, mesh=cpu_mesh(4))
    assert cuts == [dem.shape] and exchanges == [2, 2, 1, 6]


def test_texture_shading_is_cut_after_the_whole_filter(dem, no_assembly):
    got = terrain.get_terrain_attribute(dem, ["texture_shading", "slope"], resolution=20.0, mesh=cpu_mesh(4))
    assert all(isinstance(p, ShardedArray) for p in got)


# ---------------------------------------------------------------------- callers that need whole planes


def test_dem_methods_and_rasters_assemble_on_the_dem_device(dem):
    d = DEM.from_array(dem, Affine.from_origin(5e5, 8e6, 20.0, 20.0), 32633)
    mesh = cpu_mesh(4)
    _bits(d.slope(mesh=mesh).data, d.slope().data, "slope")
    got = d.get_terrain_attribute(["aspect", "roughness", "fractal_roughness"], mesh=mesh)
    want = d.get_terrain_attribute(["aspect", "roughness", "fractal_roughness"])
    for g, w in zip(got, want):
        assert type(g) is type(w) and g.transform == w.transform
        _bits(g.data, w.data)


def test_uncertainty_and_terrain_bias_give_their_single_device_results(monkeypatch):
    ref = examples.get_ref_dem().icrop((0, 128), (0, 160))
    tba = examples.get_tba_dem().icrop((0, 128), (0, 160))
    mesh = cpu_mesh(4)
    kw = dict(transform=ref.transform, crs=ref.crs, subsample=100, random_state=3)
    sig1, rho1 = uncertainty.estimate_uncertainty(ref.data, tba.data, **kw)
    sig4, rho4 = uncertainty.estimate_uncertainty(ref.data, tba.data, mesh=mesh, **kw)
    _bits(sig4, sig1, "sigma")
    lags = np.array([20.0, 200.0, 2000.0])
    np.testing.assert_array_equal(rho4(lags), rho1(lags))
    # TerrainBias fed the sharded maximum curvature of a mesh= call, and in a pipeline fitted
    # with mesh= (which runs it on one device).
    curv = terrain.get_terrain_attribute(ref, "max_curvature", mesh=mesh)
    sharded_curv = terrain.get_terrain_attribute(ref.data, "max_curvature", resolution=ref.res, mesh=mesh)
    tb = dict(bin_sizes=20)
    one = coreg.TerrainBias(**tb).fit(ref, tba, bias_vars={"max_curvature": curv.data}, random_state=1)
    got = coreg.TerrainBias(**tb).fit(ref, tba, bias_vars={"max_curvature": sharded_curv}, random_state=1)
    _bits(got.apply(tba, bias_vars={"max_curvature": sharded_curv}).data,
          one.apply(tba, bias_vars={"max_curvature": curv.data}).data, "TerrainBias with a sharded variable")
    pipe = lambda: coreg.VerticalShift() + coreg.TerrainBias(**tb)  # noqa: E731
    _bits(pipe().fit(ref, tba, random_state=1, mesh=mesh).apply(tba).data,
          pipe().fit(ref, tba, random_state=1).apply(tba).data, "pipeline with mesh=")


@pytest.mark.parametrize("with_mesh", [False, True])
def test_sharded_planes_feed_the_statistics(dem, with_mesh):
    """A mesh= plane given to infer_heteroscedasticity_from_stable, with or without mesh=,
    is assembled where inputs are converted and gives the whole plane's result to the bit."""
    from xdem_tpu_torch import spatialstats

    mesh = cpu_mesh(4)
    rng = np.random.default_rng(9)
    dh = torch.from_numpy(rng.normal(0, 1, dem.shape).astype(np.float32))
    slope = terrain.get_terrain_attribute(dem, "slope", resolution=20.0)
    kw = dict(list_var_names=["slope"], subsample=2000, random_state=4, mesh=mesh if with_mesh else None)
    want, df_w, _ = spatialstats.infer_heteroscedasticity_from_stable(dh, [slope], **kw)
    sharded_slope = terrain.get_terrain_attribute(dem, "slope", resolution=20.0, mesh=mesh)
    got, df_g, _ = spatialstats.infer_heteroscedasticity_from_stable(dh, [sharded_slope], **kw)
    _bits(got, want, "sigma")
    for k in df_w:
        np.testing.assert_array_equal(df_g[k], df_w[k])
    _bits(_device.as_tensor(sharded_slope), slope, "as_tensor")
    assert _device.as_tensor(sharded_slope, device=CPU).device == CPU


# ---------------------------------------------------------------------- the CPU only when asked


@pytest.fixture
def fresh_default_device():
    _device.default_device.cache_clear()
    yield
    _device.default_device.cache_clear()


def test_default_device_refuses_without_a_card(monkeypatch, fresh_default_device):
    monkeypatch.delenv("XDEM_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="XDEM_TPU_PLATFORM=cpu"):
        _device.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.as_tensor(np.zeros((2, 2)))
    assert _device.as_tensor(torch.zeros(2)).device == CPU  # a CPU tensor is the caller's choice


@pytest.mark.parametrize("cards", [False, True])
def test_default_device_is_the_cpu_when_asked_for(monkeypatch, fresh_default_device, cards):
    monkeypatch.setenv("XDEM_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards)
    assert _device.default_device() == CPU


def test_synchronize_skips_the_cpu(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: waited.append(d))
    _device.synchronize([CPU, torch.device("cuda", 1), torch.device("cuda", 1), torch.device("cuda", 3)])
    assert waited == [torch.device("cuda", 1), torch.device("cuda", 3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    waited.clear()
    _device.synchronize()
    assert waited == [torch.device("cuda", 0), torch.device("cuda", 1)]
