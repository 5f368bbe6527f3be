"""xdem_tpu_torch.parallel: meshes, the halo exchange, sharded terrain and the distributed
selections, against the port's single-device results and xdem_tpu's mesh= results.

The port's meshes are CPU shards (``make_mesh(devices=[torch.device("cpu")] * n)``); xdem_tpu
runs on the 8 virtual CPU devices of tests/conftest.py. A mesh= result is a ShardedArray left
on the mesh, assembled here with ``.numpy()``. Tolerances: sharded terrain planes
equal the port's single-device planes to the bit (NaN masks included), and xdem_tpu's mesh=
planes within 1e-3 of the mean magnitude (the curvatures under |grad z| at the percentile
rule of torch_port_helpers); selections are exact (order statistics).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P
from torch_port_helpers import assert_plane_close, example_dem

from xdem_tpu import terrain as jterrain
from xdem_tpu.parallel import mesh as jmesh
from xdem_tpu.parallel import selection as jsel
from xdem_tpu_torch import terrain
from xdem_tpu_torch.parallel import _collectives, halo, make_mesh, selection
from xdem_tpu_torch.parallel.mesh import as_mesh_1d, as_mesh_2d
from xdem_tpu_torch.parallel.sharded import shard

CPU = torch.device("cpu")
SUITE = ["slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
         "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
         "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
         "fractal_roughness"]


def cpu_mesh(n: int, shape=None):
    return make_mesh(devices=[CPU] * n, shape=shape)


def _same(got, want, name=""):
    """Identical NaN masks and values; a sharded result is assembled on the host here."""
    g, w = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(g), np.isnan(w)), f"{name}: NaN masks differ"
    assert np.array_equal(g[~np.isnan(g)], w[~np.isnan(w)]), f"{name}: values differ"


@pytest.fixture(scope="module")
def dem():
    return example_dem(shape=(83, 101), seed=5)


# ---------------------------------------------------------------------- meshes


@pytest.mark.parametrize("n,shape", [(8, None), (6, None), (7, None), (4, (1, 4)), (8, (8, 1)), (1, None)])
def test_mesh_shapes_match_xdem_tpu(n, shape):
    ours = cpu_mesh(n, shape)
    theirs = jmesh.make_mesh(n, shape=shape, devices=jax.devices()[:n] if n <= 8 else None)
    assert ours.devices.shape == theirs.devices.shape and ours.axis_names == theirs.axis_names
    assert as_mesh_1d(ours).devices.shape == jmesh.as_mesh_1d(theirs).devices.shape
    assert as_mesh_2d(as_mesh_1d(ours)).devices.shape == jmesh.as_mesh_2d(jmesh.as_mesh_1d(theirs)).devices.shape
    assert all(d == CPU for d in ours.devices.flat) and ours.root == CPU


def test_make_mesh_refuses_what_does_not_fit(monkeypatch):
    with pytest.raises(ValueError, match="does not match device count"):
        make_mesh(devices=[CPU] * 4, shape=(3, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_collectives_sum_and_gather_in_shard_order():
    mesh = as_mesh_1d(cpu_mesh(4))
    parts = [torch.full((3,), float(i)) for i in range(4)]
    assert _collectives.psum(parts, mesh).tolist() == [6.0, 6.0, 6.0]
    assert parts[0].tolist() == [0.0, 0.0, 0.0]  # the sum never writes into a shard's tensor
    assert _collectives.all_gather(parts, mesh)[:, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert all(r is parts[1] for r in _collectives.replicate(parts[1], mesh))  # one device: no copy


# ---------------------------------------------------------------------- the halo exchange


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (8, 1), (3, 5)])
@pytest.mark.parametrize("h", [1, 2, 6])
def test_halo_blocks_are_the_padded_neighbourhoods(shape, h, dem):
    """Every padded block is the NaN-padded raster's window around its block, corners
    included, on ragged shapes."""
    mesh = cpu_mesh(shape[0] * shape[1], shape)
    arr = torch.from_numpy(dem)
    src = shard(arr, mesh)
    bh, bw = src.block_shape
    padded = torch.nn.functional.pad(arr, (0, bw * shape[1] - arr.shape[1], 0, bh * shape[0] - arr.shape[0]),
                                     value=float("nan"))
    ref = torch.nn.functional.pad(padded, (h, h, h, h), value=float("nan"))
    blocks = halo._exchange(src, h)
    for iy in range(shape[0]):
        for ix in range(shape[1]):
            _same(blocks[iy][ix], ref[iy * bh:(iy + 1) * bh + 2 * h, ix * bw:(ix + 1) * bw + 2 * h])
    out = halo.sharded_stencil(lambda b: b * 2, arr, h, mesh)
    _same(out, arr * 2)


def test_too_small_to_shard_raises_like_xdem_tpu(dem):
    arr = dem[:20, :20]
    with pytest.raises(ValueError) as theirs:
        jterrain.get_terrain_attribute(arr, "fractal_roughness", mesh=jmesh.make_mesh(8, shape=(8, 1)))
    with pytest.raises(ValueError) as ours:
        terrain.get_terrain_attribute(arr, "fractal_roughness", mesh=cpu_mesh(8, (8, 1)))
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------- sharded terrain


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (8, 1), (2, 4)])
def test_sharded_suite_equals_single_device(shape, dem):
    single = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0)
    sharded = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=cpu_mesh(shape[0] * shape[1], shape))
    for a, g, w in zip(SUITE, sharded, single):
        _same(g, w, a)


def test_sharded_suite_matches_xdem_tpu_mesh(dem):
    want = jterrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=jmesh.make_mesh(8))
    got = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0, mesh=cpu_mesh(8))
    for a, g, w in zip(SUITE, got, want):
        assert_plane_close(g.numpy(), np.asarray(w), a, tol=1e-3, circular=360.0 if a == "aspect" else None)


@pytest.mark.parametrize("kw", [
    dict(surface_fit="ZevenbergThorne", window_size=5, window_size_fractal=7),
    dict(surface_fit="Horn", tri_method="Wilson", window_size=9, window_size_fractal=21),
], ids=["zt_5x5", "horn_9x9"])
def test_sharded_options_equal_single_device(kw, dem):
    """Other halos: 1 for the 3 x 3 fits, w // 2 for the windows, rugosity's own 3 x 3 pass."""
    attrs = ["slope", "aspect", "hillshade", "terrain_ruggedness_index", "rugosity", "roughness",
             "fractal_roughness"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fractal windows under 13 px
        single = terrain.get_terrain_attribute(dem, attrs, resolution=20.0, **kw)
        sharded = terrain.get_terrain_attribute(dem, attrs, resolution=20.0, mesh=cpu_mesh(4, (2, 2)), **kw)
    for a, g, w in zip(attrs, sharded, single):
        _same(g, w, a)


def test_wrappers_forward_mesh_and_texture_shading_stays_whole(dem):
    mesh = cpu_mesh(4)
    _same(terrain.slope(dem, resolution=20.0, mesh=mesh), terrain.slope(dem, resolution=20.0))
    _same(terrain.texture_shading(dem, resolution=20.0, mesh=mesh), terrain.texture_shading(dem, resolution=20.0))


# ---------------------------------------------------------------------- selections


def test_signed_keys_round_trip_and_order():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 100, 500).astype(np.float32),
                        np.float32([0.0, -0.0, 1e-38, -1e-38, 3.4e38, -3.4e38])])
    keys = selection.signed_monotone_u32(torch.from_numpy(x))
    np.testing.assert_array_equal(selection.u32_to_f32(keys).numpy(), x)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jsel.signed_monotone_u32(jnp.asarray(x))).astype(np.int64))
    # key order is value order, -0 before +0
    assert np.all(np.diff(keys.numpy()[np.lexsort((keys.numpy(), x))]) >= 0)
    assert keys[-5] < keys[-6]


def _shards(a: np.ndarray, n: int) -> list[torch.Tensor]:
    return list(torch.tensor_split(torch.from_numpy(a), n))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_per_bin_median_and_kth_match_numpy_and_xdem_tpu(n):
    """xdem_tpu's test_coreg.py selection cases: a bin of positives, one of negatives, an
    empty bin, invalid entries; the k-th statistics against np.partition."""
    rng = np.random.default_rng(1)
    size, n_bins = 4096, 7
    x = rng.normal(-5, 50, size).astype(np.float32)
    bins = rng.integers(0, n_bins + 1, size).astype(np.int64)  # n_bins: the invalid slot
    x[bins == 3] = np.abs(x[bins == 3])
    x[bins == 5] = -np.abs(x[bins == 5])
    bins[bins == 6] = n_bins
    mesh = as_mesh_1d(cpu_mesh(n, (1, n)))
    counts = torch.from_numpy(np.bincount(bins, minlength=n_bins + 1)[:n_bins])
    got = selection.signed_median_by_bin(_shards(x, n), _shards(bins, n), counts, n_bins, mesh).numpy()
    want = np.array([np.median(x[bins == b]) if counts[b] else np.nan for b in range(n_bins)], np.float32)
    np.testing.assert_array_equal(got, want)
    if n != 8:
        return
    jm = JaxMesh(np.asarray(jax.devices()[:8]), ("p",))
    theirs = shard_map(lambda xs, bs, c: jsel.signed_median_by_bin(xs, bs, c, n_bins, "p"), mesh=jm,
                       in_specs=(P("p"), P("p"), P(None)), out_specs=P(None))(
        jnp.asarray(x), jnp.asarray(bins.astype(np.int32)), jnp.asarray(counts.numpy().astype(np.int32)))
    np.testing.assert_array_equal(got, np.asarray(theirs))
    k = torch.clamp(counts - 3, min=0)
    kth = selection.signed_kth_by_bin(_shards(x, n), _shards(bins, n), k, n_bins, mesh).numpy()
    for b in range(n_bins):
        if counts[b]:
            assert kth[b] == np.partition(x[bins == b], int(k[b]))[int(k[b])], b


def test_masked_median_is_shard_invariant():
    rng = np.random.default_rng(2)
    x = rng.normal(3, 20, 4000).astype(np.float32)
    valid = rng.uniform(size=4000) > 0.3
    outs = []
    for n in (1, 2, 8):
        med, cnt = selection.masked_median_distributed(_shards(x, n), _shards(valid, n),
                                                       as_mesh_1d(cpu_mesh(n, (1, n))))
        assert int(cnt) == int(valid.sum())
        outs.append(float(med))
    assert outs[0] == outs[1] == outs[2] == np.float32(np.median(x[valid]))


def test_nonneg_selection_matches_the_signed_one():
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(0, 5, 3001)).astype(np.float32)
    bins = rng.integers(0, 5, 3001)
    mesh = as_mesh_1d(cpu_mesh(8))
    counts = torch.from_numpy(np.bincount(bins, minlength=5))
    a = selection.nonneg_median_by_bin(_shards(d, 8), _shards(bins, 8), counts, 5, mesh)
    b = selection.signed_median_by_bin(_shards(d, 8), _shards(bins, 8), counts, 5, mesh)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), [np.median(d[bins == i]) for i in range(5)])
