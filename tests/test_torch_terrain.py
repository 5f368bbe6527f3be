"""The port's terrain dispatcher and its 16 wrappers against xdem_tpu.terrain.

Parity tolerance as in test_torch_surfit.py (identical NaN masks; max deviation <= 1e-4 of
the mean magnitude, the four gradient-denominator curvatures at their 99th percentile), here
with each package computing its own mean-centring constant.
"""

import doctest
import importlib
import inspect
import warnings

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, example_dem, to_np

from xdem_tpu import terrain as jterrain
from xdem_tpu_torch import terrain
from xdem_tpu_torch.parallel import make_mesh

SUITE = ["slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
         "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
         "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
         "fractal_roughness"]

WRAPPERS = ["slope", "aspect", "hillshade", "curvature", "profile_curvature", "tangential_curvature",
            "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
            "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
            "fractal_roughness", "texture_shading"]


@pytest.fixture(scope="module")
def dem():
    return example_dem(shape=(96, 112), seed=5)


def test_full_suite_matches_jax(dem):
    want = jterrain.get_terrain_attribute(dem, SUITE, resolution=20.0)
    got = terrain.get_terrain_attribute(dem, SUITE, resolution=20.0)
    assert len(got) == len(SUITE)
    for a, g, w in zip(SUITE, got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert_plane_close(g, np.asarray(w), a, circular=360.0 if a == "aspect" else None)


def test_options_match_jax(dem):
    """Non-default options through the dispatcher: ZT directional, Wilson TRI on 5x5 with
    rugosity routed to its own 3x3 pass, radians, a 7x7 fractal window."""
    kw = dict(resolution=(20.0, 20.0), surface_fit="ZevenbergThorne", curv_method="directional",
              tri_method="Wilson", window_size=5, window_size_fractal=7, degrees=False,
              hillshade_azimuth=120.0, hillshade_altitude=30.0)
    attrs = ["aspect", "hillshade", "min_curvature", "terrain_ruggedness_index", "rugosity",
             "fractal_roughness"]
    with pytest.warns(UserWarning, match="less than 13"):
        want = jterrain.get_terrain_attribute(dem, attrs, **kw)
    with pytest.warns(UserWarning, match="less than 13"):
        got = terrain.get_terrain_attribute(dem, attrs, **kw)
    for a, g, w in zip(attrs, got, want):
        assert_plane_close(g, np.asarray(w), a, circular=6.283185307179586 if a == "aspect" else None)


@pytest.mark.parametrize("fn,kwargs,value", [
    ("slope", dict(surface_fit="ZevenbergThorne", resolution=1.0), 45.0),
    ("aspect", dict(surface_fit="ZevenbergThorne", resolution=1.0), 270.0),
    ("hillshade", dict(resolution=1.0), 181.11),
    ("topographic_position_index", {}, 1.0),
    ("terrain_ruggedness_index", {}, 2.8284),
    ("roughness", {}, 1.0),
])
def test_wrapper_doctest_values(fn, kwargs, value):
    if fn in ("slope", "aspect"):
        arr = np.repeat(np.arange(5, dtype=float)[None, :], 5, axis=0)
    elif fn == "hillshade":
        arr = np.zeros((5, 5))
    else:
        arr = np.zeros((5, 5))
        arr[2, 2] = 1.0
    got = getattr(terrain, fn)(arr, **kwargs)
    assert round(float(got[2, 2]), 4 if value != 181.11 else 2) == value


@pytest.mark.parametrize("module", ["xdem_tpu_torch.terrain.terrain", "xdem_tpu_torch.ops.reductions",
                                    "xdem_tpu_torch.georef", "xdem_tpu_torch.coreg.base"])
def test_docstring_examples(module):
    result = doctest.testmod(importlib.import_module(module), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_signatures_match_jax(name):
    ours = inspect.signature(getattr(terrain, name)).parameters
    theirs = inspect.signature(getattr(jterrain, name)).parameters
    assert list(ours) == list(theirs)
    assert [p.default for p in ours.values()] == [p.default for p in theirs.values()]


def test_dispatcher_signature_matches_jax():
    ours = inspect.signature(terrain.get_terrain_attribute).parameters
    theirs = inspect.signature(jterrain.get_terrain_attribute).parameters
    assert list(ours) == list(theirs)
    assert [p.default for p in ours.values()] == [p.default for p in theirs.values()]


@pytest.mark.parametrize("kwargs", [
    dict(attribute="max_curvature", surface_fit="Horn"),
    dict(attribute="not_an_attribute"),
    dict(attribute="slope", surface_fit="Quadratic"),
    dict(attribute="max_curvature", curv_method="tilted"),
    dict(attribute="terrain_ruggedness_index", tri_method="Smith"),
    dict(attribute="hillshade", hillshade_azimuth=400.0),
    dict(attribute="hillshade", hillshade_altitude=-1.0),
    dict(attribute="hillshade", hillshade_z_factor=float("inf")),
    dict(attribute="slope", resolution=None),
    dict(attribute="rugosity", resolution=(20.0, 10.0)),
    dict(attribute="slope", engine="cuda"),
])
def test_validation_errors_match_jax(kwargs):
    arr = np.zeros((6, 6), np.float32)
    kwargs = {"resolution": 20.0, **kwargs}
    with pytest.raises(ValueError) as theirs:
        jterrain.get_terrain_attribute(arr, **kwargs)
    with pytest.raises(ValueError) as ours:
        terrain.get_terrain_attribute(arr, **kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("call, err, match", [
    (lambda d: terrain.get_terrain_attribute(d, "slope", resolution=1.0, mesh=make_mesh(
        devices=[torch.device("cpu")] * 8, shape=(8, 1))), ValueError, "too small to halo-shard"),
    (lambda d: terrain.get_terrain_attribute(d, "slope", resolution=1.0, tiled=terrain.TilingConfig()), ValueError,
     "needs `outdir`"),
    (lambda d: terrain.get_terrain_attribute(d, "slope", resolution=1.0, mp_config=object()), ValueError,
     "process-pool tiling does not exist"),
], ids=["mesh", "tiled", "mp_config"])
def test_not_ported_paths_raise(call, err, match):
    """mesh= refuses a mesh whose blocks are narrower than the stencil's halo (the sharded path
    itself is held in test_torch_parallel.py); tiled= and mp_config= are routed to
    tiled_terrain_attribute and refuse what xdem_tpu refuses, with its messages."""
    with pytest.raises(err, match=match):
        call(np.zeros((6, 6), np.float32))


def test_fractal_window_warnings_match_jax():
    arr = np.random.default_rng(0).random((12, 12)).astype(np.float32)
    with pytest.warns(UserWarning, match="larger or equal to 5"):
        out = terrain.fractal_roughness(arr, window_size_fractal=3)
    assert torch.isnan(out).all()


def test_fractal_window_4_on_the_cpu_matches_jax_xla(dem):
    """Window 4 has two box scales (q = 1, 2): on a CPU tensor the port gives the reference's
    XLA values (the card raises instead; see test_torch_cuda.py). Tolerance 1e-4 scaled."""
    with pytest.warns(UserWarning, match="larger or equal to 5"):
        want = jterrain.get_terrain_attribute(dem, "fractal_roughness", window_size_fractal=4, engine="xla")
    with pytest.warns(UserWarning, match="larger or equal to 5"):
        got = terrain.get_terrain_attribute(torch.from_numpy(dem), "fractal_roughness", window_size_fractal=4)
    assert torch.isfinite(got).any()
    assert_plane_close(got, np.asarray(want), "fractal_roughness")


def test_return_types_dtype_and_inputs(dem):
    single = terrain.get_terrain_attribute(dem, "roughness")
    assert isinstance(single, torch.Tensor) and tuple(single.shape) == dem.shape
    pair = terrain.get_terrain_attribute(dem.astype(np.float64), ["roughness", "slope"], resolution=20.0,
                                         out_dtype=np.float64)
    assert isinstance(pair, list) and all(p.dtype == torch.float64 for p in pair)
    masked = np.ma.masked_array(dem, mask=np.zeros(dem.shape, bool))
    masked.mask[40, 40] = True
    m = terrain.get_terrain_attribute(masked, "roughness")
    assert torch.isnan(m[39:42, 39:42]).all()
    # A tensor input stays on its device and is not copied to numpy.
    t = torch.from_numpy(dem)
    assert terrain.slope(t, resolution=20.0).device == t.device


def test_rugosity_takes_its_own_3x3_pass(dem):
    both = terrain.get_terrain_attribute(dem, ["roughness", "rugosity"], resolution=20.0, window_size=5)
    alone = terrain.rugosity(dem, resolution=20.0)
    np.testing.assert_array_equal(to_np(both[1]), to_np(alone))


def test_deprecated_aliases(dem):
    with pytest.warns(DeprecationWarning, match="surface_fit"):
        got = terrain.slope(dem, method="Horn", resolution=20.0)
    np.testing.assert_array_equal(to_np(got), to_np(terrain.slope(dem, surface_fit="Horn", resolution=20.0)))
    with pytest.warns(DeprecationWarning, match="curvature"):
        terrain.curvature(dem, resolution=20.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        terrain.terrain_ruggedness_index(dem, method="Wilson")
