"""xdem_tpu_torch.terrain.freq (texture shading) against xdem_tpu.terrain.freq.

The same seeded DEM goes through both packages: the repository's spectral DEM (~1000 m of
relief) plus 1 m of white noise, which gives the high-pass output a magnitude that a float32
transform resolves (at alpha = 2 a noise-free spectral DEM leaves ~3 mm, below both packages'
float32 rounding of the transform). Tolerance: 1e-3 of the mean magnitude with identical NaN
masks, the terrain tolerance of the port; the deviation is both transforms' float32 rounding
(xdem_tpu transforms elevations as they are, the port removes their mean first).
"""

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from torch_port_helpers import assert_plane_close, scaled_dev

from xdem_tpu import examples
from xdem_tpu.terrain import freq as jfreq
from xdem_tpu.terrain import terrain as jterrain
from xdem_tpu_torch import terrain
from xdem_tpu_torch.terrain import freq as tfreq

TOL = 1e-3


def _dem(shape, seed=3):
    rng = np.random.default_rng(seed)
    dem = examples.synthetic_dem_array(shape=shape, resolution=20.0, seed=seed)
    dem = dem + rng.normal(0.0, 1.0, shape).astype(np.float32)
    dem[13:16, 17:21] = np.nan
    return dem.astype(np.float32)


@pytest.fixture(scope="module", params=[(200, 333), (1100, 1030)], ids=["pow2-pad", "7-smooth-pad"])
def dem(request):
    return _dem(request.param)


@pytest.mark.parametrize("alpha", [0.0, 0.8, 2.0])
def test_texture_shading_matches_xdem_tpu(dem, alpha):
    """200 x 333 pads to 256 x 512 (powers of two), 1100 x 1030 to 1120 x 1050 (7-smooth):
    within 1e-3 of the mean magnitude, identical NaN mask (the hole comes back as NaN)."""
    want = np.asarray(jfreq.texture_shading(dem, alpha))
    got = tfreq.texture_shading(torch.from_numpy(dem), alpha)
    assert got.dtype == torch.float32 and tuple(got.shape) == dem.shape
    assert_plane_close(got, want, f"texture_shading alpha={alpha}", tol=TOL)
    assert torch.isnan(got[13:16, 17:21]).all() and torch.isfinite(got).sum() == np.isfinite(dem).sum()


@pytest.mark.parametrize("alpha", [0.8, 2.0])
def test_texture_shading_against_float64(alpha):
    """The port's float32 result against the same transform in float64: within 1e-3 of the
    mean magnitude, and no further from it than xdem_tpu's float32 result is."""
    dem = _dem((300, 1100))
    got = tfreq.texture_shading(dem, alpha)
    exact = tfreq._texture_core(torch.from_numpy(dem).double(), alpha, tfreq.next_fast_fft_size(300),
                                tfreq.next_fast_fft_size(1100))
    ours = scaled_dev(got, exact)
    assert ours <= TOL
    assert ours <= scaled_dev(np.asarray(jfreq.texture_shading(dem, alpha)), exact) * 1.5


def test_symmetric_padding_equals_numpy():
    """`_pad_symmetric` is numpy's mode="symmetric" (the edge pixel repeated), to the bit."""
    x = np.random.default_rng(0).normal(size=(7, 9)).astype(np.float32)
    for dim, before, after in [(0, 0, 0), (0, 3, 2), (1, 9, 0), (1, 4, 9), (0, 7, 7)]:
        pads = [(0, 0), (0, 0)]
        pads[dim] = (before, after)
        want = np.pad(x, pads, mode="symmetric")
        np.testing.assert_array_equal(tfreq._pad_symmetric(torch.from_numpy(x), dim, before, after).numpy(), want)
    with pytest.raises(ValueError, match="exceeds"):
        tfreq._pad_symmetric(torch.from_numpy(x), 0, 8, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1024, 1025, 1030, 1100, 4999, 5003, 10_000])
def test_next_fast_fft_size_equals_original(n):
    assert tfreq.next_fast_fft_size(n) == jfreq.next_fast_fft_size(n)


@pytest.mark.parametrize("alpha", [-0.1, 2.5])
def test_alpha_outside_range_raises(alpha):
    dem = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError) as theirs:
        jfreq.texture_shading(dem, alpha)
    with pytest.raises(ValueError, match="between 0 and 2") as ours:
        tfreq.texture_shading(dem, alpha)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="between 0 and 2"):
        terrain.texture_shading(dem, alpha=alpha)


def test_alpha_none_is_the_default():
    dem = _dem((64, 80))
    np.testing.assert_array_equal(tfreq.texture_shading(dem, None).numpy(), tfreq.texture_shading(dem, 0.8).numpy())


def test_through_the_dispatcher_with_another_attribute():
    """get_terrain_attribute answers slope and texture shading from one call, in request
    order, and the wrapper passes alpha on: each within its tolerance of xdem_tpu."""
    dem = _dem((96, 112), seed=5)
    want = jterrain.get_terrain_attribute(dem, ["texture_shading", "slope"], resolution=20.0, texture_alpha=1.2)
    got = terrain.get_terrain_attribute(dem, ["texture_shading", "slope"], resolution=20.0, texture_alpha=1.2)
    assert_plane_close(got[0], np.asarray(want[0]), "texture_shading", tol=TOL)
    assert_plane_close(got[1], np.asarray(want[1]), "slope")
    alone = terrain.texture_shading(dem, alpha=1.2)
    np.testing.assert_array_equal(alone.numpy(), got[0].numpy())
    assert_plane_close(terrain.texture_shading(dem), np.asarray(jterrain.texture_shading(dem)), "default", tol=TOL)


def test_texture_shading_needs_no_resolution_and_casts_out_dtype():
    dem = _dem((40, 48))
    out = terrain.get_terrain_attribute(dem, "texture_shading", out_dtype=np.float64)
    assert out.dtype == torch.float64 and tuple(out.shape) == dem.shape
