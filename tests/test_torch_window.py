"""Plain PyTorch K2 and K3 (xdem_tpu_torch.terrain.window) against xdem_tpu's windowed
indexes and fractal roughness.

Tolerance: identical NaN masks; max deviation <= 1e-4 of each plane's mean magnitude
(measured <= 3e-5: TPI differs from XLA in the last bit of the window mean).
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, assert_same_nan, example_dem, to_np

from xdem_tpu.terrain import window as jwin
from xdem_tpu_torch.terrain import window

W4 = window.WINDOWED_ATTRS


@pytest.fixture(scope="module")
def dem():
    return example_dem(shape=(70, 90), seed=12)


@pytest.mark.parametrize("window_size,tri_method,attrs", [
    (3, "Riley", W4), (3, "Wilson", W4), (5, "Riley", W4[:3]), (7, "Wilson", W4[:3]),
])
def test_windowed_indexes_match_jax(dem, window_size, tri_method, attrs):
    want = np.asarray(jwin.windowed_indexes(dem, 20.0, attrs, window_size=window_size, tri_method=tri_method))
    got = window.windowed_indexes(torch.from_numpy(dem), 20.0, attrs, window_size, tri_method)
    for i, a in enumerate(attrs):
        assert_plane_close(got[i], want[i], a)


@pytest.mark.parametrize("window_size", [5, 7, 13])
def test_fractal_roughness_matches_jax(dem, window_size):
    want = np.asarray(jwin.fractal_roughness(dem, window_size=window_size, engine="xla"))
    got = window.fractal_roughness(torch.from_numpy(dem), window_size)
    assert_plane_close(got, want, "fractal_roughness")


def test_windowed_matches_pallas_kernel_in_interpret_mode(dem):
    from jax.experimental.pallas import tpu as pltpu

    from xdem_tpu.terrain.pallas_kernels import windowed_indexes_pallas

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(windowed_indexes_pallas(dem, 20.0, W4, window_size=3, tri_method="Riley"))
    got = window.windowed_indexes(torch.from_numpy(dem), 20.0, W4, 3, "Riley")
    for i, a in enumerate(W4):
        assert_plane_close(got[i], want[i], a)


def test_fractal_matches_pallas_kernel_in_interpret_mode(dem):
    from jax.experimental.pallas import tpu as pltpu

    from xdem_tpu.terrain.pallas_kernels import fractal_roughness_pallas

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fractal_roughness_pallas(dem, window_size=13))
    assert_plane_close(window.fractal_roughness(torch.from_numpy(dem), 13), want, "fractal_roughness")


def test_nan_poisons_whole_window():
    """A single NaN poisons every window that contains it, for every reducer."""
    dem = np.random.default_rng(1).random((15, 15)).astype(np.float32) * 10
    dem[7, 7] = np.nan
    out = to_np(window.windowed_indexes(torch.from_numpy(dem), 1.0, W4[:3], 5))
    for plane in out:
        assert np.isnan(plane[5:10, 5:10]).all() and np.isfinite(plane[2:4, 2:4]).all()
    frac = to_np(window.fractal_roughness(torch.from_numpy(dem), 5))
    # A w=5 fractal window reads rows and columns (pixel - 2) .. (pixel + 1) only.
    assert np.isnan(frac[6:10, 6:10]).all()
    assert np.isfinite(frac[5, 5]) and np.isfinite(frac[10, 10])


def test_fractal_box_geometry_skips_last_row_and_column():
    """Boxes start at (j*q, k*q) from the window's top-left corner, so a NaN in the window's
    last row or column leaves the result finite (xdem_tpu's geometry, not a centred one)."""
    dem = np.random.default_rng(0).random((21, 21)).astype(np.float32) * 10
    dem[12, :] = np.nan  # last window row of pixel row 10 for w=5 (rows 8..12)
    frac = to_np(window.fractal_roughness(torch.from_numpy(dem), 5))
    want = np.asarray(jwin.fractal_roughness(dem, window_size=5, engine="xla"))
    assert_same_nan(frac, want)
    assert np.isfinite(frac[10, 10])


def test_rugosity_needs_3x3_and_small_windows_are_nan():
    with pytest.raises(ValueError, match="3x3"):
        window.windowed_indexes(torch.zeros((9, 9)), 1.0, ("rugosity",), 5)
    assert torch.isnan(window.fractal_roughness(torch.rand(9, 9), 3)).all()
    with pytest.raises(ValueError, match=">= 3"):
        window.fractal_roughness(torch.rand(9, 9), 2)


@pytest.mark.parametrize("engine,want", [(None, None), ("xla", "xla"), ("pallas", "pallas"),
                                         ("scipy", "xla"), ("numba", "xla")])
def test_normalize_engine(engine, want):
    assert window.normalize_engine(engine) == want == jwin.normalize_engine(engine)


def test_normalize_engine_refuses_typos():
    with pytest.raises(ValueError, match="Unknown engine"):
        window.normalize_engine("cuda")
