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


def _fractal_from_definition(dem: np.ndarray, w: int) -> np.ndarray:
    """Taud & Parrot (2005) box counting written from its definition, in numpy float32: for
    each divisor q of w // 2, Ns(q) = sum over the ((w-1)//q)^2 boxes starting at (j*q, k*q)
    from the window's top-left corner (j outer, k inner) of clip(max(box) - centre, 0, w),
    each box maximum taken over its own q x q values, NaN beyond the edges; the result is
    minus the least-squares slope of log(Ns / q) against log q, in float64."""
    h, wd = dem.shape
    hw = w // 2
    pad = np.pad(dem, hw, constant_values=np.nan)
    qs = [q for q in range(1, hw + 1) if hw % q == 0]
    x = np.log(np.array(qs, np.float64))
    ys = []
    with np.errstate(invalid="ignore", divide="ignore"):
        for q in qs:
            boxes = np.lib.stride_tricks.sliding_window_view(pad, (q, q)).max(axis=(2, 3))
            ns = np.zeros_like(dem)
            for j in range((w - 1) // q):
                for k in range((w - 1) // q):
                    ns = ns + np.clip(boxes[j * q: j * q + h, k * q: k * q + wd] - dem, np.float32(0), np.float32(w))
            ys.append(np.log(ns.astype(np.float64) / q))
        y = np.stack(ys)
        dx = (x - x.mean())[:, None, None]
        return -((dx * (y - y.mean(axis=0))).sum(axis=0) / (dx * dx).sum(axis=0))


@pytest.mark.parametrize("w", [5, 8, 13, 21])
def test_fractal_roughness_matches_its_definition(w):
    """The plain version (the CUDA kernel's reference) against a brute-force box count, on a
    DEM with NaN holes, a NaN border strip, +inf and -inf pixels and an infinite centre:
    identical NaN masks (a NaN in a box, or inf - inf at an infinite centre, poisons the
    pixel) and max deviation <= 1e-5 of the mean magnitude (float32 rounding of the slope;
    measured <= 8e-7)."""
    rng = np.random.default_rng(5)
    dem = rng.normal(size=(64, 75)).cumsum(0).cumsum(1)
    dem = ((dem - dem.min()) / (dem.max() - dem.min()) * 1000.0).astype(np.float32)
    dem[5:9, 50:56] = np.nan
    dem[:, -1] = np.nan
    dem[40, 30] = np.inf
    dem[22, 20] = -np.inf
    want = _fractal_from_definition(dem, w)
    got = to_np(window.fractal_roughness(torch.from_numpy(dem), w))
    assert_same_nan(got, want, f"w={w}")
    assert np.isnan(got[40, 30]) and np.isnan(got[22, 20])  # inf - inf at the infinite centres
    assert np.isfinite(want).sum() > 300
    assert_plane_close(got, want.astype(np.float32), "fractal_roughness", tol=1e-5)


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
