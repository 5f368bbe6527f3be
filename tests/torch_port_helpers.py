"""Shared setup of the xdem_tpu_torch tests: a torch thread cap, seeded inputs and the
scaled-deviation measure the parity tests hold the port to.

Every test_torch_*.py imports this module first. Tier-1 runs six pytest-xdist workers on
one machine, so each worker keeps torch to one intra-op thread. Without a card the port's
entry points refuse numpy inputs unless the CPU is asked for, so here the tests ask for it
(``XDEM_TPU_PLATFORM=cpu``, inherited by the processes they start); on a machine with a card
the card tests run on the card.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
if not torch.cuda.is_available():
    os.environ.setdefault("XDEM_TPU_PLATFORM", "cpu")

# Planes whose formulas divide by powers of |grad z|: at near-flat pixels they magnify
# last-bit differences between XLA's and PyTorch's float32 arithmetic (the mean-centring
# reduction order, fused versus unfused multiply-adds), so they are held at a percentile.
GRADIENT_DENOMINATOR = ("profile_curvature", "tangential_curvature", "planform_curvature",
                        "flowline_curvature")


def example_dem(shape=(80, 100), seed=3) -> np.ndarray:
    """The repository's smooth spectral DEM (~1000 m relief, read at 20 m pixels) with a
    NaN hole and one +inf pixel, as float32."""
    from xdem_tpu import examples

    dem = examples.synthetic_dem_array(shape=shape, resolution=20.0, seed=seed)
    dem[13:16, 17:21] = np.nan
    dem[shape[0] // 2, shape[1] // 3] = np.inf
    return dem


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scaled_dev(got, want, circular: float | None = None, pct: float = 100.0) -> float:
    """max (or the `pct` percentile) of |got - want| over the jointly finite pixels, divided
    by the mean |want| there. `circular` is the period of an angle (2*pi or 360)."""
    g = to_np(got).astype(np.float64)
    w = to_np(want).astype(np.float64)
    both = np.isfinite(g) & np.isfinite(w)
    assert both.any(), "no jointly finite pixels"
    d = np.abs(g[both] - w[both])
    if circular is not None:
        d = np.minimum(d, circular - d)
    stat = d.max() if pct >= 100.0 else np.percentile(d, pct)
    return float(stat / max(np.abs(w[both]).mean(), 1e-12))


def assert_same_nan(got, want, name: str = "") -> None:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    assert np.array_equal(np.isnan(g), np.isnan(w)), f"{name}: NaN masks differ"


def assert_plane_close(got, want, name: str, tol: float = 1e-4, circular: float | None = None) -> None:
    """Identical NaN masks, and max deviation <= tol of the mean magnitude; for the
    GRADIENT_DENOMINATOR planes, 99th percentile <= tol and max <= 200 * tol."""
    assert_same_nan(got, want, name)
    if name in GRADIENT_DENOMINATOR:
        assert scaled_dev(got, want, pct=99.0) <= tol, f"{name}: p99 {scaled_dev(got, want, pct=99.0):.3e}"
        assert scaled_dev(got, want) <= 200 * tol, f"{name}: max {scaled_dev(got, want):.3e}"
    else:
        dev = scaled_dev(got, want, circular=circular)
        assert dev <= tol, f"{name}: scaled max deviation {dev:.3e} > {tol:.1e}"


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (decided at run time, so
    every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)
