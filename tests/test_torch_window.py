"""Plain PyTorch K2 and K3 (xdem_tpu_torch.terrain.window) against xdem_tpu's windowed
indexes and fractal roughness.

Tolerance: identical NaN masks; max deviation <= 1e-4 of each plane's mean magnitude
(measured <= 3e-5: TPI differs from XLA in the last bit of the window mean).
"""

import math
import re

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, assert_same_nan, example_dem, to_np

from xdem_tpu.terrain import window as jwin
from xdem_tpu_torch import _build
from xdem_tpu_torch.terrain import cuda_kernels, window

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


# ---------------------------------------------------------------------- what K2 is built from
# The generated header names each of the 16 half-lengths of the Jenness geometry as an entry of
# one of four planes over the raster: HH joins a pixel to its right neighbour, HV to the lower
# one, D1 to the lower right one, and D2 joins the right neighbour to the lower one.

_PLANE_ENDS = {"HH": ((0, 0), (0, 1)), "HV": ((0, 0), (1, 0)), "D1": ((0, 0), (1, 1)), "D2": ((0, 1), (1, 0))}


def _header_segments(text: str) -> list[tuple[str, int, int]]:
    """(plane, du, dv) of each half-length, in the header's order."""
    line = re.search(r"#define XDT_RUG_SEGMENTS\(S\) (.*)", text).group(1)
    segs = re.findall(r"S\((\d+), (HH|HV|D1|D2), (\d+), (\d+)\)", line)
    assert " ".join(f"S({i}, {p}, {u}, {v})" for i, p, u, v in segs) == line.strip()  # nothing else on the line
    assert [int(i) for i, *_ in segs] == list(range(len(segs)))
    return [(p, int(u), int(v)) for _, p, u, v in segs]


def _header_triangles(text: str) -> tuple[tuple[int, int, int], ...]:
    line = re.search(r"#define XDT_RUG_TRIANGLES\(T\) (.*)", text).group(1)
    return tuple(tuple(int(x) for x in t) for t in re.findall(r"T\((\d+), (\d+), (\d+)\)", line))


def _header_diag_factor(text: str) -> float:
    return float(re.search(r"#define XDT_RUG_DIAG_FACTOR ([\d.]+)f\n", text).group(1))


@pytest.mark.parametrize("i", range(16))
def test_generated_header_holds_the_rugosity_segments(i):
    """Segment i of the header, read back as the two window pixels it joins and its length
    factor, is segment i of window.RUGOSITY_CENTER_SEGS + RUGOSITY_EDGE_SEGS."""
    text = _build.windowed_header()
    plane, du, dv = _header_segments(text)[i]
    joins = {(du + r, dv + c) for r, c in _PLANE_ENDS[plane]}
    factor = _header_diag_factor(text) if plane.startswith("D") else 1.0
    if i < 8:
        pos, want = window.RUGOSITY_CENTER_SEGS[i]
        assert joins == {(1, 1), pos}
        assert factor == float(np.float32(want))
    else:
        assert joins == set(window.RUGOSITY_EDGE_SEGS[i - 8]) and factor == 1.0


def test_generated_header_triangles_and_codes():
    text = _build.windowed_header()
    assert _header_triangles(text) == window.RUGOSITY_TRIS
    assert "#define XDT_RUG_N_SEGMENTS 16\n" in text and len(_header_segments(text)) == 16
    for code, a in enumerate(window.WINDOWED_ATTRS):
        assert f"#define XDT_WIN_{a.upper()} {code}\n" in text
    assert f"#define XDT_WIN_N_ATTRS {len(window.WINDOWED_ATTRS)}\n" in text
    assert _header_diag_factor(text) == float(np.float32(math.sqrt(2.0)))
    # The source includes the header and types no table of its own; no table arrives at launch.
    source = (_build.CSRC_DIR / "windowed.cu").read_text()
    assert f'#include "{_build.WINDOWED_HEADER}"' in source
    assert "XDT_RUG_SEGMENTS(" in source and "XDT_RUG_TRIANGLES(" in source
    assert not re.search(r"seg_c|seg_e|seg_f|tri\[", source)
    assert set(_build.generated_headers()) == {_build.TABLES_HEADER, _build.WINDOWED_HEADER}


@pytest.mark.parametrize("name,value", [
    ("RUGOSITY_TRIS", ((3, 0, 12),) * 8),
    ("RUGOSITY_EDGE_SEGS", (((0, 1), (0, 0)),) * 8),
    ("WINDOWED_ATTRS", window.WINDOWED_ATTRS[::-1]),
])
def test_build_key_follows_the_windowed_tables(monkeypatch, name, value):
    path = _build.library_path()
    monkeypatch.setattr(window, name, value)
    assert _build.library_path() != path


@pytest.mark.parametrize("name,value,match", [
    ("RUGOSITY_EDGE_SEGS", (((0, 0), (0, 2)),) * 8, "neighbouring"),
    ("RUGOSITY_EDGE_SEGS", (((0, 0), (0, 3)),) * 8, "neighbouring"),
    ("RUGOSITY_CENTER_SEGS", (((0, 1), 2.0),) * 8, "factor"),
    ("RUGOSITY_CENTER_SEGS", (((0, 0), 1.0), ((2, 2), 2.0)) * 4, "one length factor"),
    ("RUGOSITY_TRIS", ((3, 0, 16),) * 8, "triangle"),
])
def test_generated_header_refuses_another_geometry(monkeypatch, name, value, match):
    """The kernel's four planes hold the Jenness geometry only: segments between neighbouring
    pixels, factor 1 along the grid and one factor on the diagonals."""
    monkeypatch.setattr(window, name, value)
    with pytest.raises(ValueError, match=match):
        _build.windowed_header()


def _holed_dem(shape=(301, 317), seed=5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).cumsum(0).cumsum(1)
    z = (z - z.min()) / (z.max() - z.min()) * 1000.0
    for _ in range(6):
        r, c = int(rng.integers(0, shape[0] - 20)), int(rng.integers(0, shape[1] - 20))
        z[r:r + int(rng.integers(1, 20)), c:c + int(rng.integers(1, 20))] = np.nan
    z[:, -3:] = np.nan
    z[100, 100], z[200, 50] = np.inf, -np.inf
    z[250:260, 200:230] = 512.0
    return torch.from_numpy(z.astype(np.float32))


@pytest.mark.parametrize("resolution", [20.0, 1.0, 0.3])
def test_rugosity_from_four_half_length_planes_is_bit_equal(resolution):
    """What K2's 3 x 3 instance rests on: the 16 half-lengths of a pixel are entries of four
    planes over the raster (a half-length squares its height difference, so either end may be
    the centre, and a centre segment of factor 1 equals the edge segment there). Assembled
    from the planes by the generated header's offsets, rugosity equals window._rugosity to
    the bit, NaN masks included, on a DEM with NaN holes, a NaN strip, an inf and a -inf."""
    text = _build.windowed_header()
    dem = _holed_dem()
    h, w = dem.shape
    t = window._nan_pad(dem, 1)
    L = torch.tensor(resolution, dtype=torch.float32)
    lf = _header_diag_factor(text) * L

    def half(dz, len2):
        return torch.sqrt(dz * dz + len2) / 2

    planes = {"HH": half(t[:, :-1] - t[:, 1:], L * L), "HV": half(t[:-1] - t[1:], L * L),
              "D1": half(t[:-1, :-1] - t[1:, 1:], lf * lf), "D2": half(t[:-1, 1:] - t[1:, :-1], lf * lf)}
    hsl = [planes[p][du:du + h, dv:dv + w] for p, du, dv in _header_segments(text)]
    area = torch.zeros_like(dem)
    for ia, ib, ic in _header_triangles(text):
        a, b, c = hsl[ia], hsl[ib], hsl[ic]
        s = (a + b + c) / 2
        area = area + torch.sqrt(torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0))
    got = area / (L * L)
    want = window._rugosity(t, h, w, resolution)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    num = ~torch.isnan(want)
    assert int(torch.isfinite(want).sum()) > 80000
    assert torch.equal(got[num], want[num])


def test_windowed_plan_of_an_out_of_order_request():
    attrs = ("rugosity", "roughness", "topographic_position_index", "roughness")
    mask, plane_of = cuda_kernels.windowed_plan(attrs)
    assert mask == 0b1101 and plane_of.dtype == np.int32
    assert list(plane_of) == [2, -1, 1, 0]  # the first mention of each; TRI is not requested
    with pytest.raises(ValueError, match="Unknown attribute"):
        cuda_kernels.windowed_plan(("roughness", "slope"))
