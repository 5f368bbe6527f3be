"""Plain reference of xdem's bias corrections of a DEM pair: Deramp, DirectionalBias and
TerrainBias, each fitted on the pair as the steps before it left it, then applied in turn.

It imports nothing of the program and computes in the dtype it is given (float64 for the
check, a lower precision for the control): the differences, the variables and the applied
corrections in that dtype; least squares, binning and fits in float64 on the host, on values
computed in the dtype. A georeferencing is the six numbers (a, b, c, d, e, f) of
x = a (col + 0.5) + b (row + 0.5) + c, y = d (col + 0.5) + e (row + 0.5) + f.

Each step fits dh = reference - to-be-corrected at a subsample of the pixels where its inputs
are all finite, xdem's draw: numpy's ``default_rng(random_state).choice`` over the flat indices
of those pixels, without replacement (all of them where there are no more). Its correction is
then added to the to-be-corrected DEM.

* Deramp (order 2): dh ~ sum c[i, j] col^i row^j over 0 <= i, j <= 2 (polyval2d's nine
  terms), by linear least squares.
* DirectionalBias (angle theta): the along-track coordinate of each pixel, s = (x - x0) cos
  theta + (y - y0) sin theta, with (x0, y0) the least x and y of the grid's corner pixels;
  100 equal bins of s between its least and largest drawn value (each closed on the left, the
  last on both sides) and the median of dh in each; then a sum of up to three sines
  a sin(2 pi s / L + phi) fitted to the medians at the bin mids as xdem_tpu documents it: a
  greedy periodogram over 256 geometric wavelengths from 3 resolutions (the larger of the
  pixel size and the bins' spacing) to the bins' span, each pass fitting A sin + B cos + C to
  what the passes before left; after each pass a joint polish of the sines found so far;
  the order kept is the lowest whose soft-L1 cost (scale 0.5) is within 20 % of the least;
  sines of amplitude at most 1 % of the medians' half range are cut.
* TerrainBias (maximum curvature): the plain maximum curvature of the reference
  (``gpu_bench/reference.py``) for the fit and of the DEM being corrected for the apply; 100
  equal bins of the drawn curvatures as above and the median of dh in each; applied by
  linear interpolation between the bin mids of the bins that hold values, flat beyond the
  outer ones.

Departures from xdem's text, none of which changes what is computed:
  * the bins are closed on the left between the least and largest value (pandas' ``cut``,
    which xdem calls, closes them on the right and moves the first edge down by 0.1 % of the
    range, which moves the first bin's mid and no value);
  * the sum of sines is xdem_tpu's fit (a periodogram, then polishes), not xdem's basin
    hopping, which draws its starts at random; the polish is scipy's ``least_squares``
    (MINPACK's Levenberg-Marquardt) with the analytic Jacobian; the parameters are not
    rounded to five decimals;
  * the Deramp least squares is solved with each column of its design scaled to at most 1;
  * the draw is given as explicit (rows, cols) where a test hands over another one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_bench import reference
from gpu_bench.reference_rigid import numpy_draw

BINS = 100
WAVELENGTHS = 256
MAX_SINES = 3
ORDER_MARGIN = 0.20  # an order is kept when its cost is within this share of the least cost
AMPLITUDE_CUT = 0.01  # of the medians' half range
SOFT_SCALE = 0.5


# ------------------------------------------------------------------ the variables


def along_track(rows, cols, shape, transform, angle_deg: float):
    """The along-track coordinate (m, float64) of pixels (rows, cols) of a grid of `shape`:
    along `angle_deg` counter-clockwise from the X axis, from the grid's least corner x and y.
    Tensors give a tensor on their device, arrays an array."""
    a, b, c, d, e, f = (float(v) for v in transform)
    h, w = shape
    corners = [(r + 0.5, q + 0.5) for r in (0, h - 1) for q in (0, w - 1)]
    x0 = min(a * q + b * r + c for r, q in corners)
    y0 = min(d * q + e * r + f for r, q in corners)
    t = math.radians(angle_deg)
    if isinstance(rows, torch.Tensor):
        rows, cols = rows.double(), cols.double()
    else:
        rows, cols = np.asarray(rows, np.float64), np.asarray(cols, np.float64)
    x, y = a * (cols + 0.5) + b * (rows + 0.5) + c, d * (cols + 0.5) + e * (rows + 0.5) + f
    return (x - x0) * math.cos(t) + (y - y0) * math.sin(t)


def along_track_range(shape, transform, angle_deg: float) -> tuple[float, float]:
    """The least and largest along-track coordinate over a grid (at its corners)."""
    h, w = shape
    s = along_track(np.array([0, 0, h - 1, h - 1]), np.array([0, w - 1, 0, w - 1]), shape, transform, angle_deg)
    return float(s.min()), float(s.max())


def max_curvature(dem: torch.Tensor, res: float, dtype=torch.float64, band_rows: int = 1024) -> torch.Tensor:
    """The plain maximum curvature of a DEM (xdem's, x100) in `dtype`, in row bands."""
    h, w = dem.shape
    out = torch.empty((h, w), dtype=dtype, device=dem.device)
    for r0 in range(0, h, band_rows):
        r1 = min(r0 + band_rows, h)
        out[r0:r1] = reference.terrain_block(dem, (r0, r1), (0, w), res, ["max_curvature"], dtype)["max_curvature"]
    return out


# ------------------------------------------------------------------ the biases of the deployment


def ramp(rows: torch.Tensor, cols: torch.Tensor, shape, coefficients: dict) -> torch.Tensor:
    """An order-2 ramp in u, v (column and row scaled to [-1, 1]): coefficients "uu", "vv", "uv"."""
    h, w = shape
    u, v = 2 * cols.double() / (w - 1) - 1, 2 * rows.double() / (h - 1) - 1
    return coefficients["uu"] * u * u + coefficients["vv"] * v * v + coefficients["uv"] * u * v


def sum_of_sines(s, sines) -> torch.Tensor | np.ndarray:
    """sum a sin(2 pi s / L + phi) over `sines`, (a, L, phi) triples (or a flat sequence)."""
    p = np.asarray(sines, np.float64).reshape(-1, 3)
    sin = torch.sin if isinstance(s, torch.Tensor) else np.sin
    out = s * 0.0
    for a, lam, phi in p:
        out = out + a * sin(2 * math.pi * s / lam + phi)
    return out


def curvature_bias(curvature: torch.Tensor, amplitude: float, q99: float) -> torch.Tensor:
    """amplitude * clamp(curvature / q99, -1, 1), 0 where the curvature is not finite."""
    return torch.nan_to_num(torch.clamp(curvature / q99, -1.0, 1.0) * amplitude, nan=0.0)


def q99(curvature: torch.Tensor) -> float:
    """The 99th percentile of |curvature| over every 16th pixel (every 4th row and column),
    the int(0.99 n)-th smallest of the n finite ones."""
    a = curvature[::4, ::4].abs()
    a = a[torch.isfinite(a)]
    return float(torch.kthvalue(a.double().cpu(), max(int(0.99 * a.numel()), 1)).values)


# ------------------------------------------------------------------ draws and bins


def draw(valid: torch.Tensor, count: int, random_state, rows=None, cols=None):
    """(rows, cols) long tensors on `valid`'s device: the explicit ones, or xdem's draw."""
    if rows is None:
        rows, cols = numpy_draw(valid, count, random_state)
    return torch.as_tensor(rows, device=valid.device).long(), torch.as_tensor(cols, device=valid.device).long()


def equal_bins(var: np.ndarray, values: np.ndarray, bins: int = BINS):
    """(edges, counts, medians) of `values` in `bins` equal bins of `var` between its least and
    largest value, each closed on the left and the last on both sides; NaN where a bin is empty."""
    var, values = np.asarray(var, np.float64), np.asarray(values, np.float64)
    edges = np.linspace(var.min(), var.max(), bins + 1)
    idx = np.clip(np.searchsorted(edges, var, side="right") - 1, 0, bins - 1)
    counts = np.bincount(idx, minlength=bins)
    order = np.argsort(idx, kind="stable")
    groups = np.split(values[order], np.cumsum(counts)[:-1])
    medians = np.array([np.median(g) if g.size else np.nan for g in groups])
    return edges, counts, medians


# ------------------------------------------------------------------ Deramp


def deramp(ref: torch.Tensor, tba: torch.Tensor, count: int, random_state=None, dtype=torch.float64,
           rows=None, cols=None, order: int = 2) -> np.ndarray:
    """The (order + 1)^2 coefficients c[i, j] of col^i row^j (flat, i major) of dh = ref - tba."""
    r, c = draw(torch.isfinite(ref) & torch.isfinite(tba), count, random_state, rows, cols)
    dh = (ref[r, c].to(dtype) - tba[r, c].to(dtype)).double().cpu().numpy()
    x, y = c.double().cpu().numpy(), r.double().cpu().numpy()
    a = np.stack([x**i * y**j for i in range(order + 1) for j in range(order + 1)], axis=1)
    scale = np.abs(a).max(axis=0)  # each column to at most 1 in magnitude
    return np.linalg.lstsq(a / scale, dh, rcond=None)[0] / scale


def polynomial(coefficients, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """sum c[i, j] col^i row^j in float64."""
    c = np.asarray(coefficients, np.float64)
    p = int(round(math.sqrt(c.size)))
    x, y = cols.double(), rows.double()
    out = torch.zeros(torch.broadcast_shapes(x.shape, y.shape), dtype=torch.float64, device=x.device)
    for i in range(p):
        for j in range(p):
            out = out + float(c[i * p + j]) * x**i * y**j
    return out


# ------------------------------------------------------------------ DirectionalBias


def _soft_l1(z: np.ndarray) -> float:
    return float(np.sum(SOFT_SCALE**2 * 2 * (np.sqrt(1 + (z / SOFT_SCALE) ** 2) - 1)))


def _polish(x: np.ndarray, y: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """The sines of p0 refined jointly by least squares on y."""
    from scipy.optimize import least_squares

    def residual(p):
        return sum_of_sines(x, p) - y

    def jacobian(p):
        cols = []
        for a, lam, phi in p.reshape(-1, 3):
            arg = 2 * math.pi * x / lam + phi
            cols += [np.sin(arg), a * np.cos(arg) * (-2 * math.pi * x / lam**2), a * np.cos(arg)]
        return np.stack(cols, axis=1)

    return least_squares(residual, p0, jac=jacobian, method="lm").x


def fit_sines(x: np.ndarray, y: np.ndarray, hop: float) -> np.ndarray:
    """A sum of up to MAX_SINES sines fitted to (x, y): (a, L, phi) rows, a > 0, L > 0, by
    decreasing amplitude."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    ok = np.isfinite(x) & np.isfinite(y)
    x, y = x[ok], y[ok]
    span = x.max() - x.min()
    res = max(hop, span / max(x.size - 1, 1))
    waves = np.geomspace(3 * res, max(span, 3 * res * 1.01), WAVELENGTHS)
    half_range = (y.max() - y.min()) / 2
    offset = float(np.median(y))
    left = y - offset
    found, fits, costs = [], [], []
    for _ in range(MAX_SINES):
        best = None
        for lam in waves:
            g = np.stack([np.sin(2 * math.pi * x / lam), np.cos(2 * math.pi * x / lam), np.ones_like(x)], axis=1)
            sol = np.linalg.lstsq(g, left, rcond=None)[0]
            rss = float(np.sum((g @ sol - left) ** 2))
            if best is None or rss < best[0]:
                best = (rss, lam, sol)
        _, lam, (sa, ca, c0) = best
        found.append((math.hypot(sa, ca), lam, math.atan2(ca, sa) % (2 * math.pi)))
        left = left - (sa * np.sin(2 * math.pi * x / lam) + ca * np.cos(2 * math.pi * x / lam) + c0)
        offset += c0
        p = _polish(x, y - offset, np.asarray(found, np.float64).ravel())
        fits.append(p)
        costs.append(_soft_l1(sum_of_sines(x, p) + offset - y))
    least = min(costs)
    keep = fits[min(k for k, c in enumerate(costs) if c < least + ORDER_MARGIN * least)].reshape(-1, 3).copy()
    # a sin(t + phi) with L < 0 or a < 0 written with both positive (the same curve)
    neg = keep[:, 1] < 0
    keep[neg, 1], keep[neg, 0], keep[neg, 2] = -keep[neg, 1], -keep[neg, 0], -keep[neg, 2]
    neg = keep[:, 0] < 0
    keep[neg, 0], keep[neg, 2] = -keep[neg, 0], keep[neg, 2] + math.pi
    big = keep[:, 0] > AMPLITUDE_CUT * half_range
    if big.any():
        keep = keep[big]
    keep[:, 2] %= 2 * math.pi
    return keep[np.argsort(-keep[:, 0])]


def directional(ref: torch.Tensor, tba: torch.Tensor, transform, angle_deg: float, count: int, random_state=None,
                dtype=torch.float64, rows=None, cols=None, bins: int = BINS):
    """(sines, (edges, counts, medians)): DirectionalBias's fit of dh = ref - tba."""
    r, c = draw(torch.isfinite(ref) & torch.isfinite(tba), count, random_state, rows, cols)
    dh = (ref[r, c].to(dtype) - tba[r, c].to(dtype)).double().cpu().numpy()
    s = along_track(r, c, ref.shape, transform, angle_deg).cpu().numpy()
    table = equal_bins(s, dh, bins)
    edges, _, medians = table
    hop = (math.hypot(float(transform[0]), float(transform[3])) + math.hypot(float(transform[1]),
                                                                              float(transform[4]))) / 2
    return fit_sines((edges[:-1] + edges[1:]) / 2, medians, hop), table


# ------------------------------------------------------------------ TerrainBias


def terrain(ref: torch.Tensor, tba: torch.Tensor, curvature: torch.Tensor, count: int, random_state=None,
            dtype=torch.float64, rows=None, cols=None, bins: int = BINS):
    """(edges, counts, medians): TerrainBias's binning of dh = ref - tba against `curvature`
    (the reference's), at xdem's draw over the pixels where all three are finite."""
    valid = torch.isfinite(ref) & torch.isfinite(tba) & torch.isfinite(curvature)
    r, c = draw(valid, count, random_state, rows, cols)
    dh = (ref[r, c].to(dtype) - tba[r, c].to(dtype)).double().cpu().numpy()
    return equal_bins(curvature[r, c].double().cpu().numpy(), dh, bins)


def table_apply(curvature: torch.Tensor, edges, medians) -> torch.Tensor:
    """The binned correction at `curvature` (float64): linear between the mids of the bins with
    a median, flat beyond the outer ones; NaN where the curvature is not finite."""
    edges, medians = np.asarray(edges, np.float64), np.asarray(medians, np.float64)
    ok = np.isfinite(medians)
    mids = torch.as_tensor(((edges[:-1] + edges[1:]) / 2)[ok], device=curvature.device)
    vals = torch.as_tensor(medians[ok], device=curvature.device)
    x = curvature.double()
    if mids.numel() == 1:
        return torch.where(torch.isfinite(x), vals[0], torch.nan)
    xc = torch.clamp(torch.nan_to_num(x, nan=float(mids[0])), float(mids[0]), float(mids[-1]))
    k = torch.clamp(torch.searchsorted(mids, xc, right=True) - 1, 0, mids.numel() - 2)
    frac = (xc - mids[k]) / (mids[k + 1] - mids[k])
    return torch.where(torch.isfinite(x), vals[k] + frac * (vals[k + 1] - vals[k]), torch.nan)


# ------------------------------------------------------------------ gaps between two fits


def ramp_gap(got, want, shape, device, band_rows: int = 1024) -> float:
    """The largest |ramp(got) - ramp(want)| (m) over every pixel of a grid."""
    h, w = shape
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    if not np.isfinite(diff).all():
        return math.inf
    cols = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    out = 0.0
    for r0 in range(0, h, band_rows):
        rows = torch.arange(r0, min(r0 + band_rows, h), dtype=torch.float64, device=device)[:, None]
        out = max(out, float(polynomial(diff, rows, cols).abs().max()))
    return out


def curve_gap(got, want, s_range: tuple[float, float], step_m: float = 100.0) -> float:
    """The largest gap (m) between two sums of sines over an along-track range, on a lattice
    of at most `step_m`."""
    lo, hi = s_range
    s = np.linspace(lo, hi, int(math.ceil((hi - lo) / step_m)) + 1)
    gap = np.abs(sum_of_sines(s, got) - sum_of_sines(s, want))
    return float(gap.max()) if np.isfinite(gap).all() else math.inf


def table_gap(got_medians, want_counts, want_medians, min_count: int = 100) -> float:
    """The gap (m) between two median tables: the mean over the bins where the second holds at
    least `min_count` values of |got - want|, each bin weighted by its count there; inf where
    the first has no median there or the tables differ in size."""
    got, counts, want = (np.asarray(v, np.float64) for v in (got_medians, want_counts, want_medians))
    if got.shape != want.shape:
        return math.inf
    full = counts >= min_count
    if not full.any():
        return 0.0
    gap = np.abs(got[full] - want[full])
    return float(np.sum(gap * counts[full]) / np.sum(counts[full])) if np.isfinite(gap).all() else math.inf
