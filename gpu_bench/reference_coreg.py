"""Plain reference of Nuth & Kääb (2011) coregistration and of a translation's apply.

It imports nothing of the program and computes in the dtype it is given (float64 for the
check, a lower precision for the control). Nuth & Kääb: slope and aspect of the reference DEM
by central differences; a seeded subsample of the pixels where both DEMs and the slope are
valid; then, until the pixel step falls below the tolerance (after at least three steps) or
for at most ten: dh = ref - tba shifted by the current offset (bilinear, NaN outside or next
to NaN), its median removed, dh / tan(slope) binned by aspect into 72 bins, the bins' medians
fitted by a cos(aspect) + b sin(aspect) + c, and the offset moved by (b, a) pixels east and
north. The fit's translation is minus the offset, its vertical shift the last median.
"""

from __future__ import annotations

import math

import torch


def bilinear(grid: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """grid at fractional (row, col), NaN outside the grid or where a neighbour is NaN."""
    h, w = grid.shape
    r0, c0 = torch.floor(rows), torch.floor(cols)
    fr, fc = rows - r0, cols - c0
    r0, c0 = r0.long(), c0.long()

    def at(r, c):
        return grid[torch.clamp(r, 0, h - 1), torch.clamp(c, 0, w - 1)]

    val = (at(r0, c0) * (1 - fc) + at(r0, c0 + 1) * fc) * (1 - fr) + (at(r0 + 1, c0) * (1 - fc) + at(r0 + 1, c0 + 1) * fc) * fr
    inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    return torch.where(inside, val, torch.nan)


def _median(x: torch.Tensor) -> torch.Tensor:
    x = x[torch.isfinite(x)]
    return torch.quantile(x.double(), 0.5).to(x.dtype) if x.numel() else x.new_tensor(float("nan"))


def nuth_kaab(ref: torch.Tensor, tba: torch.Tensor, res: float, count: int, seed: int, dtype=torch.float64,
              n_bins: int = 72, tolerance: float = 0.001, max_iterations: int = 10) -> tuple[float, float, float]:
    """(shift_x, shift_y, shift_z) in metres that align `tba` onto `ref` (square pixels of `res`)."""
    z, t = ref.to(dtype), tba.to(dtype)
    h, w = z.shape
    gy, gx = torch.gradient(z)
    slope = torch.hypot(gx, gy)
    aspect = torch.atan2(-gx, gy) + math.pi
    valid = torch.isfinite(z) & torch.isfinite(t) & torch.isfinite(slope) & (slope > 0)
    g = torch.Generator(device=z.device).manual_seed(int(seed))
    scores = torch.where(valid.reshape(-1), torch.rand(h * w, generator=g, device=z.device), -1.0)
    idx = torch.topk(scores, min(count, int(valid.sum())), sorted=False).indices
    rows, cols = (idx // w).to(dtype), (idx % w).to(dtype)
    pz, st, asp = z.reshape(-1)[idx], slope.reshape(-1)[idx], aspect.reshape(-1)[idx]
    width = 2 * math.pi / n_bins
    bins = torch.clamp(torch.floor(asp.double() / width).long(), 0, n_bins - 1)
    centers = (torch.arange(n_bins, dtype=torch.float64, device=z.device) + 0.5) * width
    order = torch.argsort(bins)
    counts = torch.bincount(bins, minlength=n_bins).tolist()
    sx = sy = 0.0
    vshift = z.new_tensor(0.0)
    for it in range(max_iterations):
        dh = pz - bilinear(t, rows - sy, cols + sx)
        vshift = _median(dh)
        y = ((dh - vshift) / st)[order]
        meds = torch.stack([_median(part) for part in torch.split(y, counts)]).double()
        ok = torch.isfinite(meds)
        design = torch.stack([torch.cos(centers), torch.sin(centers), torch.ones_like(centers)], 1)[ok]
        a, b, _ = torch.linalg.lstsq(design, meds[ok][:, None]).solution[:, 0].tolist()
        sx, sy = sx + b, sy + a
        if it >= 2 and math.hypot(a, b) < tolerance:
            break
    return -sx * res, -sy * res, float(vshift)


def apply_translation(tba: torch.Tensor, res: float, shift: tuple[float, float, float], dtype=torch.float64,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
    """`tba` moved by (shift_x east, shift_y north, shift_z up) metres and resampled bilinearly
    onto its own grid (rows r0:r1 of it, default all): out(r, c) = tba(r + shift_y / res,
    c - shift_x / res) + shift_z."""
    h, w = tba.shape
    r0, r1 = rows or (0, h)
    sx, sy, sz = shift
    rr = torch.arange(r0, r1, dtype=dtype, device=tba.device)[:, None] + sy / res
    cc = torch.arange(w, dtype=dtype, device=tba.device)[None, :] - sx / res
    return bilinear(tba.to(dtype), rr.expand(r1 - r0, w), cc.expand(r1 - r0, w)) + sz
