"""Gather-based grid interpolation on tensors.

Semantics of xdem_tpu/ops/interp.py:
  * NaN is nodata: 'linear' and 'cubic' return NaN when any participating neighbour is NaN.
  * Coordinates outside the interpolation domain return NaN.
  * Row/col coordinates use the centre-of-pixel convention (0.0 is the centre of pixel 0).
"""

from __future__ import annotations

from typing import Literal

import torch

Method = Literal["nearest", "linear", "cubic"]


def grid_coords(shape: tuple[int, int], transform, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """World (x, y) coordinates of every pixel centre of an (H, W) grid."""
    h, w = shape
    rows = torch.arange(h, dtype=dtype, device=device)
    cols = torch.arange(w, dtype=dtype, device=device)
    rgrid, cgrid = torch.meshgrid(rows, cols, indexing="ij")
    a, b, c, d, e, f = tuple(transform)
    x = a * (cgrid + 0.5) + b * (rgrid + 0.5) + c
    y = d * (cgrid + 0.5) + e * (rgrid + 0.5) + f
    return x, y


def _gather(data: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """data[r, c] with clipped indices (validity is the caller's job)."""
    h, w = data.shape
    return data[torch.clamp(r, 0, h - 1), torch.clamp(c, 0, w - 1)]


def _keys(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5."""
    at = torch.abs(t)
    a = -0.5
    w1 = (a + 2) * at**3 - (a + 3) * at**2 + 1
    w2 = a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a
    return torch.where(at <= 1, w1, torch.where(at < 2, w2, 0.0))


def interp_rowcol(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  method: Method = "linear") -> torch.Tensor:
    """Interpolate `data` (H, W) at fractional (row, col) positions of any shape.

    `method` is 'nearest', 'linear' (bilinear) or 'cubic' (Keys bicubic convolution).
    """
    h, w = data.shape
    if method == "nearest":
        r = torch.round(rows).long()
        c = torch.round(cols).long()
        inside = (rows >= -0.5) & (rows <= h - 0.5) & (cols >= -0.5) & (cols <= w - 0.5)
        return torch.where(inside, _gather(data, r, c), torch.nan)

    r0 = torch.floor(rows).long()
    c0 = torch.floor(cols).long()
    fr = rows - r0
    fc = cols - c0
    if method == "linear":
        top = _gather(data, r0, c0) * (1 - fc) + _gather(data, r0, c0 + 1) * fc
        bot = _gather(data, r0 + 1, c0) * (1 - fc) + _gather(data, r0 + 1, c0 + 1) * fc
        vals = top * (1 - fr) + bot * fr
        inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
        return torch.where(inside, vals, torch.nan)

    if method == "cubic":
        vals = torch.zeros_like(rows, dtype=data.dtype)
        for dr in range(-1, 3):
            row_acc = torch.zeros_like(rows, dtype=data.dtype)
            for dc in range(-1, 3):
                row_acc = row_acc + _keys(fc - dc) * _gather(data, r0 + dr, c0 + dc)
            vals = vals + _keys(fr - dr) * row_acc
        inside = (rows >= 1) & (rows <= h - 2) & (cols >= 1) & (cols <= w - 2)
        return torch.where(inside, vals, torch.nan)

    raise ValueError(f"Unknown interpolation method: {method}")


def interp_points(data: torch.Tensor, transform, x: torch.Tensor, y: torch.Tensor,
                  method: Method = "linear") -> torch.Tensor:
    """Interpolate a georeferenced grid at world coordinates (x, y)."""
    a, b, c, d, e, f = (float(v) for v in tuple(transform))
    det = a * e - b * d
    ia, ib, ic = e / det, -b / det, -(e * c - b * f) / det
    id_, ie, if_ = -d / det, a / det, -(-d * c + a * f) / det
    cols = ia * x + ib * y + ic - 0.5
    rows = id_ * x + ie * y + if_ - 0.5
    return interp_rowcol(data, rows, cols, method=method)
