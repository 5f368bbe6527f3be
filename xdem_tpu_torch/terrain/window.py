"""Windowed terrain indexes: sliding-window reducers with NaN-poisoning semantics.

Plain PyTorch version of xdem_tpu/terrain/window.py and the reference the CUDA kernels K2
(``csrc/windowed.cu``) and K3 (``csrc/fractal.cu``) are held against. Edges are NaN-padded
and any NaN in a window poisons the output:
  * TRI (Riley 1999): sqrt(sum (z_i - z_c)^2); TRI (Wilson 2007): sum |z_i - z_c| / (w^2 - 1)
  * TPI (Weiss 2001): z_c - mean(neighbours)
  * Roughness (Dartnell 2000): max - min
  * Rugosity (Jenness 2004): 8-triangle Heron surface-area ratio, 3x3 only
  * Fractal roughness (Taud & Parrot 2005): voxel box-counting log-log slope
"""

from __future__ import annotations

import math
from typing import Literal

import torch

WINDOWED_ATTRS = ("topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity")
FRACTAL_ATTRS = ("fractal_roughness",)

# Jenness (2004) 3x3 rugosity geometry, copied from xdem_tpu/terrain/window.py (a CPU test
# holds them equal) and shared with the CUDA kernel.
# 8 centre-to-neighbour segments: (window position, planimetric length factor)
RUGOSITY_CENTER_SEGS = (
    ((0, 0), math.sqrt(2.0)), ((0, 1), 1.0), ((0, 2), math.sqrt(2.0)), ((1, 0), 1.0),
    ((1, 2), 1.0), ((2, 0), math.sqrt(2.0)), ((2, 1), 1.0), ((2, 2), math.sqrt(2.0)),
)
# 8 neighbour-to-neighbour segments (all planimetric length L)
RUGOSITY_EDGE_SEGS = (
    ((0, 0), (0, 1)), ((0, 1), (0, 2)), ((2, 0), (2, 1)), ((2, 1), (2, 2)),
    ((0, 0), (1, 0)), ((1, 0), (2, 0)), ((0, 2), (1, 2)), ((1, 2), (2, 2)),
)
# Triangles: (centre-seg, centre-seg, edge-seg) index triplets into the 16 half-lengths
RUGOSITY_TRIS = (
    (3, 0, 12), (0, 1, 8), (1, 2, 9), (2, 4, 14), (4, 7, 15), (7, 6, 11), (6, 5, 10), (5, 3, 13),
)

#: The reference's engine names select host libraries there; here they mean "plain".
_ENGINE_ALIASES = {"scipy": "xla", "numba": "xla"}


def normalize_engine(engine: str | None) -> str | None:
    """Validate an ``engine=`` value: None, "xla", "pallas", or the aliases "scipy"/"numba".

    In the port the device of the input, not this value, picks the CUDA kernel or its plain
    version; the check only keeps a typo from passing silently.
    """
    if engine is None:
        return None
    e = _ENGINE_ALIASES.get(engine, engine)
    if e not in ("xla", "pallas"):
        raise ValueError(
            f"Unknown engine {engine!r}: choose 'xla' or 'pallas' (the reference's "
            "'scipy'/'numba' are accepted as aliases of 'xla')."
        )
    return e


def _nan_pad(dem: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(dem, (pad, pad, pad, pad), value=float("nan"))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true division. PyTorch's CUDA kernels turn division by a Python number into
    multiplication by its reciprocal, one rounding more, which the cancellation in TPI
    amplifies; a tensor divisor keeps the division of the reference and of the kernels."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def windowed_indexes(
    dem: torch.Tensor,
    resolution: float,
    attrs: tuple[str, ...],
    window_size: int = 3,
    tri_method: Literal["Riley", "Wilson"] = "Riley",
) -> torch.Tensor:
    """Windowed indexes of an (H, W) f32 DEM as a (len(attrs), H, W) stack; NaN-pad edges."""
    h, width = dem.shape
    w = window_size
    pad = w // 2
    if "rugosity" in attrs and w != 3:
        raise ValueError("Rugosity is only defined on a 3x3 window.")
    demp = _nan_pad(dem, pad)
    center = demp[pad:pad + h, pad:pad + width]
    need_sum = "topographic_position_index" in attrs
    need_tri = "terrain_ruggedness_index" in attrs
    need_rough = "roughness" in attrs
    riley = tri_method.lower() == "riley"

    acc_sum = torch.zeros_like(dem) if need_sum else None
    acc_tri = torch.zeros_like(dem) if need_tri else None
    acc_max = torch.full_like(dem, -math.inf) if need_rough else None
    acc_min = torch.full_like(dem, math.inf) if need_rough else None
    nan_seen = torch.zeros_like(dem, dtype=torch.bool) if need_rough else None

    if need_sum or need_tri or need_rough:
        for u in range(w):
            for v in range(w):
                sl = demp[u:u + h, v:v + width]
                if need_sum:
                    acc_sum = acc_sum + sl
                if need_tri:
                    d = sl - center
                    acc_tri = acc_tri + (d * d if riley else torch.abs(d))
                if need_rough:
                    acc_max = torch.maximum(acc_max, sl)
                    acc_min = torch.minimum(acc_min, sl)
                    nan_seen = nan_seen | torch.isnan(sl)

    out = []
    for a in attrs:
        if a == "topographic_position_index":
            val = center - _div(acc_sum - center, w * w - 1)
        elif a == "terrain_ruggedness_index":
            val = torch.sqrt(acc_tri) if riley else _div(acc_tri, w * w - 1)
        elif a == "roughness":
            val = torch.where(nan_seen, torch.nan, acc_max - acc_min)
        elif a == "rugosity":
            val = _rugosity(demp, h, width, resolution)
        else:
            raise ValueError(f"Unknown windowed attribute: {a}")
        out.append(val)
    return torch.stack(out, dim=0)


def _rugosity(demp: torch.Tensor, h: int, width: int, resolution: float) -> torch.Tensor:
    """Jenness (2004) rugosity on a 3x3 window from a NaN-padded DEM."""
    Z = {(u, v): demp[u:u + h, v:v + width] for u in range(3) for v in range(3)}
    L = torch.tensor(float(resolution), dtype=demp.dtype, device=demp.device)
    zc = Z[(1, 1)]
    hsl = []
    for pos, lfac in RUGOSITY_CENTER_SEGS:
        dz = zc - Z[pos]
        lf = lfac * L
        hsl.append(torch.sqrt(dz * dz + lf * lf) / 2)
    for p0, p1 in RUGOSITY_EDGE_SEGS:
        dz = Z[p0] - Z[p1]
        hsl.append(torch.sqrt(dz * dz + L * L) / 2)
    area = torch.zeros_like(zc)
    for ia, ib, ic in RUGOSITY_TRIS:
        a, b, c = hsl[ia], hsl[ib], hsl[ic]
        s = (a + b + c) / 2
        # clamp keeps NaN, so NaN poisoning survives Heron's guard.
        area = area + torch.sqrt(torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0))
    return area / (L * L)


def fractal_scales(window_size: int) -> tuple[list[int], list[float], float, float]:
    """(qs, log q, mean of log q, centred sum of squares of log q) for a window, in f32:
    the box sizes q are the divisors of w // 2 and the regression runs on log q."""
    hw = window_size // 2
    qs = [q for q in range(1, hw + 1) if hw % q == 0]
    log_q = torch.log(torch.tensor(qs, dtype=torch.float32))
    mx = torch.mean(log_q)
    ss_xx = torch.sum(log_q * log_q) - len(qs) * mx * mx
    return qs, [float(v) for v in log_q], float(mx), float(ss_xx)


def fractal_roughness(dem: torch.Tensor, window_size: int = 13, engine: str | None = None) -> torch.Tensor:
    """Taud & Parrot (2005) fractal roughness of an (H, W) f32 DEM by box counting.

    ``engine`` is validated as xdem_tpu validates it; this is the plain version whatever it
    names (the kernel runs through `cuda_kernels.fractal_roughness`).

    For each divisor q of w//2 the per-window voxel count is
      Ns(q) = sum over ((w-1)//q)^2 boxes of clip(max_box(z) - z_centre, 0, w) / q,
    boxes starting at (j*q, k*q) from the window's top-left corner, and the result is minus
    the slope of log Ns against log q. Box maxima are built once per q, separably, from the
    largest already-built divisor of q. w = 3 has one scale and gives NaN.
    """
    normalize_engine(engine)
    w = window_size
    if w < 3:
        raise ValueError("Fractal roughness requires window size >= 3.")
    h, width = dem.shape
    hw = w // 2
    demp = _nan_pad(dem, hw)
    c = demp[hw:hw + h, hw:hw + width]
    qs, log_q, mx, ss_xx = fractal_scales(w)
    n = len(qs)

    # Sliding box maxima M_q[i, j] = max(demp[i:i+q, j:j+q]); torch.maximum propagates NaN.
    maxima = {1: demp}

    def build_m(q: int) -> torch.Tensor:
        src = max(p for p in maxima if q % p == 0)
        m = maxima[src]
        f = q // src
        hm, wm = m.shape
        oh, ow = hm - (f - 1) * src, wm - (f - 1) * src
        rows = m[:oh, :]
        for t in range(1, f):
            rows = torch.maximum(rows, m[t * src: t * src + oh, :])
        out = rows[:, :ow]
        for t in range(1, f):
            out = torch.maximum(out, rows[:, t * src: t * src + ow])
        return out

    sy = torch.zeros_like(dem)
    sxy = torch.zeros_like(dem)
    for i, q in enumerate(qs):
        if q > 1:
            maxima[q] = build_m(q)
        mq = maxima[q]
        nq = (w - 1) // q
        ns = torch.zeros_like(dem)
        for j in range(nq):
            for k in range(nq):
                blk = mq[j * q: j * q + h, k * q: k * q + width]
                ns = ns + torch.clamp(blk - c, 0.0, float(w))
        yq = torch.log(_div(ns, q))
        sy = sy + yq
        sxy = sxy + log_q[i] * yq

    my = _div(sy, n)
    ss_xy = sxy - n * my * mx
    return -_div(ss_xy, ss_xx)
