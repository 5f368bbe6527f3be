"""Plain reference of the terrain suite: xdem's attribute definitions in plain PyTorch.

It imports nothing of the program and computes in the dtype it is given: float64 for the
check, a lower precision for the control. Definitions (as xdem states them):
  * surface fit (Florinsky 2009, 5 x 5 third-order fit): slope, aspect, hillshade (GDAL's
    scaling, altitude 45, azimuth 315) and the geometric curvatures ×100, from the five
    derivatives; NaN where any pixel of the 5 x 5 footprint is not finite or lies beyond the
    edge;
  * windowed indexes on 3 x 3: TPI (Weiss 2001), TRI (Riley 1999), roughness (Dartnell 2000),
    rugosity (Jenness 2004); NaN where any pixel of the window is not finite or lies beyond;
  * fractal roughness (Taud & Parrot 2005) by box counting over the divisors of w // 2;
  * slope and aspect in degrees, hillshade clipped to [0, 255].

Rows are computed in blocks, each read with a halo of HALO rows, so the reference fits
beside the program's planes at any size.
"""

from __future__ import annotations

import math

import torch

HALO = 6  # the largest footprint's half width: fractal roughness at w = 13

# Florinsky (2009) eqs. 12-20: each derivative is sum(K * z) / (DIV * res ** POW), with K
# indexed [row, col] over the 5 x 5 window from its top-left corner (row 0 is north).
FLORINSKY = {
    "z_x": ([[-31, 44, 0, -44, 31], [5, 62, 0, -62, -5], [17, 68, 0, -68, -17],
             [5, 62, 0, -62, -5], [-31, 44, 0, -44, 31]], 420.0, 1),
    "z_y": ([[31, -5, -17, -5, 31], [-44, -62, -68, -62, -44], [0, 0, 0, 0, 0],
             [44, 62, 68, 62, 44], [-31, 5, 17, 5, -31]], 420.0, 1),
    "z_xx": ([[2, -1, -2, -1, 2]] * 5, 35.0, 2),
    "z_yy": ([[2] * 5, [-1] * 5, [-2] * 5, [-1] * 5, [2] * 5], 35.0, 2),
    "z_xy": ([[-4, -2, 0, 2, 4], [-2, -1, 0, 1, 2], [0] * 5, [2, 1, 0, -1, -2], [4, 2, 0, -2, -4]], 100.0, 2),
}
CURVATURES = ("curvature", "profile_curvature", "tangential_curvature", "planform_curvature",
              "flowline_curvature", "max_curvature", "min_curvature")
SURFACE_FIT = ("slope", "aspect", "hillshade") + CURVATURES
WINDOWED = ("topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity")


def _shifts(zp: torch.Tensor, k: int, h: int, w: int):
    """((u, v), zp[u:u+h, v:v+w]) over a k x k window of a padded block."""
    for u in range(k):
        for v in range(k):
            yield (u, v), zp[u:u + h, v:v + w]


def surface_fit(zp: torch.Tensor, res: float, attrs, altitude: float = 45.0, azimuth: float = 315.0):
    """Surface-fit attributes (radians, hillshade unclipped) of the interior of `zp`, a block
    padded by 2 pixels (NaN beyond the raster)."""
    h, w = zp.shape[0] - 4, zp.shape[1] - 4
    finite = torch.isfinite(zp)
    center = zp[finite].to(torch.float64).mean().to(zp.dtype) if bool(finite.any()) else zp.new_zeros(())
    z0 = torch.where(finite, zp - center, torch.zeros_like(zp))
    valid = torch.ones((h, w), dtype=torch.bool, device=zp.device)
    d = {r: torch.zeros((h, w), dtype=zp.dtype, device=zp.device) for r in FLORINSKY}
    for (u, v), sl in _shifts(z0, 5, h, w):
        valid &= finite[u:u + h, v:v + w]
        for r, (k, _, _) in FLORINSKY.items():
            if k[u][v]:
                d[r] = d[r] + k[u][v] * sl
    res_t = torch.tensor(res, dtype=zp.dtype, device=zp.device)
    zx, zy, zxx, zyy, zxy = (d[r] / (FLORINSKY[r][1] * res_t ** FLORINSKY[r][2]) for r in FLORINSKY)

    p2 = zx * zx + zy * zy
    flat = p2 == 0
    slope = torch.atan(torch.sqrt(p2))
    aspect = torch.remainder(-torch.atan2(-zx, zy), 2 * math.pi)
    g = 1 + p2
    den_m = 2 * torch.sqrt(g * g * g)
    num_m = (1 + zy * zy) * zxx - 2 * zxy * zx * zy + (1 + zx * zx) * zyy
    mean_c = torch.where(flat, 0.0, -num_m / den_m)
    disc = (num_m / den_m) ** 2 - (zxx * zyy - zxy * zxy) / (g * g)
    unsph = torch.where(flat, 0.0, torch.sqrt(torch.clamp(disc, min=0.0)))
    num_t = -(zxx * zy * zy - 2 * zxy * zx * zy + zyy * zx * zx)
    out = []
    for a in attrs:
        if a == "slope":
            v = slope
        elif a == "aspect":
            v = aspect
        elif a == "hillshade":
            alt, az = math.radians(altitude), math.radians(360.0 - azimuth)
            v = 1.5 + 254.0 * (math.sin(alt) * torch.cos(slope) + math.cos(alt) * torch.sin(slope) * torch.sin(az - aspect))
        elif a == "curvature":
            v = -2.0 * (zxx + zyy) * 100.0
        elif a == "profile_curvature":
            num = -(zxx * zx * zx + 2 * zxy * zx * zy + zyy * zy * zy)
            v = torch.where(flat, 0.0, num / (p2 * torch.sqrt(g * g * g))) * 100.0
        elif a == "tangential_curvature":
            v = torch.where(flat, 0.0, num_t / (p2 * torch.sqrt(g))) * 100.0
        elif a == "planform_curvature":
            v = torch.where(p2 < 10e-15, 0.0, num_t / torch.sqrt(p2 * p2 * p2)) * 100.0
        elif a == "flowline_curvature":
            num = zx * zy * (zxx - zyy) - zxy * (zx * zx - zy * zy)
            v = torch.where(p2 < 10e-15, 0.0, num / (torch.sqrt(p2 * p2 * p2) * torch.sqrt(g))) * 100.0
        elif a == "max_curvature":
            v = torch.where(flat, 0.0, mean_c + unsph) * 100.0
        elif a == "min_curvature":
            v = torch.where(flat, 0.0, mean_c - unsph) * 100.0
        else:
            raise ValueError(f"not a surface-fit attribute: {a}")
        out.append(torch.where(valid, v, torch.nan))
    return out


def windowed(zp: torch.Tensor, res: float, attrs):
    """3 x 3 windowed indexes of the interior of `zp`, a block padded by 1 pixel (NaN beyond)."""
    h, w = zp.shape[0] - 2, zp.shape[1] - 2
    win = dict(_shifts(zp, 3, h, w))
    zc = win[(1, 1)]
    out = []
    for a in attrs:
        if a == "topographic_position_index":
            v = zc - (sum(s for p, s in win.items() if p != (1, 1))) / torch.tensor(8.0, dtype=zp.dtype, device=zp.device)
        elif a == "terrain_ruggedness_index":
            v = torch.sqrt(sum((s - zc) ** 2 for s in win.values()))
        elif a == "roughness":
            stack = torch.stack(list(win.values()))
            v = stack.amax(0) - stack.amin(0)  # NaN anywhere in the window gives NaN
        elif a == "rugosity":
            v = _rugosity(win, res)
        else:
            raise ValueError(f"not a windowed index: {a}")
        out.append(v)
    return out


def _rugosity(win, res: float) -> torch.Tensor:
    """Jenness (2004): the surface area of the eight triangles joining the centre to its
    neighbours, each clipped to the pixel (half-lengths), over the pixel's planar area."""
    zc = win[(1, 1)]
    ring = [(0, 0), (0, 1), (0, 2), (1, 2), (2, 2), (2, 1), (2, 0), (1, 0)]  # clockwise from north-west

    def half(z_a, z_b, planar):
        return torch.sqrt((z_a - z_b) ** 2 + planar * planar) / 2

    area = torch.zeros_like(zc)
    for i in range(8):
        p, q = ring[i], ring[(i + 1) % 8]
        a = half(zc, win[p], res * math.hypot(p[0] - 1, p[1] - 1))
        b = half(zc, win[q], res * math.hypot(q[0] - 1, q[1] - 1))
        c = half(win[p], win[q], res)
        s = (a + b + c) / 2
        area = area + torch.sqrt(torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0))
    return area / (res * res)


def fractal_roughness(zp: torch.Tensor, w: int = 13) -> torch.Tensor:
    """Fractal roughness of the interior of `zp`, a block padded by w // 2 (NaN beyond): for
    each divisor q of w // 2, Ns(q) = sum over the ((w - 1) // q)^2 boxes of q x q pixels from
    the window's top-left corner of clip(max(box) - z_centre, 0, w) / q; the result is minus
    the least-squares slope of log Ns against log q."""
    hw = w // 2
    h, width = zp.shape[0] - 2 * hw, zp.shape[1] - 2 * hw
    zc = zp[hw:hw + h, hw:hw + width]
    qs = [q for q in range(1, hw + 1) if hw % q == 0]
    log_q = torch.log(torch.tensor(qs, dtype=zp.dtype, device=zp.device))
    ys = []
    for q in qs:
        # box maxima M[i, j] = max(zp[i:i+q, j:j+q]), any NaN in the box giving NaN
        m = zp.unfold(0, q, 1).unfold(1, q, 1).amax(dim=(-1, -2))
        ns = torch.zeros_like(zc)
        for j in range((w - 1) // q):
            for k in range((w - 1) // q):
                box = m[j * q:j * q + h, k * q:k * q + width]
                ns = ns + torch.clamp(box - zc, 0.0, float(w))
        ys.append(torch.log(ns / q))
    y = torch.stack(ys)
    x = (log_q - log_q.mean())[:, None, None]
    return -(x * (y - y.mean(0))).sum(0) / (x * x).sum()


def padded_rows(dem: torch.Tensor, r0: int, r1: int, c0: int, c1: int, pad: int, dtype) -> torch.Tensor:
    """dem[r0 - pad:r1 + pad, c0 - pad:c1 + pad] in `dtype`, NaN where it lies beyond the raster."""
    n_r, n_c = dem.shape
    out = torch.full((r1 - r0 + 2 * pad, c1 - c0 + 2 * pad), float("nan"), dtype=dtype, device=dem.device)
    a, b, c, d = max(r0 - pad, 0), min(r1 + pad, n_r), max(c0 - pad, 0), min(c1 + pad, n_c)
    out[a - (r0 - pad):b - (r0 - pad), c - (c0 - pad):d - (c0 - pad)] = dem[a:b, c:d].to(dtype)
    return out


def terrain_block(dem: torch.Tensor, rows: tuple[int, int], cols: tuple[int, int], res: float, attrs,
                  dtype=torch.float64, window_size_fractal: int = 13) -> dict[str, torch.Tensor]:
    """{attribute: plane} of dem[rows, cols] in `dtype`, after the epilog (degrees, clip)."""
    r0, r1 = rows
    c0, c1 = cols
    zp = padded_rows(dem, r0, r1, c0, c1, HALO, dtype)
    out = {}
    sf = [a for a in attrs if a in SURFACE_FIT]
    win = [a for a in attrs if a in WINDOWED]

    def crop(pad: int) -> torch.Tensor:
        e = HALO - pad
        return zp[e:zp.shape[0] - e, e:zp.shape[1] - e]

    if sf:
        out.update(zip(sf, surface_fit(crop(2), res, sf)))
    if win:
        out.update(zip(win, windowed(crop(1), res, win)))
    if "fractal_roughness" in attrs:
        out["fractal_roughness"] = fractal_roughness(crop(window_size_fractal // 2), window_size_fractal)
    for a in ("slope", "aspect"):
        if a in out:
            out[a] = torch.rad2deg(out[a])
    if "hillshade" in out:
        out["hillshade"] = torch.clamp(out["hillshade"], 0, 255)
    return {a: out[a] for a in attrs}
