"""Surface-fit terrain attributes: fixed-stencil partial derivatives + closed-form algebra.

Plain PyTorch version of xdem_tpu/terrain/surfit.py and the reference the CUDA kernel K1
(``csrc/surface_fit.cu``) is held against. All requested derivative stencils are evaluated
as shifted-slice multiply-adds over the zero-filled, mean-centred DEM; validity is the
erosion of the finite mask by the k x k footprint. Stencils are never run through
``F.conv2d``: cuDNN convolutions default to TF32 on the card.

Stencil tables: Zevenbergen & Thorne (1987), Horn (1981) and Florinsky (2009); the tables
below are copies of xdem_tpu/terrain/surfit.py's, held equal to them by a CPU test.
"""

from __future__ import annotations

import math
from typing import Literal, Sequence

import numpy as np
import torch

from xdem_tpu_torch.profiler import span

SurfaceFit = Literal["Horn", "ZevenbergThorne", "Florinsky"]
CurvMethod = Literal["geometric", "directional"]

# fmt: off
# Zevenbergen & Thorne (1987), eqs. 3-11 (letters D..H as in the paper)
_ZT = {
    "zt_d": [[0, 1, 0], [0, -2, 0], [0, 1, 0]],
    "zt_e": [[0, 0, 0], [1, -2, 1], [0, 0, 0]],
    "zt_f": [[-1, 0, 1], [0, 0, 0], [1, 0, -1]],
    "zt_g": [[0, 1, 0], [0, 0, 0], [0, -1, 0]],
    "zt_h": [[0, 0, 0], [-1, 0, 1], [0, 0, 0]],
}
# Horn (1981), p.18 finite-difference gradients
_HORN = {
    "h1": [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
    "h2": [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
}
# Florinsky (2009) third-order polynomial fit on a 5x5 window, eqs. 12-20
_FL = {
    "fl_r": [[2, -1, -2, -1, 2]] * 5,
    "fl_t": [[2, 2, 2, 2, 2], [-1, -1, -1, -1, -1], [-2, -2, -2, -2, -2],
             [-1, -1, -1, -1, -1], [2, 2, 2, 2, 2]],
    "fl_s": [[-4, -2, 0, 2, 4], [-2, -1, 0, 1, 2], [0, 0, 0, 0, 0],
             [2, 1, 0, -1, -2], [4, 2, 0, -2, -4]],
    "fl_p": [[31, -44, 0, 44, -31], [-5, -62, 0, 62, 5], [-17, -68, 0, 68, 17],
             [-5, -62, 0, 62, 5], [31, -44, 0, 44, -31]],
    "fl_q": [[-31, 5, 17, 5, -31], [44, 62, 68, 62, 44], [0, 0, 0, 0, 0],
             [-44, -62, -68, -62, -44], [31, -5, -17, -5, 31]],
}
# fmt: on

ALL_STENCILS = {k: np.asarray(v, dtype=np.float64) for d in (_ZT, _HORN, _FL) for k, v in d.items()}

# Each raw stencil response is divided by DIV_CONST[name] * res ** DIV_POW[role].
DIV_CONST = {
    "zt_d": 1.0, "zt_e": 1.0, "zt_f": 4.0, "zt_g": 2.0, "zt_h": 2.0,
    "h1": 8.0, "h2": 8.0,
    "fl_r": 35.0, "fl_t": 35.0, "fl_s": 100.0, "fl_p": 420.0, "fl_q": 420.0,
}
DIV_POW = {"z_x": 1, "z_y": 1, "z_xx": 2, "z_yy": 2, "z_xy": 2}

# Derivative roles per fit method: names of the (z_x, z_y, z_xx, z_yy, z_xy) stencils.
_FIT_DERIVS = {
    "horn": {"z_x": "h2", "z_y": "h1"},
    "zevenbergthorne": {"z_x": "zt_h", "z_y": "zt_g", "z_xx": "zt_e", "z_yy": "zt_d", "z_xy": "zt_f"},
    "florinsky": {"z_x": "fl_p", "z_y": "fl_q", "z_xx": "fl_r", "z_yy": "fl_t", "z_xy": "fl_s"},
}

_CURVATURE_ATTRS = (
    "curvature",
    "profile_curvature",
    "tangential_curvature",
    "planform_curvature",
    "flowline_curvature",
    "max_curvature",
    "min_curvature",
)

SURFACE_FIT_ATTRS = ("slope", "aspect", "hillshade") + _CURVATURE_ATTRS


def _needed_derivs(attrs: Sequence[str], fit: str) -> tuple[str, ...]:
    """Which derivative roles the requested attributes need, in (z_x, z_y, z_xx, z_yy, z_xy) order."""
    roles: list[str] = []
    if any(a in SURFACE_FIT_ATTRS for a in attrs):
        roles += ["z_x", "z_y"]
    if any(a in _CURVATURE_ATTRS for a in attrs):
        roles += ["z_xx", "z_yy", "z_xy"]
    avail = _FIT_DERIVS[fit]
    return tuple(r for r in roles if r in avail)


def fit_plan(attrs: Sequence[str], surface_fit: str) -> tuple[tuple[str, ...], tuple[str, ...], int]:
    """(roles, stencil names, k) for an attribute set: what the stencil pass evaluates."""
    fit = surface_fit.lower()
    if fit == "horn" and any(a in _CURVATURE_ATTRS for a in attrs):
        raise ValueError("'Horn' surface fit cannot compute curvatures; use ZevenbergThorne or Florinsky.")
    roles = _needed_derivs(attrs, fit)
    names = tuple(_FIT_DERIVS[fit][r] for r in roles)
    ksize = ALL_STENCILS[names[0]].shape[0] if names else 3
    return roles, names, ksize


def dem_center(dem: torch.Tensor) -> torch.Tensor:
    """Mean of the finite pixels (0-dim tensor; 0 when none is finite). All derivative
    stencils annihilate constants, and removing the large constant keeps f32 sums accurate."""
    with span("xdem_tpu_torch.terrain.center", devices=[dem.device]):
        valid = torch.isfinite(dem)
        mean = torch.nanmean(torch.where(valid, dem, torch.nan))
        return torch.where(valid.any(), mean, torch.zeros_like(mean))


def divisors(roles: Sequence[str], names: Sequence[str], resolution: float,
             device: torch.device | str = "cpu") -> list[torch.Tensor]:
    """f32 divisor of each stencil response: DIV_CONST[name] * res ** DIV_POW[role]."""
    res = torch.tensor(float(resolution), dtype=torch.float32, device=device)
    return [DIV_CONST[name] * res ** DIV_POW[role] for role, name in zip(roles, names)]


def hillshade_constants(altitude: float, azimuth: float) -> tuple[float, float, float]:
    """(sin(altitude), cos(altitude), azimuth) in radians, each rounded to f32."""
    alt = torch.deg2rad(torch.tensor(float(altitude), dtype=torch.float32))
    az = torch.deg2rad(torch.tensor(360.0 - float(azimuth), dtype=torch.float32))
    return float(torch.sin(alt)), float(torch.cos(alt)), float(az)


def _erode_valid(valid: torch.Tensor, k: int) -> torch.Tensor:
    """Erode a validity mask by a k x k footprint (any invalid neighbour, or a pixel beyond
    the edge, makes a pixel invalid): a separable AND over shifted slices."""
    pad = k // 2
    h, w = valid.shape
    v = torch.nn.functional.pad(valid, (pad, pad, pad, pad), value=False)
    rows = v[0:h, :]
    for u in range(1, k):
        rows = rows & v[u:u + h, :]
    out = rows[:, 0:w]
    for t in range(1, k):
        out = out & rows[:, t:t + w]
    return out


def _apply_stencils(dem: torch.Tensor, kernels: tuple[np.ndarray, ...]) -> list[torch.Tensor]:
    """Evaluate several stencils in one pass of shifted slices (zero-padded, kernel flipped):
    out[r, c] = sum_{u,v} dem[r+u-h, c+v-h] * K[k-1-u, k-1-v]; each slice is shared across
    the kernels. Invalid samples must already be zero-filled."""
    k = kernels[0].shape[0]
    pad = k // 2
    h, w = dem.shape
    demp = torch.nn.functional.pad(dem, (pad, pad, pad, pad), value=0.0)
    outs = [torch.zeros_like(dem) for _ in kernels]
    for u in range(k):
        for v in range(k):
            weights = [float(K[k - 1 - u, k - 1 - v]) for K in kernels]
            if not any(weights):
                continue
            sl = demp[u:u + h, v:v + w]
            for i, wgt in enumerate(weights):
                if wgt:
                    outs[i] = outs[i] + wgt * sl
    return outs


def surface_attributes(
    dem: torch.Tensor,
    resolution: float,
    attrs: tuple[str, ...],
    surface_fit: SurfaceFit = "Florinsky",
    curv_method: CurvMethod = "geometric",
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
    center: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Surface-fit attributes of an (H, W) f32 DEM as a (len(attrs), H, W) stack.

    Slope and aspect are in radians and hillshade is unclipped (the dispatcher converts and
    clips); NaN where any of the k x k neighbours is not finite. Runs on any device.
    `center` replaces the DEM's own mean as the constant removed before the stencils (a
    window of a larger DEM then rounds exactly as the whole DEM does).
    """
    roles, names, ksize = fit_plan(attrs, surface_fit)
    geometric = curv_method.lower() == "geometric"
    valid_in = torch.isfinite(dem)
    if center is None:
        center = dem_center(dem)
    dem0 = torch.where(valid_in, dem - center, 0.0)
    raw = _apply_stencils(dem0, tuple(ALL_STENCILS[n] for n in names))
    D = {role: arr / div for role, arr, div in zip(roles, raw, divisors(roles, names, resolution, dem.device))}
    valid = _erode_valid(valid_in, ksize)
    vals = _attrs_from_derivs(D, attrs, geometric, hillshade_altitude, hillshade_azimuth, hillshade_z_factor)
    return torch.stack([torch.where(valid, v, torch.nan) for v in vals], dim=0)


def _attrs_from_derivs(
    D: dict,
    attrs: tuple[str, ...],
    geometric: bool,
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
) -> list[torch.Tensor]:
    """Closed-form attribute algebra from the derivative fields (xdem_tpu/terrain/surfit.py
    ::_attrs_from_derivs); no validity masking here."""
    z_x = D.get("z_x")
    z_y = D.get("z_y")
    z_xx = D.get("z_xx")
    z_yy = D.get("z_yy")
    z_xy = D.get("z_xy")

    grad2 = z_x * z_x + z_y * z_y
    flat = grad2 == 0.0

    slope = aspect = None
    if "slope" in attrs or "hillshade" in attrs:
        slope = torch.atan(torch.sqrt(grad2))
    if "aspect" in attrs or "hillshade" in attrs:
        aspect = torch.remainder(-torch.atan2(-z_x, z_y), 2 * math.pi)

    mean_c = unsphericity = None
    if geometric and ("max_curvature" in attrs or "min_curvature" in attrs):
        # Mean curvature (Gauss 1928) and unsphericity (Shary 1995).
        g1 = 1 + grad2
        denom_m = 2 * torch.sqrt(g1 * g1 * g1)
        mean_c = torch.where(flat, 0.0, -((1 + z_y * z_y) * z_xx - 2 * z_xy * z_x * z_y + (1 + z_x * z_x) * z_yy) / denom_m)
        t = ((1 + z_y * z_y) * z_xx - 2 * z_y * z_x * z_xy + (1 + z_x * z_x) * z_yy) / denom_m
        d = t * t - (z_xx * z_yy - z_xy * z_xy) / (g1 * g1)
        # clamp keeps NaN, as jnp.maximum does.
        unsphericity = torch.where(flat, 0.0, torch.sqrt(torch.clamp(d, min=0.0)))

    out = []
    for a in attrs:
        if a == "slope":
            val = slope
        elif a == "aspect":
            val = aspect
        elif a == "hillshade":
            sin_alt, cos_alt, az = hillshade_constants(hillshade_altitude, hillshade_azimuth)
            slopemap = torch.atan(torch.tan(slope) * hillshade_z_factor) if hillshade_z_factor != 1.0 else slope
            # GDAL-matching scaling.
            val = 1.5 + 254.0 * (sin_alt * torch.cos(slopemap) + cos_alt * torch.sin(slopemap) * torch.sin(az - aspect))
        elif a == "curvature":
            # Legacy Moore et al. (1991) curvature.
            val = -2.0 * (z_xx + z_yy) * 100.0
        elif a == "profile_curvature":
            num = -(z_xx * (z_x * z_x) + 2 * z_xy * z_x * z_y + z_yy * (z_y * z_y))
            g1 = 1 + grad2
            den = grad2 * torch.sqrt(g1 * g1 * g1) if geometric else grad2
            val = torch.where(flat, 0.0, num / den) * 100.0
        elif a == "tangential_curvature":
            num = -(z_xx * (z_y * z_y) - 2 * z_xy * z_x * z_y + z_yy * (z_x * z_x))
            den = grad2 * torch.sqrt(1 + grad2) if geometric else grad2
            val = torch.where(flat, 0.0, num / den) * 100.0
        elif a == "planform_curvature":
            num = -(z_xx * (z_y * z_y) - 2 * z_xy * z_x * z_y + z_yy * (z_x * z_x))
            val = torch.where(grad2 < 10e-15, 0.0, num / torch.sqrt(grad2 * grad2 * grad2)) * 100.0
        elif a == "flowline_curvature":
            num = z_x * z_y * (z_xx - z_yy) - z_xy * (z_x * z_x - z_y * z_y)
            g3 = torch.sqrt(grad2 * grad2 * grad2)
            den = g3 * torch.sqrt(1 + grad2) if geometric else g3
            val = torch.where(grad2 < 10e-15 if geometric else flat, 0.0, num / den) * 100.0
        elif a in ("max_curvature", "min_curvature"):
            if geometric:
                val = mean_c + unsphericity if a == "max_curvature" else mean_c - unsphericity
                val = torch.where(flat, 0.0, val) * 100.0
            else:
                half = (z_xx - z_yy) / 2
                root = torch.sqrt(half * half + z_xy * z_xy)
                mid = (z_xx + z_yy) / 2
                val = torch.where(flat, 0.0, -(mid - root if a == "max_curvature" else mid + root)) * 100.0
        else:
            raise ValueError(f"Unknown surface-fit attribute: {a}")
        out.append(val)
    return out
