"""Affine coregistration: AffineCoreg, VerticalShift and Nuth & Kääb (2011).

Port of the raster-raster paths of xdem_tpu/coreg/affine.py. The Nuth & Kääb fit runs on the
device of its inputs: slope and aspect from ``torch.gradient``, a seeded subsample without
replacement (uniform scores from an explicit ``torch.Generator``, invalid pixels parked at
-inf, top-k), then at most ``max_iterations`` steps of bilinear dh, aspect-binned medians
and a closed-form 3x3 solve of the cosine model, with the reference's stop rule. The
normal equations are plain float32 products: nothing here turns TF32 on.

The random draws differ from xdem_tpu's (torch and JAX generators give other bits from one
seed), so fits agree with the reference to the coregistration tolerance, not bitwise.
"""

from __future__ import annotations

import logging
import math
import warnings
from typing import Any, Callable

import numpy as np
import torch

from xdem_tpu_torch.coreg.base import Coreg, _check_matrix, matrix_from_translations_rotations
from xdem_tpu_torch.georef import Affine, is_projected
from xdem_tpu_torch.ops.interp import interp_rowcol
from xdem_tpu_torch.ops.reductions import binned_median as _binned_median
from xdem_tpu_torch.ops.reductions import masked_median as _masked_median
from xdem_tpu_torch.ops.sampling import seed_from, topk_subsample
from xdem_tpu_torch.ops.transfer import device_mask


def _warn_if_not_converged(it: int, max_iterations: int, stat: float, tolerance: float,
                           sx: float, sy: float) -> None:
    if it >= max_iterations and stat > tolerance:
        logging.warning(
            "Nuth and Kääb did not converge after %d iterations (last offset step %.3f px > "
            "tolerance %.3f px); the estimated shift (%.1f, %.1f) m may be unreliable. "
            "Moving terrain in the inputs (pass a stable-terrain inlier_mask) is the most "
            "common cause.", int(it), float(stat), float(tolerance), float(sx), float(sy),
        )


def _count_from_subsample(subsample: float | int, n_valid: int) -> int:
    if subsample <= 1:
        return max(int(subsample * n_valid), 1)
    return min(int(subsample), n_valid)


def _dh_device(pts_z, rows, cols, raster, sx_px, sy_px, invert: bool) -> torch.Tensor:
    """dh(shift) at the subsampled points: ref - tba with the raster shifted by (sx, sy) px."""
    sgn = -1.0 if invert else 1.0
    interp = interp_rowcol(raster, rows - sgn * sy_px, cols + sgn * sx_px, method="linear")
    dh = pts_z - interp
    return -dh if invert else dh


# ======================================================================================
# Nuth & Kääb
# ======================================================================================


def _nuth_kaab_solve(
    pts_z: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    raster: torch.Tensor,
    slope_tan: torch.Tensor,
    aspect: torch.Tensor,
    res_x: float,
    res_y: float,
    tolerance: float,
    max_iterations: int = 10,
    n_bins: int = 72,
    invert: bool = False,
    bin_before_fit: bool = True,
) -> tuple[float, float, float, float, int]:
    """Nuth & Kääb iterations; returns (shift_x m, shift_y m, vshift, last step px, steps).

    Each step: bilinear dh at the shifted points, median vshift removal, dh / tan(slope)
    binned by aspect (or fitted directly), closed-form cosine fit, pixel-offset increment.
    Stops after at least 3 steps once the offset step drops below `tolerance`.
    """
    dev = pts_z.device
    f32 = torch.float32
    bin_width = 2 * math.pi / n_bins
    bin_centers = (torch.arange(n_bins, dtype=f32, device=dev) + 0.5) * bin_width
    G = torch.stack([torch.cos(bin_centers), torch.sin(bin_centers), torch.ones(n_bins, dtype=f32, device=dev)], 1)
    ridge = 1e-12 * torch.eye(3, dtype=f32, device=dev)

    def lstsq(Gm: torch.Tensor, yv: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """Solve the normal equations of y = A cos x + B sin x + C over the `ok` rows."""
        Gw = Gm * ok.to(f32)[:, None]
        return torch.linalg.solve(Gw.T @ Gm + ridge, Gw.T @ torch.where(ok, yv, 0.0))

    sx = torch.zeros((), dtype=f32, device=dev)
    sy = torch.zeros((), dtype=f32, device=dev)
    vshift = torch.zeros((), dtype=f32, device=dev)
    stat = math.inf
    tol32 = float(np.float32(tolerance))  # the stop rule compares in f32
    it = 0
    while it < max_iterations and not (it >= 3 and stat < tol32):
        dh = _dh_device(pts_z, rows, cols, raster, sx, sy, invert)
        vshift = _masked_median(dh)
        y = (dh - vshift) / slope_tan
        valid = torch.isfinite(y)
        if bin_before_fit:
            bin_idx = torch.clamp((aspect / bin_width).to(torch.int32), 0, n_bins - 1)
            med = _binned_median(y, bin_idx, valid, n_bins)
            p = lstsq(G, med, torch.isfinite(med))
        else:
            Gf = torch.stack([torch.cos(aspect), torch.sin(aspect), torch.ones_like(aspect)], 1)
            p = lstsq(Gf, y, valid)
        north_px, east_px = p[0], p[1]  # a*cos(b), a*sin(b)
        sx = sx + east_px
        sy = sy + north_px
        stat = float(torch.hypot(east_px, north_px))
        it += 1
    return float(sx * res_x), float(sy * res_y), float(vshift), stat, it


def _nk_slope_aspect_valid(ref: torch.Tensor, tba: torch.Tensor, inlier: torch.Tensor):
    """Slope tangent (per pixel), aspect and the joint valid mask of a raster pair."""
    # Gradients are translation-invariant: mean-centre so f32 differencing stays accurate.
    gy, gx = torch.gradient(ref - torch.nanmean(ref))
    slope_tan = torch.hypot(gx, gy)
    aspect = torch.atan2(-gx, gy) + math.pi
    slope_tan = torch.where(torch.isclose(slope_tan, torch.zeros_like(slope_tan)), torch.nan, slope_tan)
    valid = torch.isfinite(ref) & torch.isfinite(tba) & inlier & torch.isfinite(slope_tan)
    return slope_tan, aspect, valid


def _nuth_kaab_rst_rst_device(
    ref: torch.Tensor,
    tba: torch.Tensor,
    inlier: torch.Tensor,
    seed: int,
    subsample: float | int,
    res_x: float,
    res_y: float,
    tolerance: float,
    max_iterations: int = 10,
    n_bins: int = 72,
    bin_before_fit: bool = True,
) -> dict[str, float]:
    """Raster-raster Nuth & Kääb on the inputs' device: slope/aspect, seeded subsample over
    the joint valid mask, and the iterative solve."""
    h, w = ref.shape
    slope_tan, aspect, valid = _nk_slope_aspect_valid(ref, tba, inlier)
    n_valid = int(valid.sum())
    # An absolute count is fixed by the raster size (overflow picks are NaN-poisoned below);
    # a fraction is taken of the valid pixels.
    count = min(int(subsample), ref.numel()) if subsample > 1 else _count_from_subsample(subsample, n_valid)

    generator = torch.Generator(device=ref.device).manual_seed(seed)
    idx, picked_ok = topk_subsample(generator, valid.reshape(-1), count)
    rr = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    cc = (idx % w).to(torch.float32)
    pts_z = torch.where(picked_ok, ref.reshape(-1)[idx], torch.nan)
    st = torch.where(picked_ok, slope_tan.reshape(-1)[idx], torch.nan)
    asp = aspect.reshape(-1)[idx]

    # Aspect-degeneracy diagnostic: how many aspect bins are well populated in the subsample.
    bin_idx = torch.clamp((asp / (2 * math.pi / n_bins)).to(torch.int32), 0, n_bins - 1)
    parked = torch.where(torch.isfinite(st), bin_idx.long(), n_bins)
    populated = int((torch.bincount(parked, minlength=n_bins + 1)[:n_bins] > 10).sum())

    sx, sy, vshift, stat, it = _nuth_kaab_solve(
        pts_z, rr, cc, tba, st, asp, res_x, res_y, tolerance,
        max_iterations=max_iterations, n_bins=n_bins, invert=False, bin_before_fit=bin_before_fit,
    )
    return {"shift_x": sx, "shift_y": sy, "vshift": vshift, "stat": stat, "iterations": it,
            "n_valid": n_valid, "count": count, "populated": populated}


def nuth_kaab(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    crs: Any,
    tolerance: float,
    max_iterations: int,
    subsample: float | int,
    random_state: Any,
    bin_before_fit: bool = True,
    n_bins: int = 72,
) -> tuple[tuple[float, float, float], int, int]:
    """Nuth and Kääb (2011) on a raster pair; returns ((east, north, vertical) sampling
    offsets in m, final subsample count, iterations)."""
    logging.info("Running Nuth and Kääb (2011) coregistration")
    if crs is not None and not is_projected(crs):
        raise NotImplementedError(
            f"Nuth and Kääb coregistration needs planar (projected) coordinates, but the input CRS "
            f"is {crs}. Reproject both elevations to a local projected system first."
        )
    inlier = device_mask(inlier_mask, tuple(ref_elev.shape), ref_elev.device)
    out = _nuth_kaab_rst_rst_device(
        ref_elev, tba_elev, inlier, seed_from(random_state), subsample,
        transform.xres, transform.yres, tolerance,
        max_iterations=int(max_iterations), n_bins=int(n_bins), bin_before_fit=bin_before_fit,
    )
    sx, sy, vshift = out["shift_x"], out["shift_y"], out["vshift"]
    if out["n_valid"] == 0:
        raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
    _warn_if_not_converged(out["iterations"], int(max_iterations), out["stat"], tolerance, sx, sy)
    if out["populated"] < n_bins // 4:
        logging.warning(
            "Only %d/%d aspect bins are well-populated: the terrain faces few directions, so "
            "the Nuth and Kääb horizontal offsets are poorly constrained and may diverge. "
            "Use a larger extent with diverse aspects, or DhMinimize/LZD instead.",
            out["populated"], n_bins,
        )
    if not (np.isfinite(sx) and np.isfinite(sy) and np.isfinite(vshift)):
        raise ValueError(
            "No valid points remain in the subsample: either the shift to correct moved the "
            "grids out of overlap, or the solver diverged. Passing subsample=1 keeps every "
            "valid pixel available at each iteration."
        )
    return (sx, sy, vshift), int(min(out["count"], out["n_valid"])), out["iterations"]


# ======================================================================================
# AffineCoreg base + VerticalShift
# ======================================================================================


class AffineCoreg(Coreg):
    """Generic affine coregistration: produces a 4x4 matrix."""

    _is_affine = True

    def __init__(self, subsample: float | int = 1.0, matrix: np.ndarray | None = None,
                 meta: dict[str, Any] | None = None, initial_shift: tuple | None = None):
        super().__init__(meta=meta)
        # The kwarg wins when explicitly set; the default must not clobber meta routing.
        if not (meta and "subsample" in meta and subsample == 1.0):
            self._meta["inputs"]["random"]["subsample"] = subsample
        if initial_shift is not None:
            if not (
                isinstance(initial_shift, tuple)
                and len(initial_shift) in (2, 3)
                and all(isinstance(v, (float, int)) for v in initial_shift)
            ):
                raise ValueError(
                    "Argument `initial_shift` must be a tuple of exactly two or three numerical values."
                )
            if len(initial_shift) == 2:
                initial_shift = (*initial_shift, 0)
            elif initial_shift[2] != 0:
                initial_shift = (*initial_shift[:2], 0)
                warnings.warn("Initial shift in altitude is currently work in progress.", category=UserWarning)
            self._meta["inputs"]["affine"]["initial_shift"] = tuple(initial_shift)
        if matrix is not None:
            self._meta["outputs"]["affine"] = {"matrix": _check_matrix(np.asarray(matrix))}
            self._fit_called = True

    @property
    def is_affine(self) -> bool:
        return True

    @classmethod
    def from_matrix(cls, matrix: np.ndarray) -> "AffineCoreg":
        return cls(matrix=matrix)  # type: ignore[call-arg]

    @classmethod
    def from_translations(cls, x_off: float = 0.0, y_off: float = 0.0, z_off: float = 0.0) -> "AffineCoreg":
        return cls.from_matrix(matrix_from_translations_rotations(t_x=x_off, t_y=y_off, t_z=z_off))

    @property
    def centroid(self) -> tuple[float, float, float] | None:
        return self._meta["outputs"].get("affine", {}).get("centroid")


def _masked_median_diff(ref: torch.Tensor, tba: torch.Tensor, inlier: torch.Tensor) -> tuple[float, int]:
    """Median of (ref - tba) over the inlier and finite pixels, and their count."""
    dh = torch.where(inlier, ref - tba, torch.nan)
    return float(_masked_median(dh)), int(torch.isfinite(dh).sum())


def vertical_shift(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    subsample: float | int,
    random_state: Any,
    vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
) -> tuple[float, int]:
    """Vertical shift of a raster pair: reduce the elevation differences. Returns (shift, count).

    The default (every valid pixel, median) is one device reduction. A subsample or another
    reductor draws pixels with numpy's generator from `random_state`, the same draw as
    xdem_tpu, evaluates dh on the device and reduces on the host.
    """
    logging.info("Running vertical shift coregistration")
    inlier = device_mask(inlier_mask, tuple(ref_elev.shape), ref_elev.device)
    if isinstance(subsample, float) and subsample == 1.0 and vshift_reduc_func in (np.median, np.nanmedian):
        med, n_valid = _masked_median_diff(ref_elev, tba_elev, inlier)
        if n_valid == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        return med, n_valid
    valid = (torch.isfinite(tba_elev) & torch.isfinite(ref_elev) & inlier).cpu().numpy()
    idx_flat = np.flatnonzero(valid)
    if idx_flat.size == 0:
        raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
    count = _count_from_subsample(subsample, idx_flat.size)
    rng = np.random.default_rng(random_state)
    choice = rng.choice(idx_flat, count, replace=False) if count < idx_flat.size else idx_flat
    rr, cc = np.unravel_index(choice, valid.shape)
    dev = ref_elev.device
    rows = torch.from_numpy(rr.astype(np.float32)).to(dev)
    cols = torch.from_numpy(cc.astype(np.float32)).to(dev)
    pts_z = ref_elev[torch.from_numpy(rr).to(dev), torch.from_numpy(cc).to(dev)]
    dh = _dh_device(pts_z, rows, cols, tba_elev, 0.0, 0.0, False).cpu().numpy()
    return float(vshift_reduc_func(dh[np.isfinite(dh)])), int(count)


class VerticalShift(AffineCoreg):
    """Vertical translation alignment. Default reductor: median."""

    def __init__(self, vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
                 subsample: float | int = 1.0, initial_shift: tuple | None = None):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["affine"]["vshift_reduc_func"] = vshift_reduc_func

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        vshift, count = vertical_shift(
            ref_elev, tba_elev, inlier_mask, p["subsample"], p["random_state"],
            vshift_reduc_func=self._meta["inputs"]["affine"]["vshift_reduc_func"],
        )
        self._meta["outputs"]["affine"] = {"shift_z": vshift}
        self._meta["outputs"]["random"] = {"subsample_final": count}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        m[2, 3] += self._meta["outputs"]["affine"]["shift_z"]
        return m


class NuthKaab(AffineCoreg):
    """Nuth and Kääb (2011) iterative slope/aspect alignment."""

    def __init__(
        self,
        max_iterations: int = 10,
        offset_threshold: float = 0.001,
        bin_before_fit: bool = True,
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, int] = 72,
        bin_statistic: Callable = np.nanmedian,
        subsample: int | float = 5e5,
        vertical_shift: bool = True,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": offset_threshold}
        self._meta["inputs"]["fitorbin"] = {
            "fit_or_bin": "bin_and_fit" if bin_before_fit else "fit",
            "bin_sizes": bin_sizes,
            "bin_statistic": bin_statistic,
        }
        self.vertical_shift = vertical_shift

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        fb = self._meta["inputs"]["fitorbin"]
        n_bins = fb["bin_sizes"] if isinstance(fb["bin_sizes"], int) else list(fb["bin_sizes"].values())[0]
        (easting, northing, vertical), count, n_it = nuth_kaab(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            tolerance=self._meta["inputs"]["iterative"]["tolerance"],
            max_iterations=self._meta["inputs"]["iterative"]["max_iterations"],
            subsample=p["subsample"], random_state=p["random_state"],
            bin_before_fit=fb["fit_or_bin"] == "bin_and_fit", n_bins=n_bins,
        )
        # Sampling offsets convert to apply-translations with a sign flip.
        self._meta["outputs"]["affine"] = {
            "shift_x": -easting,
            "shift_y": -northing,
            "shift_z": vertical * self.vertical_shift,
        }
        self._meta["outputs"]["random"] = {"subsample_final": count}
        self._meta["outputs"]["iterative"] = {"last_iteration": n_it}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        aff = self._meta["outputs"]["affine"]
        m[0, 3] += aff["shift_x"]
        m[1, 3] += aff["shift_y"]
        m[2, 3] += aff["shift_z"]
        return m
