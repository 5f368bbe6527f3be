"""Affine coregistration: AffineCoreg, VerticalShift, Nuth & Kääb (2011), DhMinimize, ICP,
CPD and LZD.

Port of the raster-raster and raster-point paths of xdem_tpu/coreg/affine.py. Every solver
runs on the device of its grid, in float32 (nothing here turns TF32 on); where xdem_tpu has a
``lax.while_loop`` the port has a Python loop whose stop test reads one scalar per
iteration.

- Nuth & Kääb: slope and aspect from ``torch.gradient``, a seeded subsample without
  replacement (uniform scores from an explicit ``torch.Generator``, invalid pixels parked at
  -inf, top-k), then bilinear dh, aspect-binned medians and a closed-form 3x3 solve of the
  cosine model. Its draw differs from xdem_tpu's (torch and JAX generators give other bits
  from one seed), so the fit agrees with the reference to the coregistration tolerance. A
  raster-point pair takes slope and aspect in float64 and draws over the points with numpy,
  as xdem_tpu does; only the valid count crosses to the host.
- VerticalShift, DhMinimize, ICP, CPD and LZD draw their subsample on the host with
  ``np.random.default_rng(random_state).choice`` over the jointly valid pixels, exactly as
  xdem_tpu does, so the samples are identical and the fits agree closely.
- DhMinimize: Nelder-Mead on NMAD(dh) (medians as the mean of the two middle order
  statistics); ICP: point-to-plane (Low 2004) or point-to-point, the nearest neighbours by a
  blocked direct-difference argmin on the device (``nn_method="brute"``) or a scipy KD-tree on
  the host; CPD: the EM of Myronenko & Song (2010) with the (M, N) responsibilities on the
  device; LZD: the linearised 6-parameter least squares of Rosenholm & Torlegård (1988).
"""

from __future__ import annotations

import functools
import logging
import math
import warnings
from typing import Any, Callable, Literal

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.coreg.base import (
    Coreg,
    _check_matrix,
    _grid_side,
    _make_matrix_valid,
    invert_matrix,
    matrix_from_translations_rotations,
    translations_rotations_from_matrix,
)
from xdem_tpu_torch.georef import Affine, is_projected
from xdem_tpu_torch.ops.interp import interp_rowcol
from xdem_tpu_torch.ops.reductions import binned_median as _binned_median
from xdem_tpu_torch.ops.reductions import masked_median
from xdem_tpu_torch.ops.sampling import seed_from, topk_subsample
from xdem_tpu_torch.ops.transfer import device_mask
from xdem_tpu_torch.pointcloud import PointCloud


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
# Shared subsampling: numpy's draw over the jointly valid pixels, as xdem_tpu draws
# ======================================================================================


def _finite_all(arrays: list[torch.Tensor]) -> torch.Tensor:
    """Joint finite mask of same-shape grids."""
    out = torch.isfinite(arrays[0])
    for a in arrays[1:]:
        out &= torch.isfinite(a)
    return out


def _finite_median(x: torch.Tensor) -> torch.Tensor:
    """Median over the finite entries of `x` (0-dim tensor; NaN when none is finite)."""
    return masked_median(x, torch.isfinite(x))


def _gather_flat(arrays: list[torch.Tensor], flat_idx: torch.Tensor) -> torch.Tensor:
    """(K, n) float32: every grid of `arrays` at the flat pixel indices `flat_idx`."""
    return torch.stack([a.reshape(-1)[flat_idx].to(torch.float32) for a in arrays])


def _host_mask(mask: Any) -> np.ndarray:
    return mask.detach().cpu().numpy().astype(bool) if isinstance(mask, torch.Tensor) else np.asarray(mask, bool)


def _draw_pixels(grids: dict[str, Any], inlier_mask: Any, subsample: float | int, random_state: Any):
    """Draw the subsample over the pixels where every grid is finite and the inlier mask is
    set, with ``np.random.default_rng(random_state).choice`` as xdem_tpu draws it.

    `grids` maps names to device tensors, host arrays, or functions of the drawn
    (rows, cols) that give float64 values (variables defined everywhere, such as pixel or
    rotated coordinates, so never built over the whole grid). Device grids contribute one
    joint finite mask and one gather at the picks. Returns (rows, cols, count, values), with
    device values as float32 numpy, host values indexed as stored.
    """
    dev = {k: v for k, v in grids.items() if isinstance(v, torch.Tensor)}
    host = {k: np.asarray(v) for k, v in grids.items() if not isinstance(v, torch.Tensor) and not callable(v)}
    shape = next(iter(dev.values())).shape if dev else next(iter(host.values())).shape
    valid = _finite_all(list(dev.values())).cpu().numpy() if dev else np.ones(shape, bool)
    for v in host.values():
        valid &= np.isfinite(v)
    if inlier_mask is not None:
        valid &= _host_mask(inlier_mask)
    idx_flat = np.flatnonzero(valid)
    if idx_flat.size == 0:
        raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
    count = _count_from_subsample(subsample, idx_flat.size)
    rng = np.random.default_rng(random_state)
    choice = rng.choice(idx_flat, count, replace=False) if count < idx_flat.size else idx_flat
    rr, cc = np.unravel_index(choice, tuple(shape))
    vals: dict[str, np.ndarray] = {}
    if dev:
        device = next(iter(dev.values())).device
        gathered = _gather_flat(list(dev.values()), torch.from_numpy(choice).to(device)).cpu().numpy()
        vals.update(zip(dev, gathered))
    for k, v in host.items():
        vals[k] = v[rr, cc]
    for k, v in grids.items():
        if callable(v) and not isinstance(v, torch.Tensor):
            vals[k] = np.asarray(v(rr, cc), dtype=np.float64)
    return rr, cc, int(count), vals


def _points_on_grid(pts: PointCloud, transform: Affine, device: torch.device):
    """(rows, cols, z) of the points on a grid: float64 fractional pixel coordinates
    (centre convention) and heights, on `device`."""
    rows, cols = transform.rowcol(pts.x.to(device), pts.y.to(device))
    return rows, cols, pts.z.to(device)


def _draw_valid(valid: torch.Tensor, subsample: float | int, random_state: Any) -> tuple[torch.Tensor, int]:
    """Positions of a subsample of the True entries of `valid`, drawn as xdem_tpu draws them:
    numpy's ``choice(idx, count)`` over the valid positions ``idx`` equals
    ``idx[choice(len(idx), count)]`` for one seed, so only the valid count reaches the host
    and the positions are mapped on `valid`'s device. Returns (positions, count)."""
    n_valid = int(valid.sum())
    if n_valid == 0:
        raise ValueError("No valid points overlapping the raster.")
    count = _count_from_subsample(subsample, n_valid)
    idx = torch.nonzero(valid).reshape(-1)
    if count < n_valid:
        pos = np.random.default_rng(random_state).choice(n_valid, count, replace=False)
        idx = idx[torch.from_numpy(np.asarray(pos, np.int64)).to(idx.device)]
    return idx, count


def _subsample_pair_points(ref_elev: Any, tba_elev: Any, inlier_mask: Any, transform: Affine,
                           subsample: float | int, random_state: Any, aux_vars: dict[str, torch.Tensor]) -> dict:
    """The raster-point branch of :func:`_subsample_pair`, on the grid's device. A point is
    valid when its height is finite, it lies inside the grid, and its four bilinear
    neighbours are finite, inliers, and finite in every aux grid."""
    ref_is_pts = isinstance(ref_elev, PointCloud)
    pts, rst = (ref_elev, tba_elev) if ref_is_pts else (tba_elev, ref_elev)
    dev = rst.device
    h, w = rst.shape
    rows_f, cols_f, z = _points_on_grid(pts, transform, dev)
    rst_valid = torch.isfinite(rst)
    if inlier_mask is not None:
        rst_valid &= device_mask(inlier_mask, (h, w), dev)
    for v in aux_vars.values():
        rst_valid &= torch.isfinite(v)
    flat_valid = rst_valid.reshape(-1)
    inside = (rows_f >= 0) & (rows_f <= h - 1) & (cols_f >= 0) & (cols_f <= w - 1)
    r0 = torch.clamp(torch.floor(torch.where(inside, rows_f, 0.0)), 0, h - 1).long()
    c0 = torch.clamp(torch.floor(torch.where(inside, cols_f, 0.0)), 0, w - 1).long()
    r1, c1 = torch.clamp(r0 + 1, max=h - 1), torch.clamp(c0 + 1, max=w - 1)
    valid = torch.isfinite(z) & inside
    for rr, cc in ((r0, c0), (r0, c1), (r1, c0), (r1, c1)):
        valid &= flat_valid[rr * w + cc]
    idx, count = _draw_valid(valid, subsample, random_state)
    rows, cols = rows_f[idx], cols_f[idx]
    out = {"pts_z": z[idx].to(torch.float32), "rows": rows.to(torch.float32), "cols": cols.to(torch.float32),
           "raster": rst.to(torch.float32), "invert": not ref_is_pts, "count": count}
    if aux_vars:
        nearest = torch.round(rows).long().clamp(0, h - 1) * w + torch.round(cols).long().clamp(0, w - 1)
        out["aux"] = {k: v.reshape(-1)[nearest].to(torch.float32) for k, v in aux_vars.items()}
    return out


def _subsample_pair(ref_elev: Any, tba_elev: Any, inlier_mask: Any, transform: Affine,
                    subsample: float | int, random_state: Any, aux_vars: dict[str, Any] | None = None) -> dict:
    """Subsample a raster-raster or raster-point pair for the shift-and-compare methods: the
    reference-side heights and the fractional pixel coordinates of the picks as float32
    tensors on the grid's device, the grid to interpolate (`raster`; `invert` when it is the
    reference), the count, and float32 aux values at the picks."""
    aux_vars = aux_vars or {}
    if isinstance(ref_elev, PointCloud) or isinstance(tba_elev, PointCloud):
        return _subsample_pair_points(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state, aux_vars)
    rr, cc, count, vals = _draw_pixels({"__ref__": ref_elev, "__tba__": tba_elev, **aux_vars},
                                       inlier_mask, subsample, random_state)
    dev = tba_elev.device
    out = {
        "pts_z": torch.from_numpy(vals["__ref__"]).to(dev),
        "rows": torch.from_numpy(rr.astype(np.float32)).to(dev),
        "cols": torch.from_numpy(cc.astype(np.float32)).to(dev),
        "raster": tba_elev,
        "invert": False,
        "count": count,
    }
    if aux_vars:
        out["aux"] = {k: np.asarray(vals[k]).astype(np.float32) for k in aux_vars}
    return out


def _subsample_values_points(ref_elev: Any, tba_elev: Any, inlier_mask: Any, transform: Affine,
                             subsample: float | int, random_state: Any, aux_vars: dict[str, Any]):
    """The raster-point branch of :func:`_subsample_pair_values`, on the grid's device: the
    grid and every aux grid are interpolated bilinearly at the points (float32 pixel
    coordinates, as xdem_tpu forms them); a point is valid when every interpolated value and
    its height are finite and its nearest pixel is an inlier. Aux functions of (rows, cols)
    are evaluated at the picks only."""
    ref_is_pts = isinstance(ref_elev, PointCloud)
    pts, rst = (ref_elev, tba_elev) if ref_is_pts else (tba_elev, ref_elev)
    dev = rst.device
    h, w = rst.shape
    rows_f, cols_f, z = _points_on_grid(pts, transform, dev)
    r32, c32 = rows_f.to(torch.float32), cols_f.to(torch.float32)
    grid_keys = [k for k, v in aux_vars.items() if not callable(v)]
    vals = torch.stack([interp_rowcol(as_tensor(g, device=dev), r32, c32, method="linear")
                        for g in [rst] + [aux_vars[k] for k in grid_keys]])
    valid = torch.isfinite(vals).all(0) & torch.isfinite(z)
    if inlier_mask is not None:
        nearest = torch.round(rows_f).clamp(0, h - 1).long() * w + torch.round(cols_f).clamp(0, w - 1).long()
        valid &= device_mask(inlier_mask, (h, w), dev).reshape(-1)[nearest]
    idx, _ = _draw_valid(valid, subsample, random_state)
    sub_vals = vals[:, idx].to(torch.float64).cpu().numpy()
    aux = {k: sub_vals[1 + i] for i, k in enumerate(grid_keys)}
    rr, cc = (v[idx].to(torch.float64).cpu().numpy() for v in (r32, c32))
    for k, v in aux_vars.items():
        if k not in aux:
            aux[k] = np.asarray(v(rr, cc), dtype=np.float64)
    sub_pts_z = z[idx].cpu().numpy()
    x, y = (v[idx].cpu().numpy() for v in (pts.x.to(dev), pts.y.to(dev)))
    aux = {k: aux[k] for k in aux_vars}
    return (sub_pts_z, sub_vals[0], x, y, aux) if ref_is_pts else (sub_vals[0], sub_pts_z, x, y, aux)


def _subsample_pair_values(ref_elev: Any, tba_elev: Any, inlier_mask: Any, transform: Affine,
                           subsample: float | int, random_state: Any, aux_vars: dict[str, Any] | None = None):
    """Subsample a raster-raster pair at common pixels, or a raster-point pair at the points:
    (ref, tba, x, y, aux) as float64 numpy, with x, y the world coordinates of the pixel
    centres or of the points."""
    aux_vars = aux_vars or {}
    if isinstance(ref_elev, PointCloud) or isinstance(tba_elev, PointCloud):
        return _subsample_values_points(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state,
                                        aux_vars)
    rr, cc, _, vals = _draw_pixels({"__ref__": ref_elev, "__tba__": tba_elev, **aux_vars},
                                   inlier_mask, subsample, random_state)
    x, y = transform.xy(rr, cc)
    aux = {k: np.asarray(vals[k]).astype(np.float64) for k in aux_vars}
    return vals["__ref__"].astype(np.float64), vals["__tba__"].astype(np.float64), x, y, aux


def _standardize_epc(ref_epc: np.ndarray, tba_epc: np.ndarray, scale_std: bool = True):
    """Centroid removal and NMAD standardisation of 3 x N point clouds."""
    centroid = np.median(ref_epc, axis=1)
    ref_epc = ref_epc - centroid[:, None]
    tba_epc = tba_epc - centroid[:, None]
    if scale_std:
        def _nmad(v):
            med = np.nanmedian(v)
            return 1.4826 * np.nanmedian(np.abs(v - med))

        std_fac = np.mean([_nmad(ref_epc[0]), _nmad(ref_epc[1]), _nmad(ref_epc[2])])
    else:
        std_fac = 1.0
    return ref_epc / std_fac if scale_std else ref_epc, tba_epc / std_fac if scale_std else tba_epc, \
        (float(centroid[0]), float(centroid[1]), float(centroid[2])), float(std_fac)


def _apply_matrix_pts_mat(mat: np.ndarray, matrix: np.ndarray, invert: bool = False) -> np.ndarray:
    """Apply a 4x4 matrix to a 3 x N point array."""
    if invert:
        matrix = invert_matrix(matrix)
    pts = np.vstack([mat, np.ones((1, mat.shape[1]))])
    return (np.asarray(matrix) @ pts)[:3]


def _rotation_xyz(alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx of three 0-dim tensors (radians): the extrinsic x-y-z composition of
    matrix_from_translations_rotations."""
    one, zero = torch.ones_like(alpha), torch.zeros_like(alpha)
    ca, sa, cb, sb, cg, sg = (torch.cos(alpha), torch.sin(alpha), torch.cos(beta), torch.sin(beta),
                              torch.cos(gamma), torch.sin(gamma))
    rx = torch.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca]).reshape(3, 3)
    ry = torch.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb]).reshape(3, 3)
    rz = torch.stack([cg, -sg, zero, sg, cg, zero, zero, zero, one]).reshape(3, 3)
    return rz @ ry @ rx


def _rigid_step(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    step = torch.eye(4, dtype=R.dtype, device=R.device)
    step[:3, :3] = R
    step[:3, 3] = t
    return step


# ======================================================================================
# Nuth & Kääb
# ======================================================================================


def _cosine_normal_equations(Gm: torch.Tensor, yv: torch.Tensor, ok: torch.Tensor):
    """float64 normal equations (G^T G, G^T y) of y = A cos + B sin + C over the `ok` rows;
    leading batch axes allowed. Float64, so that the float32 answer does not depend on how a
    batch is cut: the library picks its matmul kernel by batch size, and mesh= splits batches
    and sums partial equations."""
    Gw = (Gm * ok.to(Gm.dtype)[..., None]).double()
    lhs = Gw.transpose(-1, -2) @ Gm.double()
    rhs = (Gw.transpose(-1, -2) @ torch.where(ok, yv, 0.0).double()[..., None])[..., 0]
    return lhs, rhs


def _solve_cosine(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The float32 solution of the normal equations with a 1e-12 ridge. ``solve_ex``:
    ``linalg.solve``'s own singularity check would read the answer back every step (the ridge
    keeps each system regular)."""
    ridge = 1e-12 * torch.eye(3, dtype=torch.float64, device=lhs.device)
    return torch.linalg.solve_ex(lhs + ridge, rhs).result.to(torch.float32)


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
    from xdem_tpu_torch.parallel.mesh import _one_shard

    def binned(ys, bins, valids):
        return _binned_median(ys[0], bins[0], valids[0], n_bins)

    return _nuth_kaab_iterations([pts_z], [rows], [cols], [raster], [slope_tan], [aspect], res_x, res_y, tolerance,
                                 max_iterations, n_bins, invert, bin_before_fit, _one_shard(pts_z.device),
                                 lambda xs: _finite_median(xs[0]), binned)


def _nuth_kaab_iterations(z: list, r: list, c: list, rasters: list, slope_tan: list, aspect: list, res_x: float,
                          res_y: float, tolerance: float, max_iterations: int, n_bins: int, invert: bool,
                          bin_before_fit: bool, mesh: Any, median: Callable, binned_median: Callable):
    """The loop of :func:`_nuth_kaab_solve` over the shards of a 1-D `mesh`: one list entry
    per shard (its points and its copy of the raster). The reductions are given:
    ``median(dh)`` (the finite median of the shards' values, on the root) and
    ``binned_median(y, bin_idx, valid)`` (the per-aspect-bin medians); the point-sum mode's
    normal equations are summed across the shards."""
    from xdem_tpu_torch.parallel._collectives import psum, replicate

    dev = mesh.root
    f32 = torch.float32
    bin_width = 2 * math.pi / n_bins
    bin_centers = (torch.arange(n_bins, dtype=f32, device=dev) + 0.5) * bin_width
    G = torch.stack([torch.cos(bin_centers), torch.sin(bin_centers), torch.ones(n_bins, dtype=f32, device=dev)], 1)
    bin_idx = [torch.clamp((a / bin_width).to(torch.int32), 0, n_bins - 1) for a in aspect]

    sx = torch.zeros((), dtype=f32, device=dev)
    sy = torch.zeros((), dtype=f32, device=dev)
    vshift = torch.zeros((), dtype=f32, device=dev)
    stat = math.inf
    tol32 = float(np.float32(tolerance))  # the stop rule compares in f32
    it = 0
    while it < max_iterations and not (it >= 3 and stat < tol32):
        dh = [_dh_device(*a, invert) for a in zip(z, r, c, rasters, replicate(sx, mesh), replicate(sy, mesh))]
        vshift = median(dh)
        y = [(d - v) / s for d, v, s in zip(dh, replicate(vshift, mesh), slope_tan)]
        valid = [torch.isfinite(v) for v in y]
        if bin_before_fit:
            med = binned_median(y, bin_idx, valid)
            p = _solve_cosine(*_cosine_normal_equations(G, med, torch.isfinite(med)))
        else:
            eqs = [_cosine_normal_equations(torch.stack([torch.cos(a), torch.sin(a), torch.ones_like(a)], 1), yv, ok)
                   for a, yv, ok in zip(aspect, y, valid)]
            p = _solve_cosine(psum([e[0] for e in eqs], mesh), psum([e[1] for e in eqs], mesh))
        north_px, east_px = p[0], p[1]  # a*cos(b), a*sin(b)
        sx = sx + east_px
        sy = sy + north_px
        stat = float(torch.hypot(east_px, north_px))
        it += 1
    return float(sx * res_x), float(sy * res_y), float(vshift), stat, it


def _interp_tiles(tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of (T, H, W) grids at (T, K) fractional pixel coordinates, each
    row of points in its own grid, with ops.interp's rules (NaN outside or next to NaN)."""
    t, h, w = tiles.shape
    flat = tiles.reshape(-1)
    base = (torch.arange(t, device=tiles.device) * (h * w))[:, None]
    r0, c0 = torch.floor(rows).long(), torch.floor(cols).long()
    fr, fc = rows - r0, cols - c0

    def at(r, c):
        return flat[base + torch.clamp(r, 0, h - 1) * w + torch.clamp(c, 0, w - 1)]

    top = at(r0, c0) * (1 - fc) + at(r0, c0 + 1) * fc
    bot = at(r0 + 1, c0) * (1 - fc) + at(r0 + 1, c0 + 1) * fc
    vals = top * (1 - fr) + bot * fr
    inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    return torch.where(inside, vals, torch.nan)


def _nuth_kaab_solve_batched(*args, **kwargs) -> tuple[torch.Tensor, ...]:
    """:func:`_nuth_kaab_solve` over a leading tile axis: (T, K) points in (T, H, W) grids;
    the steps of :func:`_nuth_kaab_batched_steps` until no tile is active (one host read per
    iteration). Returns float32 tensors (shift_x m, shift_y m, vshift, last step px, steps)
    per tile."""
    for active, out in _nuth_kaab_batched_steps(*args, **kwargs):
        if not bool(active.any()):
            break
    return out


def _nuth_kaab_batched_steps(
    pts_z: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    rasters: torch.Tensor,
    slope_tan: torch.Tensor,
    aspect: torch.Tensor,
    res_x: float,
    res_y: float,
    tolerance: float,
    max_iterations: int = 10,
    n_bins: int = 72,
    bin_before_fit: bool = True,
):
    """The iterations of the batched Nuth & Kääb solve, as a generator: each step yields the
    (T,) mask of tiles still active and the results so far, float32 tensors (shift_x m,
    shift_y m, vshift, last step px, steps) per tile, and reads nothing back to the host, so
    a caller can step several batches (one per device) before it waits.

    Every tile runs the single solve's stop rule (at least 3 steps, then the offset step below
    `tolerance` in float32); a tile that has stopped keeps its values while the others go on,
    as a vmapped while loop does. Medians are 0.5 * (lo + hi) of sorts by (tile, value) and
    (tile, bin, value); NaN picks reach neither.
    """
    dev, f32 = pts_z.device, torch.float32
    t, k = pts_z.shape
    bin_width = 2 * math.pi / n_bins
    bin_centers = (torch.arange(n_bins, dtype=f32, device=dev) + 0.5) * bin_width
    G = torch.stack([torch.cos(bin_centers), torch.sin(bin_centers), torch.ones(n_bins, dtype=f32, device=dev)], 1)
    tile_id = torch.arange(t, device=dev)[:, None].expand(t, k)
    bin_ids = tile_id * n_bins + torch.clamp((aspect / bin_width).to(torch.int32), 0, n_bins - 1).long()
    Gp = torch.stack([torch.cos(aspect), torch.sin(aspect), torch.ones_like(aspect)], -1)

    sx = torch.zeros(t, dtype=f32, device=dev)
    sy = torch.zeros(t, dtype=f32, device=dev)
    vshift = torch.zeros(t, dtype=f32, device=dev)
    stat = torch.full((t,), math.inf, dtype=f32, device=dev)
    it = torch.zeros(t, dtype=torch.int64, device=dev)
    tol32 = float(np.float32(tolerance))
    active = torch.ones(t, dtype=torch.bool, device=dev)
    if max_iterations <= 0:  # no step: the initial state, as a while loop that never runs
        yield torch.zeros_like(active), (sx * res_x, sy * res_y, vshift, stat, it)
    for _ in range(max_iterations):
        dh = pts_z - _interp_tiles(rasters, rows - sy[:, None], cols + sx[:, None])
        vs = _binned_median(dh.reshape(-1), tile_id.reshape(-1), torch.isfinite(dh).reshape(-1), t)
        y = (dh - vs[:, None]) / slope_tan
        valid = torch.isfinite(y)
        if bin_before_fit:
            med = _binned_median(y.reshape(-1), bin_ids.reshape(-1), valid.reshape(-1), t * n_bins).reshape(t, n_bins)
            p = _solve_cosine(*_cosine_normal_equations(G.expand(t, n_bins, 3), med, torch.isfinite(med)))
        else:
            p = _solve_cosine(*_cosine_normal_equations(Gp, y, valid))
        north_px, east_px = p[:, 0], p[:, 1]
        sx = torch.where(active, sx + east_px, sx)
        sy = torch.where(active, sy + north_px, sy)
        vshift = torch.where(active, vs, vshift)
        stat = torch.where(active, torch.hypot(east_px, north_px), stat)
        it = it + active.long()
        active = active & (it < max_iterations) & ~((it >= 3) & (stat < tol32))
        yield active, (sx * res_x, sy * res_y, vshift, stat, it)


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
    mesh: Any = None,
) -> dict[str, float]:
    """Raster-raster Nuth & Kääb on the inputs' device: slope/aspect, seeded subsample over
    the joint valid mask, and the iterative solve (with a `mesh`, the subsample drawn here is
    split over the mesh for the solve: `parallel.coreg.nuth_kaab_points_sharded`)."""
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

    sx, sy, vshift, stat, it = _solver(mesh)(
        pts_z, rr, cc, tba, st, asp, res_x, res_y, tolerance,
        max_iterations=max_iterations, n_bins=n_bins, invert=False, bin_before_fit=bin_before_fit,
    )
    return {"shift_x": sx, "shift_y": sy, "vshift": vshift, "stat": stat, "iterations": it,
            "n_valid": n_valid, "count": count, "populated": populated}


def _solver(mesh: Any) -> Callable:
    """The Nuth & Kääb iterations: on one device, or with the points split over `mesh`."""
    if mesh is None:
        return _nuth_kaab_solve
    from xdem_tpu_torch.parallel.coreg import nuth_kaab_points_sharded
    from xdem_tpu_torch.parallel.mesh import as_mesh_1d

    return functools.partial(nuth_kaab_points_sharded, mesh=as_mesh_1d(mesh))


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
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[tuple[float, float, float], int, int]:
    """Nuth and Kääb (2011) on a raster pair; returns ((east, north, vertical) sampling
    offsets in m, final subsample count, iterations). ``z_name`` names a point cloud's
    elevation column (a PointCloud carries its heights as ``z``). With ``mesh=`` (a
    `parallel.Mesh`), the subsample is drawn as on one device and its points are split over
    the mesh, every median an exact distributed order statistic: the fit equals the
    single-device fit to the bit in the default ``bin_before_fit`` mode."""
    logging.info("Running Nuth and Kääb (2011) coregistration")
    if crs is not None and not is_projected(crs):
        raise NotImplementedError(
            f"Nuth and Kääb coregistration needs planar (projected) coordinates, but the input CRS "
            f"is {crs}. Reproject both elevations to a local projected system first."
        )
    if isinstance(ref_elev, PointCloud) and isinstance(tba_elev, PointCloud):
        raise TypeError(
            "The Nuth and Kääb (2011) coregistration does not support two point clouds, one elevation "
            "dataset in the pair must be a DEM."
        )
    if isinstance(ref_elev, PointCloud) or isinstance(tba_elev, PointCloud):
        return _nuth_kaab_points(ref_elev, tba_elev, inlier_mask, transform, tolerance, max_iterations, subsample,
                                 random_state, bin_before_fit, n_bins, mesh)
    inlier = device_mask(inlier_mask, tuple(ref_elev.shape), ref_elev.device)
    out = _nuth_kaab_rst_rst_device(
        ref_elev, tba_elev, inlier, seed_from(random_state), subsample,
        transform.xres, transform.yres, tolerance,
        max_iterations=int(max_iterations), n_bins=int(n_bins), bin_before_fit=bin_before_fit, mesh=mesh,
    )
    sx, sy, vshift = out["shift_x"], out["shift_y"], out["vshift"]
    if out["n_valid"] == 0:
        raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
    _check_nuth_kaab(out["iterations"], int(max_iterations), out["stat"], tolerance, sx, sy, vshift,
                     out["populated"], n_bins)
    return (sx, sy, vshift), int(min(out["count"], out["n_valid"])), out["iterations"]


def _check_nuth_kaab(it: int, max_iterations: int, stat: float, tolerance: float, sx: float, sy: float,
                     vshift: float, populated: int, n_bins: int) -> None:
    """The warnings and the refusal of a Nuth & Kääb fit's outcome."""
    if not (np.isfinite(sx) and np.isfinite(sy) and np.isfinite(vshift)):
        raise ValueError(
            "No valid points remain in the subsample: either the shift to correct moved the "
            "grids out of overlap, or the solver diverged. Passing subsample=1 keeps every "
            "valid pixel available at each iteration."
        )
    _warn_if_not_converged(it, max_iterations, stat, tolerance, sx, sy)
    if populated < n_bins // 4:
        logging.warning(
            "Only %d/%d aspect bins are well-populated: the terrain faces few directions, so "
            "the Nuth and Kääb horizontal offsets are poorly constrained and may diverge. "
            "Use a larger extent with diverse aspects, or DhMinimize/LZD instead.",
            populated, n_bins,
        )


def _grad_slope_aspect(grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slope tangent (pixel units, NaN where it is ~0) and aspect of a grid in float64 on its
    device: xdem_tpu's host formulas."""
    gradient_y, gradient_x = torch.gradient(grid.to(torch.float64))
    slope_tan = torch.sqrt(gradient_x**2 + gradient_y**2)
    aspect = torch.atan2(-gradient_x, gradient_y) + math.pi
    return torch.where(torch.isclose(slope_tan, torch.zeros_like(slope_tan)), torch.nan, slope_tan), aspect


def _nuth_kaab_points(ref_elev: Any, tba_elev: Any, inlier_mask: Any, transform: Affine, tolerance: float,
                      max_iterations: int, subsample: float | int, random_state: Any, bin_before_fit: bool,
                      n_bins: int, mesh: Any = None) -> tuple[tuple[float, float, float], int, int]:
    """Nuth and Kääb on a raster-point pair: slope and aspect of the grid side, the points'
    subsample (numpy's draw, as xdem_tpu's), and the iterative solve with the grid as the
    reference when it is one (`invert`)."""
    slope_tan, aspect = _grad_slope_aspect(_grid_side(ref_elev, tba_elev))
    sub = _subsample_pair(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state,
                          aux_vars={"slope_tan": slope_tan, "aspect": aspect})
    del slope_tan, aspect
    asp, st = sub["aux"]["aspect"], sub["aux"]["slope_tan"]
    hist = torch.histc(asp[torch.isfinite(asp)], bins=n_bins, min=0.0, max=2 * math.pi)
    populated = int((hist > 10).sum())
    sx, sy, vshift, stat, it = _solver(mesh)(
        sub["pts_z"], sub["rows"], sub["cols"], sub["raster"], st, asp, transform.xres, transform.yres, tolerance,
        max_iterations=int(max_iterations), n_bins=int(n_bins), invert=bool(sub["invert"]),
        bin_before_fit=bin_before_fit,
    )
    _check_nuth_kaab(it, int(max_iterations), stat, tolerance, sx, sy, vshift, populated, n_bins)
    return (sx, sy, vshift), sub["count"], it


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

    def _fit_rst_pts(self, **kwargs: Any) -> None:
        # Every affine method fits a raster-point pair with its raster-raster solver, whose
        # subsample draws at the points (_subsample_pair, _subsample_pair_values).
        self._fit_rst_rst(**kwargs)

    @classmethod
    def from_matrix(cls, matrix: np.ndarray) -> "AffineCoreg":
        return cls(matrix=matrix)  # type: ignore[call-arg]

    @classmethod
    def from_translations(cls, x_off: float = 0.0, y_off: float = 0.0, z_off: float = 0.0) -> "AffineCoreg":
        return cls.from_matrix(matrix_from_translations_rotations(t_x=x_off, t_y=y_off, t_z=z_off))

    @classmethod
    def from_rotations(cls, x_rot: float = 0.0, y_rot: float = 0.0, z_rot: float = 0.0,
                       use_degrees: bool = True) -> "AffineCoreg":
        return cls.from_matrix(matrix_from_translations_rotations(
            alpha=x_rot, beta=y_rot, gamma=z_rot, use_degrees=use_degrees))

    @property
    def centroid(self) -> tuple[float, float, float] | None:
        return self._meta["outputs"].get("affine", {}).get("centroid")


def _masked_median_diff(ref: torch.Tensor, tba: torch.Tensor, inlier: torch.Tensor) -> tuple[float, int]:
    """Median of (ref - tba) over the inlier and finite pixels, and their count."""
    dh = torch.where(inlier, ref - tba, torch.nan)
    return float(_finite_median(dh)), int(torch.isfinite(dh).sum())


def vertical_shift(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    subsample: float | int,
    random_state: Any,
    vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[float, int]:
    """Vertical shift of a raster pair: reduce the elevation differences. Returns (shift, count).

    The default (every valid pixel, median) is one device reduction. A subsample or another
    reductor draws pixels with numpy's generator from `random_state`, the same draw as
    xdem_tpu, evaluates dh on the device and reduces on the host. ``z_name`` as in
    `nuth_kaab`. With ``mesh=``, the default path splits the rows of the pair over the mesh
    and the median is the exact distributed order statistic (equal to the single-device fit
    to the bit); a subsample is drawn as on one device and its gathers are split, a median
    reductor reducing across the shards and any other on the host.
    """
    logging.info("Running vertical shift coregistration")
    m1 = None
    if mesh is not None:
        from xdem_tpu_torch.parallel import coreg as pcoreg
        from xdem_tpu_torch.parallel.mesh import as_mesh_1d

        m1 = as_mesh_1d(mesh)
    points = isinstance(ref_elev, PointCloud) or isinstance(tba_elev, PointCloud)
    if (isinstance(subsample, float) and subsample == 1.0 and vshift_reduc_func in (np.median, np.nanmedian)
            and not points):
        inlier = device_mask(inlier_mask, tuple(ref_elev.shape), ref_elev.device)
        if m1 is None:
            med, n_valid = _masked_median_diff(ref_elev, tba_elev, inlier)
        else:
            med, n_valid = pcoreg.masked_median_diff_sharded(ref_elev, tba_elev, inlier, m1)
        if n_valid == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        return med, n_valid
    sub = _subsample_pair(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state)
    args = (sub["pts_z"], sub["rows"], sub["cols"], sub["raster"])
    if m1 is None:
        dh = _dh_device(*args, 0.0, 0.0, sub["invert"])
    elif vshift_reduc_func in (np.median, np.nanmedian):
        med, n_fin = pcoreg.dh_median_points_sharded(*args, m1, invert=sub["invert"])
        if n_fin == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        return med, sub["count"]
    else:
        dh = pcoreg.dh_shifted_points_sharded(*args, 0.0, 0.0, m1, invert=sub["invert"])
    dh = dh.cpu().numpy()
    return float(vshift_reduc_func(dh[np.isfinite(dh)])), sub["count"]


class VerticalShift(AffineCoreg):
    """Vertical translation alignment. Default reductor: median."""

    _supports_mesh_fit = True  # fit(..., mesh=): exact distributed median (parallel/coreg.py)

    def __init__(self, vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
                 subsample: float | int = 1.0, initial_shift: tuple | None = None):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["affine"]["vshift_reduc_func"] = vshift_reduc_func

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        vshift, count = vertical_shift(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"],
            vshift_reduc_func=self._meta["inputs"]["affine"]["vshift_reduc_func"], mesh=kwargs.get("mesh"),
        )
        self._meta["outputs"]["affine"] = {"shift_z": vshift}
        self._meta["outputs"]["random"] = {"subsample_final": count}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        m[2, 3] += self._meta["outputs"]["affine"]["shift_z"]
        return m


class NuthKaab(AffineCoreg):
    """Nuth and Kääb (2011) iterative slope/aspect alignment."""

    _supports_mesh_fit = True  # fit(..., mesh=): point-sharded iterations, exact medians

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
            bin_before_fit=fb["fit_or_bin"] == "bin_and_fit", n_bins=n_bins, mesh=kwargs.get("mesh"),
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


# ======================================================================================
# DhMinimize
# ======================================================================================


def _nmad_dev(x: torch.Tensor) -> torch.Tensor:
    """NMAD over the finite entries, with medians as the mean of the two middle order
    statistics (the formula of xdem_tpu, not torch's lower-middle median)."""
    med = _finite_median(x)
    return 1.4826 * _finite_median(torch.abs(x - med))


def _nelder_mead_2d(f: Callable[[torch.Tensor], torch.Tensor]):
    """2-D Nelder-Mead of an objective `f(v)` (a float32 2-vector on the CPU to a 0-dim
    float32 CPU tensor), with scipy's defaults: reflect/expand/contract/shrink coefficients
    1, 2, 0.5, 0.5; xatol = fatol = 1e-4; at most 400 iterations; start (1, 1) with a 5 %
    initial simplex. The simplex lives on the CPU in float32; the vertices are ordered by a
    stable sort, as JAX's argsort is stable. Returns (x_best, f_best, iterations)."""
    x0 = torch.tensor([1.0, 1.0])
    s = torch.stack([x0, x0 + torch.tensor([0.05, 0.0]), x0 + torch.tensor([0.0, 0.05])])
    fv = torch.stack([f(s[0]), f(s[1]), f(s[2])])

    def _sorted(s, fv):
        idx = torch.argsort(fv, stable=True)
        return s[idx], fv[idx]

    it = 0
    while True:
        s, fv = _sorted(s, fv)
        xa = torch.max(torch.abs(s[1:] - s[0]))
        fa = torch.max(torch.abs(fv[1:] - fv[0]))
        if not (it < 400 and bool((xa > 1e-4) | (fa > 1e-4))):
            break
        centroid = (s[0] + s[1]) / 2.0
        xr = centroid + (centroid - s[2])
        fr = f(xr)
        if fr < fv[0]:  # expand
            xe = centroid + 2.0 * (centroid - s[2])
            fe = f(xe)
            s[2], fv[2] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < fv[1]:  # reflect
            s[2], fv[2] = xr, fr
        else:  # contract, outside or inside
            outside = bool(fr < fv[2])
            xc = centroid + 0.5 * (centroid - s[2]) if outside else centroid - 0.5 * (centroid - s[2])
            fc = f(xc)
            if fc < (fr if outside else fv[2]):
                s[2], fv[2] = xc, fc
            else:  # shrink towards the best vertex
                s = torch.stack([s[0], s[0] + 0.5 * (s[1] - s[0]), s[0] + 0.5 * (s[2] - s[0])])
                fv = torch.stack([fv[0], f(s[1]), f(s[2])])
        it += 1
    return s[0], fv[0], it


def _dh_minimize_nm_device(pts_z, rows, cols, raster, res_x: float, res_y: float, invert: bool):
    """Nelder-Mead of NMAD(dh(sx, sy)) over the points, each objective on their device.
    Returns (x_best metres, f_best, iterations, median dh at the optimum)."""
    res = torch.tensor([res_x, res_y], dtype=torch.float32)

    def f(v):
        sx, sy = (v / res).tolist()  # float32 quotients, exact as Python floats
        return _nmad_dev(_dh_device(pts_z, rows, cols, raster, sx, sy, invert)).cpu()

    x_best, f_best, it = _nelder_mead_2d(f)
    sx, sy = (x_best / res).tolist()
    vshift = _finite_median(_dh_device(pts_z, rows, cols, raster, sx, sy, invert))
    return x_best, f_best, it, vshift


def dh_minimize(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    subsample: float | int,
    random_state: Any,
    fit_minimizer: Any = None,
    fit_loss_func: Callable | None = None,
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[tuple[float, float, float], int]:
    """Elevation-difference minimisation: minimise a dispersion loss (default NMAD) of dh
    over a 2-D shift. Returns ((east, north, vertical) offsets in m, subsample count).
    ``z_name`` as in `nuth_kaab`. With ``mesh=``, the subsample's points are split over the
    mesh: the default Nelder-Mead reduces its NMAD with exact distributed medians (equal to
    the single-device fit to the bit), a host minimizer reads dh gathered from the shards."""
    shifts, count, _ = _dh_minimize(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state,
                                    fit_minimizer, fit_loss_func, mesh)
    return shifts, count


def _dh_minimize(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state, fit_minimizer,
                 fit_loss_func, mesh=None) -> tuple[tuple[float, float, float], int, int]:
    """`dh_minimize`, also returning the Nelder-Mead iterations (0 for a host minimizer)."""
    logging.info("Running dh minimization coregistration.")
    sub = _subsample_pair(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state)
    args = (sub["pts_z"], sub["rows"], sub["cols"], sub["raster"])
    invert = sub["invert"]
    res_x, res_y = transform.xres, transform.yres
    m1 = None
    if mesh is not None:
        from xdem_tpu_torch.parallel import coreg as pcoreg
        from xdem_tpu_torch.parallel.mesh import as_mesh_1d

        m1 = as_mesh_1d(mesh)
    if fit_minimizer is None and fit_loss_func is None:
        if m1 is None:
            x_best, _, it, vshift = _dh_minimize_nm_device(*args, res_x, res_y, invert)
        else:
            x_best, _, it, vshift = pcoreg.dh_minimize_nm_sharded(*args, res_x, res_y, m1, invert=invert)
        east, north = (-float(v) for v in x_best)
        return (east, north, float(vshift)), sub["count"], int(it)

    from scipy.optimize import minimize

    def dh_at(v) -> torch.Tensor:
        if m1 is not None:
            return pcoreg.dh_shifted_points_sharded(*args, v[0] / res_x, v[1] / res_y, m1, invert=invert)
        return _dh_device(*args, v[0] / res_x, v[1] / res_y, invert)

    if fit_loss_func is None:
        def objective(v):
            return float(_nmad_dev(dh_at(v)))
    else:
        def objective(v):
            return float(fit_loss_func(dh_at(v).cpu().numpy()))

    minimizer = fit_minimizer or minimize
    # Nelder-Mead struggles from exactly (0, 0).
    result = minimizer(objective, (1.0, 1.0), method="Nelder-Mead") if minimizer is minimize \
        else minimizer(objective, (1.0, 1.0))
    east, north = -float(result.x[0]), -float(result.x[1])
    vshift = float(np.nanmedian(dh_at((-east, -north)).cpu().numpy()))
    return (east, north, vshift), sub["count"], 0


class DhMinimize(AffineCoreg):
    """Direct 2-D minimisation of a dispersion loss of dh (default: Nelder-Mead on NMAD)."""

    _supports_mesh_fit = True  # fit(..., mesh=): point-sharded NM with distributed medians

    def __init__(self, fit_minimizer: Any = None, fit_loss_func: Callable | None = None,
                 subsample: int | float = 5e5, initial_shift: tuple | None = None):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["fitorbin"] = {"fit_minimizer": fit_minimizer, "fit_loss_func": fit_loss_func}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        fb = self._meta["inputs"]["fitorbin"]
        (east, north, vshift), count, n_it = _dh_minimize(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"],
            fb["fit_minimizer"], fb["fit_loss_func"], kwargs.get("mesh"),
        )
        self._meta["outputs"]["affine"] = {"shift_x": east, "shift_y": north, "shift_z": vshift}
        self._meta["outputs"]["random"] = {"subsample_final": count}
        self._meta["outputs"]["iterative"] = {"last_iteration": n_it}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        aff = self._meta["outputs"]["affine"]
        m[0, 3] += aff["shift_x"]
        m[1, 3] += aff["shift_y"]
        m[2, 3] += aff["shift_z"]
        return m


# ======================================================================================
# ICP
# ======================================================================================


# Coordinate that pads reference clouds to a block multiple: it squares to ~3e30 (finite in
# float32, unlike inf, whose differences can go NaN), so a padded point never wins an argmin.
_NN_PAD_COORD = 1e15


def _nn_planes_scan(ref_pts: torch.Tensor, rblk: int = 2048):
    """An ``nn(q) -> (index, d2)`` nearest-neighbour search over a fixed (N, 3) reference
    cloud: direct-difference squared distances, block by block of `rblk` reference points,
    with a running argmin. Never the |a|^2 + |b|^2 - 2ab expansion, which loses ~1e-4
    relative to cancellation.

    Ties go to the lowest reference index: within a block ``torch.min`` returns the first
    minimum, and a later block takes over only when strictly closer."""
    n = ref_pts.shape[0]
    pad = torch.full(((-n) % rblk, 3), _NN_PAD_COORD, dtype=ref_pts.dtype, device=ref_pts.device)
    r = torch.cat([ref_pts, pad])
    rx, ry, rz = (r[:, k].reshape(-1, rblk) for k in range(3))

    def nn(q: torch.Tensor):
        qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
        best_d2 = best_i = None
        for blk in range(rx.shape[0]):
            d2 = (qx - rx[blk][None, :]).square_()
            d2 += (qy - ry[blk][None, :]).square_()
            d2 += (qz - rz[blk][None, :]).square_()
            bd, bi = torch.min(d2, dim=1)
            bi += blk * rblk
            if best_d2 is None:
                best_d2, best_i = bd, bi
            else:
                take = bd < best_d2
                best_d2 = torch.where(take, bd, best_d2)
                best_i = torch.where(take, bi, best_i)
            del d2
        return best_i, best_d2

    return nn


def _brute_nearest(ref_pts: torch.Tensor, query_pts: torch.Tensor, chunk: int = 2048):
    """Nearest reference index and distance of each query point by the blocked
    direct-difference argmin (`chunk` reference points per block)."""
    idx, d2 = _nn_planes_scan(ref_pts, rblk=chunk)(query_pts)
    return idx, torch.sqrt(torch.clamp(d2, min=0.0))


def _icp_while_loop(ref, tba, norms, nn, tolerance, max_iterations: int, method: str, picky: bool,
                    only_translation: bool, n_segments: int):
    """The ICP iterations on the device of the clouds: transform the original cloud by the
    running matrix, find the neighbours with `nn`, keep one query per matched reference point
    with Picky (the closest; ties to the lowest query index), solve the step (Low 2004's
    linearised point-to-plane normal equations, or Besl & McKay's SVD for point-to-point),
    compose it. Stops once the step's translation statistic drops below `tolerance` after
    the third step. Returns (matrix, iterations, statistic)."""
    dev, dt = ref.device, ref.dtype
    m = tba.shape[0]
    qidx = torch.arange(m, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    matrix = torch.eye(4, dtype=dt, device=dev)
    tol32 = float(np.float32(tolerance))
    it, stat = 0, math.inf
    while it < max_iterations and (it <= 2 or stat >= tol32):
        tq = tba @ matrix[:3, :3].T + matrix[:3, 3]
        ind, d2 = nn(tq)
        if picky:
            dmin = torch.full((n_segments,), math.inf, dtype=dt, device=dev).scatter_reduce(0, ind, d2, "amin")
            is_min = d2 <= dmin[ind]
            qmin = torch.full((n_segments,), m, dtype=qidx.dtype, device=dev).scatter_reduce(
                0, ind, torch.where(is_min, qidx, m), "amin")
            keep = is_min & (qidx == qmin[ind])
        else:
            keep = torch.ones(m, dtype=torch.bool, device=dev)
        w = keep.to(dt)
        r = ref[ind]
        if method == "point-to-plane":
            nrm = norms[ind]
            B = torch.sum((r - tq) * nrm, dim=1)
            A = nrm if only_translation else torch.cat([torch.linalg.cross(tq, nrm, dim=1), nrm], dim=1)
            Aw = A * w[:, None]
            x = torch.linalg.solve(Aw.T @ A + 1e-8 * torch.eye(A.shape[1], dtype=dt, device=dev), Aw.T @ B)
            R, t = (eye3, x) if only_translation else (_rotation_xyz(x[0], x[1], x[2]), x[3:])
        else:
            wsum = torch.clamp(w.sum(), min=1.0)
            mu_r = (r * w[:, None]).sum(dim=0) / wsum
            mu_t = (tq * w[:, None]).sum(dim=0) / wsum
            H = ((tq - mu_t) * w[:, None]).T @ (r - mu_r)
            U, _s, Vt = torch.linalg.svd(H)
            d = torch.sign(torch.linalg.det(Vt.T @ U.T))
            diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
            R = eye3 if only_translation else Vt.T @ torch.diag(diag) @ U.T
            t = mu_r - R @ mu_t
        step = _rigid_step(R, t)
        matrix = step @ matrix
        stat = float(torch.abs(torch.sum(step[:3, 3])))
        it += 1
    return matrix, it, stat


def _icp_solve_device(ref, tba, norms, tolerance, max_iterations: int, method: str = "point-to-plane",
                      picky: bool = True, only_translation: bool = False, chunk: int = 2048):
    """ICP with the brute neighbour search, on the device of the (N, 3) float32 clouds."""
    nn = _nn_planes_scan(ref, rblk=chunk)
    return _icp_while_loop(ref, tba, norms, nn, tolerance, max_iterations, method, picky, only_translation,
                           n_segments=ref.shape[0])


def _icp_norms_device(dem: torch.Tensor, xres: float, yres: float):
    """Plane normals from the DEM gradients for point-to-plane ICP, in xdem's formulation
    (including its (gradient_x, gradient_y) naming of the (d/drow, d/dcol) outputs)."""
    gradient_x, gradient_y = torch.gradient(dem)
    normal_east = torch.sin(torch.arctan(gradient_y / torch.tensor(yres, dtype=dem.dtype, device=dem.device))) * -1
    normal_north = torch.sin(torch.arctan(gradient_x / torch.tensor(xres, dtype=dem.dtype, device=dem.device)))
    normal_up = 1 - torch.hypot(normal_east, normal_north)
    return normal_east, normal_north, normal_up


def _icp_fit_approx_lsq(ref: np.ndarray, tba: np.ndarray, norms: np.ndarray,
                        only_translation: bool = False) -> np.ndarray:
    """Low (2004) linearised point-to-plane least squares, x = lstsq(A, B) with
    A = [tba x n, n], on the host in float64."""
    B = np.sum(ref * norms, axis=1) - np.sum(tba * norms, axis=1)
    if only_translation:
        x, *_ = np.linalg.lstsq(norms, B, rcond=None)
        return matrix_from_translations_rotations(t_x=x[0], t_y=x[1], t_z=x[2], use_degrees=False)
    A = np.hstack((np.cross(tba, norms), norms))
    x, *_ = np.linalg.lstsq(A, B, rcond=None)
    return matrix_from_translations_rotations(
        alpha=x[0], beta=x[1], gamma=x[2], t_x=x[3], t_y=x[4], t_z=x[5], use_degrees=False
    )


def _icp_fit_minimizer_step(ref: np.ndarray, tba: np.ndarray, norms: np.ndarray | None, method: str,
                            fit_minimizer: Callable, fit_loss_func: Any, only_translation: bool) -> np.ndarray:
    """One ICP step through a scipy.optimize.least_squares-style minimizer, called as
    ``fit_minimizer(fit_func, x0, loss=fit_loss_func)`` on the 3 x N pairs of this step."""

    def fit_func(x: np.ndarray) -> np.ndarray:
        ts, als = (x, (0.0, 0.0, 0.0)) if only_translation else (x[:3], x[3:])
        m = matrix_from_translations_rotations(t_x=ts[0], t_y=ts[1], t_z=ts[2], alpha=als[0], beta=als[1],
                                               gamma=als[2], use_degrees=False)
        trans = _apply_matrix_pts_mat(tba, matrix=m)
        if method == "point-to-plane":
            return np.sum((trans - ref) * norms, axis=0)
        return np.sqrt(np.sum((trans - ref) ** 2, axis=0))

    results = fit_minimizer(fit_func, np.zeros(3 if only_translation else 6), loss=fit_loss_func)
    x = np.asarray(results.x, dtype=np.float64)
    ts, als = (x, (0.0, 0.0, 0.0)) if only_translation else (x[:3], x[3:])
    return matrix_from_translations_rotations(t_x=ts[0], t_y=ts[1], t_z=ts[2], alpha=als[0], beta=als[1],
                                              gamma=als[2], use_degrees=False)


def _picky_first_per_match(ind: np.ndarray, dists: np.ndarray) -> np.ndarray:
    """For each matched reference index (ascending), the query of smallest distance, ties to
    the lowest query index: pandas' ``groupby("ind")["dists"].idxmin()`` without pandas."""
    order = np.lexsort((np.arange(len(ind)), dists, ind))
    si = ind[order]
    first = np.ones(len(order), bool)
    first[1:] = si[1:] != si[:-1]
    return order[first]


def icp(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: Any,
    max_iterations: int = 20,
    tolerance: float = 0.01,
    method: str = "point-to-plane",
    picky: bool = True,
    only_translation: bool = False,
    standardize: bool = True,
    fit_minimizer: Any = "lsq_approx",
    fit_loss_func: Any = "linear",
    nn_method: str = "auto",
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Iterative closest point registration of a raster pair; returns (matrix, centroid,
    point count).

    ``nn_method="brute"`` runs the whole registration on the device of the inputs (blocked
    direct-difference argmin, Picky by scatter-min, the solve on the device);
    ``"kdtree"`` queries a scipy KD-tree on the host each iteration and solves in float64
    there (a callable ``fit_minimizer`` needs it). ``"auto"`` picks brute on a CUDA tensor
    when the minimizer is built in and N x M <= 1e10 with a 2048-block of distances within
    1.5 GB, and kdtree otherwise (always on the CPU, where the KD-tree is faster).

    With ``mesh=``, the registration runs the brute path with the REFERENCE cloud split over
    the mesh (`parallel.coreg.icp_solve_sharded`; equal to the single-device brute fit to the
    bit); an explicit ``nn_method="kdtree"`` or a callable minimizer refuses a mesh.
    """
    if callable(fit_minimizer) and (nn_method == "brute" or mesh is not None):
        raise ValueError(
            'A custom fit_minimizer runs on the host: it cannot drive the nn_method="brute" device '
            'loop (which mesh= shards). Use nn_method="kdtree" without mesh= for a callable minimizer, '
            'or fit_minimizer="lsq_approx".'
        )
    if nn_method == "kdtree" and mesh is not None:
        raise ValueError(
            'nn_method="kdtree" queries a host KD-tree, which cannot be sharded over a mesh. Drop '
            'mesh= to keep the kdtree path, or use nn_method="brute"/"auto" with mesh=.'
        )
    logging.info("Running ICP coregistration")
    from scipy.spatial import KDTree

    aux = None
    grid = _grid_side(ref_elev, tba_elev)
    if method == "point-to-plane":
        nx, ny, nz = _icp_norms_device(grid, transform.xres, transform.yres)
        aux = {"nx": nx, "ny": ny, "nz": nz}
    sub_ref, sub_tba, x, y, sub_aux = _subsample_pair_values(
        ref_elev, tba_elev, inlier_mask, transform, subsample, random_state, aux_vars=aux
    )
    ref_epc = np.vstack((x, y, sub_ref))
    tba_epc = np.vstack((x, y, sub_tba))
    norms = np.vstack((sub_aux["nx"], sub_aux["ny"], sub_aux["nz"])) if aux is not None else None
    ref_epc, tba_epc, centroid, std_fac = _standardize_epc(ref_epc, tba_epc, scale_std=standardize)
    tolerance = tolerance / std_fac

    if mesh is not None:
        nn_method = "brute"
    if nn_method == "auto":
        n_pts = ref_epc.shape[1]
        fits = (float(n_pts) * float(tba_epc.shape[1]) <= 1e10) and (2048 * n_pts * 4 <= 1.5e9)
        on_cuda = grid.device.type == "cuda"
        nn_method = "brute" if (on_cuda and not callable(fit_minimizer) and fits) else "kdtree"
        logging.info("ICP nn_method='auto' resolved to '%s' (device %s, %d points)", nn_method,
                     grid.device, n_pts)

    if nn_method == "brute":
        dev = grid.device
        norms_dev = torch.from_numpy(
            (norms.T if norms is not None else np.zeros((ref_epc.shape[1], 3))).astype(np.float32)).to(dev)
        solve = _icp_solve_device
        if mesh is not None:
            from xdem_tpu_torch.parallel.coreg import icp_solve_sharded
            from xdem_tpu_torch.parallel.mesh import as_mesh_1d

            solve = functools.partial(icp_solve_sharded, mesh=as_mesh_1d(mesh))
        matrix_dev, n_it, _stat = solve(
            torch.from_numpy(ref_epc.T.astype(np.float32)).to(dev),
            torch.from_numpy(tba_epc.T.astype(np.float32)).to(dev),
            norms_dev, np.float32(tolerance), max_iterations=int(max_iterations), method=method,
            picky=picky, only_translation=only_translation,
        )
        # float32 rotation composition drifts off orthogonality by ~1e-6: re-orthogonalise.
        matrix = _make_matrix_valid(matrix_dev.double().cpu().numpy())
        logging.info("ICP converged in %d device iterations", n_it)
        matrix[:3, 3] *= std_fac
        return matrix, centroid, len(sub_ref)

    tree = KDTree(ref_epc.T)
    matrix = np.eye(4)
    for it in range(max_iterations):
        trans_tba = _apply_matrix_pts_mat(tba_epc, matrix=matrix)
        dists, ind = tree.query(trans_tba.T, k=1)
        ind_tba = _picky_first_per_match(ind, dists) if picky else np.arange(len(ind))
        ind_ref = ind[ind_tba]
        step_ref = ref_epc[:, ind_ref]
        step_tba = trans_tba[:, ind_tba]
        if callable(fit_minimizer):
            step_norms = norms[:, ind_ref] if norms is not None else None
            step_matrix = _icp_fit_minimizer_step(step_ref, step_tba, step_norms, method, fit_minimizer,
                                                  fit_loss_func, only_translation=only_translation)
        elif method == "point-to-plane":
            step_matrix = _icp_fit_approx_lsq(step_ref.T, step_tba.T, norms[:, ind_ref].T,
                                              only_translation=only_translation)
        else:
            mu_r = step_ref.mean(axis=1, keepdims=True)
            mu_t = step_tba.mean(axis=1, keepdims=True)
            H = (step_tba - mu_t) @ (step_ref - mu_r).T
            U, _, Vt = np.linalg.svd(H)
            d = np.sign(np.linalg.det(Vt.T @ U.T))
            R = Vt.T @ np.diag([1, 1, d]) @ U.T if not only_translation else np.eye(3)
            step_matrix = np.eye(4)
            step_matrix[:3, :3] = R
            step_matrix[:3, 3] = (mu_r - R @ mu_t).ravel()
        matrix = step_matrix @ matrix
        stat = np.sqrt(np.sum(step_matrix[:3, 3]) ** 2)
        logging.info("ICP iteration %d: tolerance statistic %.6f", it + 1, stat)
        if it > 1 and stat < tolerance:
            break
    matrix[:3, 3] *= std_fac
    return matrix, centroid, len(sub_ref)


class ICP(AffineCoreg):
    """Iterative closest point registration. Defaults: point-to-plane with Picky duplicate
    removal and the Low (2004) linearised solve; the neighbour search picked by device."""

    _supports_mesh_fit = True  # fit(..., mesh=): reference cloud sharded over the brute path

    def __init__(
        self,
        method: Literal["point-to-point", "point-to-plane"] = "point-to-plane",
        picky: bool = True,
        only_translation: bool = False,
        fit_minimizer: Any = "lsq_approx",
        fit_loss_func: Any = "linear",
        max_iterations: int = 20,
        tolerance: float = 0.01,
        standardize: bool = True,
        subsample: float | int = 5e5,
        initial_shift: tuple | None = None,
        nn_method: Literal["auto", "kdtree", "brute"] = "auto",
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {
            "icp_method": method, "icp_picky": picky, "only_translation": only_translation,
            "standardize": standardize, "nn_method": nn_method,
        }
        self._meta["inputs"]["fitorbin"] = {"fit_minimizer": fit_minimizer, "fit_loss_func": fit_loss_func}
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        s = self._meta["inputs"]["specific"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = icp(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            method=s["icp_method"], picky=s["icp_picky"], only_translation=s["only_translation"],
            standardize=s["standardize"], fit_minimizer=self._meta["inputs"]["fitorbin"]["fit_minimizer"],
            fit_loss_func=self._meta["inputs"]["fitorbin"]["fit_loss_func"],
            nn_method=s.get("nn_method", "auto"), mesh=kwargs.get("mesh"),
        )
        _store_rigid(self, matrix, centroid, count)


def _store_rigid(c: AffineCoreg, matrix: np.ndarray, centroid: tuple, count: int) -> None:
    tx, ty, tz, *_ = translations_rotations_from_matrix(matrix)
    c._meta["outputs"]["affine"] = {"matrix": matrix, "centroid": centroid, "shift_x": tx, "shift_y": ty,
                                    "shift_z": tz}
    c._meta["outputs"]["random"] = {"subsample_final": count}


# ======================================================================================
# CPD
# ======================================================================================


def _cpd_em_step(X: torch.Tensor, Y: torch.Tensor, TY: torch.Tensor, weight_cpd: float, sigma2: torch.Tensor,
                 sigma2_min: float, only_translation: bool = False):
    """One rigid CPD expectation-maximisation step (Myronenko & Song 2010, Fig. 2).

    The (M, N) responsibilities come from the pairwise squared distances by the expansion
    |x|^2 + |y|^2 - 2 x.y, the algorithm's own, as a float32 matmul (TF32 stays off)."""
    N, D = X.shape
    M = Y.shape[0]
    x2 = torch.sum(X * X, dim=1)[None, :]
    t2 = torch.sum(TY * TY, dim=1)[:, None]
    P = t2 + x2 - 2.0 * TY @ X.T
    P = torch.exp(-P / (2 * sigma2))
    Pden = torch.sum(P, dim=0, keepdim=True)
    c = (2 * math.pi * sigma2) ** (D / 2) * weight_cpd / (1.0 - weight_cpd) * M / N
    Pden = torch.clamp(Pden, min=torch.finfo(X.dtype).eps) + c
    P = P / Pden

    Pt1 = torch.sum(P, dim=0)
    P1 = torch.sum(P, dim=1)
    Np = torch.sum(P1)
    PX = P @ X
    muX = torch.sum(PX, dim=0) / Np
    muY = (P.T @ Y).sum(dim=0) / Np
    X_hat = X - muX[None, :]
    Y_hat = Y - muY[None, :]
    YPY = P1 @ torch.sum(Y_hat * Y_hat, dim=1)
    A = X_hat.T @ P.T @ Y_hat
    if not only_translation:
        U, _, Vt = torch.linalg.svd(A, full_matrices=True)
        C = torch.ones(D, dtype=X.dtype, device=X.device)
        C[D - 1] = torch.linalg.det(U @ Vt)
        R = (U @ torch.diag(C) @ Vt).T
    else:
        R = torch.eye(D, dtype=X.dtype, device=X.device)
    s = 1.0
    t = muX - s * (R.T @ muY)
    trAR = torch.trace(A @ R)
    xPx = Pt1 @ torch.sum(X_hat * X_hat, dim=1)
    q = (xPx - 2 * s * trAR + s * s * YPY) / (2 * sigma2) + D * Np / 2 * torch.log(sigma2)
    new_sigma2 = (xPx - s * trAR) / (Np * D)
    new_sigma2 = torch.where(new_sigma2 <= 0, sigma2_min, new_sigma2)
    return R, t, new_sigma2, q


def _cpd_solve(X: torch.Tensor, Y: torch.Tensor, weight_cpd: float, sigma2_init: float, sigma2_min: float,
               tolerance: float, max_iterations: int, only_translation: bool):
    """The CPD EM iterations (each step re-fits the whole transform). A step whose R or t is
    not finite keeps the previous estimate and stops the loop after the third step.
    Returns (R, t, iterations, degenerate)."""
    def em_step(TY: torch.Tensor, s2: torch.Tensor):
        return _cpd_em_step(X, Y, TY, weight_cpd, s2, sigma2_min, only_translation=only_translation)

    return _cpd_iterations(em_step, Y, sigma2_init, tolerance, max_iterations)


def _cpd_iterations(em_step: Callable, Y: torch.Tensor, sigma2_init: float, tolerance: float, max_iterations: int):
    """The loop of :func:`_cpd_solve` around ``em_step(TY, sigma2) -> (R, t, sigma2, q)``, the
    EM step of one device or of a mesh; the state lies on the device of `Y`."""
    dev, dt = Y.device, Y.dtype
    R = torch.eye(3, dtype=dt, device=dev)
    t = torch.zeros(3, dtype=dt, device=dev)
    s2 = torch.tensor(sigma2_init, dtype=dt, device=dev)
    q = torch.tensor(math.inf, dtype=dt, device=dev)
    tol32 = float(np.float32(tolerance))
    it, stat = 0, math.inf
    while it < max_iterations and not (it > 2 and stat < tol32):
        # TY = R^T (y + t) for row vectors: the rigid inverse of the previous step's [R | -t].
        TY = (Y + t[None, :]) @ R
        Rn, tn, s2n, qn = em_step(TY, s2)
        ok = torch.isfinite(Rn).all() & torch.isfinite(tn).all()
        ok_f, stat_f = torch.stack([ok.to(dt), torch.abs(qn - q)]).tolist()
        if ok_f:
            R, t, s2, q, stat = Rn, tn, s2n, qn, stat_f
        else:  # degenerate EM (variance collapse)
            stat = -math.inf
        it += 1
    return R, t, it, stat == -math.inf


def cpd(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: Any,
    weight_cpd: float = 0.0,
    max_iterations: int = 100,
    tolerance: float = 0.01,
    only_translation: bool = False,
    standardize: bool = True,
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Coherent Point Drift rigid registration of a raster pair on the device of the inputs;
    returns (matrix, centroid, point count). With ``mesh=``, the reference cloud is split over
    the mesh (`parallel.cpd.cpd_solve_sharded`): each shard holds its columns of the (M, N)
    responsibilities and the M-step moments are summed."""
    logging.info("Running CPD coregistration")
    sub_ref, sub_tba, x, y, _ = _subsample_pair_values(ref_elev, tba_elev, inlier_mask, transform, subsample,
                                                       random_state)
    ref_epc, tba_epc, centroid, std_fac = _standardize_epc(np.vstack((x, y, sub_ref)), np.vstack((x, y, sub_tba)),
                                                           scale_std=standardize)
    tolerance = tolerance / std_fac
    sigma2_min = tolerance / 10
    dev = _grid_side(ref_elev, tba_elev).device
    X = torch.from_numpy(ref_epc.T.astype(np.float32)).to(dev)
    Y = torch.from_numpy(tba_epc.T.astype(np.float32)).to(dev)
    # Initial variance: the mean pairwise squared distance.
    diff2 = float(torch.mean(torch.sum(Y * Y, dim=1)) + torch.mean(torch.sum(X * X, dim=1))
                  - 2 * float(torch.mean(Y @ torch.mean(X, dim=0))))
    args = (X, Y, float(weight_cpd), diff2, float(sigma2_min), float(tolerance), int(max_iterations),
            bool(only_translation))
    if mesh is None:
        R, t, n_it, degenerate = _cpd_solve(*args)
    else:
        from xdem_tpu_torch.parallel.cpd import cpd_solve_sharded
        from xdem_tpu_torch.parallel.mesh import as_mesh_1d

        R, t, n_it, degenerate = cpd_solve_sharded(*args, as_mesh_1d(mesh))
    if degenerate:
        logging.warning("CPD EM step became degenerate (variance collapsed) at iteration %d; "
                        "stopping with the previous estimate.", n_it)
    logging.info("CPD converged in %d iterations", n_it)
    matrix = np.eye(4)
    matrix[:3, :3] = R.double().cpu().numpy()
    matrix[:3, 3] = -t.double().cpu().numpy()
    final_matrix = invert_matrix(matrix)
    final_matrix[:3, 3] *= std_fac
    return final_matrix, centroid, len(sub_ref)


class CPD(AffineCoreg):
    """Coherent Point Drift rigid registration."""

    _supports_mesh_fit = True  # fit(..., mesh=): reference cloud sharded across the mesh

    def __init__(
        self,
        weight: float = 0,
        only_translation: bool = False,
        max_iterations: int = 100,
        tolerance: float = 0.01,
        standardize: bool = True,
        subsample: int | float = 5e3,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {
            "weight_cpd": weight, "only_translation": only_translation, "standardize": standardize,
        }
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        s = self._meta["inputs"]["specific"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = cpd(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            weight_cpd=s["weight_cpd"], max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            only_translation=s["only_translation"], standardize=s["standardize"], mesh=kwargs.get("mesh"),
        )
        _store_rigid(self, matrix, centroid, count)


# ======================================================================================
# LZD
# ======================================================================================


def _lzd_solve_device(raster: torch.Tensor, gradx: torch.Tensor, grady: torch.Tensor, xc0: torch.Tensor,
                      yc0: torch.Tensor, zc0: torch.Tensor, cz: float, inv_transform: list[float], tolerance: float,
                      max_iterations: int, only_translation: bool = False, mesh: Any = None):
    """The LZD iterations on the device of the raster: transform the points by the running
    matrix (rotation about the centroid), interpolate the DEM and its gradients there, and
    solve the linearised 6-parameter model by column-equilibrated masked normal equations
    (the raw columns mix ~1e4 m coordinates with ~0.1 gradients).

    Coordinates arrive centroid-centred; `inv_transform` holds (a, b, c, d, e, f) of the
    inverted georeferencing with the centroid folded into c and f: col = a*xc + b*yc + c,
    row = d*xc + e*yc + f. Points of zero weight get zero coordinates, so a NaN height never
    reaches the sums. Stops after the third step once the translation statistic drops below
    `tolerance`, or when no point is valid. With a 1-D `mesh`, the points are split over its
    shards, each with its own copy of the grids, and the column scales and the normal
    equations are summed across the shards on the mesh's root for the solve; without one,
    the same loop runs on one shard. Returns (matrix, iterations, statistic, valid count of
    the last step)."""
    from xdem_tpu_torch.parallel._collectives import psum, replicate, scatter
    from xdem_tpu_torch.parallel.mesh import _one_shard

    mesh = _one_shard(raster.device) if mesh is None else mesh
    dev, dt = mesh.root, raster.dtype
    grids = list(zip(replicate(raster, mesh), replicate(gradx, mesh), replicate(grady, mesh)))
    pts = [torch.stack(p) for p in zip(scatter(xc0, mesh, 0.0), scatter(yc0, mesh, 0.0), scatter(zc0, mesh, math.nan))]
    n_total = torch.tensor(float(xc0.shape[0]), dtype=dt, device=dev)
    a, b, c, d, e, f = (float(v) for v in np.asarray(inv_transform, np.float32))
    cz = float(np.float32(cz))
    tol32 = float(np.float32(tolerance))
    eye = torch.eye(3 if only_translation else 6, dtype=dt, device=dev)
    matrix = torch.eye(4, dtype=dt, device=dev)
    it, stat, nvalid = 0, math.inf, 1.0
    while it < max_iterations and (it <= 2 or stat >= tol32) and (it == 0 or nvalid > 0):
        systems = []
        for (rst, gxr, gyr), p, m in zip(grids, pts, replicate(matrix, mesh)):
            xc, yc, zc = m[:3, :3] @ p + m[:3, 3][:, None]
            cols = a * xc + b * yc + c
            rows = d * xc + e * yc + f
            z_rst = interp_rowcol(rst, rows, cols, method="linear")
            gx = interp_rowcol(gxr, rows, cols, method="linear")
            gy = interp_rowcol(gyr, rows, cols, method="linear")
            dh = z_rst - (zc + cz)
            ok = torch.isfinite(dh) & torch.isfinite(gx) & torch.isfinite(gy) & torch.isfinite(zc)
            w = ok.to(dt)
            dh, gx, gy = (torch.where(ok, v, 0.0) for v in (dh, gx, gy))
            xc, yc, zc = (torch.where(ok, v, 0.0) for v in (xc, yc, zc))
            ones = torch.ones_like(gx)
            if only_translation:
                A = torch.stack([-gx, -gy, ones], dim=1)
            else:
                A = torch.stack([-gx, -gy, ones, yc + gy * zc, -xc - gx * zc, gx * yc - gy * xc], dim=1)
            systems.append((A, w, dh))
        scale = torch.sqrt(torch.clamp(psum([(A * A * w[:, None]).sum(dim=0) for A, w, _ in systems], mesh)
                                       / n_total, min=1e-12))
        lhs, rhs, wsum = [], [], []
        for (A, w, dh), s in zip(systems, replicate(scale, mesh)):
            As = A / s[None, :]
            Aw = As * w[:, None]
            lhs.append(Aw.T @ As)
            rhs.append(Aw.T @ dh)
            wsum.append(w.sum())
        sol = torch.linalg.solve(psum(lhs, mesh) + 1e-7 * eye, psum(rhs, mesh)) / scale
        R = torch.eye(3, dtype=dt, device=dev) if only_translation else _rotation_xyz(sol[3], sol[4], sol[5])
        step = _rigid_step(R, sol[:3])
        matrix = step @ matrix
        stat, nvalid = torch.stack([torch.abs(torch.sum(step[:3, 3])), psum(wsum, mesh)]).tolist()
        it += 1
    return matrix, it, stat, nvalid


def lzd(
    ref_elev: torch.Tensor,
    tba_elev: torch.Tensor,
    inlier_mask: Any,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: Any,
    max_iterations: int = 200,
    tolerance: float = 0.01,
    only_translation: bool = False,
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Least Z-difference coregistration (Rosenholm & Torlegård 1988) of a raster pair;
    returns (matrix, centroid, point count). The linearised model is linear in the 6
    parameters, so each iteration is one least-squares solve on the device. With ``mesh=``, the
    points are split over the mesh and the normal equations summed across the shards."""
    logging.info("Running LZD coregistration")
    if crs is not None and not is_projected(crs):
        raise NotImplementedError(
            f"LZD coregistration needs planar (projected) coordinates, but the input CRS is {crs}. "
            f"Reproject to a local projected system first."
        )
    if isinstance(ref_elev, PointCloud) and isinstance(tba_elev, PointCloud):
        raise TypeError("The LZD coregistration does not support two point clouds.")
    ref_is_pts = isinstance(ref_elev, PointCloud)
    raster = _grid_side(ref_elev, tba_elev)
    gy, gx = torch.gradient(raster)
    gradx = gx / torch.tensor(transform.xres, dtype=raster.dtype, device=raster.device)
    grady = -gy / torch.tensor(transform.yres, dtype=raster.dtype, device=raster.device)  # rows run south
    sub_ref, sub_tba, x, y, _ = _subsample_pair_values(ref_elev, tba_elev, inlier_mask, transform, subsample,
                                                       random_state)
    # The point side (the to-be-aligned side of a raster pair) moves; the raster side is
    # interpolated at its positions.
    sub_pts = sub_ref if ref_is_pts else sub_tba
    centroid = (float(np.nanmean(x)), float(np.nanmean(y)), float(np.nanmean(sub_pts)))
    cx, cy, cz = centroid
    inv = transform.invert()
    # The centroid folds into the inverse-transform constants in float64 on the host, so the
    # device works in small centred coordinates only.
    cc = inv.a * cx + inv.b * cy + inv.c - 0.5
    cf = inv.d * cx + inv.e * cy + inv.f - 0.5
    dev = raster.device
    if mesh is not None:
        from xdem_tpu_torch.parallel.mesh import as_mesh_1d

        mesh = as_mesh_1d(mesh)
    matrix_dev, n_it, stat, nvalid = _lzd_solve_device(
        raster, gradx, grady,
        torch.from_numpy(np.asarray(x - cx, np.float32)).to(dev),
        torch.from_numpy(np.asarray(y - cy, np.float32)).to(dev),
        torch.from_numpy(np.asarray(sub_pts - cz, np.float32)).to(dev),
        cz, [inv.a, inv.b, cc, inv.d, inv.e, cf], tolerance,
        max_iterations=int(max_iterations), only_translation=only_translation, mesh=mesh,
    )
    if nvalid == 0.0:
        raise ValueError(
            "The subsample contains no more valid values. This can happen if the affine transformation "
            "to correct is larger than the data extent, or if the algorithm diverged."
        )
    matrix = _make_matrix_valid(matrix_dev.double().cpu().numpy())
    logging.info("LZD converged in %d device iterations (statistic %.6f)", n_it, stat)
    if ref_is_pts:  # the fit moved the reference points onto the grid: invert it
        matrix = invert_matrix(matrix)
    return matrix, centroid, len(sub_pts)


class LZD(AffineCoreg):
    """Least Z-difference coregistration."""

    _supports_mesh_fit = True  # fit(..., mesh=): normal equations summed across the shards

    def __init__(
        self,
        only_translation: bool = False,
        fit_minimizer: Any = None,
        fit_loss_func: Any = "linear",
        max_iterations: int = 200,
        tolerance: float = 0.01,
        subsample: float | int = 5e5,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {"only_translation": only_translation}
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, **kwargs):
        p = self._meta["inputs"]["random"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = lzd(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            only_translation=self._meta["inputs"]["specific"]["only_translation"], mesh=kwargs.get("mesh"),
        )
        _store_rigid(self, matrix, centroid, count)
