"""Sharded coregistration: point-sharded iterative fits with exact distributed medians.

Counterpart of xdem_tpu/parallel/coreg.py. The subsample is drawn once, where the
single-device fit draws it, and its points are split over a 1-D mesh; each shard evaluates
dh on its points against its own copy of the raster, and every statistic the solver reads
comes back to the mesh's root: the medians (vertical shift, per-aspect-bin medians, the NMAD
of DhMinimize) as exact distributed order statistics (parallel/selection.py), so those fits
equal the single-device fits to the bit; the LZD normal equations as sums across the shards
(float32 reassociation, held at 1e-3 like xdem_tpu's); the ICP neighbours as the per-shard
winners merged by (distance, lowest index), which is the single-device argmin's tie-break.

The fits run the single-device loops of coreg/affine.py (Nuth & Kääb's, LZD's and ICP's,
DhMinimize's Nelder-Mead), given the shards' lists and the distributed reductions; their
scalar algebra runs on the mesh's root, and each iteration reads one value back to the host,
as on one device.
"""

from __future__ import annotations

import math

import torch

from xdem_tpu_torch.parallel._collectives import all_gather, psum, replicate, scatter, to
from xdem_tpu_torch.parallel.mesh import Mesh
from xdem_tpu_torch.parallel.selection import _histogram, masked_median_distributed, signed_median_by_bin


def _finite(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    return [torch.isfinite(p) for p in parts]


def _dh_shards(z, r, c, rasters, sx, sy, invert: bool) -> list[torch.Tensor]:
    from xdem_tpu_torch.coreg.affine import _dh_device

    sxs = sx if isinstance(sx, list) else [sx] * len(z)
    sys_ = sy if isinstance(sy, list) else [sy] * len(z)
    return [_dh_device(*a, invert) for a in zip(z, r, c, rasters, sxs, sys_)]


def nuth_kaab_points_sharded(
    pts_z: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    raster: torch.Tensor,
    slope_tan: torch.Tensor,
    aspect: torch.Tensor,
    res_x: float,
    res_y: float,
    tolerance: float,
    mesh: Mesh,
    max_iterations: int = 10,
    n_bins: int = 72,
    invert: bool = False,
    bin_before_fit: bool = True,
) -> tuple[float, float, float, float, int]:
    """``coreg.affine._nuth_kaab_solve`` with the points split over the 1-D `mesh`; same
    arguments and result. In the default ``bin_before_fit`` mode the vertical-shift median
    and the per-aspect-bin medians are exact distributed order statistics, so the fit equals
    the single-device fit to the bit; the point-sum mode sums the float64 normal equations
    across the shards (reassociation)."""
    from xdem_tpu_torch.coreg.affine import _nuth_kaab_iterations

    def median(xs: list[torch.Tensor]) -> torch.Tensor:
        return masked_median_distributed(xs, _finite(xs), mesh)[0]

    def binned(ys: list[torch.Tensor], bins: list[torch.Tensor], valids: list[torch.Tensor]) -> torch.Tensor:
        parked = [torch.where(v, b.long(), n_bins) for v, b in zip(valids, bins)]
        counts = psum([_histogram(p, v, n_bins) for p, v in zip(parked, valids)], mesh).long()
        return signed_median_by_bin(ys, parked, counts, n_bins, mesh)

    z, r, c = scatter(pts_z, mesh, math.nan), scatter(rows, mesh, 0.0), scatter(cols, mesh, 0.0)
    return _nuth_kaab_iterations(z, r, c, replicate(raster, mesh), scatter(slope_tan, mesh, math.nan),
                                 scatter(aspect, mesh, 0.0), res_x, res_y, tolerance, max_iterations, n_bins, invert,
                                 bin_before_fit, mesh, median, binned)


def masked_median_diff_sharded(ref: torch.Tensor, tba: torch.Tensor, inlier: torch.Tensor,
                               mesh: Mesh) -> tuple[float, int]:
    """VerticalShift's full-raster fit with the rows split over the mesh: the exact
    distributed median of (ref - tba) over the inlier, finite pixels, and their count; equal
    to the single-device ``_masked_median_diff``."""
    rs, ts = scatter(ref, mesh, math.nan), scatter(tba, mesh, math.nan)
    ms = scatter(inlier, mesh, False)
    dh = [torch.where(m, a - b, torch.nan).reshape(-1) for a, b, m in zip(rs, ts, ms)]
    med, n = masked_median_distributed(dh, _finite(dh), mesh)
    med, n = torch.stack([med, n.to(med.dtype)]).tolist()
    return med, int(n)


def dh_shifted_points_sharded(pts_z: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, raster: torch.Tensor,
                              sx_px, sy_px, mesh: Mesh, invert: bool = False) -> torch.Tensor:
    """``_dh_device`` (dh at points with the raster shifted by pixel offsets) with the
    bilinear gathers split over the mesh; per-point values equal the single-device ones.
    Returns the (n,) dh on the mesh's root."""
    n = pts_z.shape[0]
    z, r, c = scatter(pts_z, mesh, math.nan), scatter(rows, mesh, 0.0), scatter(cols, mesh, 0.0)
    dh = _dh_shards(z, r, c, replicate(raster, mesh), sx_px, sy_px, invert)
    return all_gather(dh, mesh).reshape(-1)[:n]


def dh_median_points_sharded(pts_z: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, raster: torch.Tensor,
                             mesh: Mesh, invert: bool = False) -> tuple[float, int]:
    """VerticalShift's median over host-subsampled points: sharded gathers and the exact
    distributed median. Returns (median, finite count)."""
    z, r, c = scatter(pts_z, mesh, math.nan), scatter(rows, mesh, 0.0), scatter(cols, mesh, 0.0)
    dh = _dh_shards(z, r, c, replicate(raster, mesh), 0.0, 0.0, invert)
    med, n = masked_median_distributed(dh, _finite(dh), mesh)
    med, n = torch.stack([med, n.to(med.dtype)]).tolist()
    return med, int(n)


def dh_minimize_nm_sharded(pts_z: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, raster: torch.Tensor,
                           res_x: float, res_y: float, mesh: Mesh, invert: bool = False):
    """DhMinimize's Nelder-Mead with the points split over the mesh and the NMAD objective
    reduced by exact distributed medians: the simplex sees the values the single-device
    ``_dh_minimize_nm_device`` sees, so the fit equals it to the bit. Returns (x_best metres,
    f_best, iterations, median dh at the optimum)."""
    from xdem_tpu_torch.coreg.affine import _nelder_mead_2d

    z, r, c = scatter(pts_z, mesh, math.nan), scatter(rows, mesh, 0.0), scatter(cols, mesh, 0.0)
    rasters = replicate(raster, mesh)
    res = torch.tensor([res_x, res_y], dtype=torch.float32)

    def med(xs: list[torch.Tensor]) -> torch.Tensor:
        return masked_median_distributed(xs, _finite(xs), mesh)[0]

    def f(v):
        sx, sy = (v / res).tolist()
        dh = _dh_shards(z, r, c, rasters, sx, sy, invert)
        m = replicate(med(dh), mesh)
        return (1.4826 * med([torch.abs(d - mi) for d, mi in zip(dh, m)])).cpu()

    x_best, f_best, it = _nelder_mead_2d(f)
    sx, sy = (x_best / res).tolist()
    return x_best, f_best, it, med(_dh_shards(z, r, c, rasters, sx, sy, invert))


def icp_solve_sharded(ref: torch.Tensor, tba: torch.Tensor, norms: torch.Tensor, tolerance, mesh: Mesh,
                      max_iterations: int, method: str = "point-to-plane", picky: bool = True,
                      only_translation: bool = False, chunk: int = 2048):
    """The brute-force ICP with the REFERENCE cloud split over the mesh: each shard runs the
    blocked direct-difference argmin against its part only (the O(N*M) search), and the
    winners merge on the root by the smallest distance, then the lowest global index among
    the points at that distance: the single-device argmin's tie-break, over the same
    per-pair distances, so the neighbours and the whole registration equal
    ``_icp_solve_device``'s to the bit. The Picky deduplication and the solve run on the root.
    Returns (matrix (4, 4), iterations, statistic)."""
    from xdem_tpu_torch.coreg.affine import _NN_PAD_COORD, _icp_while_loop, _nn_planes_scan

    n_dev = mesh.devices.size
    ref_parts = scatter(ref, mesh, _NN_PAD_COORD)
    shard = ref_parts[0].shape[0]
    n_pad = shard * n_dev
    ref_p = torch.cat([ref, torch.full((n_pad - ref.shape[0], 3), _NN_PAD_COORD, dtype=ref.dtype, device=ref.device)])
    norms_p = torch.cat([norms, torch.zeros((n_pad - norms.shape[0], 3), dtype=norms.dtype, device=norms.device)])
    nns = [_nn_planes_scan(p, rblk=min(chunk, shard)) for p in ref_parts]
    root = mesh.root

    def nn(q: torch.Tensor):
        found = [f(qi) for f, qi in zip(nns, replicate(q, mesh))]
        d2 = all_gather([d for _, d in found], mesh)
        idx = all_gather([i + s * shard for s, (i, _) in enumerate(found)], mesh)
        d2g = d2.min(dim=0).values
        return torch.where(d2 == d2g, idx, n_pad).min(dim=0).values, d2g

    return _icp_while_loop(to(ref_p, root), to(tba, root), to(norms_p, root), nn, tolerance, max_iterations,
                           method, picky, only_translation, n_segments=n_pad)


def lzd_solve_sharded(raster: torch.Tensor, gradx: torch.Tensor, grady: torch.Tensor, xc0: torch.Tensor,
                      yc0: torch.Tensor, zc0: torch.Tensor, cz: float, inv_transform, tolerance, mesh: Mesh,
                      max_iterations: int, only_translation: bool = False):
    """``coreg.affine._lzd_solve_device`` with the points split over the 1-D `mesh`: per shard
    the interpolation and the partial sums of the column scales and of the normal equations,
    summed on the root for the solve. Returns (matrix, iterations, statistic, valid count of
    the last step)."""
    from xdem_tpu_torch.coreg.affine import _lzd_solve_device

    return _lzd_solve_device(raster, gradx, grady, xc0, yc0, zc0, cz, inv_transform, tolerance, max_iterations,
                             only_translation, mesh=mesh)


def nuth_kaab_batched_sharded(pts_z: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, rasters: torch.Tensor,
                              slope_tan: torch.Tensor, aspect: torch.Tensor, res_x: float, res_y: float,
                              tolerance: float, mesh: Mesh, max_iterations: int = 10, n_bins: int = 72,
                              bin_before_fit: bool = True) -> tuple[torch.Tensor, ...]:
    """BlockwiseNuthKaab's batched solve (``coreg.affine._nuth_kaab_solve_batched``) with the
    tile axis split over the mesh (viewed as 1-D; NaN tiles pad it to a multiple of the shard
    count). Every shard's batch takes one step before the host reads the one flag "any tile
    still active", so the cards run side by side. Tiles are independent, so each tile's
    result is its single-device result. Returns the per-tile tensors on the root."""
    from xdem_tpu_torch.coreg.affine import _nuth_kaab_batched_steps
    from xdem_tpu_torch.parallel.mesh import as_mesh_1d

    m1 = as_mesh_1d(mesh)
    n_tiles = pts_z.shape[0]
    shards = zip(*(scatter(a, m1, fill) for a, fill in ((pts_z, math.nan), (rows, 0.0), (cols, 0.0),
                                                       (rasters, math.nan), (slope_tan, math.nan), (aspect, 0.0))))
    steps = [_nuth_kaab_batched_steps(*s, res_x, res_y, tolerance, max_iterations=max_iterations, n_bins=n_bins,
                                      bin_before_fit=bin_before_fit) for s in shards]
    outs = None
    for states in zip(*steps):
        outs = [out for _, out in states]
        if not bool(psum([active.any().to(torch.int32) for active, _ in states], m1)):
            break
    return tuple(all_gather(list(parts), m1).reshape(-1)[:n_tiles] for parts in zip(*outs))
