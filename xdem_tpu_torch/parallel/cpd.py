"""Sharded CPD: the (M, N) responsibilities split over the mesh along the reference axis.

Counterpart of xdem_tpu/parallel/cpd.py. The single-device step (coreg/affine.py
``_cpd_em_step``) holds the whole (M, N) responsibility matrix on one device. Here the
REFERENCE points (N) are split over a 1-D mesh: the responsibilities normalise over the
moving axis (M), which every shard holds whole, so the E-step is exact per shard, and the
M-step moments (P1, the first moments, the cross-covariance, xPx) are summed on the root.
Memory per shard: M x N / n_shards. The sums reassociate in float32, so the fit agrees with
the single-device fit to 1e-3, as xdem_tpu's does with its own. The products are float32
matmuls with TF32 off (PyTorch's default, which the port never changes).
"""

from __future__ import annotations

import math

import torch

from xdem_tpu_torch.parallel._collectives import psum, replicate, scatter
from xdem_tpu_torch.parallel.mesh import Mesh


def _cpd_em_local(Xs: list[torch.Tensor], Y: torch.Tensor, TY: torch.Tensor, weight_cpd: float,
                  s2: torch.Tensor, s2min: float, mesh: Mesh, only_translation: bool, n_eff: float):
    """One CPD EM step over reference shards `Xs` (NaN rows are padding); `Y`, `TY` and `s2`
    lie on the root. Returns (R, t, new_sigma2, q) on the root."""
    M, D = Y.shape
    c = (2 * math.pi * s2) ** (D / 2) * weight_cpd / (1.0 - weight_cpd) * M / n_eff
    parts = []
    for X, TYs, s2s, cs in zip(Xs, replicate(TY, mesh), replicate(s2, mesh), replicate(c, mesh)):
        finite = torch.isfinite(X).all(dim=1)
        Xl = torch.where(finite[:, None], X, 0.0)
        P = torch.sum(TYs * TYs, dim=1)[:, None] + torch.sum(Xl * Xl, dim=1)[None, :] - 2.0 * TYs @ Xl.T
        P = torch.where(finite[None, :], torch.exp(-P / (2 * s2s)), 0.0)
        # Normalisation over the moving axis: local to the shard, no collective.
        Pden = torch.clamp(torch.sum(P, dim=0, keepdim=True), min=torch.finfo(X.dtype).eps) + cs
        P = torch.where(finite[None, :], P / Pden, 0.0)
        parts.append((P, Xl, finite))
    P1 = psum([torch.sum(P, dim=1) for P, _, _ in parts], mesh)
    Np = torch.sum(P1)
    muX = psum([torch.sum(P @ Xl, dim=0) for P, Xl, _ in parts], mesh) / Np
    muY = P1 @ Y / Np
    Y_hat = Y - muY[None, :]
    A_parts, xpx_parts = [], []
    for (P, Xl, finite), mx, yh in zip(parts, replicate(muX, mesh), replicate(Y_hat, mesh)):
        X_hat = Xl - mx[None, :]
        A_parts.append(X_hat.T @ (P.T @ yh))
        xpx_parts.append(torch.sum(P, dim=0) @ torch.where(finite, torch.sum(X_hat * X_hat, dim=1), 0.0))
    A = psum(A_parts, mesh)
    xPx = psum(xpx_parts, mesh)
    YPY = P1 @ torch.sum(Y_hat * Y_hat, dim=1)
    if not only_translation:
        U, _, Vt = torch.linalg.svd(A, full_matrices=True)
        C = torch.ones(D, dtype=Y.dtype, device=Y.device)
        C[D - 1] = torch.linalg.det(U @ Vt)
        R = (U @ torch.diag(C) @ Vt).T
    else:
        R = torch.eye(D, dtype=Y.dtype, device=Y.device)
    t = muX - R.T @ muY
    trAR = torch.trace(A @ R)
    q = (xPx - 2 * trAR + YPY) / (2 * s2) + D * Np / 2 * torch.log(s2)
    new_sigma2 = (xPx - trAR) / (Np * D)
    new_sigma2 = torch.where(new_sigma2 <= 0, s2min, new_sigma2)
    return R, t, new_sigma2, q


def cpd_em_step_sharded(
    X: torch.Tensor,
    Y: torch.Tensor,
    TY: torch.Tensor,
    weight_cpd: float,
    sigma2,
    sigma2_min: float,
    mesh: Mesh,
    only_translation: bool = False,
    axis: Mesh | None = None,
    n_true: int | None = None,
):
    """One CPD EM step with the reference cloud X split over the mesh `axis` (default: `mesh`
    viewed as 1-D). X may hold NaN padding rows; `n_true` is the count without them (default:
    the finite rows). Returns (R, t, new_sigma2, q) on the mesh's root."""
    from xdem_tpu_torch.parallel.mesh import as_mesh_1d

    m1 = axis if axis is not None else as_mesh_1d(mesh)
    n_eff = float(n_true if n_true is not None else int(torch.isfinite(X).all(dim=1).sum()))
    root = m1.root
    s2 = torch.as_tensor(sigma2, dtype=X.dtype).to(root)
    return _cpd_em_local(scatter(X, m1, math.nan), Y.to(root), TY.to(root), weight_cpd, s2, sigma2_min, m1,
                         only_translation, n_eff)


def cpd_solve_sharded(X: torch.Tensor, Y: torch.Tensor, weight_cpd: float, sigma2_init: float, sigma2_min: float,
                      tolerance: float, max_iterations: int, only_translation: bool, mesh: Mesh,
                      n_true: int | None = None):
    """``coreg.affine._cpd_solve`` with the reference cloud split over the 1-D `mesh`: its loop
    (the same stop rule and degenerate-EM bailout, one value read back per iteration) around
    the sharded EM step. Returns (R, t, iterations, degenerate) on the root."""
    from xdem_tpu_torch.coreg.affine import _cpd_iterations

    Xs = scatter(X, mesh, math.nan)
    n_eff = float(n_true if n_true is not None else X.shape[0])
    Y = Y.to(mesh.root)

    def em_step(TY: torch.Tensor, s2: torch.Tensor):
        return _cpd_em_local(Xs, Y, TY, weight_cpd, s2, sigma2_min, mesh, only_translation, n_eff)

    return _cpd_iterations(em_step, Y, sigma2_init, tolerance, max_iterations)
