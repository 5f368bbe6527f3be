"""Sharded effective-sample-number sums: the covariance double sum split over the mesh.

Counterpart of xdem_tpu/parallel/neff.py. neff_exact and neff_hugonnet_approx reduce
sum_ij e_i e_j rho(|c_i - c_j|). The single-device sum (spatialstats
``_chunked_weighted_rho_sum``) bounds memory by chunking rows; the remaining cost is compute,
which is row-parallel: the rows are split over the mesh, each shard runs the same chunked
sum (direct-difference distances, Kahan-compensated float32 accumulation), and the partial
sums are added on the root. Zero-weight padding rows contribute nothing, so any row count
shards.
"""

from __future__ import annotations

import numpy as np
import torch

from xdem_tpu_torch.parallel._collectives import psum, replicate, scatter
from xdem_tpu_torch.parallel.mesh import Mesh, as_mesh_1d


def weighted_rho_sum_sharded(
    c1,
    e1,
    c2,
    e2,
    params_variogram_model,
    mesh: Mesh,
    axis: Mesh | None = None,
    target_elems: int = 1 << 24,
) -> float:
    """sum_ij e1_i e2_j rho(|c1_i - c2_j|) with the rows (c1, e1) split over the mesh `axis`
    (default: `mesh` viewed as 1-D). Peak memory per shard: chunk x len(e2) pairs."""
    from xdem_tpu_torch.spatialstats import _pairwise_sq_dists, _rho_device

    m1 = axis if axis is not None else as_mesh_1d(mesh)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) if not isinstance(a, torch.Tensor) \
            else a.to(torch.float32)

    c1_s, e1_s = scatter(f32(c1), m1, 0.0), scatter(f32(e1), m1, 0.0)
    c2_t, e2_t = f32(c2), f32(e2)
    m = c2_t.shape[0]
    chunk = int(min(max(64, target_elems // max(m, 1)), max(c1_s[0].shape[0], 1)))
    partials = []
    for c1p, e1p, c2p, e2p in zip(c1_s, e1_s, replicate(c2_t, m1), replicate(e2_t, m1)):
        acc = torch.zeros((), dtype=torch.float32, device=c1p.device)
        comp = torch.zeros_like(acc)
        for i0 in range(0, c1p.shape[0], chunk):
            rho = _rho_device(torch.sqrt(_pairwise_sq_dists(c1p[i0:i0 + chunk], c2p)), params_variogram_model)
            y = torch.sum(e1p[i0:i0 + chunk, None] * e2p[None, :] * rho) - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        partials.append(acc.to(torch.float64))
    return float(psum(partials, m1))
