"""Sharded empirical variogram: the sampling runs split over the mesh, the bins summed.

Counterpart of xdem_tpu/parallel/variogram.py. The runs of the equidistant sampling scheme
are split over a 1-D mesh; each shard forms the pairs of its runs and its per-lag-bin counts
and partial sums, which are summed on the root before the estimator is finalised:

* Matheron and Cressie: float64 sums of d^2 or sqrt(d) (the single-device sums are float64
  too, so the two agree to float64 rounding);
* Dowd: the exact global median of |d| per bin, by radix selection on the float32 bits
  (``selection.nonneg_median_by_bin``), so the result is the single-device one to the bit and
  the same for any sharding;
* Genton: each shard keeps its top 400 pairs per bin ranked by the tie-free global pair keys
  of ``spatialstats._genton_pair_keys``; the candidates are gathered and merged into the same
  global top 400 whatever the sharding, and Qn is taken on the host in float64.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from xdem_tpu_torch.parallel._collectives import all_gather, psum, replicate, scatter, shard_offset
from xdem_tpu_torch.parallel.mesh import Mesh, as_mesh_1d
from xdem_tpu_torch.parallel.selection import _histogram, nonneg_median_by_bin

_ESTIMATORS = ("matheron", "cressie", "dowd", "genton")


def _runs(a, mesh: Mesh) -> list[torch.Tensor]:
    """(R, ...) float32 runs, NaN-padded to a multiple of the shard count, one part per shard."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return scatter(t.to(torch.float32), mesh, math.nan)


def sharded_variogram_bins(
    za,
    zb,
    ca,
    cb,
    bin_edges: Sequence[float],
    mesh: Mesh,
    estimator: str = "matheron",
) -> tuple[np.ndarray, np.ndarray]:
    """Per-lag-bin variogram over (R, N) x (R, M) sampling runs split over `mesh`.

    :param za: (R, N) centre-sample values per run (NaN-padded), array or tensor.
    :param zb: (R, M) comparison-sample values per run.
    :param ca: (R, N, 2) centre coordinates.
    :param cb: (R, M, 2) comparison coordinates.
    :returns: (gamma per bin as float64, pair count per bin as int64), numpy.

    Any mesh shape is accepted: it is viewed as 1-D over all its devices, so the Genton pair
    keys number the runs of every shard.

    Each shard holds every pair of its runs at once (about 40 B a pair). A call whose shards
    would hold more than ``spatialstats._PAIR_CHUNK_BUDGET`` pairs on one device raises a
    ``ValueError``: the single-device route takes such a call in chunks.
    """
    from xdem_tpu_torch.spatialstats import (
        _PAIR_CHUNK_BUDGET, _dowd_gamma, _gamma_from_sums, _genton_local_topcap, _genton_merge_topcap,
        _genton_pair_keys, _genton_qn_from_reservoir, _lag_bins, _pair_weights)

    if estimator not in _ESTIMATORS:
        raise ValueError(f"Estimator '{estimator}' not supported for the sharded variogram.")
    m1 = as_mesh_1d(mesh)
    za_s, zb_s, ca_s, cb_s = (_runs(a, m1) for a in (za, zb, ca, cb))
    n_bins = len(bin_edges) - 1
    edges = torch.from_numpy(np.asarray(bin_edges, dtype=np.float32))
    n_local_runs, n_pts = za_s[0].shape
    m_pts = zb_s[0].shape[1]
    per_device = max(Counter(m1.devices.flat).values()) * n_local_runs * n_pts * m_pts
    if per_device > _PAIR_CHUNK_BUDGET:
        raise ValueError(
            f"The sharded variogram would hold {per_device:.2e} pairs on one device at once (limit "
            f"{_PAIR_CHUNK_BUDGET:.0e}). Reduce `subsample`, spread the mesh over more devices, or drop "
            "mesh= to take the pairs in chunks on one device.")

    pairs = []
    for a, b, c_a, c_b, e in zip(za_s, zb_s, ca_s, cb_s, replicate(edges, m1)):
        d_signed = (a[:, :, None] - b[:, None, :]).reshape(-1)
        d = torch.abs(d_signed)
        h = torch.sqrt(((c_a[:, :, None, :] - c_b[:, None, :, :]) ** 2).sum(-1)).reshape(-1)
        pairs.append((d, d_signed, _lag_bins(h, e, n_bins, torch.isfinite(d) & (h > 0))))
    counts = psum([_histogram(p, p < n_bins, n_bins) for _, _, p in pairs], m1).long()

    if estimator in ("matheron", "cressie"):
        sums = psum([torch.zeros(n_bins + 1, dtype=torch.float64, device=p.device).index_add_(
            0, p, _pair_weights(estimator, d, p, n_bins))[:n_bins] for d, _, p in pairs], m1)
        gamma = _gamma_from_sums(estimator, sums, counts).cpu().numpy()
    elif estimator == "dowd":
        med = nonneg_median_by_bin([d for d, _, _ in pairs], [p for _, _, p in pairs], counts, n_bins, m1)
        gamma = _dowd_gamma(med).double().cpu().numpy()
    else:
        first = shard_offset(m1)
        tops = [_genton_local_topcap(ds, p, _genton_pair_keys((first + s) * n_local_runs, n_local_runs, n_pts,
                                                               m_pts, p, n_bins), n_bins)
                for s, (_, ds, p) in enumerate(pairs)]
        vals = all_gather([v for v, _ in tops], m1)  # (shards, n_bins, CAP)
        keys = all_gather([k for _, k in tops], m1)
        merged_v = vals.transpose(0, 1).reshape(n_bins, -1)
        merged_k = keys.transpose(0, 1).reshape(n_bins, -1)
        reservoir, _ = _genton_merge_topcap(merged_v, merged_k)
        gamma = _genton_qn_from_reservoir(reservoir.cpu().numpy().astype(np.float64), counts.cpu().numpy())
    return np.asarray(gamma, dtype=np.float64), counts.cpu().numpy().astype(np.int64)
