"""Exact order statistics across the shards of a mesh, by radix selection in bit space.

Counterpart of xdem_tpu/parallel/selection.py. A float32 value maps to a 32-bit key that
orders like the value (the total order: non-negative values to ``bits | 0x8000_0000``,
negative ones to ``~bits``; keys are held in int64). Two rounds of 16-bit histograms, each
summed across the shards, locate the k-th key of each bin: round 1 its high 16 bits, round 2
its low 16 bits within that bucket. No value crosses devices, only the histograms (n_bins x
65536 int32 counts per shard), and the result is an element of the population, the same for
any sharding.

The sharded coregistration solvers (parallel/coreg.py) take their medians from here, as
0.5 * (lo + hi) of the two middle order statistics: the formula of the single-device
``ops.reductions.binned_median``, so a sharded fit equals the single-device one to the bit.

Every function takes the shards' tensors as lists (one tensor per shard of the mesh, on that
shard's device) and ``axis``, the 1-D mesh the collectives run over: its root device holds
the per-bin inputs (`k`, `counts`) and receives the results. Histograms are built with
``index_add_`` into fixed-size tensors: a CUDA ``bincount`` reads its input's maximum back to
the host, which would make the cards wait on each other.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from xdem_tpu_torch.parallel._collectives import psum, replicate

_SIGN = 0x80000000
_U32 = 0xFFFFFFFF


def signed_monotone_u32(x: torch.Tensor) -> torch.Tensor:
    """Map float32 to uint32 keys (in int64) preserving order: x < y <=> key(x) < key(y)
    (total order, -0 < +0)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where((bits >> 31) == 1, (~bits) & _U32, bits | _SIGN)


def u32_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of signed_monotone_u32."""
    bits = torch.where((key >> 31) == 1, key & 0x7FFFFFFF, (~key) & _U32)
    return _bits_to_f32(bits)


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


# Entries that a histogram does not count go to one of this many spare slots (by position),
# not to a single one: a million atomic adds to one address would serialise on the card.
_SPARE = 1024


def _histogram(flat: torch.Tensor, keep: torch.Tensor, length: int) -> torch.Tensor:
    """int32 counts of the `keep` entries of `flat` (int64 in [0, length)), by ``index_add_``
    into a fixed-size tensor, so nothing is read back to the host; the other entries land in
    spare slots past `length`, spread by position."""
    idx = torch.where(keep, flat, length + torch.arange(flat.numel(), device=flat.device) % _SPARE)
    return torch.zeros(length + _SPARE, dtype=torch.int32, device=flat.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))[:length]


def _as_list(parts) -> list[torch.Tensor]:
    return [parts] if isinstance(parts, torch.Tensor) else list(parts)


def _round_one(keys: Sequence[torch.Tensor], parked: Sequence[torch.Tensor], n_bins: int, n_hi: int, axis):
    """Round 1: per shard the high and low 16 key bits, and the (n_bins, n_hi) cumulative
    histogram of the high bits summed across the shards (on the root)."""
    his, los, hists = [], [], []
    for key, pk in zip(keys, parked):
        inb = pk < n_bins
        key = torch.where(inb, key, 0)
        hi, lo = key >> 16, key & 0xFFFF
        his.append(hi)
        los.append(lo)
        hists.append(_histogram(pk * n_hi + hi, inb, n_bins * n_hi))
    cum_hi = torch.cumsum(psum(hists, axis).reshape(n_bins, n_hi), dim=1)
    return his, los, cum_hi


def _pick_kth(his, los, cum_hi, parked, k: torch.Tensor, n_bins: int, axis) -> torch.Tensor:
    """The key of the k-th (0-based) element of each bin, given round 1 (on the root)."""
    # argmax returns the first maximal index: the first bucket whose cumulative count passes k.
    sel_hi = torch.argmax((cum_hi > k[:, None]).to(torch.int32), dim=1)
    prev = torch.gather(cum_hi, 1, torch.clamp(sel_hi - 1, min=0)[:, None])[:, 0]
    below = torch.where(sel_hi > 0, prev, 0)
    hists = []
    for hi, lo, pk, sel in zip(his, los, parked, replicate(sel_hi, axis)):
        in_sel = (pk < n_bins) & (hi == sel[torch.clamp(pk, 0, n_bins - 1)])
        hists.append(_histogram(pk * 65536 + lo, in_sel, n_bins * 65536))
    cum_lo = torch.cumsum(psum(hists, axis).reshape(n_bins, 65536), dim=1)
    sel_lo = torch.argmax((cum_lo > (k - below)[:, None]).to(torch.int32), dim=1)
    return (sel_hi << 16) | sel_lo


def _median_by_bin(keys, parked, counts: torch.Tensor, n_bins: int, axis, n_hi: int,
                   to_value: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    his, los, cum_hi = _round_one(keys, parked, n_bins, n_hi, axis)
    k_lo = torch.clamp(torch.div(counts - 1, 2, rounding_mode="floor"), min=0)
    k_hi = torch.div(counts, 2, rounding_mode="floor")
    m_lo = to_value(_pick_kth(his, los, cum_hi, parked, k_lo, n_bins, axis))
    m_hi = to_value(_pick_kth(his, los, cum_hi, parked, k_hi, n_bins, axis))
    return torch.where(counts > 0, 0.5 * (m_lo + m_hi), torch.nan)


def signed_kth_by_bin(x, parked, k, n_bins: int, axis):
    """Exact k_b-th smallest (0-based) of {x_i : parked_i == b} per bin b across all shards.

    `x` and `parked` list one tensor per shard of the 1-D mesh `axis`; `parked` must be
    n_bins for invalid entries, and `k` (int64, n_bins) lies on the mesh's root. Returns one
    float32 per bin on the root (garbage where the global bin population is at most k: mask
    with the counts)."""
    x, parked = _as_list(x), _as_list(parked)
    keys = [signed_monotone_u32(v) for v in x]
    his, los, cum_hi = _round_one(keys, parked, n_bins, 65536, axis)
    return u32_to_f32(_pick_kth(his, los, cum_hi, parked, k, n_bins, axis))


def signed_median_by_bin(x, parked, counts, n_bins: int, axis):
    """Exact global per-bin median across shards: 0.5 * (lo + hi) of the two middle order
    statistics, the formula of ``ops.reductions.binned_median``; NaN where count == 0. The
    round-1 histogram is shared between the two order statistics. `counts` (int64, n_bins,
    on the root) are the global bin populations."""
    x, parked = _as_list(x), _as_list(parked)
    return _median_by_bin([signed_monotone_u32(v) for v in x], parked, counts, n_bins, axis, 65536, u32_to_f32)


def nonneg_median_by_bin(x, parked, counts, n_bins: int, axis):
    """:func:`signed_median_by_bin` for non-negative values (variogram |dz|): their float32 bits
    already order like the values, so the keys are the bits and round 1 needs 32768 buckets."""
    x, parked = _as_list(x), _as_list(parked)
    keys = [v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) for v in x]
    return _median_by_bin(keys, parked, counts, n_bins, axis, 32768, _bits_to_f32)


def masked_median_distributed(x, valid, axis):
    """Exact global median of {x_i : valid_i} across shards; returns (median, global count),
    0-dim tensors on the root."""
    x, valid = _as_list(x), _as_list(valid)
    parked = [torch.where(v, 0, 1).reshape(-1) for v in valid]
    counts = psum([v.sum().reshape(1) for v in valid], axis)
    med = signed_median_by_bin([v.reshape(-1) for v in x], parked, counts, 1, axis)
    return med[0], counts[0]
