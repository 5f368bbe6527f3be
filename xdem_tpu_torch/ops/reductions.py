"""NaN-aware robust reductions on tensors.

Every median here is 0.5 * (lo + hi) of the two middle order statistics, the formula of
xdem_tpu/coreg/affine.py::_binned_median. ``torch.median`` returns the lower middle
element instead (2.0 for [1, 2, 3, 4], where this gives 2.5), so it is never used.
"""

from __future__ import annotations

import torch

_NMAD_FACTOR = 1.4826


def binned_median(y: torch.Tensor, bin_idx: torch.Tensor, valid: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Median of `y` in each of `n_bins` bins over the `valid` entries; NaN for empty bins.

    One sort by (bin, value), then the two middle order statistics of each bin are gathered.
    Each bin's extent is found in the sorted bin keys, so nothing waits for the device (a
    CUDA ``bincount`` reads its input's extremes back to the host).
    """
    y = y.reshape(-1)
    parked = torch.where(valid.reshape(-1), bin_idx.reshape(-1).long(), n_bins)
    # Lexicographic order by (bin, value): a stable sort by bin of the value-sorted entries.
    by_value = torch.argsort(y, stable=True)
    order = by_value[torch.argsort(parked[by_value], stable=True)]
    ys = y[order]
    bounds = torch.searchsorted(parked[order], torch.arange(n_bins + 1, device=y.device))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    last = max(y.numel() - 1, 0)
    lo = ys[torch.clamp(starts + torch.div(counts - 1, 2, rounding_mode="floor"), 0, last)]
    hi = ys[torch.clamp(starts + torch.div(counts, 2, rounding_mode="floor"), 0, last)]
    return torch.where(counts > 0, 0.5 * (lo + hi), torch.nan)


def _median_where(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    return binned_median(flat, torch.zeros_like(flat, dtype=torch.long), keep.reshape(-1), 1)[0]


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the non-NaN entries of `x` where `valid` (0-dim tensor; NaN when none)."""
    return _median_where(x, valid.reshape(x.shape) & ~torch.isnan(x))


def nanmean(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Mean over the non-NaN entries, along `axis` or of all of `x`."""
    return torch.nanmean(x, dim=axis)


def nanstd(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Standard deviation (ddof 0) over the non-NaN entries, along `axis` or of all of `x`."""
    mean = torch.nanmean(x, dim=axis, keepdim=True)
    return torch.sqrt(torch.nanmean((x - mean) ** 2, dim=axis))


def nanmedian(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Median over the non-NaN entries, along `axis` or of all of `x`, as 0.5 * (lo + hi) of
    the middle pair (NaN where a slice has none).

    >>> float(nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan")])))
    2.5
    >>> nanmedian(torch.tensor([[1.0, 2.0], [3.0, float("nan")]]), axis=1).tolist()
    [1.5, 3.0]
    """
    if axis is None:
        return _median_where(x, ~torch.isnan(x))
    moved = torch.movedim(x, axis, -1)
    ordered = torch.sort(moved, dim=-1).values  # NaN sorts last
    n = (~torch.isnan(moved)).sum(dim=-1, keepdim=True)
    lo = torch.gather(ordered, -1, torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0))
    hi = torch.gather(ordered, -1, torch.div(n, 2, rounding_mode="floor").clamp(max=moved.shape[-1] - 1))
    return torch.where(n > 0, 0.5 * (lo + hi), torch.nan).squeeze(-1)


def nmad(x: torch.Tensor) -> torch.Tensor:
    """Normalized median absolute deviation: 1.4826 * median(|x - median(x)|), NaN-aware.

    >>> round(float(nmad(torch.tensor([1.0, 2.0, 3.0, 4.0, 100.0]))), 4)
    1.4826
    """
    med = nanmedian(x)
    return _NMAD_FACTOR * nanmedian(torch.abs(x - med))


def masked_nmad(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NMAD over the non-NaN entries of `x` where `valid` (0-dim tensor; NaN when none)."""
    keep = valid.reshape(-1) & ~torch.isnan(x.reshape(-1))
    med = _median_where(x, keep)
    return _NMAD_FACTOR * _median_where(torch.abs(x - med), keep)
