"""Host and device helpers: masked arrays to NaN, tensors to numpy, masks to bool tensors."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def unmask(a: Any) -> Any:
    """Normalize a numpy masked array to a NaN-filled float array (NaN is nodata everywhere
    in the port) and a Raster to its data tensor; any other input passes through."""
    if isinstance(a, np.ma.MaskedArray):
        return a.filled(np.nan) if np.issubdtype(a.dtype, np.floating) \
            else a.astype(np.float32).filled(np.nan)
    if hasattr(a, "get_nanarray") and isinstance(getattr(a, "data", None), torch.Tensor):
        return a.data
    return a


def host_array(x: Any, dtype: Any = None) -> np.ndarray:
    """A numpy array of `x` (tensors and Rasters are copied to the host; masked arrays become
    NaN)."""
    x = unmask(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def device_mask(mask: Any, shape: tuple[int, ...] | None = None, device: torch.device | str | None = None) -> torch.Tensor:
    """`mask` as a bool tensor on `device` (by default a tensor's own device, else the default
    device), checked against `shape` when given; `mask=None` with a `shape` means all True."""
    if device is None:
        from xdem_tpu_torch._device import default_device

        device = mask.device if isinstance(mask, torch.Tensor) else default_device()
    if mask is None:
        if shape is None:
            raise ValueError("device_mask(None) needs an explicit shape.")
        return torch.ones(shape, dtype=torch.bool, device=device)
    if isinstance(mask, torch.Tensor):
        out = mask.to(device=device, dtype=torch.bool)
    else:
        out = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(device)
    if shape is not None and tuple(out.shape) != tuple(shape):
        raise ValueError(f"Mask shape {tuple(out.shape)} does not match the raster shape {tuple(shape)}.")
    return out
