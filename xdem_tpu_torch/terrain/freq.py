"""Frequency-domain terrain attributes: fractional-Laplacian texture shading.

Port of xdem_tpu/terrain/freq.py on ``torch.fft``: an |f|^alpha filter in the rfft2 domain,
NaN in-fill with the mean of the valid pixels (removed before the transform, see
``_texture_core``), symmetric padding to the next FFT-friendly
size, the DC term zeroed for alpha > 0, NaNs restored. Runs on the device of its input.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xdem_tpu_torch._device import as_tensor


def next_fast_fft_size(n: int) -> int:
    """Next FFT-friendly size: power of two below 1024, else smallest 7-smooth number >= n."""
    if n <= 1:
        return 1
    if n <= 1024:
        return int(2 ** int(np.ceil(np.log2(n))))
    candidate = n
    while True:
        temp = candidate
        for f in (2, 3, 5, 7):
            while temp % f == 0:
                temp //= f
        if temp == 1:
            return candidate
        candidate += 1


def _pad_symmetric(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """numpy's ``mode="symmetric"`` padding along `dim` (the edge pixel is repeated, which
    ``F.pad``'s reflect mode leaves out). Each pad is shorter than the side, so one flipped
    strip per side is exact."""
    n = x.shape[dim]
    if before > n or after > n:
        raise ValueError(f"Symmetric padding of {before}+{after} exceeds the side length {n}.")
    parts = []
    if before:
        parts.append(x.narrow(dim, 0, before).flip(dim))
    parts.append(x)
    if after:
        parts.append(x.narrow(dim, n - after, after).flip(dim))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


def _texture_core(dem: torch.Tensor, alpha: float, fft_rows: int, fft_cols: int) -> torch.Tensor:
    rows, cols = dem.shape
    valid = torch.isfinite(dem)
    # xdem_tpu fills the invalid pixels with the valid mean and transforms elevations of
    # order 10^3 m as they are. Removing that mean first (the fill becomes 0) is the same
    # function: the filter zeroes the DC term for alpha > 0 and is the identity for alpha = 0,
    # where the mean is added back. The float32 transform then rounds at the relief's scale,
    # not the elevation's, which matters for an output of order 1 m or less.
    fill = torch.nanmean(torch.where(valid, dem, torch.nan))
    filled = torch.where(valid, dem - fill, 0.0)

    pad_rows = (fft_rows - rows) // 2
    pad_cols = (fft_cols - cols) // 2
    padded = _pad_symmetric(filled, 0, pad_rows, fft_rows - rows - pad_rows)
    padded = _pad_symmetric(padded, 1, pad_cols, fft_cols - cols - pad_cols)

    # Frequencies k / n in the DEM's dtype before the hypot and the power, as xdem_tpu forms
    # them (a division by a tensor: by a Python number CUDA multiplies by the reciprocal).
    def _freqs(k: np.ndarray, n: int) -> torch.Tensor:
        kt = torch.from_numpy(k.astype(np.float32)).to(device=dem.device, dtype=dem.dtype)
        return kt / torch.tensor(float(n), dtype=dem.dtype, device=dem.device)

    ky = (np.arange(fft_rows) + fft_rows // 2) % fft_rows - fft_rows // 2
    fy = _freqs(ky, fft_rows)[:, None]
    fx = _freqs(np.arange(fft_cols // 2 + 1), fft_cols)[None, :]
    freq = torch.hypot(fx, fy)
    freq[0, 0] = 1.0
    filt = freq**alpha
    if alpha > 0:
        filt[0, 0] = 0.0

    spec = torch.fft.rfft2(padded)
    out = torch.fft.irfft2(spec * filt, s=(fft_rows, fft_cols))
    out = out[pad_rows: pad_rows + rows, pad_cols: pad_cols + cols]
    if alpha == 0:
        out = out + fill
    return torch.where(valid, out, torch.nan).to(dem.dtype)


def texture_shading(dem: Any, alpha: float | None = 0.8) -> torch.Tensor:
    """Texture shading (Brown 2010) via fractional Laplacian |f|^alpha, alpha in [0, 2].

    A numpy input goes to the default device; a tensor is transformed where it lies."""
    if alpha is None:
        alpha = 0.8
    if not 0 <= alpha <= 2:
        raise ValueError(f"Alpha must be between 0 and 2, got {alpha}")
    dem = as_tensor(dem)
    rows, cols = dem.shape
    return _texture_core(dem, float(alpha), next_fast_fft_size(rows), next_fast_fft_size(cols))
