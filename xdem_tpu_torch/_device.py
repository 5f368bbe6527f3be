"""Device choice and input conversion.

The port runs in float32 on one device. Numpy inputs go to :func:`default_device`; a tensor
stays on the device it already lies on, and that device decides whether the hand-written
CUDA kernels or their plain PyTorch versions run.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from xdem_tpu_torch.ops.transfer import unmask

DTYPE = torch.float32


@functools.cache
def default_device() -> torch.device:
    """The first CUDA device when one is present, else the CPU; decided once per process."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def as_tensor(x: Any, device: torch.device | str | None = None) -> torch.Tensor:
    """A float32 tensor of `x`: masked arrays become NaN-filled, numpy goes to `device`
    (default :func:`default_device`), a tensor (or a Raster's data) keeps its device unless
    `device` is given."""
    x = unmask(x)
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
        return t.to(DTYPE) if t.dtype != DTYPE else t
    arr = np.ascontiguousarray(x, dtype=np.float32)
    if not arr.flags.writeable:  # torch.from_numpy warns on read-only memory (a JAX array's view)
        arr = arr.copy()
    return torch.from_numpy(arr).to(device or default_device())
