"""Device choice and input conversion.

The port runs in float32 on the card. Numpy inputs go to :func:`default_device`; a tensor
stays on the device it already lies on, and that device decides whether the hand-written
CUDA kernels or their plain PyTorch versions run. The CPU is used only where the caller asks
for it: a CPU tensor, or ``XDEM_TPU_PLATFORM=cpu`` for numpy inputs.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Iterable

import numpy as np
import torch

from xdem_tpu_torch.ops.transfer import unmask
from xdem_tpu_torch.parallel.sharded import ShardedArray

DTYPE = torch.float32


@functools.cache
def default_device() -> torch.device:
    """The first CUDA device; the CPU only when ``XDEM_TPU_PLATFORM=cpu`` asks for it. Raises
    RuntimeError where there is no card and the CPU was not asked for. Decided once per
    process (``default_device.cache_clear()`` decides again)."""
    if os.environ.get("XDEM_TPU_PLATFORM") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xdem_tpu_torch found no CUDA device. Set XDEM_TPU_PLATFORM=cpu to run on the CPU "
            "(the plain PyTorch versions of the kernels), or pass CPU tensors.")
    return torch.device("cuda", 0)


def synchronize(devices: Iterable[torch.device] | None = None) -> None:
    """Wait for every CUDA device among `devices` (default: every visible card), not only the
    current one as ``torch.cuda.synchronize()`` does. CPU devices need no wait."""
    if devices is None:
        if not torch.cuda.is_available():
            return
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def as_tensor(x: Any, device: torch.device | str | None = None) -> torch.Tensor:
    """A float32 tensor of `x`: masked arrays become NaN-filled, numpy goes to `device`
    (default :func:`default_device`), a tensor (or a Raster's data) keeps its device unless
    `device` is given, and a `parallel.ShardedArray` is assembled on `device` (default: its
    mesh's root)."""
    if isinstance(x, ShardedArray):
        x = x.to(device or x.mesh.root)
    x = unmask(x)
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
        return t.to(DTYPE) if t.dtype != DTYPE else t
    arr = np.ascontiguousarray(x, dtype=np.float32)
    if not arr.flags.writeable:  # torch.from_numpy warns on read-only memory (a JAX array's view)
        arr = arr.copy()
    return torch.from_numpy(arr).to(device or default_device())
