"""Rasters left on their mesh: one block per shard, on that shard's device.

Counterpart of the sharded arrays that xdem_tpu's ``shard_map`` stencils return
(``out_specs=P(row, col)``): a ``mesh=`` terrain call gives back planes whose blocks stay on
the cards that computed them, so four cards can hold results that no one card holds. A
:class:`ShardedArray` is assembled only when the caller asks for it: :meth:`~ShardedArray.numpy`
on the host, :meth:`~ShardedArray.to` on one device, :meth:`~ShardedArray.window` for a
window of it.

The raster is NaN-padded to a multiple of the mesh shape and cut into equal blocks, block
(iy, ix) on ``mesh.devices[iy, ix]``; the padding past the raster's last row and column is
kept in the blocks (the halo exchange reads it as the NaN edge) and trimmed by ``blocks`` and
every assembly.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from xdem_tpu_torch.parallel._collectives import to
from xdem_tpu_torch.parallel.mesh import Mesh, as_mesh_2d


def _free_bytes(device: torch.device) -> int:
    """Bytes a new tensor can take on the card `device`: its free memory plus what PyTorch's
    allocator holds unused there."""
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device))


def _span(start: int, stop: int, block: int, n: int) -> list[tuple[int, int, int]]:
    """(block index, first, stop) of each block's part of [start, stop), in block coordinates."""
    return [(i, max(start, i * block) - i * block, min(stop, (i + 1) * block) - i * block)
            for i in range(n) if max(start, i * block) < min(stop, (i + 1) * block)]


def _assemble(sharded: "ShardedArray", rows: slice, cols: slice, device: torch.device) -> torch.Tensor:
    """The window (rows, cols) of `sharded` (steps of 1, within its shape) in one tensor on
    `device`: the only place where blocks are gathered."""
    bh, bw = sharded.block_shape
    r0, r1, _ = rows.indices(sharded.shape[-2])
    c0, c1, _ = cols.indices(sharded.shape[-1])
    out = torch.empty((*sharded.shape[:-2], r1 - r0, c1 - c0), dtype=sharded.dtype, device=device)
    grid = sharded.mesh.devices.shape
    for iy, a0, a1 in _span(r0, r1, bh, grid[0]):
        for ix, b0, b1 in _span(c0, c1, bw, grid[1]):
            part = sharded._blocks[iy][ix][..., a0:a1, b0:b1]
            out[..., iy * bh + a0 - r0:iy * bh + a1 - r0, ix * bw + b0 - c0:ix * bw + b1 - c0].copy_(
                part, non_blocking=device.type == "cuda")
    return out


class ShardedArray:
    """A (..., H, W) raster as one (..., bh, bw) block per shard of a 2-D `mesh`, each on its
    shard's device. ``shape`` and ``dtype`` are the whole raster's."""

    def __init__(self, blocks: list[list[torch.Tensor]], mesh: Mesh, shape: tuple[int, ...]):
        self._blocks = blocks
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._blocks[0][0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Bytes of the whole raster once assembled."""
        return math.prod(self.shape) * self._blocks[0][0].element_size()

    @property
    def block_shape(self) -> tuple[int, int]:
        """(bh, bw): the rows and columns of every block, padding included."""
        return tuple(self._blocks[0][0].shape[-2:])

    @property
    def blocks(self) -> list[list[torch.Tensor]]:
        """Each shard's block as a view on its device, trimmed to the raster (the last row
        and column of blocks lose the padding to the mesh's multiple)."""
        bh, bw = self.block_shape
        h, w = self.shape[-2:]
        return [[b[..., :min(bh, h - iy * bh), :min(bw, w - ix * bw)] for ix, b in enumerate(row)]
                for iy, row in enumerate(self._blocks)]

    def __len__(self) -> int:
        if self.ndim < 3:
            raise TypeError("len() of a 2-D ShardedArray: it has no leading axis")
        return self.shape[0]

    def __getitem__(self, i: int) -> "ShardedArray":
        """Plane `i` of the leading axis, left on the mesh."""
        if self.ndim < 3:
            raise TypeError("A 2-D ShardedArray has no leading axis to index; use window() or to().")
        if not -self.shape[0] <= i < self.shape[0]:
            raise IndexError(f"index {i} is out of range for {self.shape[0]} planes")
        return ShardedArray([[b[i] for b in row] for row in self._blocks], self.mesh, self.shape[1:])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedArray":
        """`fn` of every block, on the block's device (an elementwise `fn`: the shape stays)."""
        return ShardedArray([[fn(b) for b in row] for row in self._blocks], self.mesh, self.shape)

    def window(self, rows: slice, cols: slice, device: torch.device | str | None = None) -> torch.Tensor:
        """The raster's window (rows, cols) (slices with step 1) in one tensor on `device`
        (default: the mesh's root)."""
        if rows.step not in (None, 1) or cols.step not in (None, 1):
            raise ValueError("window() takes slices with a step of 1.")
        return _assemble(self, rows, cols, torch.device(device) if device is not None else self.mesh.root)

    def to(self, device: torch.device | str) -> torch.Tensor:
        """The whole raster in one tensor on `device`. On a card, raises MemoryError, with the
        bytes it needs, when that is more than the card has free; on the host, fails as
        allocating the array would."""
        device = torch.device(device)
        if device.type == "cuda" and self.nbytes > (free := _free_bytes(device)):
            raise MemoryError(
                f"Assembling this {self.shape} {self.dtype} raster on {device} needs {self.nbytes} bytes, "
                f"and {device} has {free} free: keep it on the mesh (blocks, window(), map()).")
        return _assemble(self, slice(None), slice(None), device)

    def numpy(self) -> np.ndarray:
        """The whole raster as a host numpy array (see :meth:`to`)."""
        return self.to("cpu").numpy()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, blocks={self.block_shape} over "
                f"{tuple(self.mesh.devices.shape)}, devices={sorted({str(d) for d in self.mesh.devices.flat})})")


def shard(arr: torch.Tensor, mesh: Mesh) -> ShardedArray:
    """`arr` (H, W) NaN-padded to a multiple of the mesh shape and cut into one block per shard,
    each copied once to its shard's device (a 1-D mesh is viewed as near-square)."""
    mesh = as_mesh_2d(mesh)
    n_ry, n_rx = mesh.devices.shape
    h, w = arr.shape
    ph, pw = (-h) % n_ry, (-w) % n_rx
    if ph or pw:
        arr = torch.nn.functional.pad(arr, (0, pw, 0, ph), value=float("nan"))
    bh, bw = (h + ph) // n_ry, (w + pw) // n_rx
    blocks = [[to(arr[iy * bh:(iy + 1) * bh, ix * bw:(ix + 1) * bw], mesh.devices[iy, ix]).contiguous()
               for ix in range(n_rx)] for iy in range(n_ry)]
    return ShardedArray(blocks, mesh, (h, w))
