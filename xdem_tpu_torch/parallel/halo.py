"""Halo-exchange sharded stencils: a raster split into blocks over a 2-D mesh.

Counterpart of xdem_tpu/parallel/halo.py. The raster is NaN-padded to a multiple of the mesh
shape and cut into one block per shard, each sent once to its shard's device
(``sharded.shard``); for each stencil, every block is padded with `halo` rows and columns
from its eight mesh neighbours, corners included (peer-to-peer copies between cards), NaN at
the global edges; the stencil runs on the padded block on that shard's device, and the
interiors stay there as a ``ShardedArray``. A halo-padded interior pixel sees the
neighbourhood and the constants it sees in the whole-array call, so the sharded planes equal
the single-device planes to the bit.

On a CUDA shard the stencil functions of the terrain path are the hand-written kernels K1,
K2 and K3 (``terrain/cuda_kernels.py``), launched once per shard; on a CPU shard their plain
versions.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from xdem_tpu_torch.parallel._collectives import to
from xdem_tpu_torch.parallel.mesh import Mesh
from xdem_tpu_torch.parallel.sharded import ShardedArray, shard
from xdem_tpu_torch.profiler import span


def _exchange(src: ShardedArray, halo: int) -> list[list[torch.Tensor]]:
    """The (bh + 2 halo, bw + 2 halo) padded block of every shard, on its device, from the
    blocks already on the mesh: each block's own pixels, `halo` rows and columns from its
    eight neighbours (peer-to-peer copies between cards), NaN beyond the raster's edges.
    Raises when a block is narrower than the halo."""
    n_ry, n_rx = src.mesh.devices.shape
    bh, bw = src.block_shape
    if bh < halo or bw < halo:
        h, w = src.shape
        raise ValueError(
            f"Raster of shape {(h, w)} is too small to halo-shard with radius {halo} over a "
            f"{n_ry}x{n_rx} mesh: each device block must be at least {halo} px per axis "
            f"(need >= {halo * n_ry}x{halo * n_rx}). Use fewer devices or a 1-D mesh."
        )
    if halo == 0:
        return src._blocks
    # For a neighbour at offset -1, 0 or +1: where its strip lands in the padded block, and
    # which of its rows (or columns) it sends.
    dst = {-1: slice(0, halo), 0: slice(halo, halo + bh), 1: slice(halo + bh, bh + 2 * halo)}
    dst_c = {-1: slice(0, halo), 0: slice(halo, halo + bw), 1: slice(halo + bw, bw + 2 * halo)}
    sent = {-1: slice(bh - halo, bh), 0: slice(0, bh), 1: slice(0, halo)}
    sent_c = {-1: slice(bw - halo, bw), 0: slice(0, bw), 1: slice(0, halo)}
    # Every card's own block and NaN edges first, then the neighbours' strips: a copy between
    # two cards waits for the work already queued on both, so queuing a card's own copy after
    # a neighbour's strip would chain the cards' copies one after another.
    with span("xdem_tpu_torch.parallel.exchange", devices=src.mesh.devices.flat):
        padded = [[torch.empty((bh + 2 * halo, bw + 2 * halo), dtype=src.dtype, device=src.mesh.devices[iy, ix])
                   for ix in range(n_rx)] for iy in range(n_ry)]
        for own in (True, False):
            for iy in range(n_ry):
                for ix in range(n_rx):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            jy, jx = iy + dy, ix + dx
                            inside = 0 <= jy < n_ry and 0 <= jx < n_rx
                            if own != (dy == dx == 0 or not inside):
                                continue
                            target = padded[iy][ix][dst[dy], dst_c[dx]]
                            if inside:
                                target.copy_(src._blocks[jy][jx][sent[dy], sent_c[dx]], non_blocking=True)
                            else:
                                target.fill_(float("nan"))
    return padded


def sharded_stencil(
    fn: Callable[[torch.Tensor], torch.Tensor],
    arr: torch.Tensor | ShardedArray,
    halo: int,
    mesh: Mesh,
    out_leading: int | None = None,
) -> ShardedArray:
    """Apply a stencil function over a 2-D raster sharded on `mesh` with halo exchange.

    :param fn: Maps a halo-padded (h+2*halo, w+2*halo) block to (..., h+2*halo, w+2*halo)
        outputs computed with NaN-pad edge semantics, on the block's device; the interior is
        kept here.
    :param arr: Global (H, W) tensor, cut and sent to the shards here; or a `ShardedArray`
        already on the mesh (``shard(arr, mesh)``), so several stencils share one scatter.
    :param halo: Stencil radius.
    :param mesh: 2-D mesh with axes (row, col); a 1-D mesh is viewed as near-square. A
        `ShardedArray` input keeps its own mesh.
    :param out_leading: The leading size A when fn returns a stacked (A, h, w) output (kept
        for xdem_tpu's signature: the output's shape is fn's).
    :returns: The interiors as a `ShardedArray` (..., H, W) left on the mesh, each block on
        the device that computed it; nothing is gathered.
    """
    src = arr if isinstance(arr, ShardedArray) else shard(arr, mesh)
    bh, bw = src.block_shape
    outs = [[fn(p)[..., halo:halo + bh, halo:halo + bw] for p in row] for row in _exchange(src, halo)]
    return ShardedArray(outs, src.mesh, (*outs[0][0].shape[:-2], *src.shape))


def sharded_surface_attributes(
    arr: torch.Tensor | ShardedArray,
    resolution: float,
    mesh: Mesh,
    attrs: tuple[str, ...],
    surface_fit: str = "Florinsky",
    **kwargs: Any,
) -> ShardedArray:
    """Surface-fit attributes (K1) over a mesh-sharded DEM with halo exchange (halo 2 for
    Florinsky's 5 x 5 fit, 1 for the 3 x 3 fits), as a (len(attrs), H, W) `ShardedArray`.

    The centre removed before the stencils is the whole DEM's: ``center=`` among `kwargs`
    (K1's own parameter), or when it is absent ``cuda_kernels.dem_center`` of the tensor `arr` on
    its device, as the single-device call computes it, handed to every shard, so each block
    removes the same constant. A `ShardedArray` input needs ``center=``."""
    from xdem_tpu_torch.terrain import cuda_kernels

    center = kwargs.pop("center", None)
    halo = 2 if surface_fit.lower() == "florinsky" else 1
    if center is None:
        if isinstance(arr, ShardedArray):
            raise ValueError("A ShardedArray DEM needs center=: the whole DEM's cuda_kernels.dem_center.")
        center = cuda_kernels.dem_center(arr)

    def fn(padded: torch.Tensor) -> torch.Tensor:
        c = to(center, padded.device) if isinstance(center, torch.Tensor) else center
        return cuda_kernels.surface_attributes(padded, resolution, tuple(attrs), surface_fit=surface_fit,
                                               center=c, **kwargs)

    return sharded_stencil(fn, arr, halo=halo, mesh=mesh, out_leading=len(attrs))
