"""Halo-exchange sharded stencils: a raster split into blocks over a 2-D mesh.

Counterpart of xdem_tpu/parallel/halo.py. The raster is NaN-padded to a multiple of the mesh
shape and cut into one block per shard; each block receives `halo` rows and then `halo`
columns from its mesh neighbours (the columns of the row-padded neighbours, so the corners
ride along), NaN at the global edges; the stencil runs on the padded block on that shard's
device, and the interiors are assembled on the source device. A halo-padded interior pixel
sees the neighbourhood and the constants it sees in the whole-array call, so the sharded
planes equal the single-device planes to the bit.

On a CUDA shard the stencil functions of the terrain path are the hand-written kernels K1,
K2 and K3 (``terrain/cuda_kernels.py``), launched once per shard; on a CPU shard their plain
versions.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from xdem_tpu_torch.parallel._collectives import to
from xdem_tpu_torch.parallel.mesh import Mesh, as_mesh_2d


def _pad_to_mesh(arr: torch.Tensor, halo: int, mesh: Mesh) -> tuple[torch.Tensor, int, int]:
    """`arr` NaN-padded to a multiple of the mesh shape; (padded, block rows, block cols).
    Raises when a block would be narrower than the halo."""
    n_ry, n_rx = mesh.devices.shape
    h, w = arr.shape
    ph, pw = (-h) % n_ry, (-w) % n_rx
    if (h + ph) // n_ry < halo or (w + pw) // n_rx < halo:
        raise ValueError(
            f"Raster of shape {(h, w)} is too small to halo-shard with radius {halo} over a "
            f"{n_ry}x{n_rx} mesh: each device block must be at least {halo} px per axis "
            f"(need >= {halo * n_ry}x{halo * n_rx}). Use fewer devices or a 1-D mesh."
        )
    if ph or pw:
        arr = torch.nn.functional.pad(arr, (0, pw, 0, ph), value=float("nan"))
    return arr, (h + ph) // n_ry, (w + pw) // n_rx


def _halo_blocks(arr: torch.Tensor, halo: int, mesh: Mesh) -> list[list[torch.Tensor]]:
    """The (bh + 2 halo, bw + 2 halo) padded block of every shard, on its device, from an
    array already padded to a multiple of the mesh shape. Two-phase exchange: rows from the
    blocks above and below, then columns from the row-padded blocks left and right."""
    n_ry, n_rx = mesh.devices.shape
    bh, bw = arr.shape[0] // n_ry, arr.shape[1] // n_rx
    devs = mesh.devices
    blocks = [[to(arr[iy * bh:(iy + 1) * bh, ix * bw:(ix + 1) * bw], devs[iy, ix]) for ix in range(n_rx)]
              for iy in range(n_ry)]
    if halo == 0:
        return [[b.contiguous() for b in row] for row in blocks]

    def nan(shape, dev):
        return torch.full(shape, float("nan"), dtype=arr.dtype, device=dev)

    rows = [[None] * n_rx for _ in range(n_ry)]
    for iy in range(n_ry):
        for ix in range(n_rx):
            d = devs[iy, ix]
            above = to(blocks[iy - 1][ix][-halo:], d) if iy > 0 else nan((halo, bw), d)
            below = to(blocks[iy + 1][ix][:halo], d) if iy < n_ry - 1 else nan((halo, bw), d)
            rows[iy][ix] = torch.cat([above, blocks[iy][ix], below])
    padded = [[None] * n_rx for _ in range(n_ry)]
    for iy in range(n_ry):
        for ix in range(n_rx):
            d = devs[iy, ix]
            left = to(rows[iy][ix - 1][:, -halo:], d) if ix > 0 else nan((bh + 2 * halo, halo), d)
            right = to(rows[iy][ix + 1][:, :halo], d) if ix < n_rx - 1 else nan((bh + 2 * halo, halo), d)
            padded[iy][ix] = torch.cat([left, rows[iy][ix], right], dim=1)
    return padded


def _assemble(outs: list[list[torch.Tensor]], halo: int, shape: tuple[int, int], device: torch.device) -> torch.Tensor:
    """The interiors of the per-shard outputs (..., bh + 2 halo, bw + 2 halo) written into
    one (..., H, W) tensor on `device` (H, W: the unpadded raster's shape)."""
    n_ry, n_rx = len(outs), len(outs[0])
    lead = outs[0][0].shape[:-2]
    bh, bw = outs[0][0].shape[-2] - 2 * halo, outs[0][0].shape[-1] - 2 * halo
    out = torch.empty((*lead, n_ry * bh, n_rx * bw), dtype=outs[0][0].dtype, device=device)
    for iy in range(n_ry):
        for ix in range(n_rx):
            out[..., iy * bh:(iy + 1) * bh, ix * bw:(ix + 1) * bw].copy_(
                outs[iy][ix][..., halo:halo + bh, halo:halo + bw], non_blocking=device.type == "cuda")
    return out[..., :shape[0], :shape[1]]


def sharded_stencil(
    fn: Callable[[torch.Tensor], torch.Tensor],
    arr: torch.Tensor,
    halo: int,
    mesh: Mesh,
    out_leading: int | None = None,
) -> torch.Tensor:
    """Apply a stencil function over a 2-D tensor sharded on `mesh` with halo exchange.

    :param fn: Maps a halo-padded (h+2*halo, w+2*halo) block to (..., h+2*halo, w+2*halo)
        outputs computed with NaN-pad edge semantics, on the block's device; the interior is
        extracted here.
    :param arr: Global (H, W) tensor; the output lands on its device.
    :param halo: Stencil radius.
    :param mesh: 2-D mesh with axes (row, col); a 1-D mesh is viewed as near-square.
    :param out_leading: The leading size A when fn returns a stacked (A, h, w) output (kept
        for xdem_tpu's signature: the output's shape is fn's).
    """
    if len(mesh.axis_names) != 2:
        mesh = as_mesh_2d(mesh)
    padded_arr, _, _ = _pad_to_mesh(arr, halo, mesh)
    blocks = _halo_blocks(padded_arr, halo, mesh)
    outs = [[fn(b) for b in row] for row in blocks]
    return _assemble(outs, halo, tuple(arr.shape), arr.device)


def sharded_surface_attributes(
    arr: torch.Tensor,
    resolution: float,
    mesh: Mesh,
    attrs: tuple[str, ...],
    surface_fit: str = "Florinsky",
    **kwargs: Any,
) -> torch.Tensor:
    """Surface-fit attributes (K1) over a mesh-sharded DEM with halo exchange (halo 2 for
    Florinsky's 5 x 5 fit, 1 for the 3 x 3 fits).

    The centre removed before the stencils is the whole DEM's, computed once on the source
    device with ``surfit.dem_center`` as the single-device call computes it, and handed to
    every shard: each block then removes the same constant."""
    from xdem_tpu_torch.terrain import cuda_kernels, surfit

    halo = 2 if surface_fit.lower() == "florinsky" else 1
    center = surfit.dem_center(arr)

    def fn(padded: torch.Tensor) -> torch.Tensor:
        return cuda_kernels.surface_attributes(padded, resolution, tuple(attrs), surface_fit=surface_fit,
                                               center=to(center, padded.device), **kwargs)

    return sharded_stencil(fn, arr, halo=halo, mesh=mesh, out_leading=len(attrs))
