"""The three collectives of the sharded paths, over lists of per-shard tensors.

xdem_tpu runs its multi-device code inside ``shard_map`` with ``ppermute``, ``psum`` and
``all_gather``. Here one process holds a list with one tensor per shard of a
:class:`~xdem_tpu_torch.parallel.mesh.Mesh`, and:

* :func:`to` moves a tensor to another shard's device (a peer-to-peer copy between cards,
  queued without waiting for the host), and :func:`scatter` and :func:`replicate` place a
  tensor's parts or copies on the shards;
* :func:`psum` adds the shards' partials on the mesh's root device, in shard order, so the
  result does not depend on which card holds which shard;
* :func:`all_gather` stacks them there.

A mesh that spans several processes (``parallel.distributed.global_mesh``) finishes each sum
and gather across the processes with ``torch.distributed``. Nothing here reads a device value
on the host, so a loop over the shards queues work on every card before anything waits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from xdem_tpu_torch.parallel.mesh import Mesh


def to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: the same tensor when it is there already (never write into the
    result), else a copy queued on the streams of both devices."""
    device = torch.device(device)
    if t.device == device:
        return t
    # A copy to the host cannot be non-blocking: the host would read it before it lands.
    return t.to(device, non_blocking=device.type == "cuda")


def replicate(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """One reference of `t` per shard of `mesh`, copied once per distinct device."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for d in mesh.devices.flat:
        if d not in copies:
            copies[d] = to(t, d)
        out.append(copies[d])
    return out


def scatter(a: torch.Tensor, mesh: Mesh, fill: float) -> list[torch.Tensor]:
    """`a` split along its first axis into one equal part per shard, on that shard's device,
    after padding it to a multiple of the shard count with `fill` (a value every caller's
    statistic ignores: NaN, zero weights, sentinel points)."""
    n_dev = mesh.devices.size
    pad = (-a.shape[0]) % n_dev
    if pad:
        a = torch.cat([a, torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)])
    return [to(p, d).contiguous() for p, d in zip(torch.tensor_split(a, n_dev), mesh.devices.flat)]


def _distributed(mesh: Mesh) -> bool:
    return mesh.n_processes > 1


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of the shards' `parts` on the mesh's root device, added in shard order (then over
    the processes of a cluster)."""
    total = to(parts[0], mesh.root).clone()
    for p in parts[1:]:
        total += to(p, mesh.root)
    if _distributed(mesh):
        import torch.distributed as dist

        dist.all_reduce(total)
    return total


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' `parts` stacked on a new leading axis on the root device, in global shard
    order (the processes of a cluster in rank order)."""
    local = torch.stack([to(p, mesh.root) for p in parts])
    if not _distributed(mesh):
        return local
    import torch.distributed as dist

    gathered = [torch.empty_like(local) for _ in range(mesh.n_processes)]
    dist.all_gather(gathered, local.contiguous())
    return torch.cat(gathered)


def shard_offset(mesh: Mesh) -> int:
    """Global index of this process's first shard (0 for a mesh of one process)."""
    return mesh.process_index * mesh.devices.size
