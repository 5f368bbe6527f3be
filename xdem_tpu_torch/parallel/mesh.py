"""Device meshes: the shards of a multi-device run, one process driving every device.

Counterpart of xdem_tpu/parallel/mesh.py. A :class:`Mesh` is a numpy object array of
``torch.device`` (its ``.shape`` and ``.size`` are the mesh's) with one name per axis. Each
entry is one shard; a device may appear several times, so ``[torch.device("cpu")] * 8`` is an
8-shard mesh on the CPU (the counterpart of XLA's virtual CPU devices) and
``[torch.device("cuda", 0)] * 4`` a 4-shard mesh on one card. A mesh made by
``parallel.distributed.global_mesh`` also spans the other processes of a cluster: its
``devices`` are this process's shards, and its collectives reach the others.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _near_square_factors(n: int) -> tuple[int, int]:
    """Factor n into (a, b) with a*b = n and a <= b as square as possible."""
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def _device_array(devices: Sequence[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


class Mesh:
    """Shards laid out on named axes: ``devices`` (numpy object array of ``torch.device``) and
    ``axis_names``. ``n_processes`` and ``process_index`` place this process's shards in a
    cluster (1 and 0 for a mesh of one process)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], n_processes: int = 1,
                 process_index: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"A mesh of shape {self.devices.shape} needs {self.devices.ndim} axis names, "
                             f"got {self.axis_names}.")
        self.n_processes = int(n_processes)
        self.process_index = int(process_index)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def root(self) -> torch.device:
        """The device that receives the sums and gathers of the collectives."""
        return self.devices.flat[0]

    def reshape(self, shape: tuple[int, ...], axis_names: Sequence[str]) -> "Mesh":
        return Mesh(self.devices.reshape(shape), axis_names, self.n_processes, self.process_index)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _one_shard(device: torch.device, axis_name: str = "p") -> Mesh:
    """A 1-D mesh of one shard on `device`: the single-device case of a sharded loop, whose
    collectives then add nothing and move nothing."""
    return Mesh(_device_array([device], (1,)), (axis_name,))


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("ry", "rx"),
    shape: tuple[int, int] | None = None,
    devices: Sequence[torch.device] | None = None,
) -> Mesh:
    """A 2-D mesh (rows x cols) for sharding rasters spatially.

    :param n_devices: Number of shards (default: every device given or found).
    :param axis_names: Mesh axis names, (row-axis, col-axis).
    :param shape: Explicit (rows, cols) mesh shape; default near-square factorization.
    :param devices: Explicit device list, one shard per entry (a device may repeat). Without
        it, every CUDA device; there is no CPU fallback: pass ``[torch.device("cpu")] * n``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device. Pass devices= explicitly, e.g. "
                "make_mesh(devices=[torch.device('cpu')] * 8) for an 8-shard mesh on the CPU.")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if shape is None:
        shape = _near_square_factors(n_devices)
    if shape[0] * shape[1] != n_devices:
        raise ValueError(f"Mesh shape {shape} does not match device count {n_devices}.")
    return Mesh(_device_array(devices, tuple(shape)), axis_names=tuple(axis_names))


def as_mesh_1d(mesh: Mesh, axis_name: str = "runs") -> Mesh:
    """View a mesh's devices as a 1-D mesh (for run-sharded workloads like the variogram).

    A 1-D input mesh is returned unchanged; an N-D mesh is flattened over all its devices.
    """
    if len(mesh.axis_names) == 1:
        return mesh
    return mesh.reshape((mesh.devices.size,), (axis_name,))


def as_mesh_2d(mesh: Mesh) -> Mesh:
    """View a mesh's devices as a 2-D (rows x cols) mesh (for halo-sharded stencils).

    A 2-D input mesh is returned unchanged; a 1-D mesh of n devices becomes near-square
    (rows x cols) so stencil halos stay small in both dimensions.
    """
    if len(mesh.axis_names) == 2:
        return mesh
    return mesh.reshape(_near_square_factors(mesh.devices.size), ("ry", "rx"))
