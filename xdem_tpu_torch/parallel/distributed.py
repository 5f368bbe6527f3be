"""Multi-process execution: ``torch.distributed`` clusters and meshes that span them.

Counterpart of xdem_tpu/parallel/distributed.py. Each process holds some shards (its local
devices) of a mesh that spans the cluster; the collectives of ``parallel._collectives`` sum
and gather across the processes of such a mesh with ``torch.distributed``, so the sharded
variogram and the halo-exchange stencils run unchanged over every shard of every process.
The platform is the card when one is present (NCCL, one card per process: NCCL cannot put two
ranks on one card), or what ``XDEM_TPU_PLATFORM`` says: ``cpu`` runs gloo over CPU shards, and is
the only way to run without a card. On one machine:

    python -m xdem_tpu_torch.parallel.distributed --coordinator 127.0.0.1:9876 \
        --num-processes 2 --process-id 0 --local-devices 4

`launch_local_cluster()` spawns such a group and has every worker check the cluster's
result against the port's own single-process result.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Sequence

import numpy as np
import torch

from xdem_tpu_torch.parallel._collectives import to
from xdem_tpu_torch.parallel.mesh import Mesh, _device_array, _one_shard

# This process's place in the cluster, set by initialize_multihost (the process group itself
# is torch.distributed's process-wide state).
_CLUSTER: dict = {}


def _platform(num_processes: int) -> str:
    """``XDEM_TPU_PLATFORM`` when it is set, else ``cuda``; ``cuda`` needs a card for each of the
    `num_processes` processes of this machine."""
    platform = os.environ.get("XDEM_TPU_PLATFORM", "cuda")
    if platform == "gpu":
        platform = "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"XDEM_TPU_PLATFORM={platform!r}: use 'cpu' (gloo) or 'cuda' (NCCL).")
    if platform == "cuda" and torch.cuda.device_count() < num_processes:
        raise RuntimeError(
            f"A cluster of {num_processes} processes on the card needs {num_processes} CUDA devices "
            f"(NCCL puts one process on each), found {torch.cuda.device_count()}. Set "
            "XDEM_TPU_PLATFORM=cpu to run it with gloo over CPU shards.")
    return platform


def initialize_multihost(coordinator: str, num_processes: int, process_id: int,
                         local_devices: int = 1) -> None:
    """Join a cluster of `num_processes` processes as rank `process_id`, with `local_devices`
    shards in this process. The coordinator ("host:port") hosts the rendezvous store. The
    shards lie on card ``process_id % device_count`` and the collectives use NCCL, unless
    ``XDEM_TPU_PLATFORM=cpu``: then they are CPU shards and the collectives use gloo."""
    import torch.distributed as dist

    if _platform(1) == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        backend, device = "nccl", torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id)
    _CLUSTER.update(devices=[device] * local_devices, n_processes=num_processes, rank=process_id, backend=backend)


def global_mesh(axis_name: str = "p") -> Mesh:
    """A 1-D mesh over every shard of every process in the cluster: its ``devices`` are this
    process's shards, its collectives reach the other processes."""
    if not _CLUSTER:
        raise RuntimeError("Call initialize_multihost() before global_mesh().")
    devs = _CLUSTER["devices"]
    return Mesh(_device_array(devs, (len(devs),)), (axis_name,), n_processes=_CLUSTER["n_processes"],
                process_index=_CLUSTER["rank"])


def multihost_variogram_bins(
    za_local,
    zb_local,
    ca_local,
    cb_local,
    bin_edges: Sequence[float],
    mesh: Mesh,
    estimator: str = "matheron",
):
    """Variogram bins over the runs of every process: each passes its own runs only (the
    same number in every process), split over its shards; the bins are summed (and Dowd's
    histograms, Genton's reservoirs) across all shards of all processes. Returns (gamma,
    counts), the same in every process."""
    from xdem_tpu_torch.parallel.variogram import sharded_variogram_bins

    return sharded_variogram_bins(za_local, zb_local, ca_local, cb_local, bin_edges, mesh, estimator=estimator)


def multihost_surface_attributes(
    dem_local_rows,
    mesh: Mesh,
    resolution: float,
    attrs: tuple[str, ...],
    **kwargs,
):
    """Surface-fit attributes (K1) of a raster whose horizontal bands (the same number of rows
    in every process, in rank order) lie in the processes of the cluster. The halo rows cross
    the process boundaries, then each band is halo-sharded over its process's shards (the
    column axis); the centre is the whole raster's mean (`cluster_center`). Returns the
    (len(attrs), H, W) numpy result in every process."""
    import torch.distributed as dist

    from xdem_tpu_torch.parallel.halo import sharded_stencil
    from xdem_tpu_torch.terrain import cuda_kernels

    rank, n_proc = mesh.process_index, mesh.n_processes
    local = torch.as_tensor(np.ascontiguousarray(dem_local_rows, dtype=np.float32)).to(mesh.root)
    halo = 2 if kwargs.get("surface_fit", "Florinsky").lower() == "florinsky" else 1
    center = cluster_center(local)

    edges = torch.stack([local[:halo], local[-halo:]]).contiguous()
    gathered = [torch.empty_like(edges) for _ in range(n_proc)]
    dist.all_gather(gathered, edges)
    nan_rows = torch.full((halo, local.shape[1]), float("nan"), device=local.device)
    band = torch.cat([gathered[rank - 1][1] if rank > 0 else nan_rows, local,
                      gathered[rank + 1][0] if rank < n_proc - 1 else nan_rows])

    def fn(padded: torch.Tensor) -> torch.Tensor:
        return cuda_kernels.surface_attributes(padded, resolution, tuple(attrs), center=to(center, padded.device),
                                               **kwargs)

    row = Mesh(mesh.devices.reshape(1, -1), ("ry", "rx"))
    out = sharded_stencil(fn, band, halo, row).window(slice(halo, band.shape[0] - halo), slice(None), mesh.root)
    parts = [torch.empty_like(out) for _ in range(n_proc)]
    dist.all_gather(parts, out)
    return torch.cat(parts, dim=1).cpu().numpy()


def cluster_center(local: torch.Tensor) -> torch.Tensor:
    """The mean of the finite pixels of every process's `local` band (0 where none is finite),
    summed in float64 across the cluster and rounded once to a 0-dim float32 tensor."""
    import torch.distributed as dist

    valid = torch.isfinite(local)
    total = torch.stack([torch.where(valid, local, 0.0).double().sum(), valid.sum().double()])
    dist.all_reduce(total)
    return (total[0] / total[1] if total[1] > 0 else total[0] * 0).to(torch.float32)


def _make_run_data(seed: int, n_runs: int, n: int, m: int):
    rng = np.random.default_rng(seed)
    za = rng.normal(0, 2.0, (n_runs, n)).astype(np.float32)
    zb = rng.normal(0, 2.0, (n_runs, m)).astype(np.float32)
    ca = rng.uniform(0, 1000, (n_runs, n, 2)).astype(np.float32)
    cb = rng.uniform(0, 1000, (n_runs, m, 2)).astype(np.float32)
    return za, zb, ca, cb


def _worker_main(coordinator: str, num_processes: int, process_id: int, local_devices: int) -> None:
    import torch.distributed as dist

    from xdem_tpu_torch.parallel.variogram import sharded_variogram_bins
    from xdem_tpu_torch.terrain import cuda_kernels

    torch.set_num_threads(1)
    initialize_multihost(coordinator, num_processes, process_id, local_devices)
    mesh = global_mesh()
    n_dev = mesh.devices.size * num_processes
    n, m = 24, 40
    edges = [0.0, 250.0, 600.0, 1500.0]

    # One global dataset; each process holds only its slice of the runs.
    za, zb, ca, cb = _make_run_data(7, 2 * n_dev, n, m)
    lo = process_id * (za.shape[0] // num_processes)
    hi = (process_id + 1) * (za.shape[0] // num_processes)
    gamma, counts = multihost_variogram_bins(za[lo:hi], zb[lo:hi], ca[lo:hi], cb[lo:hi], edges, mesh,
                                             estimator="dowd")
    g1, c1 = sharded_variogram_bins(za, zb, ca, cb, edges, _one_shard(mesh.root), estimator="dowd")
    if not (np.array_equal(counts, c1) and np.array_equal(gamma, g1, equal_nan=True)):
        raise AssertionError(f"cluster variogram {gamma, counts} != single-process {g1, c1}")

    # Spatial decomposition across processes: the row bands of the raster in rank order.
    H, W = 16 * num_processes, 128
    rng2 = np.random.default_rng(11)
    dem_full = np.cumsum(rng2.normal(0, 1, (H, W)), axis=0).astype(np.float32) * 3 + 500
    attrs = ("slope", "aspect", "hillshade")
    band = dem_full[process_id * (H // num_processes):(process_id + 1) * (H // num_processes)]
    out = multihost_surface_attributes(band, mesh, 20.0, attrs, surface_fit="Florinsky")
    # One process's planes of the whole raster with the cluster's centre: equal to the bit.
    center = cluster_center(torch.from_numpy(np.ascontiguousarray(band)).to(mesh.root))
    want = cuda_kernels.surface_attributes(torch.from_numpy(dem_full).to(mesh.root), 20.0, attrs,
                                           surface_fit="Florinsky", center=center).cpu().numpy()
    if not np.array_equal(out, want, equal_nan=True):
        raise AssertionError("cluster surface attributes differ from the single-process result")

    if process_id == 0:
        print(
            f"DISTRIBUTED OK: {num_processes} processes x {mesh.devices.size} devices = {n_dev} global "
            f"devices ({_CLUSTER['backend']} over {mesh.root.type}); dowd bins "
            f"{np.round(gamma, 4).tolist()} counts {counts.tolist()} equal to one process's; cross-process "
            f"halo stencil {out.shape} equal to one process's to the bit",
            flush=True,
        )
    dist.destroy_process_group()


def launch_local_cluster(num_processes: int = 2, local_devices: int = 4, timeout: float = 600.0) -> str:
    """Spawn a cluster of `num_processes` local processes with `local_devices` shards each,
    running the distributed check: on one card per process (NCCL), or on the CPU (gloo) when
    ``XDEM_TPU_PLATFORM=cpu``. Raises before starting anything when the machine has fewer
    cards than processes and the CPU was not asked for.

    Returns process 0's standard output (it contains 'DISTRIBUTED OK' and the route); raises
    on any failure, after ending every worker."""
    import socket

    platform = _platform(num_processes)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["XDEM_TPU_PLATFORM"] = platform
    env["OMP_NUM_THREADS"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "xdem_tpu_torch.parallel.distributed",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(num_processes),
             "--process-id", str(i), "--local-devices", str(local_devices)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(num_processes)
    ]
    outs, failed = [], []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"distributed worker {i} timed out after {timeout} s") from None
            outs.append(out)
            if p.returncode != 0:
                failed.append((i, p.returncode, err[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"distributed workers failed: {failed}")
    if "DISTRIBUTED OK" not in outs[0]:
        raise RuntimeError(f"process 0 did not report success: {outs[0][-500:]}")
    return outs[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=1)
    args = ap.parse_args()
    _worker_main(args.coordinator, args.num_processes, args.process_id, args.local_devices)
