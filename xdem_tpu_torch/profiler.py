"""Profiling hooks: entry-point timing, memory sampling and PyTorch profiler traces.

Counterpart of xdem_tpu/profiler.py, with upstream xdem's API: ``Profiler.enable(save_graphs,
save_raw_data)``, ``Profiler.generate_summary(dir)`` and the ``@profile("name", memprof=True)``
decorator on the entry points (``Coreg.fit``/``apply``, ``get_terrain_attribute``). With
``jax_trace_dir`` (the name is xdem_tpu's), every profiled call writes a ``torch.profiler``
Chrome trace into that directory. Tables are written with the csv module (no pandas).
"""

from __future__ import annotations

import csv
import functools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, TypeVar

import torch

from xdem_tpu_torch._device import synchronize

F = TypeVar("F", bound=Callable[..., Any])


class _MemorySampler(threading.Thread):
    """Samples host RSS every `interval` seconds while a profiled call runs."""

    def __init__(self, interval: float = 0.05):
        super().__init__(daemon=True)
        self.interval = interval
        self.samples: list[float] = []
        self._stop_evt = threading.Event()

    @staticmethod
    def _rss_mb() -> float:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
        except (OSError, ValueError):
            return float("nan")

    def run(self) -> None:
        while not self._stop_evt.is_set():
            self.samples.append(self._rss_mb())
            self._stop_evt.wait(self.interval)

    def stop(self) -> list[float]:
        self._stop_evt.set()
        self.join(timeout=1)
        return self.samples


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Global profiler: enable once, decorate entry points, generate a summary."""

    _enabled = False
    _save_graphs = False
    _save_raw_data = False
    _jax_trace_dir: str | None = None
    _records: list[dict[str, Any]] = []

    @classmethod
    def enable(cls, save_graphs: bool = False, save_raw_data: bool = False,
               jax_trace_dir: str | None = None) -> None:
        """Start recording profiled calls; with `jax_trace_dir`, also write a torch.profiler
        trace of each call there."""
        cls._enabled = True
        cls._save_graphs = save_graphs
        cls._save_raw_data = save_raw_data
        cls._jax_trace_dir = jax_trace_dir
        cls._records = []

    @classmethod
    def disable(cls) -> None:
        cls._enabled = False

    @classmethod
    def records(cls) -> list[dict[str, Any]]:
        return list(cls._records)

    @classmethod
    def generate_summary(cls, directory: str | Path) -> Path:
        """Write per-entry-point timing/memory tables (CSV + JSON) and return the directory."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        if cls._records:
            by_name: dict[str, list[dict[str, Any]]] = {}
            for r in cls._records:
                by_name.setdefault(r["name"], []).append(r)
            agg = [{"name": name, "calls": len(rs), "total_s": sum(r["wall_s"] for r in rs),
                    "mean_s": sum(r["wall_s"] for r in rs) / len(rs), "max_s": max(r["wall_s"] for r in rs),
                    "peak_mem_mb": max(r["peak_mem_mb"] for r in rs)} for name, rs in by_name.items()]
            agg.sort(key=lambda a: a["total_s"], reverse=True)
            _write_csv(directory / "profiling_summary.csv", agg)
            if cls._save_raw_data:
                _write_csv(directory / "profiling_raw.csv", cls._records)
            if cls._save_graphs:
                try:
                    import matplotlib

                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt

                    fig, ax = plt.subplots(figsize=(8, max(2, 0.4 * len(agg))))
                    ax.barh([a["name"] for a in agg], [a["total_s"] for a in agg])
                    ax.set_xlabel("total wall time (s)")
                    fig.savefig(directory / "profiling_graph.png", dpi=120, bbox_inches="tight")
                    plt.close(fig)
                except ImportError:
                    logging.warning("matplotlib is not installed: no profiling graph.")
        (directory / "profiling_meta.json").write_text(
            json.dumps({"n_records": len(cls._records), "jax_trace_dir": cls._jax_trace_dir})
        )
        return directory


def _write_csv(path: Path, rows: list[dict[str, Any]]) -> None:
    keys = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)


def profile(name: str, memprof: bool = False) -> Callable[[F], F]:
    """Decorator: record the wall time of an entry point, its peak host RSS (and, on the
    cards, the largest card's peak device allocation) with `memprof`, and a trace when
    enabled. The clock stops after every card has finished."""

    def decorator(func: F) -> F:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not Profiler._enabled:
                return func(*args, **kwargs)
            sampler = None
            on_card = memprof and torch.cuda.is_available()
            cards = range(torch.cuda.device_count()) if on_card else ()
            if memprof:
                sampler = _MemorySampler()
                sampler.start()
                for i in cards:
                    torch.cuda.reset_peak_memory_stats(i)
            trace = None
            if Profiler._jax_trace_dir is not None:
                trace = torch.profiler.profile(activities=_activities())
                trace.__enter__()
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                synchronize([torch.device("cuda", i) for i in cards])  # a mesh= call runs on every card
                wall = time.perf_counter() - t0
                if trace is not None:
                    trace.__exit__(None, None, None)
                    os.makedirs(Profiler._jax_trace_dir, exist_ok=True)
                    trace.export_chrome_trace(os.path.join(
                        Profiler._jax_trace_dir, f"{name}.{time.time_ns()}.pt.trace.json"))
                record = {"name": name, "wall_s": wall, "peak_mem_mb": float("nan"), "ts": time.time()}
                if sampler is not None:
                    samples = sampler.stop()
                    record["peak_mem_mb"] = max(samples) if samples else float("nan")
                if on_card:
                    record["peak_device_mem_mb"] = max(torch.cuda.max_memory_allocated(i) / 1e6 for i in cards)
                Profiler._records.append(record)
                logging.debug("profile[%s]: %.4f s", name, wall)

        return wrapper  # type: ignore[return-value]

    return decorator


def count_device_dispatches(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a torch.profiler trace and count device dispatches.

    Returns ``(result, counts)`` where counts has:
      - ``executions``: CUDA kernel launches (the device's kernel events of the trace);
      - ``h2d_transfers``: host-to-device copies.

    A CPU run launches no CUDA kernel and counts 0 of both. The trace adds overhead: time
    separately.
    """
    with torch.profiler.profile(activities=_activities()) as prof:
        result = fn(*args, **kwargs)
        synchronize()
    counts = {"executions": 0, "h2d_transfers": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("Memcpy HtoD"):
            counts["h2d_transfers"] += 1
        elif not e.name.startswith(("Memcpy", "Memset")):
            counts["executions"] += 1
    return result, counts
