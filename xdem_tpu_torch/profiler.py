"""Profiling hooks: entry-point timing, memory sampling, PyTorch profiler traces and spans.

Counterpart of xdem_tpu/profiler.py, with upstream xdem's API: ``Profiler.enable(save_graphs,
save_raw_data)``, ``Profiler.generate_summary(dir)`` and the ``@profile("name", memprof=True)``
decorator on the entry points (``Coreg.fit``/``apply``, ``get_terrain_attribute``,
``estimate_uncertainty``). With ``jax_trace_dir`` (the name is xdem_tpu's), every profiled call
writes a ``torch.profiler`` Chrome trace into that directory. Tables are written with the csv
module (no pandas).

``span(name, devices=())`` marks a stage of the program (``xdem_tpu_torch.<module>.<stage>``).
While a ``torch.profiler`` records, a span is a ``record_function`` in that trace, on the clock
of the kernels and copies, with a CUDA event at its entry and exit on each card of `devices`;
``spans()`` returns the closed spans of the newest profiler session with each card's stream
time. While none records, a span costs one flag check and records nothing.
"""

from __future__ import annotations

import csv
import functools
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, TypeVar

import torch

from xdem_tpu_torch import _device

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


_recording = torch._C._autograd._profiler_enabled  # whether a torch.profiler records: ~0.3 us


class _NoSpan:
    """The span while no profiler records: one shared object that records nothing."""

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def count(self, key: str, n: int = 1) -> None:
        pass


_NO_SPAN = _NoSpan()


@dataclass
class SpanRecord:
    """A closed span: its name, its ordinal in the session (`id`), its parent's ordinal (None
    for a root), the ordinal of its root call among the session's roots, each card's stream
    milliseconds from its entry to its exit event ({card index: ms}) and its counters."""

    name: str
    id: int
    parent: int | None
    root: int
    ms: dict[int, float]
    counters: dict[str, int]


class _Spans:
    """The log of the newest profiler session: open spans by thread, closed spans in order."""

    def __init__(self) -> None:
        self.local = threading.local()
        self.watching = False  # whether profiler starts are counted (from the first traced span on)
        self.session = 0  # bumped at each profiler start (see _watch_profiler_starts)
        self.logged = 0  # the session the log holds
        self.reset()

    def reset(self) -> None:
        self.closed: list[_Span] = []
        self.ids, self.roots = itertools.count(), itertools.count()

    def stack(self) -> list:
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack


_SPANS = _Spans()


class _Span:
    """A span while a profiler records: a ``record_function`` and a pair of CUDA events on
    each card of `devices`."""

    def __init__(self, name: str, devices: Iterable[Any]):
        self.name, self.devices, self.counters = name, devices, {}

    def __enter__(self) -> "_Span":
        if not _SPANS.watching:
            _watch_profiler_starts()
        if _SPANS.logged != _SPANS.session:  # the first span of a new profiler session
            _SPANS.reset()
            _SPANS.logged = _SPANS.session
        stack = _SPANS.stack()
        self.id = next(_SPANS.ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[-1].root if stack else next(_SPANS.roots)
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.events = {}
        for index in sorted({_card_index(d) for d in self.devices} - {None}):
            self.events[index] = torch.cuda.Event(enable_timing=True)
            self.events[index].record(torch.cuda.current_stream(index))
        stack.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        for index, start in self.events.items():
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(index))
            self.events[index] = (start, end)
        self.record.__exit__(*exc)
        _SPANS.stack().remove(self)
        _SPANS.closed.append(self)

    def count(self, key: str, n: int = 1) -> None:
        """Add `n` to the span's counter `key`."""
        self.counters[key] = self.counters.get(key, 0) + n


def _card_index(device: Any) -> int | None:
    """The index of a CUDA device (its current card when it names none); None for another."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def span(name: str, devices: Iterable[Any] = ()) -> Any:
    """A context manager around a stage of the program, named ``xdem_tpu_torch.<module>.<stage>``;
    it yields a record whose ``.count(key, n=1)`` adds to a counter of the span.

    While a ``torch.profiler`` records, it enters ``torch.profiler.record_function(name)`` (the
    span lands in the profiler's trace beside the kernels and copies, on their clock) and records
    a timing event at entry and at exit on the current stream of each CUDA device of `devices`
    (no synchronize); the closed span goes into the log that :func:`spans` reads. While none
    records, it returns a shared no-op context: one flag check, no ``record_function``, no event.
    """
    if not _recording():
        return _NO_SPAN
    return _Span(name, devices)


def count(key: str, n: int = 1) -> None:
    """Add `n` to the counter `key` of the innermost span open on this thread, for a stage that
    counts work inside a span it does not open; outside any span, or while no profiler records,
    nothing (one flag check)."""
    if not _recording():
        return
    stack = _SPANS.stack()
    if stack:
        stack[-1].count(key, n)


def spans() -> list[SpanRecord]:
    """The closed spans of the newest profiler session, in the order they closed, with each
    card's stream milliseconds (each exit event is waited for: call once the work is done)."""
    out = []
    for s in list(_SPANS.closed):
        ms = {}
        for index, (start, end) in s.events.items():
            end.synchronize()
            ms[index] = start.elapsed_time(end)
        out.append(SpanRecord(s.name, s.id, s.parent, s.root, ms, dict(s.counters)))
    return out


def reset_spans() -> None:
    """Empty the log of spans."""
    _SPANS.reset()


def _watch_profiler_starts() -> None:
    """Count profiler sessions from the first traced span on: torch calls
    ``autograd.profiler._run_on_profiler_start`` as each profiler starts. Until a span records,
    torch is left as it is; a torch without that hook fails here, at the first traced span."""
    from torch.autograd import profiler as autograd_profiler

    start = autograd_profiler._run_on_profiler_start

    def run_on_profiler_start(*args: Any, **kwargs: Any) -> Any:
        _SPANS.session += 1
        return start(*args, **kwargs)

    autograd_profiler._run_on_profiler_start = run_on_profiler_start
    _SPANS.watching = True


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


_PROFILED = threading.local()  # .depth: the profiled calls open on this thread


def profile(name: str, memprof: bool = False) -> Callable[[F], F]:
    """Decorator: a :func:`span` named `name` around every call of an entry point; once
    ``Profiler.enable()`` was called, also record its wall time, its peak host RSS (and, on the
    cards, the largest card's peak device allocation) with `memprof`, and a trace with
    ``jax_trace_dir``. The clock stops after every card has finished. A profiled call inside
    another (``estimate_uncertainty``'s terrain call) lands in the outer call's trace and reads
    its peak since the outer call began: one profiler and one peak count a thread."""

    def decorator(func: F) -> F:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not Profiler._enabled:
                with span(name):
                    return func(*args, **kwargs)
            depth = getattr(_PROFILED, "depth", 0)
            sampler = None
            on_card = memprof and torch.cuda.is_available()
            cards = range(torch.cuda.device_count()) if on_card else ()
            if memprof:
                sampler = _MemorySampler()
                sampler.start()
                for i in cards if depth == 0 else ():
                    torch.cuda.reset_peak_memory_stats(i)
            trace = None
            if Profiler._jax_trace_dir is not None and not _recording():
                trace = torch.profiler.profile(activities=_activities())
                trace.__enter__()
            _PROFILED.depth = depth + 1
            t0 = time.perf_counter()
            try:
                with span(name):
                    return func(*args, **kwargs)
            finally:
                _PROFILED.depth = depth
                _device.synchronize([torch.device("cuda", i) for i in cards])  # a mesh= call runs on every card
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
        _device.synchronize()
    counts = {"executions": 0, "h2d_transfers": 0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith("Memcpy HtoD"):
            counts["h2d_transfers"] += 1
        elif not e.name.startswith(("Memcpy", "Memset")):
            counts["executions"] += 1
    return result, counts
