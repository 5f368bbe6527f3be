#!/usr/bin/env python3
"""Run one cell of xdem_tpu_torch's benchmark once and print its result as the last line.

    python3 gpu_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpu_bench/`` and the
``xdem_tpu_torch`` package. The cell names a configuration (``gpu_bench/configs/``), a traffic
mix (``gpu_bench/mixes/<traffic>.json``, whose kind names ``gpu_bench/kinds/<kind>.py``) and the
cards it needs; its limits are in ``gpu_bench/limits/<cell>.json`` and each metric is read by
``gpu_bench/metrics/<metric>.py``.

A run makes its inputs from the seed on the card, warms up every call it will time, then
calls the program in a closed loop (the next call after the previous one's wait on every
card) for ``--seconds``. With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a ``torch.profiler`` window over the same loop. Once
the window has closed it reads the peak device memory, holds a sample of the calls' outputs
to the plain reference (``gpu_bench/reference*.py``) and prints each compared number beside
its limit, last on standard error and last in the result line. It exits non-zero and prints
no result without the cards the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The moment this process began, on the monotonic clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "xdem_tpu")


def _set_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout (the program's own nvcc build
    directory already is: ``xdem_tpu_torch/_build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(spec: dict, cell: dict, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or with a trace its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    """The `read(run)` function of gpu_bench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Call:
    """One timed call: host-clock start and end (s, from the window's start) and its spans."""

    def __init__(self, start: float, end: float, spans: dict, pixels: int, ok: bool):
        self.start, self.end, self.spans, self.pixels, self.ok = start, end, spans, pixels, ok

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, traced: bool, devices, size: int | None = None):
    """Set up, time and check one cell on `devices`. Returns (result dict, checks): checks are
    (name, value, limit) triples; `size` overrides the configuration's side (tests only)."""
    import numpy as np
    import torch

    from gpu_bench import inputs, trace, traffic

    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    mix = load_json(BENCH / "mixes" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell['name']}.json")
    on_card = devices[0].type == "cuda"
    for d in devices if on_card else ():
        torch.empty(0, device=d)  # the card's context first: its statistics need one
        torch.cuda.reset_peak_memory_stats(d)
    log(f"{time.monotonic() - T_PROCESS:.3f} s: torch and {len(devices)} device context(s) ready")

    # --- set-up: inputs, then one call on every input of the pool (kept alive while the
    # next runs, as the window keeps a sample), so nothing builds or first-allocates later.
    work = traffic.build(config, mix, seed, devices, size)
    from xdem_tpu_torch.terrain import cuda_kernels

    log(f"{time.monotonic() - T_PROCESS:.3f} s: program imported, {len(work.pool)} inputs made")

    keep_early = int(mix.get("keep_early", 0))
    rng = np.random.default_rng(inputs.seed_ints(seed, 4))
    keep_at = set(int(k) for k in rng.choice(len(work.pool), size=keep_early, replace=False)) if keep_early else set()
    with torch.no_grad():
        held = None
        for i in range(len(work.pool)):
            out = work.call(i, {})
            traffic.wait(devices)
            held = out if (held is None and keep_early) else held
            del out
        del held
    t_first = time.monotonic()
    setup_s = t_first - T_PROCESS
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    # --- the window: a closed loop; each call's results are dropped before the next call.
    cuda_kernels.reset_launch_counts()
    calls, kept, last, failed = [], [], None, 0
    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    with torch.no_grad(), trace.profiled(traced, [d.index for d in devices] if on_card else []) as holder:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            last = None
            spans: dict = {}
            start = time.perf_counter()
            try:
                with span("gpu_bench.call"):
                    out = work.call(i, spans)
                    traffic.wait(devices)
                ok = True
            except Exception as exc:  # a failed call counts as failed, and the window goes on
                out, ok = None, False
                failed += 1
                if failed <= 3:
                    log(f"call {i} failed: {type(exc).__name__}: {exc}")
            calls.append(Call(start - t0, time.perf_counter() - t0, spans, work.pixels_per_call, ok))
            if ok and i in keep_at:
                kept.append((i, out))
            last = (i, out) if ok else None
            del out
            i += 1
        window_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
    log(f"{len(calls)} calls in {window_s:.3f} s, {failed} failed; peak {peak / 1e9:.2f} GB")

    # --- the check, once the window has closed and the peak has been read.
    if last is not None and all(k[0] != last[0] for k in kept):
        kept.append(last)
    del last
    work.keep_inputs([k for k, _ in kept])
    if on_card:
        torch.cuda.empty_cache()
    with torch.no_grad():
        numbers = work.check(kept)
    del kept
    per_call = work.launches_per_call()
    if per_call is not None:
        expected = per_call * len(calls)
        numbers["launches_missing"] = float(max(abs(v - expected) for v in launches.values()))
    checks = [(name, float(v), float(limits[name])) for name, v in numbers.items()]
    checks.append(("failed_calls", float(failed), 0.0))
    correct = bool(calls) and all(v <= lim for _, v, lim in checks)

    run = types.SimpleNamespace(calls=calls, window_s=window_s, setup_s=setup_s, trace=holder.trace, config=config,
                                mix=mix, chips=len(devices), work=work)
    metrics = {}
    for m in cell_metrics(spec, cell, traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if on_card else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(calls), "failed": failed, "metrics": metrics, "device": device}
    if traced and holder.trace is not None:
        device["busy_s"] = holder.trace.busy_s()
        device["window_s"] = holder.trace.window_s
        result["breakdown"] = {"device_ops": holder.trace.top_device_ops(), "idle_gaps": holder.trace.idle_gaps()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json: {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    _set_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has {have}")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    result, checks = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), devices)

    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded in this process: {bad}")
        return 3
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        log(f"check {name}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
