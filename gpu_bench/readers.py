"""Arithmetic shared by the metric readers of gpu_bench/metrics/."""

import numpy as np

from gpu_bench import work


def kernel_roofline(run, kernel: str, patterns) -> float | None:
    """A kernel's share of its roofline, in %: its least time over every call, from the
    frozen work count, over the device time of the trace records whose names hold a pattern."""
    done = [c for c in run.calls if c.ok]
    if run.trace is None or run.mix["kind"] != "terrain" or not done:
        return None
    counts = work.kernel_work(run.mix["attributes"], run.mix.get("window_size_fractal", 13))
    seconds = run.trace.device_seconds(lambda name: any(p in name for p in patterns))
    if kernel not in counts or seconds <= 0:
        return None
    nbytes, ops = counts[kernel]
    least = sum(work.least_seconds(nbytes * c.pixels, ops * c.pixels, run.chips) for c in done)
    return 100.0 * least / seconds


def device_idle(run) -> float | None:
    """The share of the traced window in which a card runs no kernel and no copy, in %, the
    mean over the cell's cards."""
    if run.trace is None or not run.trace.devices or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def span_ms(run, name: str) -> float | None:
    """Mean milliseconds a call of the window spent in the harness's span `name`."""
    done = [c.spans[name] for c in run.calls if c.ok and name in c.spans]
    return 1e3 * sum(done) / len(done) if done else None


def p90_ms(run) -> float | None:
    """The 90th percentile of every call's time in the window, in ms (a failed call counts at
    the window's length)."""
    if not run.calls:
        return None
    times = [c.seconds if c.ok else run.window_s for c in run.calls]
    return float(np.percentile(times, 90)) * 1e3
