"""The device trace of a traced run: a ``torch.profiler`` window around the measured calls,
reduced to what the per-layer readers and the result's breakdown need.

Device records are the profiler's CUDA activities (kernels, copies, sets); host records are
its CPU operations and the harness's own spans (``record_function``). Times are in seconds,
relative to the start of the window span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager

WINDOW = "gpu_bench.window"


class Trace:
    """Device records [(device, start, end, name)] and host records [(start, end, name)] of one
    window [0, window_s]."""

    def __init__(self, device_ops, host_ops, window_s: float, devices: list[int]):
        self.device_ops, self.host_ops, self.window_s, self.devices = device_ops, host_ops, window_s, devices

    def device_seconds(self, match) -> float:
        """Seconds of device records whose name satisfies match(name), summed over the cards."""
        return sum(e - s for _, s, e, name in self.device_ops if match(name))

    def busy(self, device: int) -> list[tuple[float, float]]:
        """The merged intervals in which `device` runs any record."""
        spans = sorted((max(s, 0.0), min(e, self.window_s)) for d, s, e, _ in self.device_ops if d == device)
        merged: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        """Busy seconds of the window, the mean over the cell's cards."""
        if not self.devices:
            return 0.0
        return sum(e - s for d in self.devices for s, e in self.busy(d)) / len(self.devices)

    def top_device_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, float] = defaultdict(float)
        for _, s, e, name in self.device_ops:
            tot[name] += e - s
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle seconds of the cards, the mean over them, by what the host was doing halfway
        through each gap: the innermost host record open at that moment."""
        starts = sorted(self.host_ops)
        keys = [s for s, _, _ in starts]
        tot: dict[str, float] = defaultdict(float)
        for d in self.devices:
            t = 0.0
            for s, e in self.busy(d) + [(self.window_s, self.window_s)]:
                if s > t:
                    tot[self._host_at((s + t) / 2, starts, keys)] += s - t
                t = max(t, e)
        n = max(len(self.devices), 1)
        return [[name, v / n] for name, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    @staticmethod
    def _host_at(t: float, starts, keys) -> str:
        i = bisect.bisect_right(keys, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, e, name = starts[j]
            if e >= t and name != WINDOW:
                return name
        return "host outside any recorded operation"


@contextmanager
def profiled(enabled: bool, devices: list[int]):
    """Yield a holder whose ``.trace`` is the Trace of the block on the cards `devices` once it
    has ended (None when not enabled or where the profiler recorded no window)."""
    import torch

    holder = type("Holder", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
    holder.trace = reduce(prof, devices)


def reduce(prof, devices: list[int]) -> Trace | None:
    """The Trace of a finished profiler, from its raw records (no tree of events is built).
    A device record that only mirrors a host span (a user annotation) is left out."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not win:
        return None
    t0, t1 = win[0].start_ns(), win[0].end_ns()
    length = (t1 - t0) * 1e-9
    dev_ops, host_ops = [], []
    for e in events:
        s, f = (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if f > 0 and s < length and not e.is_user_annotation():
                dev_ops.append((int(e.device_index()), s, f, e.name()))
        else:
            host_ops.append((s, f, e.name()))
    return Trace(dev_ops, host_ops, length, list(devices))
