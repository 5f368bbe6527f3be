"""The program's own spans in a traced run, for the per-layer readers of gpu_bench/metrics/.

The program (``xdem_tpu_torch.profiler.span``) names its stages ``xdem_tpu_torch.<module>.<stage>``.
While the window's profiler records, each span is a host record of the trace, on the clock
of the device records, and a record of the program's log (``xdem_tpu_torch.profiler.spans()``)
with each card's stream milliseconds between the span's entry and exit events, and its
counters. Host times and counts are read from the trace, stream times and counters from the
log. Every reader here returns None where there is nothing to read: a CPU run, an untraced
run, a program without spans, or a log whose root spans are not the trace's.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

PREFIX = "xdem_tpu_torch."
FAMILY_KERNELS = {  # a terrain family's span and the names of the kernel it runs on each card
    "terrain.k1": ("surface_fit_kernel",),
    "terrain.k2": ("windowed3_kernel", "windowed_shared_kernel", "windowed_global_kernel"),
    "terrain.k3": ("fractal_planes", "fractal_global"),
}


def on_card(run) -> bool:
    """Whether the run was traced on cards."""
    return run.trace is not None and bool(run.trace.devices) and bool(run.calls)


def host_spans(run, stage: str) -> list[tuple[float, float]]:
    """(start, end) in seconds of every host record of the span ``xdem_tpu_torch.<stage>``."""
    name = PREFIX + stage
    return [(s, e) for s, e, n in run.trace.host_ops if n == name]


def host_ms(run, stage: str) -> float | None:
    """Host milliseconds a call in the span `stage`."""
    if not on_card(run):
        return None
    found = host_spans(run, stage)
    return 1e3 * sum(e - s for s, e in found) / len(run.calls) if found else None


def log(run):
    """The program's span log of the run's profiler session, or None where it is absent or its
    root spans (by name and number) differ from the trace's."""
    if not on_card(run):
        return None
    try:
        from xdem_tpu_torch import profiler
    except ImportError:
        return None
    read = getattr(profiler, "spans", None)
    if read is None:  # a program without spans
        return None
    records = read()
    named, roots = Counter(r.name for r in records), Counter(r.name for r in records if r.parent is None)
    in_trace = Counter(n for *_, n in run.trace.host_ops if n in roots)
    return records if roots and all(named[n] == in_trace[n] for n in roots) else None


def stream_ms(run, stages, card: int | None = None) -> float | None:
    """Stream milliseconds a call in the spans ``xdem_tpu_torch.<stage>`` for `stages`: on the
    card `card`, or summed over the cards when it is None."""
    records = log(run)
    if records is None:
        return None
    names = {PREFIX + s for s in stages}
    times = [ms for r in records if r.name in names for c, ms in r.ms.items() if card is None or c == card]
    return sum(times) / len(run.calls) if times else None


def counter_mean(run, stage: str, key: str) -> float | None:
    """The mean over the spans ``xdem_tpu_torch.<stage>`` of their counter `key`."""
    records = log(run)
    if records is None:
        return None
    found = [r.counters.get(key, 0) for r in records if r.name == PREFIX + stage]
    return sum(found) / len(found) if found else None


def _busy_in(busy: list[tuple[float, float]], starts: list[float], a: float, b: float) -> float:
    """Seconds of the merged intervals `busy` (with their `starts`) that fall inside [a, b]."""
    out, k = 0.0, max(bisect.bisect_right(starts, a) - 1, 0)
    while k < len(busy) and busy[k][0] < b:
        out += max(0.0, min(busy[k][1], b) - max(busy[k][0], a))
        k += 1
    return out


def exchange_busy_ms(run) -> float | None:
    """Device-busy milliseconds a call inside the cards' ``parallel.exchange`` stream intervals,
    summed over the cards: the exchanges' copies and fills, without the waits that each copy's
    barrier between two cards' streams holds there. A span's interval on a card (its stream ms
    long) is placed on the trace by its end: the start of the first kernel of the span's terrain
    family that the card runs after the host has left the span, which the host queued behind it."""
    records = log(run)
    if records is None:
        return None
    by_id = {r.id: r for r in records}
    exchanges = [r for r in records if r.name == PREFIX + "parallel.exchange"]
    hosts = sorted(host_spans(run, "parallel.exchange"))
    if not exchanges or len(hosts) != len(exchanges):
        return None
    starts: dict[tuple[int, str], list[float]] = defaultdict(list)
    for d, s, _, name in run.trace.device_ops:
        for family, kernels in FAMILY_KERNELS.items():
            if any(k in name for k in kernels):
                starts[d, family].append(s)
    for v in starts.values():
        v.sort()
    busy = {d: run.trace.busy(d) for d in run.trace.devices}
    busy_starts = {d: [s for s, _ in v] for d, v in busy.items()}
    total = 0.0
    for r, (_, host_end) in zip(exchanges, hosts):
        family = by_id.get(r.parent)
        while family is not None and family.name[len(PREFIX):] not in FAMILY_KERNELS:
            family = by_id.get(family.parent)
        if family is None:
            return None
        for card, ms in r.ms.items():
            after = starts.get((card, family.name[len(PREFIX):]), [])
            k = bisect.bisect_left(after, host_end)
            if card not in busy or k == len(after):
                return None
            total += _busy_in(busy[card], busy_starts[card], after[k] - ms / 1e3, after[k])
    return 1e3 * total / len(run.calls)


def _innermost(trace) -> list[tuple[float, float, str]]:
    """The window cut into segments (start, end, name) by the innermost program span open on
    the host, where one is."""
    spans = [(max(s, 0.0), min(e, trace.window_s), n) for s, e, n in trace.host_ops if n.startswith(PREFIX)]
    events = []
    for i, (s, e, _) in enumerate(spans):
        if e > s:
            events.append((s, 1, -e, i))  # at one instant: closes first, then the outer span opens first
            events.append((e, 0, 0.0, i))
    events.sort()
    segments, stack, last = [], [], 0.0
    for t, opens, _, i in events:
        if stack and t > last:
            segments.append((last, t, spans[stack[-1]][2]))
        if opens:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        last = t
    return segments


def idle_by_span(trace) -> dict[str, float]:
    """Idle seconds of the cards (the mean over them) by the innermost program span open on the
    host, by interval: each idle stretch of a card is cut where the open span changes."""
    segments = _innermost(trace)
    tot: dict[str, float] = defaultdict(float)
    for d in trace.devices:
        idle, t = [], 0.0
        for s, e in trace.busy(d) + [(trace.window_s, trace.window_s)]:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        i = j = 0
        while i < len(segments) and j < len(idle):
            (a, b, name), (c, e) = segments[i], idle[j]
            if min(b, e) > max(a, c):
                tot[name] += min(b, e) - max(a, c)
            if b < e:
                i += 1
            else:
                j += 1
    return {name: v / len(trace.devices) for name, v in tot.items()}


def idle_in_program_ms(run) -> float | None:
    """Milliseconds a call that a card is idle while the host is inside a program span."""
    if not on_card(run) or not any(n.startswith(PREFIX) for *_, n in run.trace.host_ops):
        return None
    return 1e3 * sum(idle_by_span(run.trace).values()) / len(run.calls)
