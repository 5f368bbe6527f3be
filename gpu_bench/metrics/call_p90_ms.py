"""call_p90_ms: the 90th percentile of every call's time in the window, from the call to its
wait on every card (a failed call counts at the window's length)."""

from gpu_bench.readers import p90_ms


def read(run):
    return p90_ms(run)
