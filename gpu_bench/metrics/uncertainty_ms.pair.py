"""uncertainty_ms.pair: mean milliseconds of estimate_uncertainty a pair, by the harness's span
around it, closed by a wait on every card."""

from gpu_bench.readers import span_ms


def read(run):
    return span_ms(run, "uncertainty")
