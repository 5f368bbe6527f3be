"""lzd_steps.rigid: LZD steps a fit: the program's ``coreg.lzd.step`` spans over its
``coreg.lzd.prepare`` spans (one a fit), from the trace."""

from gpu_bench.spans import host_spans, on_card


def read(run):
    if not on_card(run):
        return None
    fits = len(host_spans(run, "coreg.lzd.prepare"))
    return len(host_spans(run, "coreg.lzd.step")) / fits if fits else None
