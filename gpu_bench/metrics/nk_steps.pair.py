"""nk_steps.pair: Nuth & Kaab steps a fit: the program's ``coreg.nuth_kaab.step`` spans over its
``coreg.nuth_kaab.prepare`` spans (one a raster-raster fit), from the trace."""

from gpu_bench.spans import host_spans, on_card


def read(run):
    if not on_card(run):
        return None
    fits = len(host_spans(run, "coreg.nuth_kaab.prepare"))
    return len(host_spans(run, "coreg.nuth_kaab.step")) / fits if fits else None
