"""icp_steps.rigid: ICP steps a fit: the program's ``coreg.icp.step`` spans over its
``coreg.icp.prepare`` spans (one a fit), from the trace."""

from gpu_bench.spans import host_spans, on_card


def read(run):
    if not on_card(run):
        return None
    fits = len(host_spans(run, "coreg.icp.prepare"))
    return len(host_spans(run, "coreg.icp.step")) / fits if fits else None
