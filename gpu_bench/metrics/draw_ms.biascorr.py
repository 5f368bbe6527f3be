"""draw_ms.biascorr: host milliseconds a pair in the program's ``coreg.draw`` spans (a step's grid
subsample: the joint finite mask on the card, numpy's choice on the host and the gather at the
picks; one for each of the three steps' fits), from the trace."""

from gpu_bench.spans import host_ms


def read(run):
    return host_ms(run, "coreg.draw")
