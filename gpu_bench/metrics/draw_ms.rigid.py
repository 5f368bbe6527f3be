"""draw_ms.rigid: host milliseconds a pair in the program's ``coreg.draw`` spans (the grid subsample's
draw: the joint finite mask copied to the host, numpy's choice and the gather at the picks; one for
ICP and one for LZD a fit), from the trace."""

from gpu_bench.spans import host_ms


def read(run):
    return host_ms(run, "coreg.draw")
