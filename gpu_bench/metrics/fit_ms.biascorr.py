"""fit_ms.biascorr: host milliseconds a pair in the program's ``coreg.biascorr.fit`` spans (Deramp's
least squares and DirectionalBias's periodogram and LM polishes of a sum of sines), from the trace."""

from gpu_bench.spans import host_ms


def read(run):
    return host_ms(run, "coreg.biascorr.fit")
