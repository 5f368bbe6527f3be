"""bin_ms.biascorr: host milliseconds a pair in the program's ``coreg.biascorr.bin`` spans (the host
binning of the drawn differences: DirectionalBias's and TerrainBias's medians over 100 bins), from
the trace."""

from gpu_bench.spans import host_ms


def read(run):
    return host_ms(run, "coreg.biascorr.bin")
