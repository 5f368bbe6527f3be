"""vario_fit_ms.pair: host milliseconds a pair in the program's ``spatialstats.variogram.fit`` span
(scipy's bounded fit of the sum of variogram models), from the trace."""

from gpu_bench.spans import host_ms


def read(run):
    return host_ms(run, "spatialstats.variogram.fit")
