"""variogram_ms.pair: stream milliseconds a pair in the program's ``spatialstats.variogram.sample``
span (the rings' draw and the empirical variogram's bins), on the card."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["spatialstats.variogram.sample"])
