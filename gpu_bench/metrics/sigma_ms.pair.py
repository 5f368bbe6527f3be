"""sigma_ms.pair: stream milliseconds a pair in the program's four ``spatialstats.sigma.*`` spans
(the stable sample's draw, its bins, the tables and the sigma grid), on the card."""

from gpu_bench.spans import stream_ms

STAGES = ["spatialstats.sigma.prepare", "spatialstats.sigma.bins", "spatialstats.sigma.tables",
          "spatialstats.sigma.grid"]


def read(run):
    return stream_ms(run, STAGES)
