"""center_ms.terrain: stream milliseconds a call in the program's ``terrain.center`` span
(``surfit.dem_center``, the DEM's finite mean removed before K1's stencils), from the span's
events on the card."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["terrain.center"])
