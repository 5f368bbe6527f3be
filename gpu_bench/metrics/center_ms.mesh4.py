"""center_ms.mesh4: stream milliseconds a call of cuda:0 in the program's ``terrain.center`` span:
the whole DEM's finite mean, on the card that holds the DEM, while cards 1-3 wait."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["terrain.center"], card=0)
