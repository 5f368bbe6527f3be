"""regrid_ms.rigid: stream milliseconds a pair in the program's ``coreg.regrid`` spans (the
small-rotation fixed-point regrid of a whole DEM, one per apply of a rotation), on the card."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["coreg.regrid"])
