"""scatter_ms.mesh4: stream milliseconds a call of cuda:0 in the program's ``parallel.scatter`` span:
the DEM cut into the mesh's blocks and copied out of cuda:0 (the copies run on its stream)."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["parallel.scatter"], card=0)
