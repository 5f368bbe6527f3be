"""apply_ms.biascorr: stream milliseconds a pair on the card in the program's ``coreg.biascorr.apply``
spans (each step's correction plane and its addition, in the pipeline's fit and in its apply; the
variables' planes are in ``vars_ms.biascorr``)."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["coreg.biascorr.apply"])
