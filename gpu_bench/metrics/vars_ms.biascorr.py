"""vars_ms.biascorr: stream milliseconds a pair on the card in the program's ``coreg.biascorr.vars``
spans (the bias variables: TerrainBias's maximum curvature through K1 for its fit and each of its
applies, the pixel and along-track coordinates at the drawn pixels and as planes for the applies)."""

from gpu_bench.spans import stream_ms


def read(run):
    return stream_ms(run, ["coreg.biascorr.vars"])
