"""regrid_steps.rigid: fixed-point steps a regrid, the mean over the program's ``coreg.regrid``
spans of their ``steps`` counter."""

from gpu_bench.spans import counter_mean


def read(run):
    return counter_mean(run, "coreg.regrid", "steps")
