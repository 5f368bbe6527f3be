"""vario_evals.pair: evaluations of the variogram fit's objective, the mean over the fits, from the
``evaluations`` counter of the program's ``spatialstats.variogram.fit`` span."""

from gpu_bench.spans import counter_mean


def read(run):
    return counter_mean(run, "spatialstats.variogram.fit", "evaluations")
