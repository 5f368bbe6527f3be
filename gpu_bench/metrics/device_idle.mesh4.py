"""device_idle: the share of the traced window in which a card runs no kernel and no copy, in %,
the mean over the cell's cards."""

from gpu_bench.readers import device_idle


def read(run):
    return device_idle(run)
