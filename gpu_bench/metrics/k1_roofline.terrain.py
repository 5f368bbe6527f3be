"""k1_roofline.terrain: K1 (csrc/surface_fit.cu) at its least time over its device time, in %."""

from gpu_bench.readers import kernel_roofline

PATTERNS = ("surface_fit_kernel",)


def read(run):
    return kernel_roofline(run, "k1", PATTERNS)
