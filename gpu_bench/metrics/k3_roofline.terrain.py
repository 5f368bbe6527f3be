"""k3_roofline.terrain: K3 (csrc/fractal.cu) at its least time over its device time, in %."""

from gpu_bench.readers import kernel_roofline

PATTERNS = ("fractal_planes", "fractal_global")


def read(run):
    return kernel_roofline(run, "k3", PATTERNS)
