"""k2_roofline.terrain: K2 (csrc/windowed.cu) at its least time over its device time, in %."""

from gpu_bench.readers import kernel_roofline

PATTERNS = ("windowed3_kernel", "windowed_shared_kernel", "windowed_global_kernel")


def read(run):
    return kernel_roofline(run, "k2", PATTERNS)
