"""epilog_ms.terrain: device milliseconds a call spends outside K1-K3 (the DEM's centre, unit
conversions, clamps, copies), from the trace."""

KERNELS = ("surface_fit_kernel", "windowed3_kernel", "windowed_shared_kernel", "windowed_global_kernel",
           "fractal_planes", "fractal_global")


def read(run):
    done = sum(1 for c in run.calls if c.ok)
    if run.trace is None or not run.trace.device_ops or run.mix["kind"] != "terrain" or not done:
        return None
    return 1e3 * run.trace.device_seconds(lambda name: not any(k in name for k in KERNELS)) / done
