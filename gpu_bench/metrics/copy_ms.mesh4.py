"""copy_ms.mesh4: device milliseconds a call spends in copies (memcpy records and copy
kernels), summed over the cards, from the trace. Its layer is every copy of the call: the
scatter of the DEM out of the first card, the halo exchanges and the epilog's interior copies,
which the trace does not tell apart (the peer copies run as copy kernels too)."""


def read(run):
    done = sum(1 for c in run.calls if c.ok)
    if run.trace is None or not done:
        return None
    seconds = run.trace.device_seconds(lambda name: "memcpy" in name.lower() or "copy" in name.lower())
    return 1e3 * seconds / done if seconds > 0 else None
