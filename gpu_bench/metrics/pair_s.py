"""pair_s: the window over the pairs finished in it (seconds a pair)."""


def read(run):
    done = sum(1 for c in run.calls if c.ok)
    return run.window_s / done if done else None
