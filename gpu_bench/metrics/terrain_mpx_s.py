"""terrain_mpx_s: DEM pixels of every call finished in the window, in millions, over the window."""


def read(run):
    return sum(c.pixels for c in run.calls if c.ok) / run.window_s / 1e6
