"""suite_roofline: the suite's least time on the cell's cards over its measured time, in %.

The least time is the larger of the request's bytes over the cards' bandwidth and its f32
operations over their peak, counted by gpu_bench/work.py from the request alone; the measured
time is each call's host-clock time, from the call to its wait on every card, over all calls."""

from gpu_bench import work


def read(run):
    done = [c for c in run.calls if c.ok]
    if run.mix["kind"] != "terrain" or not done:
        return None
    nbytes, ops = work.suite_work(run.mix["attributes"], run.mix.get("window_size_fractal", 13))
    least = sum(work.least_seconds(nbytes * c.pixels, ops * c.pixels, run.chips) for c in done)
    return 100.0 * least / sum(c.seconds for c in done)
