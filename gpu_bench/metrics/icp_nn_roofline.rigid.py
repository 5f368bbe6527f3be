"""icp_nn_roofline.rigid: ICP's nearest-neighbour scans at their least time over their stream time,
in %: the frozen count of ``gpu_bench/work_rigid.py`` for each ``coreg.icp.nn`` span of the
program, from its ``pairs`` counter and the ``points`` counter of the fits' ``coreg.icp.prepare``
spans (the points of each cloud), over those scans' stream milliseconds on the card."""

from gpu_bench import spans, work, work_rigid


def read(run):
    records = spans.log(run)
    if records is None:
        return None
    scans = [r for r in records if r.name == spans.PREFIX + "coreg.icp.nn"]
    seconds = sum(ms for r in scans for ms in r.ms.values()) / 1e3
    points = spans.counter_mean(run, "coreg.icp.prepare", "points")
    if not scans or seconds <= 0 or not points or not all(r.counters.get("pairs") for r in scans):
        return None
    least = sum(work.least_seconds(*work_rigid.scan_work(r.counters["pairs"], points), 1) for r in scans)
    return 100.0 * least / seconds
