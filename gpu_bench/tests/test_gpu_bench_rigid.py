"""The rigid cell (dem10k.rigid) on the CPU at a small size, and its readers.

`correct` comes out true for a sound run and false for the control (the plain reference in
bfloat16 in the program's place) and for each fault, planted where it is produced: ICP's
rotation 0.01 degrees off, LZD's translation 2 m off, the regrid cut to one fixed-point step,
and a call that returns the previous call's outputs. The limits are the cell's. The readers
give known answers on synthetic span logs and None where there is nothing to read (a CPU run,
an untraced run, a program without the spans).
"""

import functools
import types
import warnings

import numpy as np
import pytest
import torch

from gpu_bench import reference_rigid, run, traffic, work, work_rigid
from gpu_bench.trace import Trace
from xdem_tpu_torch import profiler

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
CELL = next(w for w in SPEC["workloads"] if w["name"] == "dem10k.rigid")
CPU = torch.device("cpu")
SMALL = {"icp": {"subsample": 3000}, "lzd": {"subsample": 30000}, "pool": 2}
SIZE, SEED = 384, 2**33 + 17
P = "xdem_tpu_torch."
READERS = ["icp_nn_roofline.rigid", "icp_steps.rigid", "lzd_steps.rigid", "draw_ms.rigid", "regrid_ms.rigid",
           "regrid_steps.rigid", "idle_in_program_ms.rigid", "device_idle.rigid"]


def _run(monkeypatch, plant=None, control=False, traced=False):
    """(correct, the names of the numbers beyond their limits, the result) of a short run."""
    real = traffic.build

    def build(config, mix, *rest):
        work_ = real(config, {**mix, **SMALL}, *rest)
        if control:
            work_.call = traffic.kind("rigid").control(work_, torch.bfloat16)
        else:
            if plant is not None:
                plant(monkeypatch, work_)
        return work_

    monkeypatch.setattr(traffic, "build", build)
    with warnings.catch_warnings():  # some torch versions warn at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        res, checks = run.run_cell(SPEC, CELL, SEED, 0.3, traced, [CPU], size=SIZE)
    return res["correct"], [n for n, v, lim in checks if not v <= lim], res


def _icp_rotated(monkeypatch, work_):
    from xdem_tpu_torch.coreg import affine

    real = affine.icp

    def icp(*args, **kwargs):  # the fitted rotation 0.01 degrees off about x
        matrix, centroid, count = real(*args, **kwargs)
        matrix = matrix.copy()
        matrix[:3, :3] = reference_rigid.rotation_xyz(np.deg2rad(0.01), 0.0, 0.0) @ matrix[:3, :3]
        return matrix, centroid, count

    monkeypatch.setattr(affine, "icp", icp)


def _lzd_moved(monkeypatch, work_):
    from xdem_tpu_torch.coreg import affine

    real = affine.lzd

    def lzd(*args, **kwargs):  # the fitted translation 2 m off to the east
        matrix, centroid, count = real(*args, **kwargs)
        matrix = matrix.copy()
        matrix[0, 3] += 2.0
        return matrix, centroid, count

    monkeypatch.setattr(affine, "lzd", lzd)


def _one_step(monkeypatch, work_):
    from xdem_tpu_torch.coreg import base

    monkeypatch.setattr(base, "_iterate_affine_regrid_small_rotations",
                        functools.partial(base._iterate_affine_regrid_small_rotations, max_iterations=1))


def _stale(monkeypatch, work_):
    real, previous = work_.call, {}

    def call(i, spans_):  # the state is one call behind: each call returns the previous call's outputs
        out = real(i, spans_)
        stale = previous.get("out", out)
        previous["out"] = out
        return stale

    work_.call = call


def test_a_sound_run_is_correct(monkeypatch):
    assert _run(monkeypatch)[:2] == (True, [])


def test_the_control_is_not_correct(monkeypatch):
    correct, failed, _ = _run(monkeypatch, control=True)
    assert not correct and {"icp_t", "icp_r", "lzd_r", "regrid"} <= set(failed), failed


@pytest.mark.parametrize("plant, wrong", [(_icp_rotated, "icp_r"), (_lzd_moved, "lzd_t"), (_one_step, "regrid"),
                                          (_stale, "regrid")])
def test_a_planted_fault_is_not_correct(monkeypatch, plant, wrong):
    correct, failed, _ = _run(monkeypatch, plant)
    assert not correct and wrong in failed, failed


# ------------------------------------------------------------------ the readers


def _leaf(stage, s, e, ms=None, **counters):
    return (stage, s, e, [], ms or {}, counters)


def _call(t0, icp_steps, lzd_steps, regrid_steps):
    """The span tree of one pipeline call starting at t0 (s): ICP's fit, its apply, LZD's fit, its
    apply, and the pipeline's two applies; each scan 8 ms and each regrid 100 ms on card 0."""
    icp = ("coreg.Coreg.fit", t0, t0 + 0.3, [
        ("coreg.icp.prepare", t0, t0 + 0.1, [_leaf("coreg.draw", t0 + 0.01, t0 + 0.05)], {}, {"points": 50000}),
        *[("coreg.icp.step", t0 + 0.1 + 0.01 * k, t0 + 0.11 + 0.01 * k,
           [_leaf("coreg.icp.nn", t0 + 0.1 + 0.01 * k, t0 + 0.108 + 0.01 * k, {0: 8.0}, pairs=50000**2)], {}, {})
          for k in range(icp_steps)]], {}, {})
    lzd = ("coreg.Coreg.fit", t0 + 0.5, t0 + 0.7, [
        ("coreg.lzd.prepare", t0 + 0.5, t0 + 0.6, [_leaf("coreg.draw", t0 + 0.5, t0 + 0.52)], {}, {"points": 500000}),
        *[_leaf("coreg.lzd.step", t0 + 0.6 + 0.001 * k, t0 + 0.6005 + 0.001 * k) for k in range(lzd_steps)]], {}, {})

    def apply(s):
        return ("coreg.Coreg.apply", s, s + 0.1, [_leaf("coreg.regrid", s, s + 0.1, {0: 100.0}, steps=regrid_steps)],
                {}, {})

    return [icp, apply(t0 + 0.3), lzd, apply(t0 + 0.7), apply(t0 + 0.8), apply(t0 + 0.9)]


def _traced(tree, calls, busy, devices=(0,), window_s=2.0):
    """A run and its span log from `tree`, roots in call order; `busy` is [(device, start, end)]."""
    records, host = [], []

    def walk(node, parent, root):
        stage, s, e, children, ms, counters = node
        i = len(records)
        records.append(None)
        for child in children:
            walk(child, i, root)
        records[i] = profiler.SpanRecord(P + stage, i, parent, root, dict(ms), dict(counters))
        host.append((s, e, P + stage))

    for root, node in enumerate(tree):
        walk(node, None, root)
    trace = Trace([(*op, "kernel") for op in busy], sorted(host), window_s, list(devices))
    return types.SimpleNamespace(calls=[types.SimpleNamespace(ok=True) for _ in range(calls)], trace=trace), records


TREE = _call(0.0, 4, 3, 2) + _call(1.0, 6, 5, 4)
BUSY = [(0, 0.1, 0.3), (0, 0.3, 0.4), (0, 1.1, 1.2)]
SCAN_LEAST = work.least_seconds(*work_rigid.scan_work(50000**2, 50000))
CASES = {
    "icp_nn_roofline.rigid": 100.0 * SCAN_LEAST / 8e-3,  # ten scans of 8 ms, each at its least time
    "icp_steps.rigid": 5.0,
    "lzd_steps.rigid": 4.0,
    "draw_ms.rigid": 60.0,  # (40 ms + 20 ms) a call
    "regrid_ms.rigid": 400.0,
    "regrid_steps.rigid": 3.0,
    # Idle inside a span: the window less the busy 0.4 s and the host's two gaps between LZD's fit
    # and ICP's apply (0.4-0.5 s and 1.4-1.5 s), over two calls.
    "idle_in_program_ms.rigid": 1e3 * (2.0 - 0.4 - 0.1 - 0.1) / 2,
    "device_idle.rigid": 100.0 * (1 - 0.4 / 2.0),
}


@pytest.fixture
def log_of(monkeypatch):
    def install(records):
        monkeypatch.setattr(profiler, "spans", lambda: list(records))
    return install


def test_the_scan_count_is_nine_operations_a_pair_and_the_clouds_once():
    assert work_rigid.scan_work(50000 * 20000, 35000) == (12 * 70000, 9 * 50000 * 20000)
    assert SCAN_LEAST == pytest.approx(9 * 50000**2 / work.F32_OPS_PER_S)  # operations bound it


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_gives_its_known_answer(metric, log_of):
    cell, records = _traced(TREE, 2, BUSY)
    log_of(records)
    assert run.reader(metric)(cell) == pytest.approx(CASES[metric])


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("nothing", ["cpu", "untraced", "a program without the rigid spans"])
def test_each_reader_returns_none_where_there_is_nothing_to_read(metric, nothing, log_of):
    cell, records = _traced(TREE, 2, BUSY, devices=() if nothing == "cpu" else (0,))
    if nothing == "untraced":
        cell.trace = None
    elif nothing.startswith("a program"):  # the parent's program: its entry points' spans, none inside
        keep = {P + "coreg.Coreg.fit", P + "coreg.Coreg.apply"}
        cell.trace.host_ops = [op for op in cell.trace.host_ops if op[2] in keep]
        records = [r for r in records if r.name in keep]
        if metric in ("idle_in_program_ms.rigid", "device_idle.rigid"):
            assert run.reader(metric)(cell) is not None  # the entry points' spans and the trace remain
            return
    log_of(records)
    assert run.reader(metric)(cell) is None


def test_the_cells_traced_cpu_run_reports_none_of_the_rigid_metrics(monkeypatch):
    correct, _, res = _run(monkeypatch, traced=True)
    assert correct and not set(res["metrics"]) & set(READERS)
    assert P + "coreg.regrid" in {r.name for r in profiler.spans()}
