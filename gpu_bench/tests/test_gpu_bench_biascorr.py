"""The bias-correction cell (dem10k.biascorr) on the CPU at a small size, and its readers.

`correct` comes out true for a sound run and false for the control (the plain reference in
bfloat16 in the program's place) and for each fault, planted where it is produced: a step's
apply left out, the ramp's quadratic coefficient 1 % off, a sine's wavelength 5 % off, the
median table shifted one bin, and a call that returns the previous call's outputs. The limits
are the cell's. The readers give known answers on synthetic span logs and None where there is
nothing to read (a CPU run, an untraced run, a program without the spans).
"""

import types
import warnings

import numpy as np
import pytest
import torch

from gpu_bench import run, traffic
from gpu_bench.trace import Trace
from xdem_tpu_torch import profiler

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
CELL = next(w for w in SPEC["workloads"] if w["name"] == "dem10k.biascorr")
CPU = torch.device("cpu")
SIZE, SEED, COUNT = 320, 2**33 + 29, 20000
P = "xdem_tpu_torch."
READERS = ["draw_ms.biascorr", "vars_ms.biascorr", "bin_ms.biascorr", "fit_ms.biascorr", "fit_evals.biascorr",
           "apply_ms.biascorr", "device_idle.biascorr", "idle_in_program_ms.biascorr"]


def _run(monkeypatch, plant=None, control=False, traced=False):
    """(correct, the names of the numbers beyond their limits, the result) of a short run."""
    real = traffic.build

    def build(config, mix, *rest):
        work_ = real({**config, "subsample": COUNT}, {**mix, "pool": 2}, *rest)
        if control:
            work_.call = traffic.kind("biascorr").control(work_, torch.bfloat16)
        elif plant is not None:
            plant(monkeypatch, work_)
        return work_

    monkeypatch.setattr(traffic, "build", build)
    with warnings.catch_warnings():  # some torch versions warn at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        res, checks = run.run_cell(SPEC, CELL, SEED, 0.3, traced, [CPU], size=SIZE)
    return res["correct"], [n for n, v, lim in checks if not v <= lim], res


def _directional_left_out(monkeypatch, work_):
    from xdem_tpu_torch.coreg import biascorr

    def left_out(self, elev, transform=None, **kwargs):  # the step's apply returns the DEM as it came
        return elev, transform

    monkeypatch.setattr(biascorr.DirectionalBias, "_apply_func", left_out)


def _ramp_off(monkeypatch, work_):
    from xdem_tpu_torch.coreg import biascorr

    real = biascorr.Deramp._bin_or_and_fit_biasvars

    def fitted(self, *args, **kwargs):  # the coefficient of col^2 1 % off
        real(self, *args, **kwargs)
        self._meta["outputs"]["fitorbin"]["fit_params"][6] *= 1.01

    monkeypatch.setattr(biascorr.Deramp, "_bin_or_and_fit_biasvars", fitted)


def _wavelength_off(monkeypatch, work_):
    from xdem_tpu_torch.coreg import biascorr

    real = biascorr.robust_nfreq_sumsin_fit

    def sines(*args, **kwargs):  # the first sine's wavelength 5 % longer
        params, n = real(*args, **kwargs)
        params = np.array(params, np.float64)
        params[1] *= 1.05
        return params, n

    monkeypatch.setattr(biascorr, "robust_nfreq_sumsin_fit", sines)
    monkeypatch.setitem(biascorr.fit_workflows["nfreq_sumsin"], "optimizer", sines)


def _table_shifted(monkeypatch, work_):
    from xdem_tpu_torch import spatialstats

    def shifted(real):
        def binned(*args, **kwargs):  # each bin takes the median of the bin below it
            table = real(*args, **kwargs)
            table["nanmedian"] = np.r_[table["nanmedian"][:1], table["nanmedian"][:-1]]
            return table

        return binned

    # The general binning, and the one-variable median binning where the program has it.
    for name in ("nd_binning", "_nd_binning_median_1d"):
        if hasattr(spatialstats, name):
            monkeypatch.setattr(spatialstats, name, shifted(getattr(spatialstats, name)))


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
    assert not correct and {"deramp", "directional", "terrain", "corrected"} <= set(failed), failed


@pytest.mark.parametrize("plant, wrong", [(_directional_left_out, "corrected"), (_ramp_off, "deramp"),
                                          (_wavelength_off, "directional"), (_table_shifted, "terrain"),
                                          (_stale, "corrected")])
def test_a_planted_fault_is_not_correct(monkeypatch, plant, wrong):
    correct, failed, _ = _run(monkeypatch, plant)
    assert not correct and wrong in failed, failed


# ------------------------------------------------------------------ the readers


def _leaf(stage, s, e, ms=None, **counters):
    return (stage, s, e, [], ms or {}, counters)


def _call(t0, evaluations):
    """The span tree of one pipeline call starting at t0 (s): each step's fit and its apply, then
    the pipeline's three applies; each variables span 2 ms and each correction 1 ms on card 0."""
    def apply(s):
        return ("coreg.Coreg.apply", s, s + 0.01, [_leaf("coreg.biascorr.vars", s, s + 0.004, {0: 2.0}),
                                                  _leaf("coreg.biascorr.apply", s + 0.004, s + 0.01, {0: 1.0})], {}, {})

    deramp = ("coreg.Coreg.fit", t0, t0 + 0.1, [
        _leaf("coreg.draw", t0, t0 + 0.03), _leaf("coreg.biascorr.vars", t0 + 0.03, t0 + 0.031, {0: 0.0}),
        _leaf("coreg.biascorr.vars", t0 + 0.031, t0 + 0.032, {0: 0.0}),
        _leaf("coreg.biascorr.fit", t0 + 0.04, t0 + 0.09)], {}, {})
    directional = ("coreg.Coreg.fit", t0 + 0.2, t0 + 0.4, [
        _leaf("coreg.draw", t0 + 0.2, t0 + 0.23), _leaf("coreg.biascorr.vars", t0 + 0.23, t0 + 0.24, {0: 0.0}),
        _leaf("coreg.biascorr.bin", t0 + 0.24, t0 + 0.3, values=500000, bins=100),
        _leaf("coreg.biascorr.fit", t0 + 0.3, t0 + 0.4, evaluations=evaluations, frequencies=2)], {}, {})
    terrain = ("coreg.Coreg.fit", t0 + 0.5, t0 + 0.6, [
        _leaf("coreg.biascorr.vars", t0 + 0.5, t0 + 0.51, {0: 6.0}), _leaf("coreg.draw", t0 + 0.51, t0 + 0.54),
        _leaf("coreg.biascorr.bin", t0 + 0.54, t0 + 0.6, values=500000, bins=100)], {}, {})
    return [deramp, apply(t0 + 0.1), directional, apply(t0 + 0.4), terrain, apply(t0 + 0.6),
            apply(t0 + 0.7), apply(t0 + 0.8), apply(t0 + 0.9)]


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


TREE = _call(0.0, 61) + _call(1.0, 91)
BUSY = [(0, 0.5, 0.51), (0, 0.1, 0.11), (0, 1.5, 1.51)]
CASES = {
    "draw_ms.biascorr": 90.0,  # three draws of 30 ms a call
    "vars_ms.biascorr": 18.0,  # six applies' 2 ms and TerrainBias's 6 ms a call
    "bin_ms.biascorr": 120.0,
    "fit_ms.biascorr": 150.0,
    "fit_evals.biascorr": 76.0,  # (61 + 91) evaluations over two calls
    "apply_ms.biascorr": 6.0,
    # Idle inside a span: the spans' host time (the fits' 0.1 + 0.2 + 0.1 s and six 0.01 s applies
    # a call) less the card's busy 0.03 s, over two calls.
    "idle_in_program_ms.biascorr": 1e3 * (2 * (0.4 + 0.06) - 0.03) / 2,
    "device_idle.biascorr": 100.0 * (1 - 0.03 / 2.0),
}


@pytest.fixture
def log_of(monkeypatch):
    def install(records):
        monkeypatch.setattr(profiler, "spans", lambda: list(records))
    return install


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_gives_its_known_answer(metric, log_of):
    cell, records = _traced(TREE, 2, BUSY)
    log_of(records)
    assert run.reader(metric)(cell) == pytest.approx(CASES[metric])


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("nothing", ["cpu", "untraced", "a program without the bias-correction spans"])
def test_each_reader_returns_none_where_there_is_nothing_to_read(metric, nothing, log_of):
    cell, records = _traced(TREE, 2, BUSY, devices=() if nothing == "cpu" else (0,))
    if nothing == "untraced":
        cell.trace = None
    elif nothing.startswith("a program"):  # the parent's program: its entry points' spans and the draw
        keep = {P + "coreg.Coreg.fit", P + "coreg.Coreg.apply", P + "coreg.draw"}
        cell.trace.host_ops = [op for op in cell.trace.host_ops if op[2] in keep]
        records = [r for r in records if r.name in keep]
        if metric in ("idle_in_program_ms.biascorr", "device_idle.biascorr", "draw_ms.biascorr"):
            assert run.reader(metric)(cell) is not None  # the entry points' spans, the draw and the trace remain
            return
    log_of(records)
    assert run.reader(metric)(cell) is None


def test_the_cells_traced_cpu_run_reports_none_of_its_metrics(monkeypatch):
    correct, _, res = _run(monkeypatch, traced=True)
    assert correct and not set(res["metrics"]) & set(READERS)
    assert P + "coreg.biascorr.fit" in {r.name for r in profiler.spans()}
