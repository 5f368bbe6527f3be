"""The readers of the program's spans (gpu_bench/spans.py and the metrics built on it) on
synthetic traces and span logs with known answers, and on runs that have nothing to read."""

import types
import warnings

import pytest
import torch

from gpu_bench import run, spans
from gpu_bench.trace import Trace
from xdem_tpu_torch import profiler

P = "xdem_tpu_torch."
NEW = ["center_ms.terrain", "idle_in_program_ms.terrain", "center_ms.mesh4", "scatter_ms.mesh4", "exchange_ms.mesh4",
       "sigma_ms.pair", "variogram_ms.pair", "vario_fit_ms.pair", "vario_evals.pair", "nk_steps.pair",
       "idle_in_program_ms.pair"]


def _cell(tree, calls, busy, devices=(0,), window_s=1.0, extra_host=()):
    """A run and its span log from `tree`: (stage, start, end, children, ms, counters) tuples, the
    roots in call order; `busy` is [(device, start, end)] or [(device, start, end, name)]."""
    records, host = [], list(extra_host)

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
    trace = Trace([(*op, "kernel")[:4] for op in busy], sorted(host), window_s, list(devices))
    calls = [types.SimpleNamespace(ok=True) for _ in range(calls)]
    return types.SimpleNamespace(calls=calls, trace=trace), records


def _leaf(stage, s, e, ms=None, **counters):
    return (stage, s, e, [], ms or {}, counters)


ENTRY = "terrain.get_terrain_attribute"
TERRAIN = [
    (ENTRY, 0.0, 0.4, [("terrain.k1", 0.05, 0.15, [_leaf("terrain.center", 0.06, 0.08, {0: 2.0})], {}, {}),
                       _leaf("terrain.epilog", 0.2, 0.3)], {}, {}),
    (ENTRY, 0.5, 0.9, [_leaf("terrain.center", 0.55, 0.6, {0: 4.0})], {}, {}),
]
TERRAIN_BUSY = [(0, 0.0, 0.1), (0, 0.25, 0.45), (0, 0.5, 0.8)]

FAMILIES = [("terrain.k1", "surface_fit_kernel"), ("terrain.k2", "windowed3_kernel"), ("terrain.k3", "fractal_planes")]
MESH = [(ENTRY, 0.0, 0.9, [
    _leaf("parallel.scatter", 0.0, 0.1, {0: 20.0, 1: 1.0, 2: 1.0, 3: 1.0}),
    *[(family, 0.1 + 0.2 * k, 0.3 + 0.2 * k, [
        *([_leaf("terrain.center", 0.1, 0.15, {0: 50.0})] if k == 0 else []),
        _leaf("parallel.exchange", 0.15 + 0.2 * k, 0.2 + 0.2 * k, {0: 100.0, 1: 100.0, 2: 60.0, 3: 100.0})], {}, {})
      for k, (family, _) in enumerate(FAMILIES)],
], {}, {})]
# Each card runs a family's kernel at 0.4, 0.6, 0.8 s (after the host has left that family's
# exchange), 20 ms of copies just before it (inside the exchange's interval), and a copy 110-80
# ms before it, of which 20 ms fall inside a 100 ms interval (cards 0, 1, 3) and none inside a 60
# ms one (card 2).
MESH_BUSY = [op for d in range(4) for k, (_, kernel) in enumerate(FAMILIES)
             for op in ((d, 0.29 + 0.2 * k, 0.32 + 0.2 * k, "Memcpy PtoP"), (d, 0.38 + 0.2 * k, 0.4 + 0.2 * k, "copy"),
                        (d, 0.4 + 0.2 * k, 0.45 + 0.2 * k, kernel))]


def _pair(t0, steps, evaluations):
    fit = ("coreg.Coreg.fit", t0, t0 + 0.1, [
        _leaf("coreg.nuth_kaab.prepare", t0, t0 + 0.01), _leaf("coreg.nuth_kaab.draw", t0 + 0.01, t0 + 0.02),
        *[_leaf("coreg.nuth_kaab.step", t0 + 0.02 + k * 0.001, t0 + 0.021 + k * 0.001) for k in range(steps)]], {}, {})
    unc = ("uncertainty.estimate_uncertainty", t0 + 0.15, t0 + 0.4, [
        _leaf("spatialstats.sigma.prepare", t0 + 0.16, t0 + 0.17, {0: 10.0}),
        _leaf("spatialstats.sigma.bins", t0 + 0.17, t0 + 0.18, {0: 5.0}),
        _leaf("spatialstats.sigma.tables", t0 + 0.18, t0 + 0.19, {0: 1.0}),
        _leaf("spatialstats.sigma.grid", t0 + 0.19, t0 + 0.2, {0: 4.0}),
        _leaf("spatialstats.variogram.sample", t0 + 0.2, t0 + 0.25, {0: 22.0}),
        _leaf("spatialstats.variogram.fit", t0 + 0.25, t0 + 0.25 + evaluations / 1e4, evaluations=evaluations)],
        {}, {})
    return [fit, _leaf("coreg.Coreg.apply", t0 + 0.1, t0 + 0.15), unc]


PAIR = _pair(0.0, 3, 300) + _pair(0.5, 5, 100)

CASES = {  # metric: (tree, calls, busy, devices, value)
    "center_ms.terrain": (TERRAIN, 2, TERRAIN_BUSY, (0,), 3.0),
    "idle_in_program_ms.terrain": (TERRAIN, 2, TERRAIN_BUSY, (0,), 125.0),  # (0.15 s + 0.1 s) / 2
    "center_ms.mesh4": (MESH, 1, MESH_BUSY, (0, 1, 2, 3), 50.0),
    "scatter_ms.mesh4": (MESH, 1, MESH_BUSY, (0, 1, 2, 3), 20.0),
    "exchange_ms.mesh4": (MESH, 1, MESH_BUSY, (0, 1, 2, 3), 3 * (3 * 40.0 + 20.0)),
    "sigma_ms.pair": (PAIR, 2, [(0, 0.0, 1.0)], (0,), 20.0),
    "variogram_ms.pair": (PAIR, 2, [(0, 0.0, 1.0)], (0,), 22.0),
    "vario_fit_ms.pair": (PAIR, 2, [(0, 0.0, 1.0)], (0,), 20.0),  # (30 ms + 10 ms) / 2
    "vario_evals.pair": (PAIR, 2, [(0, 0.0, 1.0)], (0,), 200.0),
    "nk_steps.pair": (PAIR, 2, [(0, 0.0, 1.0)], (0,), 4.0),
    "idle_in_program_ms.pair": (PAIR, 2, [(0, 0.0, 0.05), (0, 0.5, 1.0)], (0,), 175.0),  # [0.05, 0.4] / 2
}


@pytest.fixture
def log_of(monkeypatch):
    def install(records):
        monkeypatch.setattr(profiler, "spans", lambda: list(records))
    return install


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_gives_its_known_answer(metric, log_of):
    tree, calls, busy, devices, want = CASES[metric]
    cell, records = _cell(tree, calls, busy, devices)
    log_of(records)
    assert run.reader(metric)(cell) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
@pytest.mark.parametrize("nothing", ["cpu", "untraced", "no spans in the program"])
def test_each_reader_returns_none_where_there_is_nothing_to_read(metric, nothing, log_of, monkeypatch):
    tree, calls, busy, devices, _ = CASES[metric]
    cell, records = _cell(tree, calls, busy, () if nothing == "cpu" else devices)
    log_of(records)
    if nothing == "untraced":
        cell.trace = None
    elif nothing == "no spans in the program":
        cell.trace.host_ops = [op for op in cell.trace.host_ops if not op[2].startswith(P)]
        monkeypatch.delattr(profiler, "spans")
    assert run.reader(metric)(cell) is None


@pytest.mark.parametrize("metric", ["center_ms.terrain", "sigma_ms.pair", "vario_evals.pair", "exchange_ms.mesh4"])
def test_a_log_whose_roots_are_not_the_traces_reads_nothing(metric, log_of):
    tree, calls, busy, devices, _ = CASES[metric]
    cell, records = _cell(tree, calls, busy, devices)
    last_root = [r for r in records if r.parent is None][-1]
    log_of([r for r in records if r is not last_root])  # a root the trace has and the log lacks
    assert run.reader(metric)(cell) is None


def test_the_exchange_reads_nothing_without_the_kernel_queued_behind_it(log_of):
    cell, records = _cell(MESH, 1, [op for op in MESH_BUSY if op[3] != "fractal_planes"], (0, 1, 2, 3))
    log_of(records)
    assert spans.exchange_busy_ms(cell) is None


def test_a_gap_inside_a_long_span_goes_to_that_span_behind_many_host_records():
    aten = [(0.1 + k * 1e-4, 0.1 + k * 1e-4 + 5e-5, "aten::mul") for k in range(1000)]
    cell, _ = _cell([_leaf("spatialstats.variogram.fit", 0.1, 0.9)], 1, [(0, 0.0, 0.1), (0, 0.95, 1.0)],
                    extra_host=aten)
    assert spans.idle_by_span(cell.trace) == pytest.approx({P + "spatialstats.variogram.fit": 0.8})
    assert spans.idle_in_program_ms(cell) == pytest.approx(800.0)


def test_idle_goes_to_the_innermost_open_span_and_is_averaged_over_the_cards():
    cell, _ = _cell(TERRAIN, 2, TERRAIN_BUSY + [(1, 0.0, 1.0)], devices=(0, 1))
    got = spans.idle_by_span(cell.trace)
    assert got == pytest.approx({P + ENTRY: 0.075, P + "terrain.k1": 0.025, P + "terrain.epilog": 0.025})


def test_a_traced_cpu_run_of_a_cell_reports_none_of_the_span_metrics():
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == "dem10k.terrain")
    with warnings.catch_warnings():  # some torch versions warn at a profiler's first start
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        res, _ = run.run_cell(spec, cell, 4, 0.3, True, [torch.device("cpu")], size=160)
    assert res["correct"] is True and not set(res["metrics"]) & set(NEW)
    assert {r.name for r in profiler.spans()} >= {P + ENTRY, P + "terrain.center", P + "terrain.k3"}
