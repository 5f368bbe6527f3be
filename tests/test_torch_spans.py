"""The port's spans (xdem_tpu_torch.profiler.span): free while no profiler records, named and
nested under their entry point while one does, and without effect on any number."""

import contextlib
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.optimize
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu_torch import coreg, examples, profiler, spatialstats, terrain, uncertainty
from xdem_tpu_torch.parallel import make_mesh

P = "xdem_tpu_torch."
ROOT = Path(__file__).resolve().parents[1]
SUITE = ["slope", "aspect", "hillshade", "max_curvature", "terrain_ruggedness_index", "rugosity",
         "fractal_roughness"]


@pytest.fixture(scope="module")
def pair():
    ref = examples.get_ref_dem().icrop((0, 512), (0, 640))
    tba = examples.get_tba_dem().icrop((0, 512), (0, 640))
    return ref.data.cpu().contiguous(), tba.data.cpu().contiguous(), ref.transform  # on the CPU with a card too


@contextlib.contextmanager
def traced():
    """A torch.profiler window on the CPU (some torch versions warn at a profiler's first start
    that it keeps one cycle's events, which the repository's warning filter would raise)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            yield prof


def _suite(ref, mesh=None):
    out = terrain.get_terrain_attribute(ref[:200, :240], SUITE, resolution=20.0, mesh=mesh)
    return [o.numpy() for o in out]


def _chain(ref, tba, transform):
    nk = coreg.NuthKaab(subsample=5000)
    nk.fit(ref, tba, transform=transform, crs=32633, random_state=3)
    aligned, _ = nk.apply(tba, transform=transform)
    sig, rho = uncertainty.estimate_uncertainty(ref, aligned, subsample=300, random_state=3, transform=transform,
                                                crs=32633)
    return [np.array(nk.to_translations()), aligned.numpy(), sig.numpy(), rho(np.array([20.0, 200.0, 2000.0]))], nk


WORKLOADS = {
    "suite": lambda p: (_suite(p[0]), None),
    "mesh": lambda p: (_suite(p[0], make_mesh(devices=[torch.device("cpu")] * 4, shape=(2, 2))), None),
    "chain": lambda p: _chain(*p),
}


def _raise(*args, **kwargs):
    raise AssertionError("a span recorded while no profiler ran")


@pytest.fixture(scope="module")
def runs(pair):
    """Each workload untraced, with record_function and torch.cuda.Event made to raise, then
    under a torch.profiler: (outputs off, outputs on, spans, the trace's host names, the
    chain's fit)."""
    out = {}
    for name, work in WORKLOADS.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", _raise)
            mp.setattr(torch.autograd.profiler, "record_function", _raise)
            mp.setattr(torch.cuda, "Event", _raise)
            off, _ = work(pair)
        with traced() as prof:
            on, fit = work(pair)
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        out[name] = (off, on, profiler.spans(), names, fit)
    return out


def _by_id(records):
    return {r.id: r for r in records}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_outputs_are_bit_equal_with_tracing_on_and_off(runs, name):
    off, on = runs[name][:2]
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_every_span_is_in_the_trace_and_nested_under_its_entry_point(runs, name):
    records, names = runs[name][2], runs[name][3]
    assert records and all(r.name.startswith(P) for r in records)
    by_id = _by_id(records)
    roots = [r for r in records if r.parent is None]
    entries = {P + "terrain.get_terrain_attribute", P + "coreg.Coreg.fit", P + "coreg.Coreg.apply",
               P + "uncertainty.estimate_uncertainty"}
    assert {r.name for r in roots} <= entries
    assert [r.root for r in roots] == sorted(r.root for r in roots) == list(range(len(roots)))
    for r in records:
        top = r
        while top.parent is not None:
            top = by_id[top.parent]
        assert top.root == r.root and top.name in entries
        assert names.count(r.name) == sum(1 for q in records if q.name == r.name)
        assert r.ms == {}  # no card here


def test_a_mesh_suite_scatters_once_and_exchanges_three_times(runs):
    records = runs["mesh"][2]
    names = [r.name for r in records]
    assert names.count(P + "parallel.scatter") == 1
    assert names.count(P + "parallel.exchange") == 3
    assert names.count(P + "terrain.center") == 1
    for stage in ("k1", "k2", "k3"):
        assert names.count(P + "terrain." + stage) == 1
    assert names.count(P + "terrain.epilog") == 3
    by_id = _by_id(records)
    exchanges = [r for r in records if r.name == P + "parallel.exchange"]
    assert sorted(by_id[r.parent].name for r in exchanges) == [P + "terrain.k1", P + "terrain.k2", P + "terrain.k3"]


def test_the_chain_opens_a_step_span_per_iteration_and_the_uncertainty_stages(runs):
    records, fit = runs["chain"][2], runs["chain"][4]
    by_id = _by_id(records)
    steps = [r for r in records if r.name == P + "coreg.nuth_kaab.step"]
    assert len(steps) == fit.meta["outputs"]["iterative"]["last_iteration"] >= 3
    assert {by_id[r.parent].name for r in steps} == {P + "coreg.Coreg.fit"}
    parents = {r.name: by_id[r.parent].name for r in records if r.parent is not None}
    assert parents[P + "coreg.nuth_kaab.prepare"] == parents[P + "coreg.nuth_kaab.draw"] == P + "coreg.Coreg.fit"
    unc = P + "uncertainty.estimate_uncertainty"
    for stage in ("uncertainty.attributes", "spatialstats.sigma.prepare", "spatialstats.sigma.bins",
                  "spatialstats.sigma.tables", "spatialstats.sigma.grid", "spatialstats.variogram.sample",
                  "spatialstats.variogram.fit"):
        assert parents[P + stage] == unc, stage
    assert parents[P + "terrain.get_terrain_attribute"] == P + "uncertainty.attributes"
    assert [r.name for r in records if r.parent is None] == [P + "coreg.Coreg.fit", P + "coreg.Coreg.apply", unc]


def test_the_variogram_fit_counts_the_objective_evaluations(monkeypatch):
    calls = []
    curve_fit = scipy.optimize.curve_fit

    def counted(f, *args, **kwargs):
        def objective(*a):
            calls.append(1)
            return f(*a)
        return curve_fit(objective, *args, **kwargs)

    monkeypatch.setattr(scipy.optimize, "curve_fit", counted)
    lags = np.linspace(50.0, 5000.0, 30)
    emp = {"exp": 1.0 - np.exp(-lags / 800.0) + 0.01 * np.sin(lags), "lags": lags, "count": np.full(30, 100),
           "err_exp": np.full(30, 0.05)}
    with traced():
        spatialstats.fit_sum_model_variogram(["spherical", "gaussian"], emp)
    (fit,) = profiler.spans()
    assert fit.name == P + "spatialstats.variogram.fit" and fit.parent is None
    assert fit.counters == {"evaluations": len(calls)} and len(calls) > 5


def test_two_traced_windows_each_see_only_their_own_spans(pair):
    ref = pair[0][:64, :64]
    with traced():
        terrain.get_terrain_attribute(ref, ["slope", "fractal_roughness"], resolution=20.0)
    first = profiler.spans()
    with traced():
        terrain.get_terrain_attribute(ref, "roughness", resolution=20.0)
    second = profiler.spans()
    assert P + "terrain.k3" in {r.name for r in first}
    assert [r.name for r in second] == [P + "terrain.k2", P + "terrain.epilog", P + "terrain.get_terrain_attribute"]
    assert [r.root for r in second] == [0, 0, 0]
    assert profiler.spans() == second  # reading the log does not empty it
    profiler.reset_spans()
    assert profiler.spans() == []


def test_without_a_profiler_a_span_is_one_shared_no_op():
    a, b = profiler.span(P + "a", devices=[torch.device("cpu")]), profiler.span(P + "b")
    assert a is b
    with a as record:
        record.count("n", 3)
    profiler.reset_spans()
    with a:
        pass
    assert profiler.spans() == []


def test_an_enabled_profilers_trace_files_hold_the_entry_span(tmp_path, pair, monkeypatch):
    monkeypatch.setattr(profiler.Profiler, "_records", [])  # restored afterwards, as other tests expect
    profiler.Profiler.enable(jax_trace_dir=str(tmp_path))
    try:
        terrain.get_terrain_attribute(pair[0][:64, :64], "slope", resolution=20.0)
    finally:
        profiler.Profiler.disable()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    text = trace.read_text()
    assert f'"{P}terrain.get_terrain_attribute"' in text and f'"{P}terrain.center"' in text
    assert [r.name for r in profiler.spans()][-1] == P + "terrain.get_terrain_attribute"


def test_estimate_uncertainty_under_an_enabled_profiler_writes_one_trace_with_every_span(tmp_path, pair,
                                                                                          monkeypatch):
    """The terrain call inside estimate_uncertainty is profiled inside a profiled call: it lands in
    the outer call's trace (a second profiler on the thread would be refused) and both are recorded."""
    monkeypatch.setattr(profiler.Profiler, "_records", [])
    ref, tba, transform = pair
    profiler.Profiler.enable(jax_trace_dir=str(tmp_path))
    try:
        sig, _ = uncertainty.estimate_uncertainty(ref, tba, subsample=300, random_state=3, transform=transform,
                                                  crs=32633)
        records = profiler.Profiler.records()
    finally:
        profiler.Profiler.disable()
    assert torch.isfinite(sig).any()
    unc, entry = P + "uncertainty.estimate_uncertainty", P + "terrain.get_terrain_attribute"
    assert [r["name"] for r in records] == [entry, unc]
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert trace.name.startswith(unc)
    text = trace.read_text()
    assert f'"{unc}"' in text and f'"{entry}"' in text and f'"{P}spatialstats.variogram.fit"' in text
    names = [r.name for r in profiler.spans()]
    assert names[-1] == unc and names.count(unc) == 1 and P + "uncertainty.attributes" in names


def test_a_profiled_call_inside_another_keeps_the_outer_calls_peak_counters(monkeypatch):
    resets = []
    monkeypatch.setattr(profiler.Profiler, "_records", [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", resets.append)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 0)
    monkeypatch.setattr(profiler._device, "synchronize", lambda devices=None: None)
    inner = profiler.profile(P + "inner", memprof=True)(lambda: 1)
    outer = profiler.profile(P + "outer", memprof=True)(lambda: inner() + 1)
    profiler.Profiler.enable()
    try:
        assert outer() == 2
        assert inner() == 1
    finally:
        profiler.Profiler.disable()
    assert resets == [0, 1, 0, 1]  # the outer call's, then the inner call's alone; none nested
    assert [r["name"] for r in profiler.Profiler.records()] == [P + "inner", P + "outer", P + "inner"]


def test_importing_the_port_leaves_torchs_profiler_hooks_alone_until_a_span_records():
    code = ("import torch.autograd.profiler as p; start = p._run_on_profiler_start; "
            "import xdem_tpu_torch.terrain, xdem_tpu_torch.coreg, xdem_tpu_torch.uncertainty; "
            "from xdem_tpu_torch import profiler; assert p._run_on_profiler_start is start; "
            "prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]); prof.start(); "
            "profiler.span('xdem_tpu_torch.a').__enter__().__exit__(None, None, None); prof.stop(); "
            "assert p._run_on_profiler_start is not start; session = profiler._SPANS.session; "
            "prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]); prof.start(); "
            "prof.stop(); assert profiler._SPANS.session == session + 1")
    done = subprocess.run([sys.executable, "-W", "ignore", "-c", "import torch; " + code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
