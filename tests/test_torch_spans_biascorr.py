"""The spans of the bias corrections (xdem_tpu_torch.profiler.span): each step's variables,
host binning, host fit and correction plane, beside the grid draw, with their counters, under a
CPU torch.profiler; and nothing recorded without one."""

import contextlib
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu_torch import coreg, fit, profiler
from xdem_tpu_torch.georef import Affine

P = "xdem_tpu_torch."
TRANSFORM = Affine.from_origin(-300000.0, -1000000.0, 10.0, 10.0)
COUNT, N = 8000, 160
FIT, APPLY = P + "coreg.Coreg.fit", P + "coreg.Coreg.apply"
# The spans under each step's fit, and under every apply.
UNDER_FIT = {
    "Deramp": {"coreg.draw": 1, "coreg.biascorr.vars": 2, "coreg.biascorr.fit": 1},  # one vars span a coordinate
    "DirectionalBias": {"coreg.draw": 1, "coreg.biascorr.vars": 1, "coreg.biascorr.bin": 1, "coreg.biascorr.fit": 1},
    "TerrainBias": {"coreg.draw": 1, "coreg.biascorr.vars": 1, "coreg.biascorr.bin": 1},
}
UNDER_APPLY = {"coreg.biascorr.vars": 1, "coreg.biascorr.apply": 1}


@pytest.fixture(scope="module")
def pair():
    """A smooth seeded DEM and the same plus a ramp, an along-track sine and noise."""
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:N, 0:N] / N
    ref = 300 * np.sin(3 * xx + 1) * np.cos(2 * yy) + 200 * xx * yy + rng.normal(0, 2, (N, N))
    along = (xx * np.cos(1.3) + (1 - yy) * np.sin(1.3)) * N * 10.0
    tba = ref + 3 * (xx - 0.5) ** 2 - 2 * xx * yy + np.sin(2 * np.pi * along / 400.0) + rng.normal(0, 0.2, (N, N))
    tba[40:50, 60:75] = np.nan
    return torch.from_numpy(ref.astype(np.float32)), torch.from_numpy(tba.astype(np.float32))


@contextlib.contextmanager
def traced():
    """A torch.profiler window on the CPU (some torch versions warn at a profiler's first start)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            yield


def _pipeline(ref, tba):
    pipe = coreg.CoregPipeline([coreg.Deramp(subsample=COUNT), coreg.DirectionalBias(angle=74.5, subsample=COUNT),
                                coreg.TerrainBias(subsample=COUNT)])
    pipe.fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=3)
    corrected, _ = pipe.apply(tba, transform=TRANSFORM)
    return pipe, corrected


@pytest.fixture(scope="module")
def traced_run(pair):
    """The pipeline under a profiler, with the sum of sines' own count of its residual
    evaluations (a call of its residual or of its Jacobian)."""
    evaluations = []
    with pytest.MonkeyPatch.context() as mp:
        make = fit._sumsin_residual_and_jacobian

        def counting(fn):
            def call(p):
                evaluations.append(1)
                return fn(p)

            return call

        mp.setattr(fit, "_sumsin_residual_and_jacobian", lambda x, y: tuple(map(counting, make(x, y))))
        with traced():
            pipe, corrected = _pipeline(*pair)
    return profiler.spans(), len(evaluations), pipe, corrected


def _by_root(records):
    """[(root's name, the draw and bias-correction spans under it, counted)] in the order the
    roots closed (the terrain call inside TerrainBias's variables opens spans of its own)."""
    roots = [r for r in records if r.parent is None]
    children = {r.root: Counter() for r in roots}
    for r in records:
        if r.parent is not None and r.name.startswith((P + "coreg.biascorr.", P + "coreg.draw")):
            children[r.root][r.name[len(P):]] += 1
    return [(r.name, children[r.root]) for r in roots]


def test_each_span_appears_once_a_step_where_it_should(traced_run):
    records, _, pipe, _ = traced_run
    steps = [type(step).__name__ for step in pipe]
    roots = _by_root(records)
    # The pipeline's fit: each step's fit, then its apply; then the pipeline's apply, step by step.
    assert [name for name, _ in roots] == [FIT, APPLY] * 3 + [APPLY] * 3
    fits = [children for name, children in roots if name == FIT]
    assert [dict(c) for c in fits] == [UNDER_FIT[s] for s in steps]
    assert all(dict(children) == UNDER_APPLY for name, children in roots if name == APPLY)
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name.startswith(P + "coreg.biascorr.") or r.name == P + "coreg.draw":
            assert by_id[r.parent].parent is None  # directly under an entry point: no span nests in another


def test_the_counters_read_what_the_fit_and_the_binning_did(traced_run):
    records, evaluations, pipe, _ = traced_run
    by_name = {}
    for r in records:
        by_name.setdefault(r.name[len(P):], []).append(r)
    for r, step in zip(by_name["coreg.biascorr.bin"], pipe[1:]):
        table = step.meta["outputs"]["fitorbin"]["bin_dataframe"]
        assert r.counters == {"values": step.meta["outputs"]["random"]["subsample_final"], "bins": len(table["count"])}
        assert r.counters == {"values": COUNT, "bins": 100}
    deramp, directional = by_name["coreg.biascorr.fit"]
    assert deramp.counters == {}  # a linear least squares: no LM loop
    sines = pipe[1].meta["outputs"]["fitorbin"]["fit_params"]
    assert directional.counters == {"evaluations": evaluations, "frequencies": len(sines) // 3}
    assert evaluations > 0 and len(sines) // 3 >= 1


def test_an_lm_fit_counts_its_evaluations_on_the_span_it_runs_in():
    calls = []

    def line(xx, *params):
        calls.append(1)
        return fit.polynomial_1d(xx, *params)

    x, y = np.arange(20.0), 2.0 + 0.5 * np.arange(20.0)
    with traced():
        fit.curve_fit_lm(line, x, y, p0=[0.0, 0.0])  # outside any span: counted nowhere
        outside = len(calls)
        with profiler.span(P + "tests.outer"):
            p = fit.curve_fit_lm(line, x, y, p0=[0.0, 0.0])
    (outer,) = profiler.spans()
    assert outer.counters == {"evaluations": len(calls) - outside} and outside == len(calls) - outside
    assert np.allclose(p, [2.0, 0.5], atol=1e-3)


def test_off_a_trace_the_pipeline_records_nothing_and_gives_the_same_numbers(pair, traced_run, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded while no profiler ran")

    profiler.reset_spans()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    pipe, corrected = _pipeline(*pair)
    assert profiler.spans() == []
    _, _, traced_pipe, traced_corrected = traced_run
    for step, other in zip(pipe, traced_pipe):
        a, b = step.meta["outputs"]["fitorbin"], other.meta["outputs"]["fitorbin"]
        assert np.array_equal(np.asarray(a["fit_params"], float), np.asarray(b["fit_params"], float), equal_nan=True)
    assert torch.equal(torch.isnan(corrected), torch.isnan(traced_corrected))
    assert torch.equal(corrected.nan_to_num(), traced_corrected.nan_to_num())
