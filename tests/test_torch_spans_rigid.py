"""The spans of rigid coregistration (xdem_tpu_torch.profiler.span): the grid draw, ICP's
preparation, steps and neighbour scans, LZD's preparation and steps, and the small-rotation
regrid, with their counters, under a CPU torch.profiler; and nothing recorded without one. The
regrid's ``kernel`` counter (a launch of ``csrc/regrid.cu`` a step on the card) is held to its
``steps`` on the card in ``test_torch_cuda.py``, as is the scan's (a launch of ``csrc/nn_scan.cu``
a step); a CPU cloud takes the ATen scan and counts no launch."""

import contextlib
import warnings

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu_torch import coreg, profiler
from xdem_tpu_torch.coreg import affine, base
from xdem_tpu_torch.georef import Affine

P = "xdem_tpu_torch."
TRANSFORM = Affine.from_origin(-300000.0, -1000000.0, 10.0, 10.0)
ICP_POINTS, LZD_POINTS = 1500, 10000
STAGES = ["coreg.draw", "coreg.icp.prepare", "coreg.icp.step", "coreg.icp.nn", "coreg.lzd.prepare", "coreg.lzd.step",
          "coreg.regrid"]


@pytest.fixture(scope="module")
def pair():
    """A smooth seeded DEM and the same raised, moved and tilted by the small-rotation regrid."""
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:160, 0:160] / 160.0
    ref = 300 * np.sin(3 * xx + 1) * np.cos(2 * yy) + 200 * xx * yy + rng.normal(0, 2, (160, 160))
    ref = torch.from_numpy(ref.astype(np.float32))
    motion = coreg.matrix_from_translations_rotations(20.0, 5.0, 0.1, 0.1, 0.05, 0.01)
    tba, _ = coreg.apply_matrix(ref, motion, centroid=(-299200.0, -1000800.0, 0.0), transform=TRANSFORM)
    return ref, tba


@contextlib.contextmanager
def traced():
    """A torch.profiler window on the CPU (some torch versions warn at a profiler's first start)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events", category=UserWarning)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            yield


def _pipeline(ref, tba):
    pipe = coreg.ICP(subsample=ICP_POINTS, nn_method="brute") + coreg.LZD(subsample=LZD_POINTS)
    pipe.fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=2)
    aligned, _ = pipe.apply(tba, transform=TRANSFORM)
    return pipe, aligned


@pytest.fixture(scope="module")
def traced_run(pair):
    """The pipeline under a profiler, with each solver's and each regrid's own count of its steps."""
    counts = {"icp": [], "lzd": [], "regrid": []}
    with pytest.MonkeyPatch.context() as mp:
        icp_loop, lzd_loop, interp = affine._icp_while_loop, affine._lzd_solve_device, base.interp_rowcol

        def icp_counted(*args, **kwargs):
            out = icp_loop(*args, **kwargs)
            counts["icp"].append(out[1])
            return out

        def lzd_counted(*args, **kwargs):
            out = lzd_loop(*args, **kwargs)
            counts["lzd"].append(out[1])
            return out

        def interp_counted(*args, **kwargs):  # one interpolation a fixed-point step
            counts["regrid"][-1] += 1
            return interp(*args, **kwargs)

        regrid = base._iterate_affine_regrid_small_rotations

        def regrid_counted(*args, **kwargs):
            counts["regrid"].append(0)
            return regrid(*args, **kwargs)

        mp.setattr(affine, "_icp_while_loop", icp_counted)
        mp.setattr(affine, "_lzd_solve_device", lzd_counted)
        mp.setattr(base, "interp_rowcol", interp_counted)
        mp.setattr(base, "_iterate_affine_regrid_small_rotations", regrid_counted)
        with traced():
            pipe, aligned = _pipeline(*pair)
    return profiler.spans(), counts, pipe, aligned


def test_each_rigid_stage_opens_its_span_under_its_entry_point(traced_run):
    records, counts, _, _ = traced_run
    by_id = {r.id: r for r in records}
    names = [r.name for r in records]
    for stage in STAGES:
        assert P + stage in names, stage
    parents = {r.name: by_id[r.parent].name for r in records if r.parent is not None}
    fit, apply = P + "coreg.Coreg.fit", P + "coreg.Coreg.apply"
    assert parents[P + "coreg.icp.prepare"] == parents[P + "coreg.icp.step"] == fit
    assert parents[P + "coreg.lzd.prepare"] == parents[P + "coreg.lzd.step"] == fit
    assert parents[P + "coreg.icp.nn"] == P + "coreg.icp.step"
    assert {by_id[r.parent].name for r in records if r.name == P + "coreg.draw"} == {P + "coreg.icp.prepare",
                                                                                     P + "coreg.lzd.prepare"}
    assert {by_id[r.parent].name for r in records if r.name == P + "coreg.regrid"} == {apply}
    # Each step a span, and each regrid of the fit's two applies and the pipeline's two.
    assert names.count(P + "coreg.icp.step") == names.count(P + "coreg.icp.nn") == sum(counts["icp"])
    assert names.count(P + "coreg.lzd.step") == sum(counts["lzd"])
    assert names.count(P + "coreg.regrid") == len(counts["regrid"]) == 4


def test_the_counters_count_points_pairs_and_regrid_steps(traced_run):
    records, counts, pipe, _ = traced_run
    by_name = {}
    for r in records:
        by_name.setdefault(r.name[len(P):], []).append(r)
    (icp_prepare,), (lzd_prepare,) = by_name["coreg.icp.prepare"], by_name["coreg.lzd.prepare"]
    assert icp_prepare.counters == {"points": ICP_POINTS}
    assert pipe[0].meta["outputs"]["random"]["subsample_final"] == ICP_POINTS
    assert lzd_prepare.counters == {"points": LZD_POINTS}
    assert [r.counters for r in by_name["coreg.icp.nn"]] == [{"pairs": ICP_POINTS * ICP_POINTS}] * sum(counts["icp"])
    assert [r.counters["steps"] for r in by_name["coreg.regrid"]] == counts["regrid"]
    # The CPU takes the ATen loop: no step is a launch of the regrid kernel.
    assert [r.counters.get("kernel", 0) for r in by_name["coreg.regrid"]] == [0] * len(counts["regrid"])
    assert all(steps >= 1 for steps in counts["regrid"])


def test_off_a_trace_a_rigid_fit_records_nothing_and_gives_the_same_numbers(pair, traced_run, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded while no profiler ran")

    profiler.reset_spans()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    pipe, aligned = _pipeline(*pair)
    assert profiler.spans() == []
    _, _, traced_pipe, traced_aligned = traced_run
    assert np.array_equal(pipe.to_matrix(), traced_pipe.to_matrix())
    assert torch.equal(torch.isnan(aligned), torch.isnan(traced_aligned))
    assert torch.equal(aligned.nan_to_num(), traced_aligned.nan_to_num())


def test_a_cpu_cloud_takes_the_aten_scan_and_counts_no_launch(monkeypatch):
    """ICP on CPU clouds builds its scan from the ATen loop, never the card's, and leaves the
    launch count and the ``coreg.icp.nn`` spans' counters (``pairs`` alone) as they were."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU cloud reached the scan kernel")

    built = []
    aten = affine._nn_scan_aten
    monkeypatch.setattr(affine, "_nn_scan_aten", lambda *a, **k: built.append(1) or aten(*a, **k))
    monkeypatch.setattr(affine, "_nn_scan_on_card", refuse)
    rng = np.random.default_rng(4)
    ref = torch.from_numpy(rng.normal(size=(ICP_POINTS, 3)).astype(np.float32))
    motion = torch.from_numpy(coreg.matrix_from_translations_rotations(0.02, -0.01, 0.01, 0.5, 0.2, 0.1)
                              .astype(np.float32))
    tba = ref @ motion[:3, :3].T + motion[:3, 3]
    norms = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(ICP_POINTS, 3)).astype(np.float32)), dim=1)
    launches = dict(base.LAUNCHES)
    with traced():
        _, iterations, _ = affine._icp_solve_device(ref, tba, norms, np.float32(1e-4), max_iterations=6)
    assert built == [1]
    assert base.LAUNCHES == launches
    scans = [r.counters for r in profiler.spans() if r.name == P + "coreg.icp.nn"]
    assert iterations >= 3 and scans == [{"pairs": ICP_POINTS * ICP_POINTS}] * iterations
