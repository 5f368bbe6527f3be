"""`correct` comes out false for the control and for each fault a cell can have.

The control is the plain reference in bfloat16 (the precision below the configurations'
float32) in the program's place. The faults, planted under the timed call with the harness
otherwise whole: a call that returns the previous call's outputs (its state unchanged), an
output altered where it is produced, and on a mesh the exchange of halos between the shards
left out. The pair cell runs here with a smaller variogram draw (1 000 pixels), so that the
program's and the reference's pairs of pixels fit a CPU test.
"""

import pytest
import torch

from gpu_bench import readings, run, traffic

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
SMALL_PAIR = {"uncertainty": {"subsample": 1000, "sigma_draw": 5000000}}


def _cell(name):
    return next(w for w in SPEC["workloads"] if w["name"] == name)


def _run(monkeypatch, name, plant=None, devices=(CPU,), size=160, mix=None):
    real = traffic.build

    def build(config, mix_file, *rest):
        work = real(config, {**mix_file, **(mix or {})}, *rest)
        if plant is not None:
            plant(work)
        return work

    monkeypatch.setattr(traffic, "build", build)
    res, checks = run.run_cell(SPEC, _cell(name), 11, 0.3, False, list(devices), size=size)
    failed = [n for n, v, lim in checks if v > lim]
    return res["correct"], failed


def _control(work):
    work.call = traffic.kind(work.mix["kind"]).control(work, torch.bfloat16)


def test_sound_runs_are_correct(monkeypatch):
    assert _run(monkeypatch, "dem10k.terrain") == (True, [])
    assert _run(monkeypatch, "dem50k.terrain.mesh4", devices=[CPU] * 4, size=256) == (True, [])


def test_the_control_is_not_correct(monkeypatch):
    correct, failed = _run(monkeypatch, "dem10k.terrain", _control)
    assert not correct and "slope" in failed and "topographic_position_index" in failed


def _stale(work):
    real, previous = work.call, {}

    def call(i, spans):  # the state is one call behind: each call returns the previous call's outputs
        out = real(i, spans)
        stale = previous.get("out", out)
        previous["out"] = out
        return stale

    work.call = call


def _altered(work):
    real = work.call

    def call(i, spans):
        planes = real(i, spans)
        planes[0] = planes[0] * 1.01  # slope, one per cent off where it is produced
        return planes

    work.call = call


@pytest.mark.parametrize("plant, wrong", [(_stale, "slope"), (_altered, "slope")])
def test_a_planted_fault_is_not_correct(monkeypatch, plant, wrong):
    correct, failed = _run(monkeypatch, "dem10k.terrain", plant)
    assert not correct and wrong in failed


def test_the_exchange_left_out_is_not_correct(monkeypatch):
    readings.exchange_left_out(monkeypatch.setattr)
    correct, failed = _run(monkeypatch, "dem50k.terrain.mesh4", devices=[CPU] * 4, size=256)
    assert not correct and "slope.seams" in failed


def _shifted(work):  # the translation altered where it is produced: 5 m east, half the pair's shift
    real = work.call

    def call(i, spans):
        (tx, ty, tz), *rest = real(i, spans)
        return ((tx + 5.0, ty, tz), *rest)

    work.call = call


def _sigma_scaled(work):  # sigma altered where it is produced: a pair's error split in two, sqrt(2) too small
    real = work.call

    def call(i, spans):
        shift, aligned, sig, rho = real(i, spans)
        return shift, aligned, sig / 2**0.5, rho

    work.call = call


def test_pair_sound_run_is_correct(monkeypatch):
    assert _run(monkeypatch, "dem10k.pair", size=384, mix=SMALL_PAIR) == (True, [])


@pytest.mark.parametrize("plant, wrong", [(_control, "sigma"), (_stale, "aligned"), (_shifted, "shift"),
                                          (_sigma_scaled, "sigma")])
def test_pair_control_and_faults_are_not_correct(monkeypatch, plant, wrong):
    correct, failed = _run(monkeypatch, "dem10k.pair", plant, size=384, mix=SMALL_PAIR)
    assert not correct and wrong in failed, failed
