"""The harness on the CPU: discovery by name, seeded inputs, the result line, the import check."""

import json
import re
import subprocess
import sys

import pytest
import torch

from gpu_bench import inputs, run, traffic

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for cell in SPEC["workloads"]:
        assert (run.ROOT / configs[cell["config"]]["file"]).is_file()
        mix = run.load_json(run.BENCH / "mixes" / f"{cell['traffic']}.json")
        kind = traffic.kind(mix["kind"])
        assert kind.__file__ == str(run.BENCH / "kinds" / f"{mix['kind']}.py")
        assert callable(kind.Work) and callable(kind.control)
        limits = run.load_json(run.BENCH / "limits" / f"{cell['name']}.json")
        assert limits and all(v >= 0 for v in limits.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and callable(run.reader(m["name"]))
        assert set(m.get("workloads", [])) <= {c["name"] for c in SPEC["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in SPEC["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(SPEC, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(SPEC, cell, True)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 1])
def test_inputs_repeat_exactly_for_a_seed(seed):
    def make(s):
        z = inputs.spectral_dem(96, inputs.seed_ints(s, 1, 0), torch.device("cpu"), shift_m=(-9.2, 4.6, -2.35),
                                pixel_m=10.0)
        inputs.cut_voids(z[1], inputs.seed_ints(s, 2, 0), 5, 2, 9, (2, 2))
        return z

    a, b, c = make(seed), make(seed), make(seed + 1)
    for x, y in zip(a, b):
        assert torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
    assert not torch.equal(a[0], c[0])
    assert float(a[0].min()) == 0.0 and float(a[0].max()) == pytest.approx(1000.0)
    assert int(torch.isnan(a[1]).sum()) > 0


def _cell(name):
    return next(w for w in SPEC["workloads"] if w["name"] == name)


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_has_the_keys_the_contract_names(traced):
    res, checks = run.run_cell(SPEC, _cell("dem10k.terrain"), 3, 0.3, traced, [torch.device("cpu")], size=160)
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device"} | ({"breakdown"} if traced else set())
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"] for m in run.cell_metrics(SPEC, _cell("dem10k.terrain"), traced)}
    assert set(res["metrics"]) <= wanted
    if not traced:
        assert set(res["metrics"]) == wanted
    limits = run.load_json(run.BENCH / "limits" / "dem10k.terrain.json")
    assert {n for n, _, _ in checks} == set(limits) | {"failed_calls"}
    json.dumps(res)


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "xdem_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "xdem_tpu.terrain", sys)
    assert run.forbidden_modules() == ["xdem_tpu"]
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "xdem_tpu"]


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "gpu_bench/run.py", "--workload", "dem10k.terrain", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_prints_a_correct_result(card):
    proc = subprocess.run([sys.executable, "gpu_bench/run.py", "--workload", "dem10k.terrain", "--seed", "5",
                           "--seconds", "2", "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
