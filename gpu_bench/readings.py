#!/usr/bin/env python3
"""Readings that set a cell's limits, many seeds in one process (not part of a run).

    python3 gpu_bench/readings.py --workload <name> --side program|control|witness --seeds 1 2 3 --seconds 2
        [--fault exchange]

``--side program`` runs the cell as ``run.py`` does (set-up, a short window, the check) once
per seed and prints each compared number: the lower readings. ``--side control`` puts the
plain reference, computed in the precision below the configuration's (bfloat16 for float32),
in the program's place and prints the same numbers: the upper readings. ``--side witness``
puts the plain reference in the configuration's own precision there: what rounding in that
precision alone reads. ``--fault exchange`` leaves the exchange of halos between the shards
of a mesh out of the program (the neighbours' strips read zeros). Each seed's numbers are one
JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpu_bench import run  # noqa: E402

BELOW = {"float64": "float32", "float32": "bfloat16"}


def exchange_left_out(monkeypatch_setattr=setattr) -> None:
    """Plant the fault: every halo strip a shard should receive from its neighbours is zeros."""
    from xdem_tpu_torch.parallel import halo

    real = halo._exchange

    def exchange(src, h):
        padded = real(src, h)
        for row in padded:
            for p in row:
                p[:h].zero_(), p[-h:].zero_(), p[:, :h].zero_(), p[:, -h:].zero_()
        return padded

    monkeypatch_setattr(halo, "_exchange", exchange)


FAULTS = {"exchange": exchange_left_out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control", "witness"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    run._set_caches()
    import torch

    from gpu_bench import traffic

    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    if args.fault:
        FAULTS[args.fault]()
    if args.side != "program":
        config = run.load_json(run.ROOT / next(c["file"] for c in spec["configs"] if c["name"] == cell["config"]))
        dtype = getattr(torch, BELOW[config["dtype"]] if args.side == "control" else config["dtype"])
        real_build = traffic.build

        def build(*a, **kw):
            work = real_build(*a, **kw)
            work.call = traffic.kind(work.mix["kind"]).control(work, dtype)
            return work

        traffic.build = build
    for seed in args.seeds:
        result, checks = run.run_cell(spec, cell, seed, args.seconds, False, devices)
        print(json.dumps({"seed": seed, "side": args.side, "fault": args.fault, "attempted": result["attempted"],
                          "correct": result["correct"], "numbers": {n: v for n, v, _ in checks}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
