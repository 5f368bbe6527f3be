"""The one generator of traffic: it reads a configuration and a mix (data files) and builds
the pool of inputs, the timed call and the check of the call's outputs.

A mix's "kind" names the module ``gpu_bench/kinds/<kind>.py``, found by that name, that holds
the entry points a call drives: its ``Work(config, mix, seed, devices, size)`` has ``pool``,
``pixels_per_call``, ``call(i, spans)``, ``launches_per_call()``, ``keep_inputs(indices)`` and
``check(kept)``, and its ``control(work, dtype)`` is the call with the plain reference in
`dtype` in the program's place. Inputs are made from the run's seed into a pool during set-up
and used in turn. A later cell of a new kind adds its own module and changes no file here.
"""

from __future__ import annotations

import importlib


def wait(devices) -> None:
    from xdem_tpu_torch._device import synchronize

    synchronize(devices)


def kind(name: str):
    """The module gpu_bench/kinds/<name>.py."""
    return importlib.import_module(f"gpu_bench.kinds.{name}")


def build(config: dict, mix: dict, seed: int, devices, size: int | None = None):
    return kind(mix["kind"]).Work(config, mix, seed, devices, size)
