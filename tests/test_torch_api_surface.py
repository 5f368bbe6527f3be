"""xdem_tpu_torch offers every public name of xdem_tpu with the same parameter list.

Every module of xdem_tpu (found on disk, so that collecting the tests imports nothing), every
class and function it defines, and every public method of those classes has a counterpart at
the same path in xdem_tpu_torch whose ``inspect.signature`` has the same parameters: names,
kinds and defaults, in order. A user script should need only a different import.

The allow-list is explicit: what exists only for the TPU (ROADMAP, "Rules that carry over")
and the port's extra parameters, which choose a tensor's device or precision or give a
georeferencing that xdem_tpu reads from its inputs.
"""

from __future__ import annotations

import importlib
import inspect
from pathlib import Path

import pytest
import torch_port_helpers  # noqa: F401  (thread cap)

import xdem_tpu

REF_DIR = Path(__file__).resolve().parent.parent / "xdem_tpu"

# Modules that exist only for the TPU. The Pallas kernels' counterparts are the CUDA kernels
# behind terrain/cuda_kernels.py; ops.precision's is the port's float32 matmuls with TF32 off.
# parallel/ (multi-device execution: an H100 node has several cards) and profiler (upstream
# xdem's profiling API) are ported, so their names are held like the rest.
TPU_ONLY_MODULES = ("ops.precision", "terrain.pallas_kernels")
# Names that exist only for the TPU: fixed-shape padding for the XLA compile cache.
TPU_ONLY_NAMES = {"ops.transfer:pad_to_bucket"}
# Parameters the port adds: (name path, parameter).
PORT_EXTRAS = {
    ("ops.interp:grid_coords", "device"), ("ops.interp:grid_coords", "dtype"),
    ("ops.transfer:device_mask", "device"),
    ("pointcloud:PointCloud", "device"), ("pointcloud:PointCloud.__init__", "device"),
    ("uncertainty:estimate_uncertainty", "transform"), ("uncertainty:estimate_uncertainty", "crs"),
}


def _modules() -> list[str]:
    out = []
    for f in sorted(REF_DIR.rglob("*.py")):
        parts = f.relative_to(REF_DIR).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if any(p.startswith("_") for p in parts):
            continue
        rel = ".".join(parts)
        if rel and not any(rel == m or rel.startswith(m + ".") for m in TPU_ONLY_MODULES):
            out.append(rel)
    return out


def _default(v):
    """A parameter default in a comparable form: functions by name, containers by element."""
    if v is inspect.Parameter.empty:
        return "<no default>"
    if callable(v) and hasattr(v, "__name__"):
        return f"<callable {v.__name__}>"
    if isinstance(v, (tuple, list)):
        return type(v).__name__, tuple(_default(x) for x in v)
    return repr(v)


def _params(obj, key: str):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [(p.name, p.kind.name, _default(p.default)) for p in sig.parameters.values()
            if (key, p.name) not in PORT_EXTRAS]


def _public(pkg: str, rel: str) -> dict:
    """{"module:Name" or "module:Class.method": parameter list or "property"} of one module."""
    name = pkg + ("." + rel if rel else "")
    mod = importlib.import_module(name)
    out = {}
    for attr, obj in vars(mod).items():
        if attr.startswith("_") or not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        if getattr(obj, "__module__", None) != name:
            continue
        key = f"{rel}:{attr}"
        out[key] = _params(obj, key)
        if inspect.isclass(obj):
            for m, mo in vars(obj).items():
                if m.startswith("_") and m != "__init__":
                    continue
                if isinstance(mo, (staticmethod, classmethod)):
                    mo = mo.__func__
                if isinstance(mo, property):
                    out[f"{key}.{m}"] = "property"
                elif inspect.isfunction(mo):
                    out[f"{key}.{m}"] = _params(mo, f"{key}.{m}")
    return out


@pytest.mark.parametrize("rel", _modules())
def test_module_has_every_public_name_with_the_same_parameters(rel):
    theirs = _public("xdem_tpu", rel)
    ours = _public("xdem_tpu_torch", rel)
    missing = sorted(k for k in theirs if k not in ours and k not in TPU_ONLY_NAMES)
    assert not missing, f"missing in xdem_tpu_torch: {missing}"
    differ = {k: (theirs[k], ours[k]) for k in theirs if k in ours and theirs[k] != ours[k]}
    assert not differ, f"parameter lists differ (xdem_tpu, xdem_tpu_torch): {differ}"


def test_top_level_names_and_allow_list():
    """Every name xdem_tpu exports is on xdem_tpu_torch, the lazy workflows included, and each
    allow-listed name is really absent from the port (the list holds nothing stale)."""
    import xdem_tpu_torch

    for name in xdem_tpu.__all__ + ["workflows", "dDEM", "DEMCollection"]:
        assert hasattr(xdem_tpu_torch, name), name
    for name in ("cli", "workflows.topo", "workflows.accuracy", "terrain.tiled", "ddem", "demcollection"):
        importlib.import_module(f"xdem_tpu_torch.{name}")
    for rel in TPU_ONLY_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module(f"xdem_tpu_torch.{rel}")
    for key in TPU_ONLY_NAMES:
        rel, name = key.split(":")
        assert not hasattr(importlib.import_module(f"xdem_tpu_torch.{rel}"), name), key
    for key, param in PORT_EXTRAS:
        rel, path = key.split(":")
        obj = importlib.import_module(f"xdem_tpu_torch.{rel}")
        for part in path.split("."):
            obj = getattr(obj, part)
        assert param in inspect.signature(obj).parameters, (key, param)
