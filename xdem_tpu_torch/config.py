"""Package-level behaviour configuration: a validating dict with a context-manager override.

The keys the port reads, with xdem_tpu/config.py's defaults and validation (a CPU test holds
them equal):

>>> from xdem_tpu_torch.config import config, config_context
>>> config["resampling"]
'bilinear'
>>> with config_context(resampling="nearest"):
...     config["resampling"]
'nearest'
>>> config["resampling"]
'bilinear'

Keys
----
resampling : {"nearest", "linear", "bilinear", "cubic"}
    Default resampling of Raster.reproject and Coreg.apply when a call passes none.
warn_area_or_point : bool
    Warn when a raster pair mixes Area and Point pixel interpretations.
shift_area_or_point : bool
    Shift coordinates by half a pixel when interpolating a raster tagged "Point" (whose
    samples sit at pixel corners, not centres).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator

_DEFAULTS: dict[str, Any] = {
    "resampling": "bilinear",
    "warn_area_or_point": True,
    "shift_area_or_point": True,
}

_VALID_RESAMPLING = ("nearest", "linear", "bilinear", "cubic")


class _Config(dict):
    """Validating dict: unknown keys and invalid values fail fast."""

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in _DEFAULTS:
            raise KeyError(f"Unknown config key {key!r}; valid keys: {sorted(_DEFAULTS)}.")
        if key == "resampling" and value not in _VALID_RESAMPLING:
            raise ValueError(f"resampling must be one of {_VALID_RESAMPLING}, got {value!r}.")
        if key in ("warn_area_or_point", "shift_area_or_point"):
            value = bool(value)
        super().__setitem__(key, value)

    # Every bulk-set API goes through the validating __setitem__.
    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def setdefault(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        if key not in self:
            self[key] = default
        return self[key]

    def __ior__(self, other: Any) -> "_Config":
        self.update(other)
        return self

    def reset(self) -> None:
        for k, v in _DEFAULTS.items():
            dict.__setitem__(self, k, v)


config = _Config(_DEFAULTS)


@contextmanager
def config_context(**overrides: Any) -> Iterator[_Config]:
    """Temporarily override package config keys within a `with` block."""
    previous = {k: config[k] for k in overrides}
    try:
        for k, v in overrides.items():
            config[k] = v
        yield config
    finally:
        for k, v in previous.items():
            config[k] = v
