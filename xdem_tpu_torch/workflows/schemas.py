"""Configuration schemas of the workflows, with a self-contained validator.

A copy of xdem_tpu/workflows/schemas.py (the tests hold the two equal). Upstream xdem
validates with cerberus; this module implements the subset the schemas use
(type/required/nullable/default/allowed/min/schema/anyof/keysrules/valuesrules/path_exists).
"""

from __future__ import annotations

import os
from typing import Any

COREG_METHODS = ["NuthKaab", "DhMinimize", "VerticalShift", "DirectionalBias", "TerrainBias", "LZD", None]

MIN_STATS = [
    "min", "max", "mean", "median", "standarddeviation", "nmad",
    "validcount", "totalcount", "percentagevalidpoints",
]

STATS_METHODS = [
    "mean", "median", "max", "min", "sum", "sumofsquares", "90thpercentile", "le90",
    "nmad", "rmse", "std", "standarddeviation", "validcount", "totalcount", "percentagevalidpoints",
]

TERRAIN_ATTRIBUTES_DEFAULT = ["slope", "aspect", "max_curvature"]

TERRAIN_ATTRIBUTES = [
    "slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
    "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
    "terrain_ruggedness_index", "topographic_position_index", "roughness", "rugosity",
    "fractal_roughness", "texture_shading",
]

INPUTS_DEM = {
    "path_to_elev": {"type": "string", "required": True, "path_exists": True},
    "force_source_nodata": {"type": ["integer", "float"], "required": False, "nullable": True},
    "path_to_mask": {"type": "string", "required": False, "path_exists": True, "nullable": True},
    "force_vcrs": {"type": ["integer", "string"], "required": False, "nullable": True, "default": None},
    "downsample": {"type": ["integer", "float"], "required": False, "default": 1, "min": 1},
}

_TYPES = {
    "string": str,
    "integer": int,
    "float": (int, float),
    "boolean": bool,
    "dict": dict,
    "list": list,
}


class ValidationError(ValueError):
    pass


def _check_type(value: Any, types: Any, field: str) -> None:
    types = [types] if isinstance(types, str) else types
    ok = any(isinstance(value, _TYPES[t]) and not (t in ("integer", "float") and isinstance(value, bool))
             for t in types)
    if not ok:
        raise ValidationError(f"'{field}': must be of type {types}, got {type(value).__name__}")


def _validate_field(value: Any, rules: dict[str, Any], field: str) -> Any:
    if value is None:
        if rules.get("nullable", False):
            return None
        raise ValidationError(f"'{field}': null value not allowed")
    if "anyof" in rules:
        errors = []
        for option in rules["anyof"]:
            try:
                return _validate_field(value, option, field)
            except ValidationError as e:
                errors.append(str(e))
        raise ValidationError(f"'{field}': no anyof rule satisfied ({'; '.join(errors)})")
    if "type" in rules:
        _check_type(value, rules["type"], field)
    if "allowed" in rules:
        items = value if isinstance(value, list) else [value]
        for it in items:
            if it not in rules["allowed"]:
                raise ValidationError(f"'{field}': unallowed value {it!r}")
    if "min" in rules and isinstance(value, (int, float)) and value < rules["min"]:
        raise ValidationError(f"'{field}': min value is {rules['min']}")
    if rules.get("path_exists") and isinstance(value, str) and not os.path.exists(value):
        raise ValidationError(f"'{field}': path does not exist: {value}")
    if "schema" in rules:
        if isinstance(value, dict):
            value = _validate_dict(value, rules["schema"], field)
        elif isinstance(value, list):
            value = [_validate_field(v, rules["schema"], f"{field}[{i}]") for i, v in enumerate(value)]
    if "keysrules" in rules and isinstance(value, dict):
        for k in value:
            _validate_field(k, rules["keysrules"], f"{field}.{k}")
    if "valuesrules" in rules and isinstance(value, dict):
        for k, v in value.items():
            if v is not None:
                _validate_field(v, rules["valuesrules"], f"{field}.{k}")
    return value


def _validate_dict(doc: dict[str, Any], schema: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    out = dict(doc)
    for key, rules in schema.items():
        path = f"{prefix}.{key}" if prefix else key
        if key not in out or out[key] is None and "default" in rules:
            if "default" in rules:
                out[key] = rules["default"]
                # Defaults are applied recursively through nested schemas below
            elif rules.get("required", False):
                if key not in out:
                    raise ValidationError(f"'{path}': required field")
        if key in out:
            out[key] = _validate_field(out[key], rules, path)
    unknown = set(out) - set(schema)
    if unknown:
        raise ValidationError(f"Unknown configuration field(s): {sorted(unknown)}")
    return out


def validate_configuration(user_config: dict[str, Any], schema: dict[str, Any]) -> dict[str, Any]:
    """Validate + normalize a workflow configuration, injecting defaults
    (reference schemas.py:188)."""
    try:
        doc = _validate_dict(user_config, schema)
    except ValidationError as err:
        raise ValueError(f"User configuration invalid: {err}") from err

    if "statistics" not in doc or doc.get("statistics") is None:
        doc["statistics"] = MIN_STATS
    if "terrain_attributes" not in doc and "coregistration" not in doc:
        doc["terrain_attributes"] = TERRAIN_ATTRIBUTES_DEFAULT
    return doc


class CustomValidator:
    """Cerberus-style validator facade (reference schemas.py:52-99 subclasses
    cerberus.Validator; this project ships a self-contained schema engine, so the class is
    a thin stateful wrapper over :func:`validate_configuration`).

    Usage matches the cerberus surface the reference relies on:
    ``v = CustomValidator(schema); ok = v.validate(doc); v.errors; v.document``.
    """

    def __init__(self, schema: dict[str, Any]):
        self.schema = schema
        self.errors: dict[str, list[str]] = {}
        self.document: dict[str, Any] | None = None

    def validate(self, document: dict[str, Any]) -> bool:
        try:
            self.document = validate_configuration(document, self.schema)
            self.errors = {}
            return True
        except ValueError as err:
            self.errors = {"config": [str(err)]}
            self.document = None
            return False

    def normalized(self, document: dict[str, Any]) -> dict[str, Any]:
        return validate_configuration(document, self.schema)


def make_coreg_step(required: bool = False, default_method: str | None = None) -> dict[str, Any]:
    step_schema: dict[str, Any] = {
        "type": "dict",
        "required": required,
        "nullable": True,
        "schema": {
            "method": {
                "type": "string",
                "allowed": COREG_METHODS,
                "required": bool(required),
                "nullable": not required,
            },
            "extra_information": {"type": "dict", "required": False, "nullable": True},
        },
    }
    if default_method:
        step_schema["default"] = {"method": default_method}
    return step_schema


OUTPUTS_SCHEMA = {
    "type": "dict",
    "required": False,
    "default": {"path": "outputs", "level": 1},
    "schema": {
        "path": {"type": "string", "required": False, "default": "outputs"},
        "level": {"type": "integer", "default": 1, "required": False, "allowed": [1, 2]},
        "generate_pdf": {"type": "boolean", "default": False, "required": False},
    },
}

ACCURACY_SCHEMA = {
    "inputs": {
        "type": "dict",
        "required": True,
        "schema": {
            "reference_elev": {"type": "dict", "schema": INPUTS_DEM, "required": False, "nullable": True},
            "to_be_aligned_elev": {"type": "dict", "schema": INPUTS_DEM, "required": True},
            "sampling_grid": {
                "type": "string",
                "allowed": ["reference_elev", "to_be_aligned_elev"],
                "default": "reference_elev",
                "nullable": True,
                "required": False,
            },
        },
    },
    "outputs": OUTPUTS_SCHEMA,
    "coregistration": {
        "type": "dict",
        "required": False,
        "default": {"step_one": {"method": "NuthKaab"}},
        "schema": {
            "step_one": make_coreg_step(default_method="NuthKaab"),
            "step_two": make_coreg_step(required=False),
            "step_three": make_coreg_step(required=False),
            "process": {"type": "boolean", "default": True, "required": False},
        },
    },
    "statistics": {"type": "list", "required": False, "allowed": STATS_METHODS, "nullable": True},
}

TOPO_SCHEMA = {
    "inputs": {
        "anyof": [
            {"type": "list", "required": True, "schema": {"type": "dict", "schema": INPUTS_DEM}},
            {"type": "dict", "schema": INPUTS_DEM},
        ],
        "required": True,
    },
    "reproject": {
        "type": "dict",
        "required": False,
        "nullable": True,
        "schema": {
            "crs": {"type": ["boolean", "integer", "string"], "required": False, "nullable": True, "default": None},
        },
    },
    "statistics": {"type": "list", "required": False, "allowed": STATS_METHODS, "nullable": True},
    "terrain_attributes": {
        "required": False,
        "default": TERRAIN_ATTRIBUTES_DEFAULT,
        "nullable": True,
        "anyof": [
            {"type": "list", "schema": {"type": "string", "allowed": TERRAIN_ATTRIBUTES}},
            {
                "type": "dict",
                "keysrules": {"type": "string", "allowed": TERRAIN_ATTRIBUTES},
                "valuesrules": {"type": "dict", "required": False, "nullable": True},
            },
        ],
    },
    "outputs": OUTPUTS_SCHEMA,
}

COMPLETE_CONFIG_ACCURACY = {
    "inputs": {
        "reference_elev": {"path_to_elev": "", "force_source_nodata": None, "force_vcrs": None, "downsample": 1},
        "to_be_aligned_elev": {
            "path_to_elev": "", "force_source_nodata": None, "force_vcrs": None,
            "path_to_mask": None, "downsample": 1,
        },
        "sampling_grid": "reference_elev",
    },
    "outputs": {"level": 1, "path": "outputs", "generate_pdf": False},
    "coregistration": {
        "step_one": {"method": "NuthKaab", "extra_information": {"subsample": 500000}},
        "step_two": {"method": None, "extra_information": None},
        "step_three": {"method": None, "extra_information": None},
        "process": True,
    },
    "statistics": MIN_STATS,
}

COMPLETE_CONFIG_TOPO = {
    "inputs": {
        "path_to_elev": "", "force_source_nodata": None, "force_vcrs": None,
        "path_to_mask": None, "downsample": 1,
    },
    "reproject": {"crs": None},
    "outputs": {"level": 1, "path": "outputs", "generate_pdf": False},
    "statistics": MIN_STATS,
    "terrain_attributes": ["slope", "aspect", "max_curvature"],
}
