"""Terrain attributes: surface fit (K1), windowed indexes (K2) and fractal roughness (K3), in memory
or out of core by row bands (`tiled_terrain_attribute`)."""

from xdem_tpu_torch.terrain.terrain import (
    ALL_ATTRS,
    aspect,
    curvature,
    flowline_curvature,
    fractal_roughness,
    get_terrain_attribute,
    hillshade,
    max_curvature,
    min_curvature,
    planform_curvature,
    profile_curvature,
    roughness,
    rugosity,
    slope,
    tangential_curvature,
    terrain_ruggedness_index,
    texture_shading,
    topographic_position_index,
)
from xdem_tpu_torch.terrain.tiled import TilingConfig, tiled_terrain_attribute

__all__ = [
    "ALL_ATTRS",
    "get_terrain_attribute",
    "slope",
    "aspect",
    "hillshade",
    "curvature",
    "profile_curvature",
    "tangential_curvature",
    "planform_curvature",
    "flowline_curvature",
    "max_curvature",
    "min_curvature",
    "topographic_position_index",
    "terrain_ruggedness_index",
    "roughness",
    "rugosity",
    "fractal_roughness",
    "texture_shading",
    "TilingConfig",
    "tiled_terrain_attribute",
]
