"""Topo workflow: terrain attributes, their statistics and a report for one or more DEMs.

Port of xdem_tpu/workflows/topo.py. The attributes come from `DEM.get_terrain_attribute`, so
on the card each runs its kernel (K1, K2 or K3); the statistics run on the host.
"""

from __future__ import annotations

import logging
import math
import warnings

import numpy as np
import torch

from xdem_tpu_torch.dem import DEM
from xdem_tpu_torch.workflows.schemas import TOPO_SCHEMA
from xdem_tpu_torch.workflows.workflows import Workflows, _pyplot


class Topo(Workflows):
    """Compute the configured terrain attributes, write rasters, plots, statistics tables and
    a report."""

    schema = TOPO_SCHEMA

    # Display defaults of each attribute on the combined map: greys for shading, fixed
    # ranges for the bounded attributes.
    _ATTR_STYLE: dict[str, tuple[str, float | None, float | None]] = {
        "hillshade": ("Greys_r", 0, 255),
        "texture_shading": ("Greys_r", -20, 20),
        "slope": ("Reds", 0, 90),
        "aspect": ("twilight", 0, 360),
        "profile_curvature": ("RdGy_r", -2, 2),
        "tangential_curvature": ("RdGy_r", -2, 2),
        "planform_curvature": ("RdGy_r", -2, 2),
        "flowline_curvature": ("RdGy_r", -2, 2),
        "max_curvature": ("RdGy_r", -2, 2),
        "min_curvature": ("RdGy_r", -2, 2),
        "terrain_ruggedness_index": ("Purples", None, None),
        "rugosity": ("YlOrRd", None, None),
        "topographic_position_index": ("Spectral", None, None),
        "roughness": ("Oranges", None, None),
        "fractal_roughness": ("Reds", None, None),
    }

    def _attr_items(self) -> list[tuple[str, dict]]:
        attrs_cfg = self.config.get("terrain_attributes") or []
        if isinstance(attrs_cfg, dict):
            return list(attrs_cfg.items())
        return [(a, {}) for a in attrs_cfg]

    def _load_projected_dem(self, dem_cfg: dict) -> DEM:
        """The configured DEM, reprojected as ``reproject.crs`` says (``true``: the DEM's metric
        CRS). A DEM left in a geographic CRS warns: its surface-fit attributes would be in
        degrees."""
        dem = self._load_dem(dem_cfg)
        reproj = self.config.get("reproject")
        if reproj and reproj.get("crs"):
            crs = reproj["crs"]
            dem = dem.reproject(crs=dem.get_metric_crs() if crs is True else crs)
        elif not dem.crs.is_projected:
            warnings.warn(
                f"DEM '{dem_cfg['path_to_elev']}' is in a geographic CRS: set reproject: crs: true to compute the "
                f"attributes in its metric CRS.", UserWarning, stacklevel=3,
            )
        return dem

    def generate_terrain_attributes(self, export_tif: bool = False) -> list:
        """Compute the configured attributes on the (first) configured DEM, after the reproject
        step of `run`, write the combined PNG map, and optionally export GeoTIFFs. Returns the
        attribute rasters in configuration order."""
        inputs = self.config["inputs"]
        dem = self._load_projected_dem(inputs[0] if isinstance(inputs, list) else inputs)
        attr_items = self._attr_items()
        self.list_attributes = [a for a, _ in attr_items]
        rasters = [dem.get_terrain_attribute(name, **(extra or {})) for name, extra in attr_items]
        if export_tif:
            for name, r in zip(self.list_attributes, rasters):
                r.save(str(self.output_dir / "rasters" / f"{name}.tif"))
        self.generate_terrain_attributes_png(rasters)
        return rasters

    def generate_terrain_attributes_png(self, attributes: list) -> None:
        """One figure with every attribute's panel, saved as ``plots/terrain_attributes_map.png``."""
        plt = _pyplot("terrain attributes map")
        if plt is None:
            return
        n = len(attributes)
        if n == 0:
            return
        names = getattr(self, "list_attributes", None) or [f"attribute {i+1}" for i in range(n)]
        ncols = 3 if n > 6 else min(2, n)
        nrows = math.ceil(n / ncols)
        fig, axes = plt.subplots(nrows, ncols, squeeze=False)
        flat = axes.flatten()
        for i, (name, r) in enumerate(zip(names, attributes)):
            ax = flat[i]
            cmap, vmin, vmax = self._ATTR_STYLE.get(name, ("viridis", None, None))
            im = ax.imshow(np.asarray(r.get_nanarray()), cmap=cmap, vmin=vmin, vmax=vmax)
            fig.colorbar(im, ax=ax, shrink=0.7)
            ax.set_title(name, fontsize=6)
            ax.set_xticks([])
            ax.set_yticks([])
        for ax in flat[n:]:
            fig.delaxes(ax)
        fig.tight_layout()
        fig.savefig(self.output_dir / "plots" / "terrain_attributes_map.png", dpi=300)
        plt.close(fig)

    def run(self) -> None:
        inputs = self.config["inputs"]
        dem_cfgs = inputs if isinstance(inputs, list) else [inputs]
        attr_items = self._attr_items()
        stats_names = self.config["statistics"]

        for i, dem_cfg in enumerate(dem_cfgs):
            suffix = f"_dem{i+1}" if len(dem_cfgs) > 1 else ""
            logging.info("Topo workflow: loading DEM %d", i + 1)
            dem = self._load_projected_dem(dem_cfg)

            # path_to_mask marks unstable terrain: the statistics and the attributes are
            # computed on its complement.
            mask = self._load_mask(dem_cfg, dem)
            if mask is not None:
                dem = dem.copy(new_array=torch.where(mask, torch.nan, dem.data))

            self.save_raster_plot(dem, f"dem{suffix}", title="Elevation")
            dem_stats = self.compute_stats(dem, stats_names)
            self.save_stats_table(dem_stats, f"dem_stats{suffix}")
            self.add_report_section(self.stats_to_html(dem_stats, f"Elevation statistics{suffix}"))
            self.add_report_section(f'<img src="plots/dem{suffix}.png">')

            for attr_name, extra in attr_items:
                logging.info("Computing attribute: %s", attr_name)
                attr = dem.get_terrain_attribute(attr_name, **(extra or {}))
                if self.level >= 2:
                    attr.save(str(self.output_dir / "rasters" / f"{attr_name}{suffix}.tif"))
                cmap = "Greys_r" if attr_name == "hillshade" else "viridis"
                self.save_raster_plot(attr, f"{attr_name}{suffix}", cmap=cmap, title=attr_name)
                stats = self.compute_stats(attr, stats_names)
                self.save_stats_table(stats, f"{attr_name}_stats{suffix}")
                self.add_report_section(self.stats_to_html(stats, f"{attr_name}{suffix}"))
                self.add_report_section(f'<img src="plots/{attr_name}{suffix}.png">')

        self.create_html("xdem-tpu Topo report")
        logging.info("Topo workflow complete: outputs in %s", self.output_dir)
