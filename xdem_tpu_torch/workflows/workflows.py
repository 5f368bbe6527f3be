"""Workflow base class: configuration, output tree, statistics tables and the report.

Port of xdem_tpu/workflows/workflows.py without pandas: tables are written with the `csv`
module, with the headers and column order of xdem_tpu's pandas output. PyYAML and
matplotlib are imported when first needed, on the host: a dict configuration runs without
PyYAML, and without matplotlib every plot and the PDF report are skipped with a logged
warning.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

import numpy as np
import torch

from xdem_tpu_torch.dem import DEM
from xdem_tpu_torch.raster import Raster, mask_on


def load_yaml_config(path: str) -> dict[str, Any]:
    """Load a YAML configuration, turning 'None'/'null'/'' strings into None."""
    try:
        import yaml
    except ImportError as err:
        raise ImportError(
            f"Reading the YAML configuration '{path}' needs PyYAML, which is not installed: install "
            f"it, or pass the configuration as a dict."
        ) from err

    with open(path) as f:
        cfg = yaml.safe_load(f)

    def fix(obj: Any) -> Any:
        if isinstance(obj, dict):
            return {k: fix(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [fix(v) for v in obj]
        if isinstance(obj, str) and obj.strip().lower() in ("none", "null", ""):
            return None
        return obj

    return fix(cfg)


def _pyplot(what: str) -> Any:
    """matplotlib's pyplot on the Agg backend, or None (with a logged warning) without it."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logging.warning("matplotlib unavailable; skipping %s", what)
        return None
    return plt


def _csv_value(v: Any) -> Any:
    """A statistic as pandas' to_csv writes it: NaN as an empty field, numbers as Python's."""
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    if isinstance(v, float) and math.isnan(v):
        return ""
    return v


def write_table_csv(path: Path, rows: list[dict[str, Any]]) -> None:
    """Write rows of one set of keys as a CSV table: a header line, then one line per row."""
    with path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow([_csv_value(v) for v in row.values()])


class Workflows(ABC):
    """Base class of the configuration-driven workflows."""

    schema: dict[str, Any] = {}

    def __init__(self, user_config: str | dict[str, Any], output: str | None = None,
                 output_dir: str | None = None):
        from xdem_tpu_torch.workflows.schemas import validate_configuration

        # `user_config`/`output` are upstream xdem's parameter names; output_dir is an alias.
        config = user_config
        self.user_config = user_config
        if output_dir is None:
            output_dir = output
        if isinstance(config, str):
            config = load_yaml_config(config)
        self.config = validate_configuration(config, self.schema)
        out_cfg = self.config.get("outputs", {})
        self.output_dir = Path(output_dir or out_cfg.get("path", "outputs"))
        self.level = out_cfg.get("level", 1)
        self.pdf_enabled = out_cfg.get("generate_pdf", False)
        self._make_output_tree()
        self._report_sections: list[str] = []

    def _make_output_tree(self) -> None:
        for sub in ("plots", "rasters", "tables"):
            os.makedirs(self.output_dir / sub, exist_ok=True)

    @property
    def outputs_folder(self) -> Path:
        """The output directory, under upstream xdem's attribute name."""
        return self.output_dir

    @outputs_folder.setter
    def outputs_folder(self, value: str | Path) -> None:
        self.output_dir = Path(value)

    def create_output_dir(self, sub_dir: Path | None = None) -> None:
        """Create the plots/rasters/tables output tree; ``sub_dir`` replaces the configured
        output folder."""
        if sub_dir is not None:
            self.output_dir = Path(sub_dir)
        logging.info("Outputs will be saved at %s", self.output_dir)
        self._make_output_tree()

    def load_config(self) -> dict[str, Any]:
        """Load and validate again the configuration this workflow was built from."""
        from xdem_tpu_torch.workflows.schemas import validate_configuration

        config = self.user_config
        if isinstance(config, str):
            config = load_yaml_config(config)
        return validate_configuration(config, self.schema)

    def generate_plot(self, dem: Raster, title: str, filename: str,
                      dem_right: Raster | None = None, title_dem_right: str | None = None,
                      **kwargs: Any) -> None:
        """Side-by-side raster plot saved to ``plots/{filename}.png`` (the right panel is
        optional). ``cbar_title`` labels the colour bars; other keywords go to imshow."""
        plt = _pyplot(f"plot {filename}")
        if plt is None:
            return
        cmap = plt.get_cmap(kwargs.pop("cmap", "terrain")).copy()
        cmap.set_bad(color="k")
        vmin = kwargs.pop("vmin", None)
        vmax = kwargs.pop("vmax", None)
        cbar_title = kwargs.pop("cbar_title", None)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=[6.4, 2.4])
        for ax, r, t in ((ax1, dem, title), (ax2, dem_right, title_dem_right)):
            if r is None:
                ax.set_axis_off()
                continue
            b = r.bounds
            im = ax.imshow(r.get_nanarray(), cmap=cmap, vmin=vmin, vmax=vmax,
                           extent=(b.left, b.right, b.bottom, b.top), **kwargs)
            cbar = fig.colorbar(im, ax=ax, shrink=0.8)
            if cbar_title is not None:
                cbar.set_label(cbar_title, fontsize=6)
            ax.set_title(t, fontsize=6)
            ax.tick_params(labelsize=6)
        fig.savefig(self.output_dir / "plots" / f"{filename}.png", dpi=300, bbox_inches="tight")
        plt.close(fig)

    def generate_plot_with_profiles(self, dem: Raster, title: str, filename: str,
                                    **kwargs: Any) -> None:
        """Raster plot with its centre row and column profiles, saved to
        ``plots/{filename}.png``. ``cbar_title`` labels the colour bar."""
        plt = _pyplot(f"plot {filename}")
        if plt is None:
            return
        from matplotlib.gridspec import GridSpec

        arr = dem.get_nanarray()
        b = dem.bounds
        cmap = plt.get_cmap(kwargs.pop("cmap", "terrain")).copy()
        cmap.set_bad(color="k")
        cbar_title = kwargs.pop("cbar_title", None)
        fig = plt.figure(figsize=(6.4, 6.4))
        gs = GridSpec(2, 2, width_ratios=[3, 1], height_ratios=[3, 1], figure=fig)
        ax = fig.add_subplot(gs[0, 0])
        im = ax.imshow(arr, cmap=cmap, extent=(b.left, b.right, b.bottom, b.top), **kwargs)
        ax.set_title(title, fontsize=8)
        r_mid, c_mid = arr.shape[0] // 2, arr.shape[1] // 2
        ax_r = fig.add_subplot(gs[0, 1])
        ax_r.plot(arr[:, c_mid], np.linspace(b.top, b.bottom, arr.shape[0]), lw=0.8)
        ax_r.set_title("N-S profile", fontsize=6)
        ax_b = fig.add_subplot(gs[1, 0])
        ax_b.plot(np.linspace(b.left, b.right, arr.shape[1]), arr[r_mid, :], lw=0.8)
        ax_b.set_title("W-E profile", fontsize=6)
        for a in (ax, ax_r, ax_b):
            a.tick_params(labelsize=6)
        cbar = fig.colorbar(im, ax=ax_r, shrink=0.6)
        if cbar_title is not None:
            cbar.set_label(cbar_title, fontsize=6)
        fig.savefig(self.output_dir / "plots" / f"{filename}.png", dpi=300, bbox_inches="tight")
        plt.close(fig)

    def floats_process(self, dict_with_floats: Any) -> Any:
        """Round every float of a nested dict/list/tuple to two decimals."""
        if isinstance(dict_with_floats, dict):
            return {k: self.floats_process(v) for k, v in dict_with_floats.items()}
        if isinstance(dict_with_floats, list):
            return [self.floats_process(v) for v in dict_with_floats]
        if isinstance(dict_with_floats, tuple):
            return tuple(self.floats_process(v) for v in dict_with_floats)
        if isinstance(dict_with_floats, (float, np.floating)):
            return round(float(dict_with_floats), 2)
        return dict_with_floats

    @staticmethod
    def load_dem(config_dem: dict[str, Any] | None):
        """A DEM and its inlier mask from an inputs dict: ``(dem, inlier_mask, mask_path)``.
        ``inlier_mask`` (a bool tensor on the DEM's device) is True on stable terrain, the
        complement of the mask file. The names of ``examples.available`` resolve to their
        generated files."""
        if config_dem is None:
            logging.warning("No DEM provided")
            return None, None, None
        from xdem_tpu_torch import examples

        cfg = dict(config_dem)
        for key in ("path_to_elev", "path_to_mask"):
            path = cfg.get(key)
            if isinstance(path, str) and path in examples.available:
                cfg[key] = examples.get_path(path)
        dem = Workflows._load_dem(None, cfg)  # type: ignore[arg-type]
        inlier_mask = None
        mask_path = cfg.get("path_to_mask")
        if mask_path is not None:
            inlier_mask = ~Workflows._load_mask(None, cfg, dem)  # type: ignore[arg-type]
        return dem, inlier_mask, mask_path

    def remove_none(self, dico: Any) -> Any:
        """Drop None values from nested dicts and lists, keeping the 'statistics' key as it is."""
        if isinstance(dico, dict):
            cleaned = {}
            for k, v in dico.items():
                if k == "statistics":
                    cleaned[k] = v
                    continue
                vv = self.remove_none(v) if v is not None else None
                if vv is not None:
                    cleaned[k] = vv
            return cleaned
        if isinstance(dico, list):
            return [self.remove_none(v) for v in dico if v is not None]
        return dico

    def generate_pdf(self) -> None:
        """Render the report as a PDF when ``outputs.generate_pdf`` is set."""
        if self.config.get("outputs", {}).get("generate_pdf", False):
            self.create_pdf("Report")

    def save_stat_as_csv(self, data: dict[str, float], file_name: str) -> None:
        """Write one statistics dict as ``tables/{file_name}_stats.csv`` (a header line and a
        value line)."""
        cleaned = {k: float(v) if isinstance(v, (np.floating, np.integer)) else v for k, v in data.items()}
        path = self.output_dir / "tables" / f"{file_name}_stats.csv"
        with path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=list(cleaned.keys()))
            writer.writeheader()
            writer.writerow(cleaned)

    def format_values_stats(self, key: str, val: float | int) -> str:
        """One statistic for the report: counts as integers, percentages with '%', very large
        or small magnitudes in scientific notation."""
        if "count" in key.lower():
            return str(int(val))
        if "percentage" in key.lower():
            return f"{val:.2f}%"
        if abs(val) > 10e4 or abs(val) < 10e-4:
            return np.format_float_scientific(val, precision=3)
        return f"{val:.3f}"

    # ------------------------------------------------------------------ helpers

    def _load_dem(self, dem_cfg: dict[str, Any]) -> DEM:
        """A DEM from an inputs dict: path, forced nodata, vertical CRS, decimation."""
        nd = dem_cfg.get("force_source_nodata")
        ds = int(dem_cfg.get("downsample", 1) or 1)
        dem = DEM(dem_cfg["path_to_elev"], nodata=float(nd) if nd is not None else None,
                  downsample=ds if ds > 1 else 1)
        if dem_cfg.get("force_vcrs") is not None:
            dem.set_vcrs(dem_cfg["force_vcrs"])
        return dem

    def _load_mask(self, dem_cfg: dict[str, Any], dem: DEM) -> torch.Tensor | None:
        """The mask file of an inputs dict (GeoJSON outlines or a raster > 0, regridded onto
        the DEM when its grid differs) as a bool tensor on the DEM's grid and device."""
        path = dem_cfg.get("path_to_mask")
        if path is None:
            return None
        if str(path).endswith((".json", ".geojson")):
            from xdem_tpu_torch.vector import Vector

            mask = Vector.from_geojson(str(path))
        else:
            mask = Raster.open(str(path))
        return mask_on(mask, dem, dem.shape, dem.data.device)

    def compute_stats(self, raster: Raster, names: list[str]) -> dict[str, float]:
        return raster.get_stats(names)

    def save_stats_table(self, stats: dict[str, Any], name: str) -> Path:
        """Write one statistics dict as ``tables/{name}.csv``."""
        path = self.output_dir / "tables" / f"{name}.csv"
        write_table_csv(path, [stats])
        return path

    def save_raster_plot(self, raster: Raster, name: str, cmap: str = "terrain",
                         title: str | None = None, vmin: float | None = None,
                         vmax: float | None = None) -> Path | None:
        plt = _pyplot(f"plot {name}")
        if plt is None:
            return None
        fig, ax = plt.subplots(figsize=(7, 5))
        arr = raster.get_nanarray()
        b = raster.bounds
        if vmin is None or vmax is None:
            auto = np.nanpercentile(arr, [2, 98]) if np.isfinite(arr).any() else (0, 1)
            vmin = auto[0] if vmin is None else vmin
            vmax = auto[1] if vmax is None else vmax
        im = ax.imshow(arr, cmap=cmap, vmin=vmin, vmax=vmax, extent=(b.left, b.right, b.bottom, b.top))
        fig.colorbar(im, ax=ax, shrink=0.8)
        ax.set_title(title or name)
        path = self.output_dir / "plots" / f"{name}.png"
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path

    @staticmethod
    def table_to_html(df: dict[str, dict[str, Any]], caption: str) -> str:
        """An HTML report section of a table given as a dict of rows ``{"Data" name: {column:
        value}}``: one header line, then one line per row."""
        columns = list(next(iter(df.values()), {}))
        head = "".join(f"<th>{c}</th>" for c in ["Data", *columns])
        body = "".join(
            f"<tr><th>{name}</th>" + "".join(
                f"<td>{v:.6g}</td>" if isinstance(v, float) else f"<td>{v}</td>" for v in row.values()) + "</tr>"
            for name, row in df.items())
        return f"<h3>{caption}</h3><table><tr>{head}</tr>{body}</table>"

    def add_report_section(self, html: str) -> None:
        self._report_sections.append(html)

    def create_html(self, title: str) -> Path:
        body = "\n".join(self._report_sections)
        html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}} table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 8px}} img{{max-width:45em}}</style></head>
<body><h1>{title}</h1>
{body}
</body></html>"""
        path = self.output_dir / "report.html"
        path.write_text(html)
        if self.pdf_enabled:
            self.create_pdf(title)
        return path

    def create_pdf(self, title: str) -> Path | None:
        """A multi-page PDF of the report's sections (tables, text and figures), laid out with
        matplotlib: no HTML engine is needed."""
        import re

        plt = _pyplot("the PDF report")
        if plt is None:
            return None
        import matplotlib.image as mpimg
        from matplotlib.backends.backend_pdf import PdfPages

        def section_lines(s: str) -> list[str]:
            """One HTML section as display lines (captions, table rows, text)."""
            out: list[str] = []
            for cap in re.findall(r"<h3>(.*?)</h3>", s, re.S):
                out += ["", cap.strip(), "-" * min(len(cap.strip()), 70)]
            for row in re.findall(r"<tr>(.*?)</tr>", s, re.S):
                cells = re.findall(r"<t[hd][^>]*>(.*?)</t[hd]>", row, re.S)
                cells = [re.sub(r"<[^>]+>", "", c).strip() for c in cells]
                if any(cells):
                    out.append("  ".join(f"{c:<18}" if i == 0 else c for i, c in enumerate(cells)))
            for par in re.findall(r"<p>(.*?)</p>", s, re.S):
                out += ["", re.sub(r"<[^>]+>", "", par).strip()]
            return out

        path = self.output_dir / "report.pdf"
        page_size = (8.27, 11.69)  # A4 portrait
        max_lines = 58
        with PdfPages(path) as pdf:
            pending: list[str] = [title, "=" * min(len(title), 70)]

            def flush_text() -> None:
                nonlocal pending
                while pending:
                    chunk, pending = pending[:max_lines], pending[max_lines:]
                    fig = plt.figure(figsize=page_size)
                    fig.text(0.07, 0.95, "\n".join(chunk), va="top", family="monospace", fontsize=9)
                    pdf.savefig(fig)
                    plt.close(fig)

            for section in self._report_sections:
                m = re.search(r'<img src="([^"]+)"', section)
                if m:
                    img_path = self.output_dir / m.group(1)
                    if not img_path.exists():
                        continue
                    flush_text()
                    fig, ax = plt.subplots(figsize=page_size)
                    ax.imshow(mpimg.imread(str(img_path)))
                    ax.axis("off")
                    ax.set_title(img_path.stem)
                    pdf.savefig(fig)
                    plt.close(fig)
                else:
                    pending += section_lines(section)
            flush_text()
        return path

    @staticmethod
    def stats_to_html(stats: dict[str, Any], caption: str) -> str:
        rows = "".join(f"<tr><th>{k}</th><td>{v:.6g}</td></tr>" if isinstance(v, float)
                       else f"<tr><th>{k}</th><td>{v}</td></tr>" for k, v in stats.items())
        return f"<h3>{caption}</h3><table>{rows}</table>"

    @abstractmethod
    def run(self) -> None:
        """Execute the workflow."""
