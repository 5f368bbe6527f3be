"""Accuracy workflow: coregister a DEM pair and report the elevation differences before and after.

Port of xdem_tpu/workflows/accuracy.py. The pair, the differences and the masks stay on the
data's device; the statistics, the tables and the plots run on the host.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import numpy as np
import torch

from xdem_tpu_torch.raster import Raster
from xdem_tpu_torch.workflows.schemas import ACCURACY_SCHEMA
from xdem_tpu_torch.workflows.workflows import Workflows, _pyplot, write_table_csv


class Accuracy(Workflows):
    """Coregistration accuracy workflow for a reference and a to-be-aligned DEM."""

    schema = ACCURACY_SCHEMA

    def _build_pipeline(self):
        """The one- to three-step coregistration pipeline of the configuration, or None."""
        from xdem_tpu_torch import coreg as _coreg

        steps = []
        cfg = self.config.get("coregistration", {})
        for key in ("step_one", "step_two", "step_three"):
            step_cfg = cfg.get(key)
            if not step_cfg or step_cfg.get("method") in (None, "None"):
                continue
            method = getattr(_coreg, step_cfg["method"])
            kwargs = step_cfg.get("extra_information") or {}
            steps.append(method(**kwargs))
        if not steps:
            return None
        pipeline = steps[0]
        for s in steps[1:]:
            pipeline = pipeline + s
        return pipeline

    def run(self) -> None:
        inputs = self.config["inputs"]
        tba = self._load_dem(inputs["to_be_aligned_elev"])
        ref = self._load_dem(inputs["reference_elev"]) if inputs.get("reference_elev") else None
        if ref is None:
            raise ValueError("The accuracy workflow requires a reference elevation input.")
        # One grid: the chosen sampling grid.
        sampling = inputs.get("sampling_grid", "reference_elev")
        if sampling == "to_be_aligned_elev":
            ref = ref.reproject(tba)
        else:
            tba_on_grid = tba.reproject(ref)
            tba = tba.copy(new_array=tba_on_grid.data)
            tba.transform, tba.crs = ref.transform, ref.crs

        # The mask is read on the common grid. path_to_mask marks unstable terrain (glacier
        # outlines): the pipeline fits on its complement.
        mask = self._load_mask(inputs["to_be_aligned_elev"], tba)
        inlier_mask = ~mask if mask is not None else None

        t0 = time.time()

        # dh = to-be-aligned - reference
        dh_before = Raster(tba.data - ref.data, ref.transform, ref.crs)
        stats_names = self.config["statistics"]
        stats_before = self.compute_stats(dh_before, stats_names)
        self.save_stats_table(stats_before, "dh_before_stats")

        process = self.config.get("coregistration", {}).get("process", True)
        pipeline = self._build_pipeline() if process else None

        aligned = dh_after = stats_after = None
        if pipeline is not None:
            logging.info("Running coregistration pipeline: %s", pipeline)
            aligned = pipeline.fit_and_apply(ref, tba, inlier_mask=inlier_mask)
            self.coreg = pipeline
            dh_after = Raster(aligned.data - ref.data, ref.transform, ref.crs)
            stats_after = self.compute_stats(dh_after, stats_names)
            self.save_stats_table(stats_after, "dh_after_stats")

        # Symmetric colour limits: median +- 3 NMAD of both maps.
        lim = self._sym_limit(dh_before, dh_after)

        self.save_raster_plot(dh_before, "dh_before", cmap="RdBu", vmin=-lim, vmax=lim,
                              title="Difference to-be-aligned - reference (before coregistration)")
        self.add_report_section(self.stats_to_html(stats_before, "Elevation difference BEFORE coregistration"))
        self.add_report_section('<img src="plots/dh_before.png">')

        if pipeline is not None:
            self.save_raster_plot(dh_after, "dh_after", cmap="RdBu", vmin=-lim, vmax=lim,
                                  title="Difference aligned - reference (after coregistration)")
            self.add_report_section(self.stats_to_html(stats_after, "Elevation difference AFTER coregistration"))
            self.add_report_section('<img src="plots/dh_after.png">')

            # Statistics on stable terrain only: the quality where the pipeline was fitted.
            if inlier_mask is not None:
                self.add_report_section(self.table_to_html(
                    self._stats_frame([
                        ("dh before (stable terrain)", self._masked(dh_before, inlier_mask)),
                        ("dh after (stable terrain)", self._masked(dh_after, inlier_mask)),
                    ], stats_names, "dh_stable_stats"),
                    "Stable-terrain (inlier) statistics"))

            if self.level >= 2:
                aligned.save(str(self.output_dir / "rasters" / "aligned_dem.tif"))
                dh_before.save(str(self.output_dir / "rasters" / "dh_before.tif"))
                dh_after.save(str(self.output_dir / "rasters" / "dh_after.tif"))
                # Aligned minus to-be-aligned: the applied correction.
                dh_corr = Raster(aligned.data - tba.data, ref.transform, ref.crs)
                self.save_raster_plot(dh_corr, "dh_aligned_vs_tba", cmap="RdBu",
                                      title="Difference aligned - to-be-aligned (applied correction)")
                dh_corr.save(str(self.output_dir / "rasters" / "dh_aligned_vs_tba.tif"))
                self.add_report_section('<img src="plots/dh_aligned_vs_tba.png">')

            # The estimated transformation and each step's metadata.
            try:
                from xdem_tpu_torch.coreg.base import translations_rotations_from_matrix

                tx, ty, tz, a, b, g = translations_rotations_from_matrix(pipeline.to_matrix())
                self.add_report_section(self.stats_to_html(
                    {"shift_x": tx, "shift_y": ty, "shift_z": tz, "rot_x": a, "rot_y": b, "rot_z": g},
                    "Estimated transformation",
                ))
            except NotImplementedError:
                pass
            self.add_report_section(self._coreg_meta_html(pipeline))

        # Statistics of each dataset; the input elevations at level 2.
        items = [("dh before coreg", dh_before, 1)]
        if dh_after is not None:
            items.append(("dh after coreg", dh_after, 1))
        items += [("reference elevation", ref, 2), ("to-be-aligned elevation", tba, 2)]
        if aligned is not None:
            items.append(("aligned elevation", aligned, 1))
        rows = [(name, r) for name, r, level in items if level <= self.level or name.startswith("dh")]
        self.add_report_section(self.table_to_html(
            self._stats_frame(rows, stats_names, "stats_summary"), "Statistics summary"))

        self._histogram(dh_before, dh_after)
        self.add_report_section(f"<p>Elapsed: {time.time() - t0:.1f} s</p>")
        self.create_html("xdem-tpu Accuracy report")
        logging.info("Accuracy workflow complete: outputs in %s", self.output_dir)

    @staticmethod
    def _sym_limit(dh_before: Raster, dh_after: Raster | None) -> float:
        def one(r):
            arr = r.get_nanarray()
            valid = arr[np.isfinite(arr)]
            if not valid.size:
                return 1.0
            med = float(np.median(valid))
            nmad = 1.4826 * float(np.median(np.abs(valid - med)))
            return abs(med) + 3 * nmad

        lims = [one(dh_before)] + ([one(dh_after)] if dh_after is not None else [])
        return max(lims) or 1.0

    @staticmethod
    def _masked(r: Raster, mask: torch.Tensor) -> Raster:
        """`r` with NaN outside `mask`, on the data's device."""
        keep = torch.as_tensor(mask, dtype=torch.bool).to(r.data.device)
        return Raster(torch.where(keep, r.data, torch.nan), r.transform, r.crs)

    def _stats_frame(self, rows, stats_names, csv_name: str) -> dict[str, dict[str, Any]]:
        """The statistics of each (name, raster) row, written as ``tables/{csv_name}.csv``
        with the row names in a first ``Data`` column; returned as a dict of rows."""
        table = {name: self.compute_stats(raster, stats_names) for name, raster in rows}
        write_table_csv(self.output_dir / "tables" / f"{csv_name}.csv",
                        [{"Data": name, **stats} for name, stats in table.items()])
        return table

    def _coreg_meta_html(self, pipeline) -> str:
        """A table per coregistration step: the method, its scalar inputs and fitted outputs."""
        steps = getattr(pipeline, "pipeline", None) or [pipeline]
        parts = []
        for i, step in enumerate(steps):
            meta = getattr(step, "meta", {}) or {}
            rec: dict[str, Any] = {"method": type(step).__name__}
            for group in ("random", "fitorbin", "iterative", "specific", "affine"):
                for k, v in (meta.get("inputs", {}).get(group, {}) or {}).items():
                    if isinstance(v, (int, float, str, bool)) and v is not None:
                        rec[k] = v
            for group, vals in (meta.get("outputs", {}) or {}).items():
                for k, v in (vals or {}).items():
                    if isinstance(v, (int, float, np.floating, np.integer)):
                        rec[k] = float(v)
            parts.append(self.stats_to_html(rec, f"Coregistration step {i + 1}: {type(step).__name__}"))
        return "\n".join(parts)

    def _histogram(self, dh_before: Raster, dh_after: Raster | None) -> None:
        plt = _pyplot("the dh histogram")
        if plt is None:
            return

        def _mn(v):
            med = float(np.median(v)) if v.size else float("nan")
            nmad = 1.4826 * float(np.median(np.abs(v - med))) if v.size else float("nan")
            return med, nmad

        fig, ax = plt.subplots(figsize=(7, 4))
        b = dh_before.get_nanarray().ravel()
        b = b[np.isfinite(b)]
        rng_lim = np.nanpercentile(np.abs(b), 99) if b.size else 1.0
        bins = np.linspace(-rng_lim, rng_lim, 100)
        ax.hist(b, bins=bins, alpha=0.5, color="g", label="before", density=True)
        med_b, nmad_b = _mn(b)
        ax.text(0.05, 0.8, f"Before:\nmedian = {med_b:.2f}\nNMAD = {nmad_b:.2f}",
                color="g", transform=ax.transAxes)
        if dh_after is not None:
            a = dh_after.get_nanarray().ravel()
            a = a[np.isfinite(a)]
            ax.hist(a, bins=bins, alpha=0.5, color="b", label="after", density=True)
            med_a, nmad_a = _mn(a)
            ax.text(0.75, 0.8, f"After:\nmedian = {med_a:.2f}\nNMAD = {nmad_a:.2f}",
                    color="b", transform=ax.transAxes)
        ax.set_title("Histogram of elevation differences before and after coregistration")
        ax.set_xlabel("dh (m)")
        ax.legend()
        path = self.output_dir / "plots" / "dh_histogram.png"
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        self.add_report_section('<img src="plots/dh_histogram.png">')
