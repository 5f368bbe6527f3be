"""DEMCollection: a timestamped series of DEMs with dh, dv and cumulative series.

Port of xdem_tpu/demcollection.py without pandas. Timestamps (a ``datetime``, a ``date``, an
ISO string or an ``np.datetime64``) are ordered by their integer nanoseconds. Where xdem_tpu
returns a frame or a series, this module returns a dict of 1-D numpy arrays: an interval
index becomes ``start_time``/``end_time`` columns (``datetime64[ns]``), a time index a
``time`` column. The outlines' masks and the means run on the data's device; only the
scalars reach the host.
"""

from __future__ import annotations

from datetime import date, datetime, timezone
from typing import Any, Literal, Sequence

import numpy as np
import torch

from xdem_tpu_torch.ddem import dDEM
from xdem_tpu_torch.dem import DEM
from xdem_tpu_torch.raster import Raster, mask_on
from xdem_tpu_torch.vector import Vector


def _timestamp_ns(t: Any) -> int:
    """Integer nanoseconds since 1970-01-01 UTC of a timestamp, as ``pd.Timestamp(t).value``
    gives them: a naive ``datetime``, a ``date`` (at midnight) and an ISO string count as UTC,
    an aware ``datetime`` is converted to UTC."""
    if isinstance(t, np.datetime64):
        return int(t.astype("datetime64[ns]").astype(np.int64))
    if isinstance(getattr(t, "value", None), (int, np.integer)):  # a pandas Timestamp
        return int(t.value)
    if isinstance(t, str):
        try:
            t = datetime.fromisoformat(t)
        except ValueError:
            return int(np.datetime64(t, "ns").astype(np.int64))
    if isinstance(t, datetime):
        if t.tzinfo is not None:
            t = t.astimezone(timezone.utc).replace(tzinfo=None)
        return int(np.datetime64(t, "us").astype("datetime64[ns]").astype(np.int64))
    if isinstance(t, date):
        return int(np.datetime64(t, "D").astype("datetime64[ns]").astype(np.int64))
    raise TypeError(f"Cannot read {t!r} ({type(t).__name__}) as a timestamp.")


def _datetimes(values: Sequence[Any]) -> np.ndarray:
    return np.array([_timestamp_ns(t) for t in values], dtype=np.int64).astype("datetime64[ns]")


class DEMCollection:
    """A temporal collection of DEMs, with optional outlines per date."""

    def __init__(
        self,
        dems: Sequence[DEM],
        timestamps: Sequence[Any] | None = None,
        outlines: Vector | dict[Any, Vector] | None = None,
        reference_dem: DEM | int = 0,
    ):
        if timestamps is None:
            raise ValueError("Timestamps must be provided.")
        if len(timestamps) != len(dems):
            raise ValueError("The 'timestamps' len differs from the 'dems' len.")
        order = np.argsort([_timestamp_ns(t) for t in timestamps], kind="stable")
        self.dems = [dems[i] for i in order]
        self.timestamps = [timestamps[i] for i in order]
        if isinstance(reference_dem, int):
            reference_dem = dems[reference_dem]
        self.reference_dem = reference_dem
        if isinstance(outlines, Vector):
            outlines = {self.timestamps[0]: outlines}
        self.outlines: dict[Any, Vector] = outlines or {}
        self.ddems: list[dDEM] = []
        self.ddems_are_intervalwise = False

    @property
    def reference_index(self) -> int:
        # By identity: raster == raster is elementwise, so list.index would not do.
        return next(i for i, d in enumerate(self.dems) if d is self.reference_dem)

    @property
    def reference_timestamp(self) -> Any:
        """Timestamp of the reference DEM."""
        return self.timestamps[self.reference_index]

    def subtract_dems(self, resampling_method: str = "cubic_spline") -> list[dDEM]:
        """dDEMs between the reference DEM and every DEM, on the reference's grid.

        The reference DEM itself gives an all-zero dDEM, so the list stays index-aligned with
        `dems`; the series skip it.
        """
        ddems = []
        ref = self.reference_dem
        ref_time = self.timestamps[self.reference_index]
        for dem, ts in zip(self.dems, self.timestamps):
            if dem is ref:
                zero = Raster(torch.zeros(ref.shape, dtype=torch.float32, device=ref.data.device), ref.transform,
                              ref.crs)
                ddems.append(dDEM(zero, start_time=ref_time, end_time=ref_time, error=0))
                continue
            reproj = dem if _same_grid(dem, ref) else dem.reproject(ref, resampling=resampling_method)
            diff = _subtract_on_grid(ref, reproj)
            start, end = (ts, ref_time) if _timestamp_ns(ts) < _timestamp_ns(ref_time) else (ref_time, ts)
            ddems.append(dDEM(diff, start_time=start, end_time=end))
        self.ddems = ddems
        self.ddems_are_intervalwise = False
        return ddems

    def subtract_dems_intervalwise(self, resampling_method: str = "cubic_spline") -> list[dDEM]:
        """dDEMs of consecutive intervals (later minus earlier), each on the later DEM's grid."""
        ddems = []
        for i in range(len(self.dems) - 1):
            early, late = self.dems[i], self.dems[i + 1]
            reproj = early if _same_grid(early, late) else early.reproject(late, resampling=resampling_method)
            diff = _subtract_on_grid(late, reproj)
            ddems.append(dDEM(diff, start_time=self.timestamps[i], end_time=self.timestamps[i + 1]))
        self.ddems = ddems
        self.ddems_are_intervalwise = True
        return ddems

    def interpolate_ddems(self, method: str = "idw") -> list[np.ndarray]:
        """Gap-fill every dDEM; the outlines are the hypsometric methods' mask."""
        return [d.interpolate(method=method, reference_elevation=self.reference_dem,
                              mask=self.get_ddem_mask(d) if self.outlines else None)
                for d in self.ddems]

    def get_ddem_mask(self, ddem: dDEM, outlines_filter: str | None = None) -> torch.Tensor:
        """Boolean mask of the outlines on a dDEM's grid, on its device: the union of the start
        and end outlines when both exist, else the start outlines, else the one outline set,
        else all True. `outlines_filter` is a `Vector.query` expression over the outlines'
        properties (e.g. ``"name == 'some glacier'"``)."""
        if not any(ddem is d for d in self.ddems):
            raise ValueError("Given dDEM must be a part of the DEMCollection object.")
        outlines = self.outlines
        if outlines_filter is not None:
            outlines = {key: out.query(outlines_filter) for key, out in outlines.items()}

        if ddem.start_time in outlines and ddem.end_time in outlines:
            mask = outlines[ddem.start_time].create_mask(ddem) | outlines[ddem.end_time].create_mask(ddem)
        elif ddem.start_time in outlines:
            mask = outlines[ddem.start_time].create_mask(ddem)
        elif len(outlines) == 1:
            mask = next(iter(outlines.values())).create_mask(ddem)
        else:
            mask = torch.ones(ddem.shape, dtype=torch.bool, device=ddem.data.device)
        return mask.reshape(ddem.shape)

    def get_dh_series(self, outlines_filter: str | None = None, mask: Any = None,
                      nans_ok: bool = False) -> dict[str, np.ndarray]:
        """Mean dh and area within the outlines (or `mask`) per interval:
        ``{"start_time", "end_time", "dh", "area"}``, one row per dDEM but the reference's
        zero dDEM. The mean reads `filled_data` once interpolate() ran."""
        if len(self.ddems) == 0:
            raise ValueError("dDEMs have not yet been calculated")
        rows: dict[str, list] = {"start_time": [], "end_time": [], "dh": [], "area": []}
        for d in self.ddems:
            if (d.start_time is not None and d.end_time is not None
                    and _timestamp_ns(d.start_time) == _timestamp_ns(d.end_time)):
                continue  # the reference DEM's zero dDEM
            dev = d.data.device
            m = mask_on(mask, d, d.shape, dev) if mask is not None else self.get_ddem_mask(d, outlines_filter)
            filled = d._filled_data
            data = d.data if filled is None else torch.from_numpy(np.ascontiguousarray(filled)).to(dev)
            if not nans_ok and filled is None and bool((m & ~torch.isfinite(data)).any()):
                raise ValueError("Unfilled NaNs in dDEM; interpolate first or pass nans_ok=True.")
            keep = m & ~torch.isnan(data)
            n_keep = int(keep.sum())
            mean_dh = float(torch.where(keep, data.double(), 0.0).sum()) / n_keep if n_keep else np.nan
            rows["start_time"].append(d.start_time)
            rows["end_time"].append(d.end_time)
            rows["dh"].append(mean_dh)
            rows["area"].append(float(int(m.sum()) * d.res[0] * d.res[1]))
        return {"start_time": _datetimes(rows["start_time"]), "end_time": _datetimes(rows["end_time"]),
                "dh": np.array(rows["dh"], dtype=np.float64), "area": np.array(rows["area"], dtype=np.float64)}

    def get_dv_series(self, outlines_filter: str | None = None, mask: Any = None,
                      nans_ok: bool = False) -> dict[str, np.ndarray]:
        """Volume change per interval, dh times area: ``{"start_time", "end_time", "dv"}``."""
        dhs = self.get_dh_series(outlines_filter=outlines_filter, mask=mask, nans_ok=nans_ok)
        return {"start_time": dhs["start_time"], "end_time": dhs["end_time"], "dv": dhs["area"] * dhs["dh"]}

    def get_cumulative_series(
        self,
        kind: Literal["dh", "dv"] = "dh",
        outlines_filter: str | None = None,
        mask: Any = None,
        nans_ok: bool = False,
    ) -> dict[str, np.ndarray]:
        """Cumulative dh or dv since the first timestamp: ``{"time", kind}`` in time order.

        A reference-wise dDEM is (reference - DEM) over [year, reference year]: the value at
        each other year is its negation, anchored at zero at the reference, then the series is
        shifted to start at zero. Interval-wise dDEMs (later - earlier) are summed in order.
        """
        if kind not in ("dh", "dv"):
            raise ValueError(f"Invalid kind: {kind}. Choices: ['dh', 'dv'].")
        series = self.get_dh_series(outlines_filter=outlines_filter, mask=mask, nans_ok=nans_ok)
        values = series["dh"] if kind == "dh" else series["area"] * series["dh"]
        left, right = series["start_time"], series["end_time"]

        if self.ddems_are_intervalwise:
            return {"time": np.r_[left[:1], right], kind: np.r_[0.0, np.cumsum(values)]}

        ref_time = np.datetime64(_timestamp_ns(self.reference_timestamp), "ns")
        cumulative = {ref_time: 0.0}
        for lo, hi, value in zip(left, right, values):
            non_ref = lo if lo != ref_time else hi
            cumulative[non_ref] = -value
        times = np.array(sorted(cumulative), dtype="datetime64[ns]")
        vals = np.array([cumulative[t] for t in times], dtype=np.float64)
        return {"time": times, kind: vals - vals[0]}


def _same_grid(a: Raster, b: Raster) -> bool:
    """True when two rasters share shape, transform and CRS (no resampling needed)."""
    return a.shape == b.shape and a.transform.almost_equals(b.transform) and a.crs == b.crs


def _subtract_on_grid(a: Raster, b: Raster) -> Raster:
    """Difference of two rasters on one grid, as a plain Raster on a's device."""
    if not _same_grid(a, b):
        raise ValueError("Rasters share a shape but not a grid (transform/CRS differ); reproject first.")
    return Raster(a.data - b.data.to(a.data.device), a.transform, a.crs)
