"""Georeferencing for the port: the affine grid transform and the CRS engine.

Copies of xdem_tpu/georef.py's `Affine`, `CRS` (EPSG codes, PROJ strings and WKT through
`projections.py`), `transform_points` and `suggest_utm_crs` (CPU tests hold them equal to the
originals). `transform_points` runs on host arrays with ``xp=numpy`` and on tensors, on their
device, with ``xp=projections.TORCH``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

__all__ = ["Affine", "CRS", "epsg_code", "is_projected", "suggest_utm_crs", "transform_points"]


@dataclass(frozen=True)
class Affine:
    """2-D affine georeferencing transform: x = a*col + b*row + c ; y = d*col + e*row + f."""

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def from_origin(cls, west: float, north: float, xres: float, yres: float) -> "Affine":
        """North-up transform with upper-left corner (west, north) and pixel size (xres, yres>0).

        >>> t = Affine.from_origin(500000.0, 8000000.0, 20.0, 20.0)
        >>> t.xy(0, 0)  # center of the upper-left pixel
        (500010.0, 7999990.0)
        >>> t.rowcol(500010.0, 7999990.0)
        (0.0, 0.0)
        """
        return cls(xres, 0.0, west, 0.0, -yres, north)

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    def __iter__(self):
        yield from (self.a, self.b, self.c, self.d, self.e, self.f)

    def __mul__(self, other: "Affine") -> "Affine":
        """Compose: (self * other)(col, row) == self(other(col, row))."""
        a1, b1, c1, d1, e1, f1 = self
        a2, b2, c2, d2, e2, f2 = other
        return Affine(
            a1 * a2 + b1 * d2,
            a1 * b2 + b1 * e2,
            a1 * c2 + b1 * f2 + c1,
            d1 * a2 + e1 * d2,
            d1 * b2 + e1 * e2,
            d1 * c2 + e1 * f2 + f1,
        )

    def translation(self, xoff: float, yoff: float) -> "Affine":
        """Return this transform shifted by a world-coordinate offset."""
        return Affine(self.a, self.b, self.c + xoff, self.d, self.e, self.f + yoff)

    @property
    def determinant(self) -> float:
        return self.a * self.e - self.b * self.d

    def invert(self) -> "Affine":
        det = self.determinant
        if det == 0:
            raise ValueError("Affine transform is singular.")
        ia = self.e / det
        ib = -self.b / det
        id_ = -self.d / det
        ie = self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def xy(self, rows: Any, cols: Any, offset: str = "center") -> Tuple[Any, Any]:
        """World coordinates of pixel (row, col); offset 'center'|'ul' like rasterio."""
        shift = 0.5 if offset == "center" else 0.0
        cc = cols + shift
        rr = rows + shift
        return self.a * cc + self.b * rr + self.c, self.d * cc + self.e * rr + self.f

    def rowcol(self, xs: Any, ys: Any) -> Tuple[Any, Any]:
        """Fractional (row, col) pixel indices (center-of-pixel convention) of world coords."""
        inv = self.invert()
        col = inv.a * xs + inv.b * ys + inv.c - 0.5
        row = inv.d * xs + inv.e * ys + inv.f - 0.5
        return row, col

    @property
    def xres(self) -> float:
        return math.hypot(self.a, self.d)

    @property
    def yres(self) -> float:
        return math.hypot(self.b, self.e)

    def almost_equals(self, other: "Affine", precision: float = 1e-9) -> bool:
        return all(abs(p - q) <= precision for p, q in zip(self, other))


# --------------------------------------------------------------------------------------
# CRS
# --------------------------------------------------------------------------------------

from xdem_tpu_torch import projections as _proj

# Geographic EPSG codes recognized for *carried-only* CRSs (no parameter table entry).
_GEOGRAPHIC_EPSG = {4326, 4269, 4258, 4267, 4979}


class CRS:
    """A coordinate reference system, built from any of:

      - an EPSG code (int or ``"EPSG:<code>"``) — resolved through a transcribed EPSG
        parameter table + range families (UTM on 8 datums, national LCC/Albers/TM/LAEA/
        stereographic/Swiss grids, polar/world CRSs);
      - a PROJ.4-style string (``"+proj=lcc +lat_1=49 ..."``);
      - WKT1 or WKT2 text (``PROJCS[...]`` / ``PROJCRS[...]`` / ``GEOGCS[...]`` ...);
      - a raw projection-definition dict (advanced; see ``projections.normalize_def``).

    Upstream xdem accepts arbitrary CRSs via pyproj; this class is the standalone equivalent:
    any CRS whose projection method is one of the implemented families
    (``projections.SUPPORTED_PROJECTIONS``) is fully transformable; an unrecognized EPSG code
    is representable (round-trips through I/O) but raises on transformation.

    >>> CRS("+proj=utm +zone=33 +datum=WGS84") == CRS(32633)
    True
    >>> CRS(32633).is_projected
    True
    """

    __slots__ = ("_epsg", "_def", "_name", "_key")

    def __init__(self, value: "int | str | dict | CRS"):
        if isinstance(value, CRS):
            self._epsg, self._def, self._name, self._key = (
                value._epsg, value._def, value._name, value._key)
            return
        self._epsg: int | None = None
        self._def: dict | None = None
        self._name: str = ""
        if isinstance(value, dict):
            self._def = _proj.normalize_def(value)
            self._name = str(value.get("name", ""))
        elif isinstance(value, (int, np.integer)):
            self._init_from_epsg(int(value))
        elif isinstance(value, str):
            s = value.strip()
            m = re.match(r"(?i)^epsg:\s*(\d+)$", s)
            if m:
                self._init_from_epsg(int(m.group(1)))
            elif s.startswith("+") or re.search(r"(?:^|\s)\+proj=", s):
                self._def = _proj.normalize_def(_proj.parse_projstring(s))
            elif _proj.looks_like_wkt(s):
                d, epsg, name = _proj.parse_wkt(s)
                self._name = name
                if d is not None:
                    self._def = _proj.normalize_def(d)
                    self._epsg = epsg
                elif epsg is not None:
                    self._init_from_epsg(epsg)
                else:
                    raise ValueError(f"WKT carries neither parameters nor an EPSG code: {s[:80]!r}")
            else:
                raise ValueError(
                    f"Unsupported CRS string: {value!r} (use 'EPSG:<code>', a '+proj=...' "
                    f"string, or WKT)."
                )
        else:
            raise TypeError(f"Cannot build a CRS from {type(value).__name__}.")
        self._key = _proj.canonical_key(self._def) if self._def is not None else ("epsg", self._epsg)

    def _init_from_epsg(self, code: int) -> None:
        self._epsg = code
        raw = _proj.epsg_def(code)
        if raw is not None:
            self._name = str(raw.get("name", "")) or self._name
            self._def = _proj.normalize_def(raw)

    # ---- constructors ----

    @classmethod
    def from_epsg(cls, code: int) -> "CRS":
        return cls(int(code))

    @classmethod
    def from_user_input(cls, value) -> "CRS":
        return cls(value)

    @classmethod
    def from_wkt(cls, wkt: str) -> "CRS":
        return cls(wkt)

    @classmethod
    def from_proj4(cls, s: str) -> "CRS":
        return cls(s)

    # ---- properties ----

    @property
    def epsg(self) -> int | None:
        return self._epsg

    def to_epsg(self) -> int | None:
        return self._epsg

    @property
    def name(self) -> str:
        return self._name or (f"EPSG:{self._epsg}" if self._epsg else "unknown")

    @property
    def projdef(self) -> dict | None:
        """The normalized projection definition (None for carried-only EPSG codes)."""
        return dict(self._def) if self._def is not None else None

    @property
    def is_transformable(self) -> bool:
        return self._def is not None

    @property
    def is_geographic(self) -> bool:
        if self._def is not None:
            return self._def["proj"] == "longlat"
        return self._epsg in _GEOGRAPHIC_EPSG

    @property
    def is_projected(self) -> bool:
        return not self.is_geographic

    @property
    def utm_zone(self) -> tuple[int, bool] | None:
        """(zone, is_north) when this is a WGS84 UTM CRS, else None."""
        if self._epsg is not None:
            if 32601 <= self._epsg <= 32660:
                return self._epsg - 32600, True
            if 32701 <= self._epsg <= 32760:
                return self._epsg - 32700, False
        return None

    @property
    def units(self) -> str:
        if self.is_geographic:
            return "degree"
        tm = (self._def or {}).get("to_meter", 1.0)
        return "metre" if tm == 1.0 else f"unknown ({tm} m)"

    # ---- identity ----

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (int, str, dict)):
            try:
                other = CRS(other)
            except (ValueError, TypeError, NotImplementedError, KeyError):
                return NotImplemented
        if isinstance(other, CRS):
            if self._def is not None and other._def is not None:
                return self._key == other._key
            if self._epsg is not None and other._epsg is not None:
                return self._epsg == other._epsg
            return self._key == other._key
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("CRS", self._key))

    def __repr__(self) -> str:
        if self._epsg is not None:
            return f"CRS(EPSG:{self._epsg})"
        return f"CRS({self.name})"

    # ---- serialization ----

    def to_wkt(self) -> str:
        if self._def is not None:
            return _proj.def_to_wkt1(self._def, name=self.name, epsg=self._epsg)
        # Carried-only code: identification-only WKT (enough to round-trip our own files)
        kind = "GEOGCS" if self.is_geographic else "PROJCS"
        return f'{kind}["EPSG:{self._epsg}",AUTHORITY["EPSG","{self._epsg}"]]'

    def to_proj4(self) -> str:
        """A PROJ.4-style string for the definition (best effort, debugging aid)."""
        if self._def is None:
            return f"+init=epsg:{self._epsg}"
        p = self._def
        parts = [f"+proj={'longlat' if p['proj'] == 'longlat' else p['proj']}"]
        for k in ("lat_0", "lon_0", "lat_1", "lat_2", "lat_ts", "k_0", "x_0", "y_0"):
            if k in p and p[k] is not None:
                parts.append(f"+{k}={p[k]:g}")
        parts.append(f"+a={p['a']:.9g}")
        if p["f"]:
            parts.append(f"+rf={1.0 / p['f']:.12g}")
        if p.get("towgs84"):
            parts.append("+towgs84=" + ",".join(f"{v:g}" for v in p["towgs84"]))
        if p.get("to_meter", 1.0) != 1.0:
            parts.append(f"+to_meter={p['to_meter']:g}")
        parts.append("+no_defs")
        return " ".join(parts)


# --------------------------------------------------------------------------------------
# Point transformation
# --------------------------------------------------------------------------------------


def transform_points(src: CRS | int | str, dst: CRS | int | str, x: Any, y: Any, xp: Any = np) -> Tuple[Any, Any]:
    """Transform coordinate arrays between CRSs via the WGS84 geographic intermediate.

    `xp` is numpy (host arrays) or `projections.TORCH` (tensors, computed on their device in
    their dtype: pass float64 for metre-level coordinates).
    Datum changes apply 3-/7-parameter Helmert shifts through ECEF (position-vector
    convention), mirroring the reference's pyproj ballpark path without grid files.
    """
    src = CRS(src)
    dst = CRS(dst)
    if src == dst:
        return x, y
    for c in (src, dst):
        if c._def is None:
            raise NotImplementedError(
                f"No built-in transform for {c!r}: the EPSG code is carried but not in the "
                f"parameter table. Construct the CRS from WKT or a '+proj=...' string instead."
            )
    lon, lat = _proj.projdef_to_wgs84(src._def, x, y, xp=xp)
    return _proj.projdef_from_wgs84(dst._def, lon, lat, xp=xp)


def suggest_utm_crs(lon: float, lat: float) -> CRS:
    """The UTM CRS containing (lon, lat) — analog of geoutils' get_metric_crs."""
    zone = int((lon + 180) // 6) + 1
    zone = min(max(zone, 1), 60)
    return CRS((32600 if lat >= 0 else 32700) + zone)


# The EPSG codes that xdem_tpu's CRS resolves to a geographic (longitude/latitude) system;
# every other code is projected, as for the codes it only carries. A CPU test holds this
# set equal to xdem_tpu.georef.CRS(code).is_projected.
GEOGRAPHIC_EPSG = frozenset({
    4148, 4149, 4150, 4151, 4167, 4171, 4230, 4258, 4267, 4269, 4272, 4275, 4277, 4283, 4289,
    4299, 4300, 4314, 4322, 4326, 4612, 4617, 4618, 4619, 4674, 4979, 6318, 6668, 7844,
})


def epsg_code(crs: Any) -> int | None:
    """The EPSG code of any CRS input (an int, ``"EPSG:<code>"``, a PROJ string, WKT or a
    `CRS`); None where it has none. Anything else raises `CRS`'s error."""
    return CRS(crs).to_epsg()


def is_projected(crs: Any) -> bool:
    """Whether a CRS (any input `CRS` takes) has planar coordinates."""
    return CRS(crs).is_projected
