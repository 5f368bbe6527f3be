"""Georeferencing for the port: the affine grid transform and the "projected CRS" rule.

`Affine` is a copy of xdem_tpu/georef.py::Affine (a CPU test holds the two equal). The full
CRS engine (xdem_tpu/georef.py::CRS with xdem_tpu/projections.py) is not ported yet: the
coregistration path only needs to know whether a CRS is projected, which this module
answers for EPSG codes given as an int or as ``"EPSG:<code>"``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np

__all__ = ["Affine", "is_projected"]


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


# The EPSG codes that xdem_tpu's CRS resolves to a geographic (longitude/latitude) system;
# every other code is projected, as for the codes it only carries. A CPU test holds this
# set equal to xdem_tpu.georef.CRS(code).is_projected.
GEOGRAPHIC_EPSG = frozenset({
    4148, 4149, 4150, 4151, 4167, 4171, 4230, 4258, 4267, 4269, 4272, 4275, 4277, 4283, 4289,
    4299, 4300, 4314, 4322, 4326, 4612, 4617, 4618, 4619, 4674, 4979, 6318, 6668, 7844,
})


def epsg_code(crs: Any) -> int:
    """The EPSG code of an int or ``"EPSG:<code>"`` CRS; any other form is not ported yet."""
    if isinstance(crs, (int, np.integer)) and not isinstance(crs, bool):
        return int(crs)
    if isinstance(crs, str):
        m = re.match(r"(?i)^epsg:\s*(\d+)$", crs.strip())
        if m:
            return int(m.group(1))
    raise NotImplementedError(
        f"CRS {crs!r} is not supported by xdem_tpu_torch yet: pass an EPSG code as an int or "
        "as 'EPSG:<code>' (PROJ strings, WKT and CRS objects need the CRS engine, which is "
        "not ported)."
    )


def is_projected(crs: Any) -> bool:
    """Whether an EPSG CRS (int or ``"EPSG:<code>"``) has planar coordinates."""
    return epsg_code(crs) not in GEOGRAPHIC_EPSG
