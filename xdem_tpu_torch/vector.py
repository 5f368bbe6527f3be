"""Host-side vector (polygon) container with rasterization — substitute for geoutils.Vector.

Port of xdem_tpu/vector.py: polygons with holes, GeoJSON round-tripping, and mask
rasterization by an even-odd scanline fill (north-up grids) or a vectorized crossing-number
point-in-polygon test, both on the host. `create_mask` returns a boolean tensor on the
reference raster's device (the default device for a bare transform and shape). Used for
inlier and stable-terrain masks, like upstream xdem's geopandas vectors in coreg and
spatialstats. `query` filters on the feature properties without pandas.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from xdem_tpu_torch._device import default_device
from xdem_tpu_torch.georef import CRS, Affine, transform_points


class Vector:
    """A collection of polygons (each: list of rings; first exterior, rest holes).

    >>> import numpy as np
    >>> from xdem_tpu_torch.georef import Affine
    >>> ring = np.array([[0.0, 0.0], [40.0, 0.0], [40.0, 30.0], [0.0, 30.0]])
    >>> v = Vector([[ring]], crs=32633)
    >>> v.create_mask(transform=Affine(10.0, 0, -10.0, 0, -10.0, 30.0),
    ...               shape=(3, 5)).int().tolist()
    [[0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 1, 1]]
    """

    def __init__(self, polygons: "str | Sequence[Sequence[np.ndarray]]", crs: CRS | int | str = 4326,
                 properties: Sequence[dict] | None = None):
        # A path loads the file, like upstream xdem's Vector(filename) (a geoutils idiom)
        if isinstance(polygons, (str, os.PathLike)):
            loaded = type(self).from_geojson(str(polygons))
            self.polygons = loaded.polygons
            self.crs = loaded.crs
            self.properties = loaded.properties
            return
        # polygons: list of list-of-rings; each ring an (N, 2) array of (x, y)
        self.polygons: List[List[np.ndarray]] = [
            [np.asarray(ring, dtype=np.float64).reshape(-1, 2) for ring in poly] for poly in polygons
        ]
        self.crs = CRS(crs)
        if properties is None:
            properties = [{} for _ in self.polygons]
        if len(properties) != len(self.polygons):
            raise ValueError("'properties' must have one dict per polygon.")
        self.properties: List[dict] = [dict(p or {}) for p in properties]

    def __len__(self) -> int:
        return len(self.polygons)

    @classmethod
    def from_geojson(cls, obj: str | dict) -> "Vector":
        if isinstance(obj, str):
            with open(obj) as f:
                obj = json.load(f)
        feats = obj["features"] if obj.get("type") == "FeatureCollection" else [obj]

        def _open_ring(r: np.ndarray) -> np.ndarray:
            # Internal representation keeps rings unclosed; GeoJSON rings are closed
            if len(r) > 3 and bool(np.all(r[0] == r[-1])):
                return r[:-1]
            return r

        polys: list[list[np.ndarray]] = []
        props: list[dict] = []
        for feat in feats:
            geom = feat.get("geometry", feat)
            feat_props = feat.get("properties") or {}
            gtype = geom["type"]
            if gtype == "Polygon":
                polys.append([_open_ring(np.asarray(r)) for r in geom["coordinates"]])
                props.append(feat_props)
            elif gtype == "MultiPolygon":
                # MultiPolygons explode into one entry per part; each carries the
                # feature's properties so attribute queries keep matching every part
                for p in geom["coordinates"]:
                    polys.append([_open_ring(np.asarray(r)) for r in p])
                    props.append(feat_props)
        # The GDAL convention carries a named CRS member (RFC 7946 dropped it, but without
        # it a UTM vector would silently rebrand as lon/lat on reload)
        crs: Any = 4326
        crs_name = (obj.get("crs") or {}).get("properties", {}).get("name", "")
        m = re.search(r"EPSG:?:?(\d+)", str(crs_name))
        if m:
            crs = int(m.group(1))
        return cls(polys, crs=crs, properties=props)

    def to_geojson(self) -> dict:
        def _close(r: np.ndarray) -> list:
            # RFC 7946: linear rings must be closed (first == last position)
            pts = r.tolist()
            if pts and pts[0] != pts[-1]:
                pts.append(pts[0])
            return pts

        out = {
            "type": "FeatureCollection",
            "features": [
                {
                    "type": "Feature",
                    "properties": prop,
                    "geometry": {"type": "Polygon", "coordinates": [_close(r) for r in poly]},
                }
                for poly, prop in zip(self.polygons, self.properties)
            ],
        }
        if self.crs is not None and self.crs.epsg:
            out["crs"] = {"type": "name",
                          "properties": {"name": f"urn:ogc:def:crs:EPSG::{self.crs.epsg}"}}
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_geojson(), f)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        all_pts = np.vstack([ring for poly in self.polygons for ring in poly])
        return (all_pts[:, 0].min(), all_pts[:, 1].min(), all_pts[:, 0].max(), all_pts[:, 1].max())

    def to_crs(self, crs: CRS | int | str) -> "Vector":
        crs = CRS(crs)
        out_polys = []
        for poly in self.polygons:
            rings = []
            for ring in poly:
                x, y = transform_points(self.crs, crs, ring[:, 0], ring[:, 1])
                rings.append(np.column_stack([x, y]))
            out_polys.append(rings)
        return Vector(out_polys, crs=crs, properties=self.properties)

    def crop(self, bbox: Any, clip: bool = False) -> "Vector":
        """Features intersecting a bounding box (geoutils Vector.crop; upstream xdem crops
        outlines to a cropped DEM's bounds).

        ``bbox`` is a Raster/DEM (its bounds are used, reprojected from its CRS if needed),
        a Vector, or a (left, bottom, right, top) tuple in THIS vector's CRS. Features are
        kept when their EXTERIOR ring truly intersects the rectangle (not just its bbox;
        the rare rectangle-entirely-inside-a-hole case is still counted as intersecting).
        With ``clip=True``, polygon rings are additionally clipped to the rectangle
        (Sutherland–Hodgman; exact for the convex rectangle).
        """
        if hasattr(bbox, "transform") and hasattr(bbox, "crs"):  # Raster-like
            b = bbox.bounds
            # Densify the boundary before reprojecting: under a curved reprojection the
            # true extent can bulge past the 4 corners' hull
            t = np.linspace(0.0, 1.0, 21)
            ex = np.concatenate([b.left + (b.right - b.left) * t,      # bottom edge
                                 np.full_like(t, b.right),             # right edge
                                 b.right + (b.left - b.right) * t,     # top edge
                                 np.full_like(t, b.left)])             # left edge
            ey = np.concatenate([np.full_like(t, b.bottom),
                                 b.bottom + (b.top - b.bottom) * t,
                                 np.full_like(t, b.top),
                                 b.top + (b.bottom - b.top) * t])
            if CRS(bbox.crs) != self.crs:
                ex, ey = transform_points(CRS(bbox.crs), self.crs, ex, ey)
            left, bottom = ex.min(), ey.min()
            right, top = ex.max(), ey.max()
        elif isinstance(bbox, Vector):
            other = bbox.to_crs(self.crs) if bbox.crs != self.crs else bbox
            left, bottom, right, top = other.bounds
        else:
            left, bottom, right, top = (float(v) for v in bbox)

        def ring_intersects(ring: np.ndarray) -> bool:
            return bool((ring[:, 0].max() >= left) and (ring[:, 0].min() <= right)
                        and (ring[:, 1].max() >= bottom) and (ring[:, 1].min() <= top))

        def clip_ring(ring: np.ndarray) -> np.ndarray | None:
            pts = ring
            for inside, project in (
                (lambda p: p[0] >= left, lambda a, b: a + (b - a) * (left - a[0]) / (b[0] - a[0])),
                (lambda p: p[0] <= right, lambda a, b: a + (b - a) * (right - a[0]) / (b[0] - a[0])),
                (lambda p: p[1] >= bottom, lambda a, b: a + (b - a) * (bottom - a[1]) / (b[1] - a[1])),
                (lambda p: p[1] <= top, lambda a, b: a + (b - a) * (top - a[1]) / (b[1] - a[1])),
            ):
                if len(pts) == 0:
                    return None
                out = []
                closed = np.vstack([pts, pts[:1]]) if not np.array_equal(pts[0], pts[-1]) else pts
                for a, b in zip(closed[:-1], closed[1:]):
                    a_in, b_in = inside(a), inside(b)
                    if a_in:
                        out.append(a)
                        if not b_in:
                            out.append(project(a, b))
                    elif b_in:
                        out.append(project(a, b))
                pts = np.asarray(out, dtype=np.float64).reshape(-1, 2)
            if len(pts) < 3:
                return None
            # Internal convention keeps rings UNCLOSED (see from_geojson)
            if np.array_equal(pts[0], pts[-1]):
                pts = pts[:-1]
            return pts if len(pts) >= 3 else None

        out_polys, out_props = [], []
        for poly, props in zip(self.polygons, self.properties):
            # Cheap bbox rejection, then a true geometric test: the clipped exterior is
            # non-empty iff the exterior polygon intersects the rectangle
            if not ring_intersects(poly[0]) or clip_ring(poly[0]) is None:
                continue
            if not clip:
                out_polys.append([ring.copy() for ring in poly])
                out_props.append(dict(props))
                continue
            ext = clip_ring(poly[0])
            if ext is None:
                continue
            rings = [ext]
            for hole in poly[1:]:
                h = clip_ring(hole)
                if h is not None:
                    rings.append(h)
            out_polys.append(rings)
            out_props.append(dict(props))
        return Vector(out_polys, crs=self.crs, properties=out_props)

    def query(self, expr: str) -> "Vector":
        """Filter features by an expression over their GeoJSON properties.

        The analog of upstream xdem's `gdf.query("name == 'some glacier'")` outline
        filtering, without pandas: the expression is a Python expression evaluated once per
        feature with its properties as names (a property a feature lacks reads None).
        """
        if not expr:
            return self
        if not any(self.properties):
            raise ValueError(
                "This Vector carries no feature properties to query; load it from a GeoJSON "
                "with per-feature 'properties' or pass properties= to the constructor."
            )
        code = compile(expr, "<query>", "eval")
        names = set().union(*(p.keys() for p in self.properties))
        keep = [i for i, p in enumerate(self.properties)
                if eval(code, {"__builtins__": {}}, {**dict.fromkeys(names), **p})]  # noqa: S307
        return Vector([self.polygons[i] for i in keep], crs=self.crs,
                      properties=[self.properties[i] for i in keep])

    def rasterize(self, ref: Any = None, transform: Affine | None = None,
                  shape: Tuple[int, int] | None = None, crs: CRS | int | str | None = None,
                  in_value: Any = None, out_value: float = 0.0):
        """Rasterize features to a value grid (the reference's geoutils `Vector.rasterize`,
        e.g. examples/advanced/plot_norm_regional_hypso.py:49).

        ``in_value=None`` burns the per-feature index 1..N (an index map); a scalar burns
        that value for every feature; a sequence gives one value per feature. Later features
        overwrite earlier ones. Returns a float32 Raster with ``out_value`` elsewhere.
        """
        from xdem_tpu_torch.raster import Raster

        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs
        assert transform is not None and shape is not None
        vec = self if crs is None or CRS(crs) == self.crs else self.to_crs(crs)
        n = len(vec.polygons)
        if in_value is None:
            values = list(range(1, n + 1))
        elif np.isscalar(in_value):
            values = [float(in_value)] * n
        else:
            values = [float(v) for v in in_value]
            if len(values) != n:
                raise ValueError(f"in_value has {len(values)} entries for {n} features.")
        out = np.full(shape, float(out_value), dtype=np.float32)
        t = transform
        north_up = t.b == 0 and t.d == 0 and t.a > 0 and t.e < 0
        h, w = shape
        for poly, val in zip(vec.polygons, values):
            if north_up:
                # Confine the scanline fill to the feature's bounding-box window: per-feature
                # full-grid passes would be O(n_features * h * w)
                pts = np.vstack([np.asarray(r) for r in poly])
                r0 = int(np.clip(np.floor((pts[:, 1].max() - t.f) / t.e - 0.5), 0, h - 1))
                r1 = int(np.clip(np.ceil((pts[:, 1].min() - t.f) / t.e + 0.5), 0, h - 1))
                c0 = int(np.clip(np.floor((pts[:, 0].min() - t.c) / t.a - 0.5), 0, w - 1))
                c1 = int(np.clip(np.ceil((pts[:, 0].max() - t.c) / t.a + 0.5), 0, w - 1))
                t_win = Affine(t.a, t.b, t.c + t.a * c0, t.d, t.e, t.f + t.e * r0)
                m = Vector([poly], crs=vec.crs).mask_array(
                    transform=t_win, shape=(r1 - r0 + 1, c1 - c0 + 1))
                out[r0:r1 + 1, c0:c1 + 1][m] = val
            else:
                m = Vector([poly], crs=vec.crs).mask_array(transform=t, shape=shape)
                out[m] = val
        return Raster(out, transform=transform, crs=crs if crs is not None else vec.crs)

    def create_mask(self, ref: Any = None, transform: Affine | None = None, shape: Tuple[int, int] | None = None,
                    crs: CRS | int | str | None = None) -> torch.Tensor:
        """Rasterize to a boolean mask (True inside polygons) on a reference grid, as a tensor
        on the reference raster's device (the default device when `transform` and `shape`
        are given instead); see `mask_array` for the rasterization."""
        mask = torch.from_numpy(self.mask_array(ref, transform=transform, shape=shape, crs=crs))
        device = ref.data.device if isinstance(getattr(ref, "data", None), torch.Tensor) else default_device()
        return mask.to(device)

    def mask_array(self, ref: Any = None, transform: Affine | None = None, shape: Tuple[int, int] | None = None,
                   crs: CRS | int | str | None = None) -> np.ndarray:
        """Rasterize to a boolean numpy mask (True inside polygons) on a reference grid.

        Axis-aligned (north-up) grids use an O(crossings + pixels) scanline fill with the
        exact even-odd semantics of the general per-pixel test (which is O(edges x pixels)
        and minutes-slow for polygonize outputs with one vertex per boundary pixel);
        rotated transforms fall back to the general test.
        """
        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs
        assert transform is not None and shape is not None
        vec = self if crs is None or CRS(crs) == self.crs else self.to_crs(crs)
        h, w = shape
        t = transform
        if t.b == 0 and t.d == 0 and t.a > 0 and t.e < 0:
            return _rasterize_scanline(vec.polygons, t, (h, w))
        rows = np.arange(h)
        cols = np.arange(w)
        cgrid, rgrid = np.meshgrid(cols, rows)
        px, py = transform.xy(rgrid, cgrid)
        px = px.ravel()
        py = py.ravel()
        inside = np.zeros(px.shape, dtype=bool)
        for poly in vec.polygons:
            poly_inside = np.zeros(px.shape, dtype=bool)
            for ring in poly:
                poly_inside ^= _points_in_ring(px, py, ring)
            inside |= poly_inside
        return inside.reshape(h, w)


def _rasterize_scanline(polygons: Sequence[Sequence[np.ndarray]], t: Affine,
                        shape: Tuple[int, int]) -> np.ndarray:
    """Even-odd scanline rasterization on a north-up grid, crossing-for-crossing identical
    to `_points_in_ring` (a pixel center is inside iff an odd number of ring edges cross
    the horizontal ray to its right).

    Per edge: the pixel rows whose center y lies in [min(y0,y1), max(y0,y1)) each get one
    crossing at the interpolated x; a crossing at x toggles every pixel with center < x,
    realized as a scatter into column bucket j = #centers-below and a right-to-left cumsum.
    """
    h, w = shape
    out = np.zeros((h, w), dtype=bool)
    for poly in polygons:
        # Restrict the crossing buffer to the polygon's bounding rows/cols: with many small
        # polygons a full-raster buffer per polygon would be O(n_polygons * h * w).
        pts = np.vstack([np.asarray(r) for r in poly])
        r_min = int(np.clip(np.floor((pts[:, 1].max() - t.f) / t.e - 0.5), 0, h - 1))
        r_max = int(np.clip(np.ceil((pts[:, 1].min() - t.f) / t.e - 0.5), 0, h - 1))
        c_max = int(np.clip(np.ceil((pts[:, 0].max() - t.c) / t.a - 0.5), 0, w - 1))
        bh = r_max - r_min + 1
        T = np.zeros((bh, c_max + 2), dtype=np.int64)
        any_cross = False
        for ring in poly:
            closed = _ring_is_closed(ring)
            x0 = ring[:-1, 0] if closed else ring[:, 0]
            y0 = ring[:-1, 1] if closed else ring[:, 1]
            x1 = np.roll(x0, -1)
            y1 = np.roll(y0, -1)
            keep = y0 != y1  # horizontal edges never satisfy (y0 > y) != (y1 > y)
            x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
            if x0.size == 0:
                continue
            ylo = np.minimum(y0, y1)
            yhi = np.maximum(y0, y1)
            # Pixel rows with center y_r = f + e*(r + 0.5) in [ylo, yhi); e < 0 so y_r
            # decreases with r: r ranges over (r_of(yhi), r_of(ylo)] with r_of(y)=(y-f)/e-0.5
            r_hi_f = (yhi - t.f) / t.e - 0.5
            r_lo_f = (ylo - t.f) / t.e - 0.5
            r_start = np.maximum(np.floor(r_hi_f).astype(np.int64) + 1, r_min)
            # A center exactly AT ylo is included ([ylo, ...)): floor works except when
            # r_lo_f is an exact integer row, which floor keeps — correct for inclusive.
            r_end = np.minimum(np.floor(r_lo_f).astype(np.int64), r_max)
            n_rows = np.maximum(r_end - r_start + 1, 0)
            total = int(n_rows.sum())
            if total == 0:
                continue
            any_cross = True
            edge_idx = np.repeat(np.arange(x0.size), n_rows)
            offs = np.arange(total) - np.repeat(np.cumsum(n_rows) - n_rows, n_rows)
            rows = r_start[edge_idx] + offs
            y_r = t.f + t.e * (rows + 0.5)
            xint = x0[edge_idx] + (y_r - y0[edge_idx]) / (y1[edge_idx] - y0[edge_idx]) * (
                x1[edge_idx] - x0[edge_idx])
            # Toggle pixels with center x strictly below xint: bucket = count of such centers
            j = np.ceil((xint - t.c) / t.a - 0.5).astype(np.int64)
            j = np.clip(j, 0, c_max + 1)
            np.add.at(T, (rows - r_min, j), 1)
        if any_cross:
            right = np.cumsum(T[:, ::-1], axis=1)[:, ::-1]  # right[r, c] = crossings at j >= c
            out[r_min:r_max + 1, :c_max + 1] |= (right[:, 1:] % 2).astype(bool)
    return out


def _ring_is_closed(ring: np.ndarray) -> bool:
    """Whether the ring repeats its first vertex at the end.

    EXACT comparison: np.allclose's relative tolerance on projected coordinates (northings
    ~1e7 m) calls vertices tens of meters apart "equal", silently dropping a real vertex
    and replacing two edges with a diagonal closure.
    """
    return bool(np.all(ring[0] == ring[-1]))


def _points_in_ring(px: np.ndarray, py: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Vectorized even-odd crossing-number point-in-polygon test for one ring."""
    closed = _ring_is_closed(ring)
    x0 = ring[:-1, 0] if closed else ring[:, 0]
    y0 = ring[:-1, 1] if closed else ring[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    inside = np.zeros(px.shape, dtype=bool)
    # Process edges in chunks to bound memory: (n_edges, n_points) intermediate
    n_edges = len(x0)
    chunk = max(1, int(4e7 // max(px.size, 1)))
    for s in range(0, n_edges, chunk):
        e = slice(s, min(s + chunk, n_edges))
        ex0, ey0, ex1, ey1 = x0[e][:, None], y0[e][:, None], x1[e][:, None], y1[e][:, None]
        cond = (ey0 > py[None, :]) != (ey1 > py[None, :])
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = ex0 + (py[None, :] - ey0) / (ey1 - ey0) * (ex1 - ex0)
        crossing = cond & (px[None, :] < xint)
        inside ^= (np.sum(crossing, axis=0) % 2).astype(bool)
    return inside
