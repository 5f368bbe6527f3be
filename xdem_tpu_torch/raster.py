"""Raster container: a single-band georeferenced tensor with NaN nodata.

Port of xdem_tpu/raster.py. ``.data`` is a float32 tensor on :func:`default_device` (a tensor
given on the CPU stays there, as everywhere in the port), georeferencing (``Affine`` +
``CRS``) is host metadata, and ``get_nanarray()`` is a cached host copy that every
assignment to ``.data`` invalidates (an in-place change of the tensor does not: assign
instead). Arithmetic and comparisons run on the tensors.

``reproject`` is the one heavy device program: destination pixel centres in float64, the
inverse projection through ``projections.TORCH`` on the raster's device, then a gather
interpolation (``ops.interp``), in row bands that bound its float64 temporaries.
"""

from __future__ import annotations

import copy as _copy
import os
import warnings
from typing import Any, Iterator, Literal, Sequence, Tuple

import numpy as np
import torch

from xdem_tpu_torch import projections
from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.georef import CRS, Affine, suggest_utm_crs, transform_points
from xdem_tpu_torch.ops.interp import interp_points as _interp_points_dev
from xdem_tpu_torch.ops.transfer import device_mask

__all__ = ["Raster", "BoundingBox"]

# Pixels per row band of reproject and DEM.to_vcrs: ~20 float64 temporaries of a band take
# ~2.7 GB, whatever the raster's size.
BAND_PIXELS = 1 << 24


def row_bands(shape: Tuple[int, int]) -> Iterator[Tuple[int, int]]:
    """(r0, r1) row ranges of at most `BAND_PIXELS` pixels (at least one row) covering `shape`."""
    h, w = shape
    step = max(1, BAND_PIXELS // max(w, 1))
    for r0 in range(0, h, step):
        yield r0, min(h, r0 + step)


def band_coords(transform: Affine, r0: int, r1: int, w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 world (x, y) of the pixel centres of rows [r0, r1) of a `w`-wide grid."""
    rows = torch.arange(r0, r1, dtype=torch.float64, device=device)
    cols = torch.arange(w, dtype=torch.float64, device=device)
    rgrid, cgrid = torch.meshgrid(rows, cols, indexing="ij")
    return transform.xy(rgrid, cgrid)


def _data_tensor(data: Any, device: torch.device | None = None) -> torch.Tensor:
    """A tensor of raster data: floating tensors keep their dtype, anything else becomes float32."""
    if isinstance(data, torch.Tensor) and data.is_floating_point():
        return data if device is None else data.to(device)
    return as_tensor(data, device=device)


class BoundingBox(tuple):
    """(left, bottom, right, top) with named access."""

    def __new__(cls, left: float, bottom: float, right: float, top: float):
        return super().__new__(cls, (left, bottom, right, top))

    left = property(lambda self: self[0])
    bottom = property(lambda self: self[1])
    right = property(lambda self: self[2])
    top = property(lambda self: self[3])


class Raster:
    """A single-band georeferenced raster with NaN-coded nodata."""

    def __init__(
        self,
        data: Any,
        transform: Affine | Sequence[float] | None = None,
        crs: CRS | int | str | None = None,
        nodata: float | None = None,
        area_or_point: Literal["Area", "Point"] = "Area",
        tags: dict[str, str] | None = None,
        downsample: int = 1,
    ):
        if isinstance(data, (str, os.PathLike)):
            # Path constructor: `DEM(path)` / `Raster(path)`. `downsample=N` loads every Nth
            # pixel (geoutils' decimated read); `nodata=` forces the nodata value when the
            # file metadata lacks or mislabels one.
            if transform is not None or crs is not None:
                raise TypeError("When constructing from a file path, do not pass transform/crs.")
            from xdem_tpu_torch import io as _io

            loaded = _io.read_raster(str(data), raster_cls=Raster)
            self.data = loaded.data
            self.transform = loaded.transform
            self.crs = loaded.crs
            self.nodata = loaded.nodata
            self.area_or_point = loaded.area_or_point
            self.tags = dict(loaded.tags)
            if tags:
                self.tags.update(tags)
            if nodata is not None:
                self.data = torch.where(self.data == float(nodata), torch.nan, self.data)
                self.nodata = nodata
            if downsample and int(downsample) > 1:
                ds = int(downsample)
                self.data = self.data[::ds, ::ds].contiguous()
                # Both strides scale all four linear terms (x = a*col + b*row + c;
                # y = d*col + e*row + f), shear on rotated grids included
                t = self.transform
                self.transform = Affine(t.a * ds, t.b * ds, t.c, t.d * ds, t.e * ds, t.f)
            return
        if downsample and int(downsample) > 1:
            raise TypeError("downsample= only applies when constructing from a file path.")
        if transform is None or crs is None:
            raise TypeError("Raster.__init__() missing 2 required positional arguments: "
                            "'transform' and 'crs'")
        if np.ndim(data) != 2:
            raise ValueError(f"Raster data must be 2-D, got shape {tuple(np.shape(data))}.")
        self.data = _data_tensor(data)
        self.transform = transform if isinstance(transform, Affine) else Affine(*transform)
        self.crs = CRS(crs)
        self.nodata = nodata
        self.area_or_point = area_or_point
        self.tags: dict[str, str] = dict(tags or {})

    # ---------------------------------------------------------------- constructors

    @classmethod
    def from_array(
        cls,
        data: Any,
        transform: Affine | Sequence[float],
        crs: CRS | int | str,
        nodata: float | None = None,
        area_or_point: Literal["Area", "Point"] = "Area",
        tags: dict[str, str] | None = None,
        cast_nodata: bool = True,
    ) -> "Raster":
        # `cast_nodata` is accepted for the signature of geoutils' from_array: NaN is the
        # nodata here, so there is never a dtype-incompatible nodata to cast.
        if isinstance(data, np.ma.MaskedArray):
            data = data.filled(np.nan).astype(np.float32)
        arr = _data_tensor(data)
        if nodata is not None:
            arr = torch.where(arr == nodata, torch.nan, arr)
        return cls(arr, transform, crs, nodata=nodata, area_or_point=area_or_point, tags=tags)

    @classmethod
    def open(cls, path: str) -> "Raster":
        from xdem_tpu_torch import io as _io

        return _io.read_raster(path, raster_cls=cls)

    def save(self, path: str, **kwargs: Any) -> None:
        from xdem_tpu_torch import io as _io

        _io.write_raster(path, self, **kwargs)

    def to_file(self, path: str, **kwargs: Any) -> None:
        """Write to a GeoTIFF (geoutils' name for :meth:`save`)."""
        self.save(path, **kwargs)

    def set_nodata(self, new_nodata: float | None, update_array: bool = True) -> None:
        """Set the nodata value; with `update_array`, pixels equal to it become NaN
        (geoutils Raster.set_nodata semantics; nodata is NaN-coded here)."""
        if new_nodata is not None and update_array:
            self.data = torch.where(self.data == new_nodata, torch.nan, self.data)
        self.nodata = None if new_nodata is None else float(new_nodata)

    def set_area_or_point(self, new_area_or_point: str | None,
                          shift_area_or_point: bool = True) -> None:
        """Change the pixel interpretation; with `shift_area_or_point`, the georeferencing
        moves by half a pixel so coordinates keep pointing at the same ground locations
        (GDAL convention: Area anchors the transform at the corner, Point at the center)."""
        if new_area_or_point not in ("Area", "Point", None):
            raise ValueError(f"area_or_point must be 'Area', 'Point' or None, got {new_area_or_point!r}.")
        old = self.area_or_point
        if shift_area_or_point and old in ("Area", "Point") and new_area_or_point in ("Area", "Point") \
                and old != new_area_or_point:
            t = self.transform
            s = 0.5 if (old == "Area" and new_area_or_point == "Point") else -0.5
            self.transform = t.translation(s * (t.a + t.b), s * (t.d + t.e))
        self.area_or_point = new_area_or_point

    def plot(self, ax: Any = None, cmap: str = "viridis", cbar_title: str | None = None,
             add_cbar: bool = True, **kwargs: Any):
        """Show the raster with georeferenced extent (matplotlib imshow, on the host);
        returns the axes."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        b = self.bounds
        im = ax.imshow(self.get_nanarray(), extent=(b.left, b.right, b.bottom, b.top),
                       cmap=cmap, **kwargs)
        if add_cbar:
            cbar = plt.colorbar(im, ax=ax)
            if cbar_title:
                cbar.set_label(cbar_title)
        return ax

    def proximity(self, target_values: Any = None,
                  distance_unit: str = "georeferenced") -> "Raster":
        """Per-pixel distance to the nearest target pixel (geoutils Raster.proximity; scipy's
        Euclidean distance transform on the host).

        `target_values=None` targets all valid (finite) pixels; otherwise pixels whose value
        is in `target_values`. `distance_unit` is 'georeferenced' (meters) or 'pixel'.
        """
        from scipy.ndimage import distance_transform_edt

        arr = self.get_nanarray()
        if target_values is None:
            target = np.isfinite(arr)
        else:
            target = np.isin(arr, np.atleast_1d(target_values))
        if distance_unit == "georeferenced":
            sampling = (abs(self.transform.yres), abs(self.transform.xres))
        elif distance_unit == "pixel":
            sampling = (1.0, 1.0)
        else:
            raise ValueError("distance_unit must be 'georeferenced' or 'pixel'.")
        dist = distance_transform_edt(~target, sampling=sampling)
        return self.copy(new_array=dist.astype(np.float32))

    def polygonize(self, target_values: Any = 1) -> "Vector":  # noqa: F821
        """Convert target pixels to polygons with holes (geoutils Raster.polygonize analog,
        a boundary tracing on the host).

        `target_values='all'` polygonizes every valid (finite) pixel; a scalar or sequence
        selects pixels by value. Round-trips with Vector.create_mask.
        """
        from xdem_tpu_torch.vector import Vector

        arr = self.get_nanarray()
        if isinstance(target_values, str) and target_values == "all":
            mask = np.isfinite(arr)
        else:
            mask = np.isin(arr, np.atleast_1d(target_values))
        polygons = []
        for rings_px in _mask_to_polygons(mask):
            rings_xy = []
            for ring in rings_px:
                x, y = self.transform.xy(ring[:, 1], ring[:, 0], offset="ul")
                rings_xy.append(np.column_stack([x, y]))
            polygons.append(rings_xy)
        return Vector(polygons, crs=self.crs)

    # ---------------------------------------------------------------- properties

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)  # type: ignore[return-value]

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def res(self) -> Tuple[float, float]:
        return (self.transform.xres, self.transform.yres)

    @property
    def bounds(self) -> BoundingBox:
        h, w = self.shape
        xs, ys = [], []
        for (r, c) in ((0, 0), (0, w), (h, 0), (h, w)):
            x, y = self.transform.xy(r, c, offset="ul")
            xs.append(x)
            ys.append(y)
        return BoundingBox(min(xs), min(ys), max(xs), max(ys))

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def data(self) -> torch.Tensor:
        """The elevation tensor (NaN nodata)."""
        return self._data

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        self._data = value
        self._np_cache = None

    def _host(self) -> np.ndarray:
        """The cached host copy of `.data` (read-only use)."""
        if getattr(self, "_np_cache", None) is None:
            self._np_cache = self.data.detach().cpu().numpy()
        return self._np_cache

    def get_nanarray(self) -> np.ndarray:
        """Host numpy array with NaN nodata (a fresh copy of a cached host copy)."""
        return self._host().copy()

    def get_mask(self) -> np.ndarray:
        """Host boolean mask of invalid (nodata) pixels."""
        return ~np.isfinite(self._host())

    def copy(self, new_array: Any = None) -> "Raster":
        """A copy sharing the georeferencing; `new_array` (a tensor keeps its dtype and
        device, anything else becomes float32 on this raster's device) replaces the data."""
        out = _copy.copy(self)
        if new_array is None:
            out.data = self.data
        elif isinstance(new_array, torch.Tensor):
            out.data = new_array
        else:
            out.data = _data_tensor(new_array, device=self.data.device)
        out.tags = dict(self.tags)
        return out

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.shape}, res={self.res}, crs={self.crs!r}, "
            f"bounds={tuple(self.bounds)})"
        )

    # ---------------------------------------------------------------- arithmetic

    def _binary_op(self, other: Any, op) -> "Raster":
        if isinstance(other, Raster):
            if other.shape != self.shape or not other.transform.almost_equals(self.transform):
                raise ValueError("Rasters must share shape and transform for arithmetic; reproject first.")
            other = other.data
        elif isinstance(other, np.ma.MaskedArray):
            other = other.astype(np.float32).filled(np.nan)
        if isinstance(other, np.ndarray):
            other = torch.from_numpy(np.ascontiguousarray(other)).to(self.data.device)
        return self.copy(new_array=op(self.data, other))

    def __add__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a + b)

    def __radd__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: b + a)

    def __sub__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a - b)

    def __rsub__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: b - a)

    def __mul__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a * b)

    def __truediv__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a / b)

    def __rmul__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: b * a)

    def __rtruediv__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: b / a)

    def __pow__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a ** b)

    def __neg__(self) -> "Raster":
        return self.copy(new_array=-self.data)

    def __abs__(self) -> "Raster":
        return self.copy(new_array=torch.abs(self.data))

    # Comparisons give a boolean mask raster, like geoutils' Raster (`dem > 1` is a bool
    # raster). NaN nodata compares False.

    def __gt__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a > b)

    def __ge__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a >= b)

    def __lt__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a < b)

    def __le__(self, other: Any) -> "Raster":
        return self._binary_op(other, lambda a, b: a <= b)

    def __eq__(self, other: Any) -> Any:  # type: ignore[override]
        # Elementwise like the other comparisons; non-numeric operands (None, strings)
        # keep ordinary equality semantics instead of raising
        if isinstance(other, (Raster, int, float, np.ndarray, torch.Tensor)):
            return self._binary_op(other, lambda a, b: a == b)
        return NotImplemented

    def __ne__(self, other: Any) -> Any:  # type: ignore[override]
        if isinstance(other, (Raster, int, float, np.ndarray, torch.Tensor)):
            return self._binary_op(other, lambda a, b: a != b)
        return NotImplemented

    # Defining __eq__ would otherwise clear hashability; identity hash keeps rasters
    # usable in dicts/sets (matching object semantics)
    __hash__ = object.__hash__

    def __bool__(self) -> bool:
        raise ValueError(
            "The truth value of a raster is ambiguous (comparisons are elementwise); use "
            "`is`/`is not` for identity, or reduce explicitly (e.g. .data.all()/.data.any())."
        )

    # ---------------------------------------------------------------- geospatial ops

    def get_metric_crs(self) -> CRS:
        """A suitable projected (UTM) CRS for this raster's location."""
        if self.crs.is_projected:
            return self.crs
        b = self.bounds
        return suggest_utm_crs((b.left + b.right) / 2, (b.bottom + b.top) / 2)

    def _shifted_points(self, x: Any, y: Any, shift_area_or_point: bool | None) -> Tuple[Any, Any]:
        """(x, y) moved by half a pixel for a "Point" raster when the shift applies."""
        if shift_area_or_point is None:
            from xdem_tpu_torch.config import config

            shift_area_or_point = config["shift_area_or_point"]
        if shift_area_or_point and self.area_or_point == "Point":
            t = self.transform
            x = x + 0.5 * (t.a + t.b)
            y = y + 0.5 * (t.d + t.e)
        return x, y

    def interp_points(
        self,
        points: Tuple[Any, Any],
        method: Literal["nearest", "linear", "cubic"] = "linear",
        shift_area_or_point: bool | None = None,
    ) -> torch.Tensor:
        """Interpolate raster values at world (x, y) points, on the raster's device with
        float64 coordinates; returns a tensor of the points' shape.

        For a raster tagged `area_or_point="Point"` the samples sit at pixel corners rather
        than centers, so coordinates are shifted by half a pixel before interpolating
        (geoutils' shift_area_or_point behavior; default from
        `xdem_tpu_torch.config["shift_area_or_point"]`).
        """
        x, y = (torch.as_tensor(np.asarray(v, np.float64) if not isinstance(v, torch.Tensor) else v,
                                dtype=torch.float64, device=self.data.device) for v in points)
        x, y = self._shifted_points(x, y, shift_area_or_point)
        return _interp_points_dev(self.data, self.transform, x, y, method=method)

    def value_at_coords(self, x: Any, y: Any,
                        shift_area_or_point: bool | None = None) -> np.ndarray:
        """Raster value of the pixel CONTAINING each world (x, y) point: nearest-pixel
        lookup, no interpolation (geoutils Raster.value_at_coords); out-of-bounds or
        non-finite points return NaN. Scalar input gives a scalar, array input an array.
        "Point"-convention rasters get the same half-pixel shift as :meth:`interp_points`
        (so the two methods always read the same pixel). Use :meth:`interp_points` for
        sub-pixel interpolation."""
        scalar_in = np.ndim(x) == 0 and np.ndim(y) == 0
        xa = np.atleast_1d(np.asarray(x, np.float64))
        ya = np.atleast_1d(np.asarray(y, np.float64))
        xa, ya = self._shifted_points(xa, ya, shift_area_or_point)
        rows, cols = self.transform.rowcol(xa, ya)
        # rowcol is fractional in the center-of-pixel convention: pixel i spans [i-0.5, i+0.5),
        # so the CONTAINING pixel is floor(frac + 0.5)
        rows = np.asarray(rows, np.float64)
        cols = np.asarray(cols, np.float64)
        finite = np.isfinite(rows) & np.isfinite(cols)
        ri = np.floor(np.where(finite, rows, -1.0) + 0.5).astype(np.int64)
        ci = np.floor(np.where(finite, cols, -1.0) + 0.5).astype(np.int64)
        h, w = self.shape
        inside = finite & (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        out = np.full(ri.shape, np.nan, dtype=np.float64)
        if inside.any():
            idx = torch.from_numpy(ri[inside] * w + ci[inside]).to(self.data.device)
            out[inside] = self.data.reshape(-1)[idx].double().cpu().numpy()
        return out.reshape(())[()] if scalar_in else out

    def xy2ij(self, x: Any, y: Any) -> Tuple[Any, Any]:
        return self.transform.rowcol(x, y)

    def ij2xy(self, i: Any, j: Any) -> Tuple[Any, Any]:
        return self.transform.xy(i, j)

    def coords(self, grid: bool = True):
        """Pixel-center coordinate arrays (x, y) on the host, gridded by default."""
        h, w = self.shape
        cols = np.arange(w)
        rows = np.arange(h)
        if grid:
            cgrid, rgrid = np.meshgrid(cols, rows)
            return self.transform.xy(rgrid, cgrid)
        x, _ = self.transform.xy(np.zeros_like(cols), cols)
        _, y = self.transform.xy(rows, np.zeros_like(rows))
        return x, y

    def set_mask(self, mask: Any) -> None:
        """Mask pixels where ``mask`` is True (set them to NaN), in place (geoutils'
        `Raster.set_mask`). A float mask's NaN means "no mask value here": not masked."""
        m = mask.data if isinstance(mask, Raster) else mask
        m = m if isinstance(m, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(m))
        if tuple(m.shape) != self.shape:
            raise ValueError(f"Mask shape {tuple(m.shape)} does not match raster shape {self.shape}.")
        m = m.to(self.data.device)
        if m.is_floating_point():
            m = torch.where(torch.isfinite(m), m, 0.0)
        self.data = torch.where(m.to(torch.bool), torch.nan, self.data)

    def subsample(self, subsample: int | float, random_state: int | None = None,
                  return_indices: bool = False):
        """Random subsample of the valid pixels: values by default, (rows, cols) index
        arrays with ``return_indices=True``, as numpy arrays. A float <= 1 is a fraction of
        the valid count, an int is a count (geoutils' `Raster.subsample`). The draw equals
        xdem_tpu's for one seed: numpy's ``choice(n_valid, count)`` picks positions among the
        valid pixels in raster order, which map to pixels on the raster's device (only the
        valid count reaches the host)."""
        valid = torch.isfinite(self.data)
        n = int(valid.sum())
        count = int(subsample * n) if subsample <= 1 else int(subsample)
        idx = np.random.default_rng(random_state).choice(n, min(count, n), replace=False)
        flat = torch.nonzero(valid.reshape(-1)).squeeze(1)
        flat = flat[torch.from_numpy(np.asarray(idx, np.int64)).to(flat.device)]
        if return_indices:
            w = self.width
            return (flat // w).cpu().numpy(), (flat % w).cpu().numpy()
        return self.data.reshape(-1)[flat].cpu().numpy()

    def translate(self, xoff: float, yoff: float, zoff: float = 0.0, inplace: bool = False) -> "Raster":
        """Shift the georeferencing (and optionally elevation) without resampling."""
        new_transform = self.transform.translation(xoff, yoff)
        if inplace:
            self.transform = new_transform
            if zoff:
                self.data = self.data + zoff
            return self
        out = self.copy(new_array=self.data + zoff if zoff else self.data)
        out.transform = new_transform
        return out

    def reproject(
        self,
        ref: "Raster | None" = None,
        crs: CRS | int | str | None = None,
        res: float | Tuple[float, float] | None = None,
        bounds: Tuple[float, float, float, float] | None = None,
        resampling: Literal["nearest", "linear", "bilinear", "cubic", "cubic_spline"] | None = None,
        silent: bool = True,
    ) -> "Raster":
        """Reproject/regrid onto a reference raster's grid or an explicit crs/res/bounds.

        An inverse-coordinate gather interpolation on the raster's device (upstream xdem
        delegates to rasterio.warp; same pixel-center convention): the destination pixel
        centres are built in float64, projected into the source CRS with
        ``projections.TORCH`` and read by `ops.interp`, in row bands of `BAND_PIXELS`.
        `resampling=None` uses the package default (`xdem_tpu_torch.config["resampling"]`,
        bilinear out of the box). `silent=False` warns when the target grid equals the
        source grid (the reproject is a resampling no-op).
        """
        if resampling is None:
            from xdem_tpu_torch.config import config

            resampling = config["resampling"]
        # rasterio's names are accepted ("cubic_spline" is DEMCollection's default).
        method = {"bilinear": "linear", "cubic_spline": "cubic"}.get(resampling, resampling)
        dst_crs, dst_transform, dst_shape = self._destination_grid(ref, crs, res, bounds)

        if (not silent and dst_crs == self.crs and dst_shape == self.shape
                and dst_transform.almost_equals(self.transform)):
            warnings.warn(
                "Output projection, bounds and grid size are identical to the input raster: "
                "the reproject only resamples in place.", UserWarning,
            )

        h, w = dst_shape
        out = torch.empty((h, w), dtype=self.data.dtype, device=self.data.device)
        for r0, r1 in row_bands(dst_shape):
            dx, dy = band_coords(dst_transform, r0, r1, w, self.data.device)
            sx, sy = transform_points(dst_crs, self.crs, dx, dy, xp=projections.TORCH)
            out[r0:r1] = _interp_points_dev(self.data, self.transform, sx, sy, method=method)
        result = self.copy(new_array=out)
        result.transform = dst_transform
        result.crs = dst_crs
        return result

    def _destination_grid(self, ref: "Raster | None", crs: Any, res: Any,
                          bounds: Any) -> Tuple[CRS, Affine, Tuple[int, int]]:
        """(crs, transform, shape) of a reproject's destination grid, as xdem_tpu sets it."""
        if ref is not None:
            return ref.crs, Affine(*ref.transform), ref.shape
        dst_crs = CRS(crs) if crs is not None else self.crs
        if bounds is None:
            if dst_crs == self.crs:
                bounds = tuple(self.bounds)
            else:
                # Densify the outline (21 points per edge, rasterio
                # calculate_default_transform-style): conic/azimuthal projections bulge
                # mid-edge beyond the corner images
                b = self.bounds
                t_edge = np.linspace(0.0, 1.0, 21)
                xs = np.concatenate([
                    b.left + (b.right - b.left) * t_edge,   # bottom
                    b.left + (b.right - b.left) * t_edge,   # top
                    np.full(21, b.left),                    # left
                    np.full(21, b.right),                   # right
                ])
                ys = np.concatenate([
                    np.full(21, b.bottom), np.full(21, b.top),
                    b.bottom + (b.top - b.bottom) * t_edge,
                    b.bottom + (b.top - b.bottom) * t_edge,
                ])
                tx, ty = transform_points(self.crs, dst_crs, xs, ys)
                bounds = (float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max()))
        if res is None:
            if dst_crs == self.crs:
                res = self.res
            else:
                # Cross-CRS default: keep the pixel COUNT over the reprojected bounds
                # (rasterio calculate_default_transform semantics)
                left, bottom, right, top = bounds
                res = (max(right - left, 1e-12) / self.shape[1],
                       max(top - bottom, 1e-12) / self.shape[0])
        if not isinstance(res, (tuple, list)):
            res = (float(res), float(res))
        left, bottom, right, top = bounds
        # ceil (rasterio semantics); the 1e-9 slack keeps exact multiples from gaining a pixel
        w = max(int(np.ceil((right - left) / res[0] - 1e-9)), 1)
        h = max(int(np.ceil((top - bottom) / res[1] - 1e-9)), 1)
        return dst_crs, Affine.from_origin(left, top, res[0], res[1]), (h, w)

    def crop(self, bbox: "Raster | Tuple[float, float, float, float]", mode: str = "match_pixel") -> "Raster":
        """Crop to a bounding box (or another raster's bounds).

        ``mode="match_pixel"`` (default) snaps the box to the existing pixel grid (pure
        slicing, no resampling); ``mode="match_extent"`` matches the requested extent
        exactly, resampling onto a grid whose resolution is adjusted to fit (geoutils crop
        semantics).
        """
        if mode not in ("match_pixel", "match_extent"):
            raise ValueError(f"mode must be 'match_pixel' or 'match_extent', got {mode!r}.")
        if isinstance(bbox, Raster):
            bbox = tuple(bbox.bounds)
        left, bottom, right, top = bbox
        if mode == "match_extent":
            w = max(int(np.round((right - left) / self.res[0])), 1)
            h = max(int(np.round((top - bottom) / self.res[1])), 1)
            return self.reproject(bounds=(left, bottom, right, top),
                                  res=((right - left) / w, (top - bottom) / h))
        row0, col0 = self.transform.rowcol(left, top)
        row1, col1 = self.transform.rowcol(right, bottom)
        r0 = int(np.clip(np.round(row0 + 0.5), 0, self.height))
        c0 = int(np.clip(np.round(col0 + 0.5), 0, self.width))
        r1 = int(np.clip(np.round(row1 + 0.5), 0, self.height))
        c1 = int(np.clip(np.round(col1 + 0.5), 0, self.width))
        if r1 <= r0 or c1 <= c0:
            raise ValueError("Crop bounds do not intersect the raster.")
        return self.icrop((r0, r1), (c0, c1))

    def icrop(self, rows: Tuple[int, int], cols: Tuple[int, int]) -> "Raster":
        """Crop by integer pixel bounds [r0, r1), [c0, c1)."""
        r0, r1 = rows
        c0, c1 = cols
        new_data = self.data[r0:r1, c0:c1].contiguous()
        ul_x, ul_y = self.transform.xy(r0, c0, offset="ul")
        out = self.copy(new_array=new_data)
        out.transform = Affine(self.transform.a, self.transform.b, ul_x, self.transform.d, self.transform.e, ul_y)
        return out

    def to_pointcloud(self, data_column_name: str = "z", subsample: int | float = 1,
                      random_state: int | None = None, *, data_band: int = 1,
                      auxiliary_data_bands: Sequence[int] | None = None,
                      auxiliary_column_names: Sequence[str] | None = None,
                      skip_nodata: bool = True, as_array: bool = False,
                      force_pixel_offset: str = "center"):
        """Valid pixels as a PointCloud on the raster's device (x, y in float64), or as an
        (N, 3) numpy array with ``as_array=True``.

        ``skip_nodata=False`` keeps NaN pixels and ``force_pixel_offset`` picks the in-pixel
        coordinate ("center" default, or a rasterio-style corner "ul"/"ur"/"ll"/"lr");
        ``subsample`` draws as xdem_tpu does (numpy's choice over the valid pixels in raster
        order). Rasters are single-band, so ``data_band`` must be 1."""
        from xdem_tpu_torch.pointcloud import PointCloud

        if data_band != 1:
            raise ValueError("Rasters are single-band here: data_band must be 1.")
        if auxiliary_data_bands is not None or auxiliary_column_names is not None:
            raise ValueError("Rasters are single-band here: auxiliary bands are not available.")
        if force_pixel_offset not in ("center", "ul", "ur", "ll", "lr"):
            raise ValueError("force_pixel_offset must be 'center', 'ul', 'ur', 'll' or 'lr'.")
        h, w = self.shape
        flat = self.data.reshape(-1)
        idx = torch.nonzero(torch.isfinite(flat)).reshape(-1) if skip_nodata else torch.arange(h * w, device=flat.device)
        if subsample != 1:
            n = int(idx.numel())
            count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
            pick = np.random.default_rng(random_state).choice(n, min(count, n), replace=False)
            idx = idx[torch.from_numpy(np.asarray(pick, np.int64)).to(idx.device)]
        rr = torch.div(idx, w, rounding_mode="floor").to(torch.float64)
        cc = (idx % w).to(torch.float64)
        if force_pixel_offset == "center":
            x, y = self.transform.xy(rr, cc)
        else:
            dr = {"ul": 0, "ur": 0, "ll": 1, "lr": 1}[force_pixel_offset]
            dc = {"ul": 0, "ur": 1, "ll": 0, "lr": 1}[force_pixel_offset]
            x, y = self.transform.xy(rr + dr, cc + dc, offset="ul")
        z = flat[idx].to(torch.float64)
        if as_array:
            return torch.stack([x, y, z], dim=1).cpu().numpy()
        return PointCloud(x=x, y=y, z=z, crs=self.crs, data_column=data_column_name)

    def get_stats(self, stats: Sequence[str] | None = None) -> dict[str, float]:
        """Common raster statistics over valid pixels, computed on the cached host copy as
        xdem_tpu computes them.

        ``stats`` accepts geoutils' full name set case/space-insensitively:
        mean/median/max/min/sum/std ("standard deviation")/nmad/rmse/sumofsquares/
        90thpercentile/le90/validcount/totalcount/percentagevalidpoints."""
        arr = self._host()
        valid = arr[np.isfinite(arr)]
        out = stats_from_values(valid, int(arr.size))
        if stats is None:
            return out
        if isinstance(stats, str):  # the single-name form returns the scalar
            return select_stats(out, valid, [stats])[stats]
        return select_stats(out, valid, stats)


def mask_on(m: Any, ref: Raster | None, shape: Tuple[int, ...], device: torch.device | str) -> torch.Tensor | None:
    """`m` as a bool tensor of `shape` on `device`, or None for no mask. A Vector is rasterized
    on the grid of the Raster `ref`; a Raster counts its pixels > 0, regridded onto `ref` by
    nearest neighbour when its grid differs (nothing outside its extent is kept); a masked
    array keeps none of its masked slots; any other array or tensor is taken as it is."""
    if m is None:
        return None
    if hasattr(m, "create_mask"):
        if ref is None:
            raise ValueError("A raster is needed to rasterize a vector mask.")
        m = m.create_mask(ref)
    elif isinstance(m, Raster):
        if ref is not None and (m.shape != ref.shape or m.transform != ref.transform or m.crs != ref.crs):
            m = m.copy(new_array=m.data.to(torch.float32)).reproject(ref, resampling="nearest")
        m = torch.nan_to_num(m.data, nan=0.0) > 0
    elif isinstance(m, np.ma.MaskedArray):
        m = np.asarray(m.filled(False), dtype=bool)
    return device_mask(m, tuple(shape), device)


def stats_from_values(valid: np.ndarray, total_count: int) -> dict[str, float]:
    """The shared Raster/PointCloud statistics dict over an array of valid values."""
    med = float(np.median(valid)) if valid.size else float("nan")
    return {
        "mean": float(np.mean(valid)) if valid.size else float("nan"),
        "median": med,
        "max": float(np.max(valid)) if valid.size else float("nan"),
        "min": float(np.min(valid)) if valid.size else float("nan"),
        "sum": float(np.sum(valid)) if valid.size else float("nan"),
        "std": float(np.std(valid)) if valid.size else float("nan"),
        "nmad": float(1.4826 * np.median(np.abs(valid - med))) if valid.size else float("nan"),
        "rmse": float(np.sqrt(np.mean(valid**2))) if valid.size else float("nan"),
        "valid_count": int(valid.size),
        "total_count": int(total_count),
        "percentage_valid_points": (float(100 * valid.size / total_count)
                                    if total_count else float("nan")),
    }


def select_stats(out: dict[str, float], valid: np.ndarray, stats: Sequence[str]) -> dict[str, float]:
    """Resolve requested statistic names against a stats_from_values dict, accepting
    geoutils' aliases case/space-insensitively plus the three percentile-family extras
    (geoutils Raster.get_stats name set)."""
    alias = {
        "standarddeviation": "std",
        "maximum": "max",
        "minimum": "min",
        "validcount": "valid_count",
        "totalcount": "total_count",
        "percentagevalidpoints": "percentage_valid_points",
    }
    result = {}
    for name in stats:
        key = name.lower().replace(" ", "").replace("_", "")
        key = alias.get(key, key)
        if key in out:
            result[name] = out[key]
        elif key == "sumofsquares":
            result[name] = float(np.sum(valid**2)) if valid.size else float("nan")
        elif key == "90thpercentile":
            result[name] = float(np.percentile(valid, 90)) if valid.size else float("nan")
        elif key == "le90":
            # geoutils' linear_error: the central 90% interval width p95 - p5 (NOT the
            # 90th percentile of |x| — the two differ by ~2x on symmetric errors)
            result[name] = (float(np.percentile(valid, 95) - np.percentile(valid, 5))
                            if valid.size else float("nan"))
        else:
            raise KeyError(f"Unknown statistic '{name}'.")
    return result


def _mask_to_polygons(mask: np.ndarray) -> list:
    """Trace a binary mask into polygons: list of [exterior, *holes], each an (N, 2) array
    of (col, row) pixel-corner coordinates.

    Directed boundary edges are emitted per filled pixel against each empty 4-neighbor; at
    checkerboard corners the turn toward the filled side is taken so diagonally-touching
    regions stay separate loops. Hole rings are identified by orientation (opposite shoelace
    sign from exteriors) and attached to the smallest exterior containing them.
    """
    h, w = mask.shape
    if not mask.any():
        return []
    m = np.zeros((h + 2, w + 2), bool)
    m[1:-1, 1:-1] = mask
    rr, cc = np.nonzero(mask)
    r1, c1 = rr + 1, cc + 1
    edges: dict = {}

    def add(sx, sy, ex, ey, sel):
        for x0, y0, x1_, y1_ in zip(sx[sel], sy[sel], ex[sel], ey[sel]):
            edges.setdefault((x0, y0), []).append((x1_, y1_))

    # (col, row) corners; directions chosen so the filled pixel sits on the walker's right
    add(cc, rr, cc + 1, rr, ~m[r1 - 1, c1])          # top edge, heading +x
    add(cc + 1, rr, cc + 1, rr + 1, ~m[r1, c1 + 1])  # right edge, heading +y
    add(cc + 1, rr + 1, cc, rr + 1, ~m[r1 + 1, c1])  # bottom edge, heading -x
    add(cc, rr + 1, cc, rr, ~m[r1, c1 - 1])          # left edge, heading -y

    loops = []
    while edges:
        # Start at a NON-saddle vertex (single outgoing edge): starting at a saddle gives
        # the walker no incoming direction to resolve the turn, and an arbitrary pick can
        # jump between the two loops that cross there.
        start = None
        for v, outs0 in edges.items():
            if len(outs0) == 1:
                start = v
                break
        if start is None:  # all remaining vertices are saddles (two tangent loops): any works
            start = next(iter(edges))
        ring = [start]
        prev = None
        cur = start
        while True:
            outs = edges.get(cur)
            if not outs:
                break
            if len(outs) == 1 or prev is None:
                nxt = outs.pop()
            else:
                # Saddle (diagonally-touching pixels): keep hugging the SAME filled pixel by
                # taking the right turn (positive cross in y-down screen coords), so separate
                # components get separate loops and diagonal hole pairs pinch into one ring.
                dx, dy = cur[0] - prev[0], cur[1] - prev[1]
                nxt = max(outs, key=lambda e: dx * (e[1] - cur[1]) - dy * (e[0] - cur[0]))
                outs.remove(nxt)
            if not outs:
                del edges[cur]
            prev, cur = cur, nxt
            if cur == start:
                break
            ring.append(cur)
        if len(ring) >= 4:
            loops.append(np.asarray(ring, dtype=np.float64))

    def shoelace(ring):
        x, y = ring[:, 0], ring[:, 1]
        return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))

    from xdem_tpu_torch.vector import _points_in_ring

    areas = [shoelace(rg) for rg in loops]
    # Exterior orientation: the edge directions walk the outermost loop of any component
    # clockwise in screen coords, which is a POSITIVE shoelace in (x, y-down) coordinates;
    # hole loops run the other way.
    exteriors = [(rg, abs(a)) for rg, a in zip(loops, areas) if a > 0]
    holes = [rg for rg, a in zip(loops, areas) if a <= 0]
    exteriors.sort(key=lambda t: t[1])  # smallest first: holes attach to tightest container
    polygons = [[rg] for rg, _a in exteriors]
    for hole in holes:
        # Probe strictly inside the hole region: the empty side is on the walker's LEFT,
        # so step half a unit left of the first edge's midpoint (unit-length edges).
        dx, dy = hole[1, 0] - hole[0, 0], hole[1, 1] - hole[0, 1]
        probe = (0.5 * (hole[0, 0] + hole[1, 0]) + 0.5 * dy,
                 0.5 * (hole[0, 1] + hole[1, 1]) - 0.5 * dx)
        for k, (ext, _a) in enumerate(exteriors):
            if _points_in_ring(np.array([probe[0]]), np.array([probe[1]]), ext)[0]:
                polygons[k].append(hole)
                break
    return polygons
