"""Point cloud container: x, y and the data column as float64 tensors on one device.

Port of xdem_tpu/pointcloud.py. The coordinates and values live on one explicit device
(:func:`default_device` for host inputs; a tensor keeps its device), so every consumer (the
CRS transform, gridding by binning, interpolation at the points, the matrix apply) runs
there. Host numpy is used where the algorithm is host-only: the Delaunay triangulation of
``grid(resampling="linear")`` (scipy), ``get_stats`` and ``plot``. Random subsamples draw
with ``np.random.default_rng(random_state)`` as xdem_tpu does, so the picks are the same.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Tuple

import numpy as np
import torch

from xdem_tpu_torch import projections
from xdem_tpu_torch._device import default_device
from xdem_tpu_torch.georef import CRS, transform_points


def _f64(v: Any, device: torch.device | None) -> torch.Tensor:
    """`v` as a float64 tensor: a tensor keeps its device unless `device` is given, host data
    goes to `device` (default :func:`default_device`)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device or v.device, dtype=torch.float64)
    return torch.from_numpy(np.array(v, dtype=np.float64, copy=True)).to(device or default_device())


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


class PointCloud:
    """A set of (x, y, <data_column>) points with a CRS and optional auxiliary columns."""

    def __init__(
        self,
        x: Any,
        y: Any,
        z: Any,
        crs: CRS | int | str,
        data_column: str = "z",
        aux_columns: Dict[str, Any] | None = None,
        device: torch.device | str | None = None,
    ):
        if device is None and isinstance(x, torch.Tensor):
            device = x.device
        device = torch.device(device) if device is not None else default_device()
        self.x = _f64(x, device)
        self.y = _f64(y, device)
        self.z = _f64(z, device)
        if not (self.x.shape == self.y.shape == self.z.shape):
            raise ValueError("x, y, z must have the same shape.")
        self.crs = CRS(crs)
        self.data_column = data_column
        self.aux_columns = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                               device=device) for k, v in (aux_columns or {}).items()}

    @property
    def device(self) -> torch.device:
        return self.x.device

    def __len__(self) -> int:
        return int(self.x.numel())

    @property
    def nb_points(self) -> int:
        return len(self)

    point_count = nb_points  # geoutils' name

    @property
    def ds(self) -> torch.Tensor:
        """(N, 3) tensor of coordinates and data."""
        return torch.stack([self.x, self.y, self.z], dim=1)

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        lo_x, hi_x = torch.aminmax(self.x)
        lo_y, hi_y = torch.aminmax(self.y)
        return tuple(float(v) for v in torch.stack([lo_x, lo_y, hi_x, hi_y]).cpu())  # type: ignore[return-value]

    def copy(self, new_array: Any = None) -> "PointCloud":
        """Copy the point cloud, optionally replacing the elevation values with
        ``new_array`` (same shape)."""
        out = _copy.copy(self)
        out.x, out.y = self.x.clone(), self.y.clone()
        if new_array is not None:
            if tuple(np.shape(new_array)) != tuple(self.z.shape):
                raise ValueError(f"new_array must have shape {tuple(self.z.shape)}, got {tuple(np.shape(new_array))}.")
            out.z = _f64(new_array, self.device).clone()
        else:
            out.z = self.z.clone()
        out.aux_columns = {k: v.clone() for k, v in self.aux_columns.items()}
        return out

    def subset(self, index: Any) -> "PointCloud":
        """The points at `index` (a boolean mask or integer positions, numpy or tensor)."""
        idx = index if isinstance(index, torch.Tensor) else torch.from_numpy(np.asarray(index))
        idx = idx.to(self.device)
        out = _copy.copy(self)
        out.x, out.y, out.z = self.x[idx], self.y[idx], self.z[idx]
        out.aux_columns = {k: v[idx] for k, v in self.aux_columns.items()}
        return out

    def subsample(self, subsample: int | float, random_state: int | None = None) -> "PointCloud":
        n = len(self)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        count = min(count, n)
        rng = np.random.default_rng(random_state)
        return self.subset(np.asarray(rng.choice(n, count, replace=False), np.int64))

    def to_crs(self, crs: CRS | int | str) -> "PointCloud":
        """The points in another CRS, transformed on their device in float64."""
        crs = CRS(crs)
        nx, ny = transform_points(self.crs, crs, self.x, self.y, xp=projections.TORCH)
        out = self.copy()
        out.x, out.y = nx, ny
        out.crs = crs
        return out

    def reproject(self, crs: CRS | int | str) -> "PointCloud":
        """Transform coordinates to another CRS (alias of to_crs)."""
        return self.to_crs(crs)

    def translate(self, xoff: float = 0.0, yoff: float = 0.0, zoff: float = 0.0) -> "PointCloud":
        out = self.copy()
        out.x = out.x + xoff
        out.y = out.y + yoff
        out.z = out.z + zoff
        return out

    def _cells(self, transform: Any, shape: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(flat cell index, z) of the finite points inside the grid: the cell is the nearest
        integer (row, col), as rowcol is centre-convention fractional."""
        h, w = shape
        rows, cols = transform.rowcol(self.x, self.y)
        ri, ci = torch.round(rows), torch.round(cols)
        ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w) & torch.isfinite(self.z)
        return (ri[ok] * w + ci[ok]).long(), self.z[ok]

    def grid(self, ref: Any = None, transform: Any = None, shape: Any = None, crs: Any = None,
             resampling: str = "linear"):
        """Grid the point cloud onto a raster grid.

        resampling="linear" (default) interpolates on the Delaunay triangulation of the
        points (scipy on the host), NaN outside the convex hull; a cloud with no triangulation
        falls back to "mean". resampling="mean" bins on the points' device: mean per cell,
        then empty cells take the mean of their populated 3x3 neighbours.
        """
        from xdem_tpu_torch.raster import Raster

        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs
        out_crs = crs if crs is not None else self.crs
        h, w = shape
        if resampling == "linear":
            from scipy.interpolate import LinearNDInterpolator
            from scipy.spatial import QhullError

            x, y, z = _host(self.x), _host(self.y), _host(self.z)
            ok = np.isfinite(z)
            try:
                interp = LinearNDInterpolator(np.column_stack([x[ok], y[ok]]), z[ok], fill_value=np.nan)
            except (QhullError, ValueError):
                return self.grid(transform=transform, shape=shape, crs=crs, resampling="mean")
            rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            gx, gy = transform.xy(rr.ravel(), cc.ravel())
            grid = interp(np.column_stack([gx, gy])).reshape(h, w).astype(np.float32)
            return Raster(torch.from_numpy(grid).to(self.device), transform, out_crs)
        if resampling != "mean":
            raise ValueError(f"resampling must be 'linear' or 'mean', got {resampling!r}.")
        flat, z = self._cells(transform, (h, w))
        sums = torch.bincount(flat, weights=z, minlength=h * w)
        counts = torch.bincount(flat, minlength=h * w)
        grid = (sums / counts).reshape(h, w).to(torch.float32)
        empty = ~torch.isfinite(grid)
        if bool(empty.any()) and not bool(empty.all()):
            # 3x3 neighbourhood mean of the populated cells, summed in xdem_tpu's order.
            pv = torch.nn.functional.pad(torch.where(empty, 0.0, grid), (1, 1, 1, 1))
            pc = torch.nn.functional.pad((~empty).to(torch.float32), (1, 1, 1, 1))
            nsum = ncnt = 0
            for i in range(3):
                for j in range(3):
                    nsum = nsum + pv[i:i + h, j:j + w]
                    ncnt = ncnt + pc[i:i + h, j:j + w]
            grid = torch.where(empty & (ncnt > 0), nsum / ncnt, grid)
        return Raster(grid, transform, out_crs)

    def rasterize(self, ref: Any = None, transform: Any = None, shape: Any = None, crs: Any = None,
                  statistic: str = "mean") -> Any:
        """Bin points onto a raster grid with a per-cell statistic (mean/count/min/max) on the
        points' device; unlike :meth:`grid` there is no interpolation: empty cells stay NaN."""
        from xdem_tpu_torch.raster import Raster

        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs
        h, w = shape
        flat, z = self._cells(transform, (h, w))
        counts = torch.bincount(flat, minlength=h * w).to(torch.float64)
        if statistic == "count":
            grid = torch.where(counts == 0, torch.nan, counts)
        elif statistic == "mean":
            grid = torch.bincount(flat, weights=z, minlength=h * w) / counts
        elif statistic in ("min", "max"):
            fill = torch.inf if statistic == "min" else -torch.inf
            grid = torch.full((h * w,), fill, dtype=torch.float64, device=self.device)
            grid.scatter_reduce_(0, flat, z, "amin" if statistic == "min" else "amax")
            grid = torch.where(counts == 0, torch.nan, grid)
        else:
            raise ValueError(f"statistic must be mean/count/min/max, got {statistic!r}.")
        return Raster(grid.reshape(h, w).to(torch.float32), transform, crs if crs is not None else self.crs)

    # ------------------------------------------------------- geoutils.PointCloud names

    @classmethod
    def from_xyz(cls, x: Any, y: Any, z: Any, crs: CRS | int | str, data_column: str = "z") -> "PointCloud":
        """Build from separate coordinate arrays."""
        return cls(x=x, y=y, z=z, crs=crs, data_column=data_column)

    @classmethod
    def from_array(cls, array: Any, crs: CRS | int | str, data_column: str = "z") -> "PointCloud":
        """Build from an (N, 3) or (3, N) array or tensor of x, y, z."""
        arr = array if isinstance(array, torch.Tensor) else np.asarray(array, dtype=np.float64)
        if arr.ndim != 2 or 3 not in tuple(arr.shape):
            raise ValueError(f"Expected an (N, 3) or (3, N) array, got shape {tuple(arr.shape)}.")
        if arr.shape[0] == 3 and arr.shape[1] != 3:
            arr = arr.T
        return cls(x=arr[:, 0], y=arr[:, 1], z=arr[:, 2], crs=crs, data_column=data_column)

    @classmethod
    def from_tuples(cls, tuples: Any, crs: CRS | int | str, data_column: str = "z") -> "PointCloud":
        """Build from an iterable of (x, y, z) tuples."""
        return cls.from_array(np.asarray(list(tuples), dtype=np.float64), crs, data_column=data_column)

    def crop(self, bbox: Any) -> "PointCloud":
        """Keep points inside (left, bottom, right, top); a raster or vector with `.bounds`
        also works."""
        b = getattr(bbox, "bounds", bbox)
        left, bottom, right, top = (float(v) for v in tuple(b))
        return self.subset((self.x >= left) & (self.x <= right) & (self.y >= bottom) & (self.y <= top))

    def get_stats(self, stats: Any = None) -> Dict[str, float] | float:
        """Statistics of the data column over the finite points (the Raster set of names,
        including LE90, 90thpercentile and sumofsquares), computed on the host."""
        from xdem_tpu_torch.raster import select_stats, stats_from_values

        z = _host(self.z)
        valid = z[np.isfinite(z)]
        out = stats_from_values(valid, int(z.size))
        if stats is None:
            return out
        if isinstance(stats, str):
            return select_stats(out, valid, [stats])[stats]
        return select_stats(out, valid, stats)

    def info(self) -> str:
        """Human-readable summary."""
        b = self.bounds
        lines = [
            f"{type(self).__name__} with {len(self)} points",
            f"CRS: {self.crs}",
            f"Bounds: left={b[0]:.3f} bottom={b[1]:.3f} right={b[2]:.3f} top={b[3]:.3f}",
            f"Data column: {self.data_column!r}" + (f" (+aux: {sorted(self.aux_columns)})" if self.aux_columns else ""),
        ]
        return "\n".join(lines)

    def to_file(self, path: str) -> None:
        """Write to .las, .npz or delimited text (see xdem_tpu_torch.epc.write_epc)."""
        from xdem_tpu_torch.epc import write_epc

        write_epc(path, self)

    def plot(self, ax: Any = None, cmap: str = "viridis", marker_size: float = 2.0, add_cbar: bool = True,
             **kwargs: Any):
        """Scatter the points coloured by the data column (matplotlib, on the host); returns
        the axes."""
        import matplotlib.pyplot as plt

        if ax is None:
            ax = plt.gca()
        sc = ax.scatter(_host(self.x), _host(self.y), c=_host(self.z), s=marker_size, cmap=cmap, **kwargs)
        if add_cbar:
            plt.colorbar(sc, ax=ax).set_label(self.data_column)
        return ax
