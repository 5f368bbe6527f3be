"""Coregistration framework: matrix toolbox, matrix application, the Coreg base class and
CoregPipeline.

Port of xdem_tpu/coreg/base.py for elevation given as Rasters/DEMs, arrays or tensors with
``transform=`` (and ``crs=``), or point clouds (PointCloud/EPC). A to-be-aligned Raster on
another grid is reprojected onto the reference's; the point side of a raster-point pair goes
to the raster's CRS, and a point-point pair to the reference's. Inlier masks may be arrays,
tensors, Rasters (regridded by nearest neighbour) or Vectors. A fit tries the method's
raster-raster solver, then its raster-point one (the reference raster turned into points),
then its point-point one, as xdem_tpu does. ``apply`` returns a Raster for a Raster, a point
cloud for a point cloud and (tensor, transform) for an array. A matrix moves points exactly
in float64 on their device, and a DEM in four tiers: (1) a pure vertical shift, (2) a
translation applied by updating the georeferencing (resampled back onto the input grid by
bilinear gathers), (3) small rotations by a fixed-point inverse regrid on the device of the
DEM, (4) large rotations by a host Delaunay regrid (scipy).

The fitted state is the ``meta`` dict. :meth:`Coreg.load` reads the pickle that
``xdem_tpu``'s ``Coreg.save`` writes (pipelines included), and :meth:`Coreg.from_meta` takes
such a tree in memory.
"""

from __future__ import annotations

import copy as _copy
import importlib
import io
import logging
import math
import pickle
import warnings
from typing import Any, Callable, Iterable, Literal, NamedTuple, TypedDict

import numpy as np
import torch

from xdem_tpu_torch import _build
from xdem_tpu_torch._device import as_tensor
from xdem_tpu_torch.georef import CRS, Affine
from xdem_tpu_torch.ops.interp import interp_rowcol
from xdem_tpu_torch.pointcloud import PointCloud
from xdem_tpu_torch.profiler import profile as _profile
from xdem_tpu_torch.profiler import span
from xdem_tpu_torch.raster import Raster, mask_on


class NotImplementedCoregFit(NotImplementedError):
    """Raised when a Coreg does not implement a given fit input combination."""


class NotImplementedCoregApply(NotImplementedError):
    """Raised when a Coreg does not implement a given apply input."""


# ------------------------------------------------------------------ matrix toolbox


def _check_matrix(matrix: np.ndarray) -> np.ndarray:
    """Validate a 4x4 rigid transform matrix."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if matrix.shape != (4, 4):
        raise ValueError(f"Invalid transform matrix shape {matrix.shape}, must be (4, 4).")
    if not np.allclose(matrix[3, :], [0, 0, 0, 1]):
        raise ValueError("Last row of transform matrix must be [0, 0, 0, 1].")
    R = matrix[:3, :3]
    if not np.allclose(R @ R.T, np.eye(3), atol=1e-6):
        raise ValueError("The rotation part of the matrix is not orthogonal (not a rigid transform).")
    return matrix


def _make_matrix_valid(matrix: np.ndarray) -> np.ndarray:
    """Orthogonalize the rotation part via SVD."""
    matrix = np.asarray(matrix, dtype=np.float64).copy()
    U, _, Vt = np.linalg.svd(matrix[:3, :3])
    matrix[:3, :3] = U @ Vt
    matrix[3, :] = [0, 0, 0, 1]
    return matrix


def matrix_from_translations_rotations(
    t_x: float = 0.0,
    t_y: float = 0.0,
    t_z: float = 0.0,
    alpha: float = 0.0,
    beta: float = 0.0,
    gamma: float = 0.0,
    use_degrees: bool = True,
    *,
    t1: float | None = None,
    t2: float | None = None,
    t3: float | None = None,
    alpha1: float | None = None,
    alpha2: float | None = None,
    alpha3: float | None = None,
) -> np.ndarray:
    """Build a 4x4 rigid matrix from translations and extrinsic-Euler xyz rotations.

    Upstream xdem's keyword names (``t1/t2/t3`` for the translations, ``alpha1/alpha2/alpha3``
    for the rotations) are aliases of ``t_x/t_y/t_z`` and ``alpha/beta/gamma``.

    >>> matrix_from_translations_rotations(1.0, 2.0, 3.0)[:3, 3]
    array([1., 2., 3.])
    >>> matrix_from_translations_rotations(t1=1.0, t3=3.0)[:3, 3]
    array([1., 0., 3.])
    """
    t_x = t_x if t1 is None else t1
    t_y = t_y if t2 is None else t2
    t_z = t_z if t3 is None else t3
    alpha = alpha if alpha1 is None else alpha1
    beta = beta if alpha2 is None else alpha2
    gamma = gamma if alpha3 is None else alpha3
    if use_degrees:
        alpha, beta, gamma = np.deg2rad([alpha, beta, gamma])
    Rx = np.array([[1, 0, 0], [0, np.cos(alpha), -np.sin(alpha)], [0, np.sin(alpha), np.cos(alpha)]])
    Ry = np.array([[np.cos(beta), 0, np.sin(beta)], [0, 1, 0], [-np.sin(beta), 0, np.cos(beta)]])
    Rz = np.array([[np.cos(gamma), -np.sin(gamma), 0], [np.sin(gamma), np.cos(gamma), 0], [0, 0, 1]])
    M = np.eye(4)
    M[:3, :3] = Rz @ Ry @ Rx  # extrinsic x-y-z
    M[:3, 3] = [t_x, t_y, t_z]
    return M


def translations_rotations_from_matrix(matrix: np.ndarray, return_degrees: bool = True):
    """Extract (t_x, t_y, t_z, alpha, beta, gamma) from a rigid matrix."""
    matrix = _check_matrix(matrix)
    t_x, t_y, t_z = matrix[:3, 3]
    R = matrix[:3, :3]
    beta = np.arcsin(np.clip(-R[2, 0], -1, 1))
    if np.isclose(np.cos(beta), 0):
        alpha = np.arctan2(R[0, 1], R[1, 1])
        gamma = 0.0
    else:
        alpha = np.arctan2(R[2, 1], R[2, 2])
        gamma = np.arctan2(R[1, 0], R[0, 0])
    if return_degrees:
        alpha, beta, gamma = np.rad2deg([alpha, beta, gamma])
    return float(t_x), float(t_y), float(t_z), float(alpha), float(beta), float(gamma)


def invert_matrix(matrix: np.ndarray, atol: float = 10e-8) -> np.ndarray:
    """Invert a rigid 4x4 matrix; ``atol`` bounds how far the bottom row may sit from
    [0, 0, 0, 1] before the matrix is rejected as non-affine."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if matrix.shape == (4, 4) and not np.allclose(matrix[3], [0, 0, 0, 1], atol=atol):
        raise ValueError("Matrix is not affine: bottom row must be [0, 0, 0, 1].")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        checked = _check_matrix(_make_matrix_valid(matrix))
    return np.linalg.inv(checked)


def _matrix_is_translation_only(matrix: np.ndarray) -> bool:
    return np.allclose(matrix[:3, :3], np.eye(3), atol=1e-12)


# ------------------------------------------------------------------ matrix application


def _apply_matrix_pts_arr(x: Any, y: Any, z: Any, matrix: np.ndarray,
                          centroid: tuple[float, float, float] | None = None, invert: bool = False):
    """Exact rigid transform of points about `centroid`, in float64: numpy arrays on the
    host, tensors on their device."""
    if invert:
        matrix = invert_matrix(matrix)
    cx, cy, cz = centroid if centroid is not None else (0.0, 0.0, 0.0)
    if isinstance(x, torch.Tensor):
        m = [[float(v) for v in row] for row in np.asarray(matrix, np.float64)]
        xc, yc, zc = (t.to(torch.float64) - c for t, c in ((x, cx), (y, cy), (z, cz)))
        return tuple(m[i][0] * xc + m[i][1] * yc + m[i][2] * zc + m[i][3] + c for i, c in enumerate((cx, cy, cz)))
    pts = np.stack([np.asarray(x) - cx, np.asarray(y) - cy, np.asarray(z) - cz, np.ones_like(np.asarray(z))], axis=0)
    out = np.asarray(matrix) @ pts
    return out[0] + cx, out[1] + cy, out[2] + cz


def _apply_matrix_pts(epc: PointCloud, matrix: np.ndarray, centroid: tuple[float, float, float] | None = None,
                      invert: bool = False) -> PointCloud:
    """A copy of the point cloud moved by a rigid matrix, on its device in float64."""
    x, y, z = _apply_matrix_pts_arr(epc.x, epc.y, epc.z, matrix, centroid=centroid, invert=invert)
    out = epc.copy()
    out.x, out.y, out.z = x, y, z
    return out


# Launches of csrc/regrid.cu, one a tier-3 step on the card, and of csrc/nn_scan.cu, one an ICP
# neighbour scan on the card (coreg/affine.py): counted where the wrappers launch and nowhere
# else, so a run can show that its regrids and scans went through the kernels.
LAUNCHES = {"regrid_step": 0, "nn_scan": 0}


class _RegridConstants(NamedTuple):
    """Tier 3's constants, grouped in float64 on the host about the centroid (cx, cy, cz)."""

    a: float  # the DEM's affine transform, with c and f less cx and cy
    b: float
    c: float
    d: float
    e: float
    f: float
    mi: list[list[float]]  # the inverse matrix and the matrix, as exact float32 values
    mf: list[list[float]]
    det: float  # a * e - b * d
    col_off: float  # the centroid's pixel offsets, less 0.5
    row_off: float
    cz: float
    res_x: float  # the pixel sizes
    res_y: float


def _regrid_constants(transform: Affine, matrix: np.ndarray,
                      centroid: tuple[float, float, float] | None) -> _RegridConstants:
    """Tier 3's constants for `transform` and `matrix` about `centroid` (None: the origin)."""
    cx, cy, cz = centroid if centroid is not None else (0.0, 0.0, 0.0)
    a, b, c, d, e, f = (float(v) for v in tuple(transform))
    det = a * e - b * d
    return _RegridConstants(
        a, b, c - cx, d, e, f - cy,
        mi=[[float(v) for v in row] for row in np.asarray(invert_matrix(matrix), np.float32)],
        mf=[[float(v) for v in row] for row in np.asarray(matrix, np.float32)],
        det=det,
        col_off=(e * cx - b * cy - (e * c - b * f)) / det - 0.5,
        row_off=(-d * cx + a * cy - (-d * c + a * f)) / det - 0.5,
        cz=cz, res_x=transform.xres, res_y=transform.yres,
    )


def _regrid_step_aten(dem: torch.Tensor, k: _RegridConstants, resampling: str, regrid: Any) -> Callable:
    """The plain version of tier 3's step, in ATen passes on the DEM's device: returns
    ``step(zg) -> (new guess, largest residual)``. The divisions by the determinant and the
    pixel sizes are by tensors, true divisions on every device. It counts nothing on the span
    `regrid`, which it takes for the card's signature."""
    h, w = dem.shape
    dev, f32 = dem.device, torch.float32
    cols = torch.arange(w, dtype=f32, device=dev)[None, :]
    rows = torch.arange(h, dtype=f32, device=dev)[:, None]
    X = k.a * (cols + 0.5) + k.b * (rows + 0.5) + k.c
    Y = k.d * (cols + 0.5) + k.e * (rows + 0.5) + k.f
    det_t = torch.tensor(k.det, dtype=f32, device=dev)
    res_x = torch.tensor(k.res_x, dtype=f32, device=dev)
    res_y = torch.tensor(k.res_y, dtype=f32, device=dev)
    mi, mf = k.mi, k.mf

    def step(zg: torch.Tensor) -> tuple[torch.Tensor, float]:
        xs = mi[0][0] * X + mi[0][1] * Y + mi[0][2] * zg + mi[0][3]
        ys = mi[1][0] * X + mi[1][1] * Y + mi[1][2] * zg + mi[1][3]
        colp = (k.e * xs - k.b * ys) / det_t + k.col_off
        rowp = (-k.d * xs + k.a * ys) / det_t + k.row_off
        zsrc = interp_rowcol(dem, rowp, colp, method=resampling) - k.cz
        del colp, rowp
        xf = mf[0][0] * xs + mf[0][1] * ys + mf[0][2] * zsrc + mf[0][3]
        yf = mf[1][0] * xs + mf[1][1] * ys + mf[1][2] * zsrc + mf[1][3]
        zg = mf[2][0] * xs + mf[2][1] * ys + mf[2][2] * zsrc + mf[2][3]
        del xs, ys, zsrc
        res = torch.hypot((xf - X) / res_x, (yf - Y) / res_y)
        return zg, float(torch.where(torch.isfinite(zg), res, 0.0).max())

    return step


def _regrid_step_on_card(dem: torch.Tensor, k: _RegridConstants, resampling: str, regrid: Any) -> Callable:
    """Tier 3's step on a contiguous CUDA float32 DEM with linear resampling: each ``step(zg)``
    is one launch of ``csrc/regrid.cu`` on the current stream of the DEM's card, which
    overwrites `zg` with the new guess, then one read of its largest residual. Bit-equal to
    :func:`_regrid_step_aten`; each launch counts in ``LAUNCHES`` and in the span's ``kernel``."""
    # The kernel's constants in the order of its RegridParams, rounded once to float32 as ATen
    # rounds a Python scalar on a float32 tensor.
    params = np.array([k.a, k.b, k.c, k.d, k.e, k.f, *k.mi[0], *k.mi[1], *k.mf[0], *k.mf[1], *k.mf[2], k.det,
                       k.col_off, k.row_off, k.cz, k.res_x, k.res_y], dtype=np.float32)
    maxres = torch.empty((), dtype=torch.float32, device=dem.device)
    launch = _build.load().launch_regrid_step

    def step(zg: torch.Tensor) -> tuple[torch.Tensor, float]:
        with torch.cuda.device(dem.device):
            stream = torch.cuda.current_stream(dem.device).cuda_stream
            rc = launch(dem.data_ptr(), zg.data_ptr(), dem.shape[0], dem.shape[1], params.ctypes.data,
                        maxres.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel regrid_step failed to launch: cudaError {rc}.")
        LAUNCHES["regrid_step"] += 1
        regrid.count("kernel")
        return zg, float(maxres)

    return step


def _iterate_affine_regrid_small_rotations(
    dem: torch.Tensor,
    transform: Affine,
    matrix: np.ndarray,
    centroid: tuple[float, float, float] | None,
    resampling: str = "linear",
    max_iterations: int = 20,
    tolerance: float = 1e-4,
) -> torch.Tensor:
    """Fixed-point inverse regrid for small rotations, on the device of `dem`.

    For each output node (X, Y) seek the source height z whose forward-transformed point lands
    on (X, Y): inverse-transform (X, Y, z_guess), interpolate the DEM there, forward-transform,
    and stop once the largest horizontal residual over the finite pixels is below `tolerance`
    pixels or after `max_iterations` steps (one scalar read per step).

    Everything runs in float32 about the centroid: the large constants (georeferencing
    offsets minus the centroid, the pixel offsets of the centroid) are grouped in float64 on
    the host first, so UTM magnitudes never meet a float32 tensor.

    A CUDA DEM with linear resampling takes each step as one launch of ``csrc/regrid.cu``
    (:func:`_regrid_step_on_card`; a view is copied first, a dtype other than float32 raises);
    nearest and cubic resampling, and a CPU DEM, take the ATen passes of :func:`_regrid_step_aten`.
    """
    if dem.is_cuda and resampling == "linear":
        if dem.dtype != torch.float32:
            raise ValueError(f"Tier 3's step kernel takes a float32 DEM, got {dem.dtype}.")
        dem, make_step = dem.contiguous(), _regrid_step_on_card
    else:
        make_step = _regrid_step_aten

    with span("xdem_tpu_torch.coreg.regrid", devices=[dem.device]) as regrid:
        k = _regrid_constants(transform, matrix, centroid)
        step = make_step(dem, k, resampling, regrid)
        zg = dem - k.cz
        tol32 = float(np.float32(tolerance))
        it, maxres = 0, math.inf
        while it < max_iterations and maxres > tol32:
            zg, maxres = step(zg)
            it += 1
            regrid.count("steps")
        return zg + k.cz


def _apply_matrix_rst(
    dem: torch.Tensor,
    transform: Affine,
    matrix: np.ndarray,
    centroid: tuple[float, float, float] | None = None,
    resampling: str = "linear",
    force_regrid_method: str | None = None,
) -> tuple[torch.Tensor, Affine]:
    """Apply a rigid matrix to a DEM in four tiers: (1) pure z shift, (2) pure translation
    via the georeferencing, (3) small rotations (< 20 degrees about x and y) by the
    fixed-point regrid on the device, (4) large rotations by a host Delaunay regrid."""
    matrix = np.asarray(matrix, dtype=np.float64)
    # Tier 1: vertical shift only
    if np.allclose(matrix, np.diag(np.diag(matrix))) and np.allclose(np.diag(matrix), 1) and np.allclose(
        matrix[:2, 3], 0
    ):
        return dem + matrix[2, 3], transform
    # Tier 2: translation only — update the geotransform, shift z
    if _matrix_is_translation_only(matrix) and force_regrid_method is None:
        return dem + matrix[2, 3], transform.translation(matrix[0, 3], matrix[1, 3])

    _, _, _, a_deg, b_deg, _ = translations_rotations_from_matrix(_make_matrix_valid(matrix))
    small = max(abs(a_deg), abs(b_deg)) < 20.0
    if (small and force_regrid_method is None) or force_regrid_method == "iterative":
        if centroid is None:
            # Re-centre about the raster centre in float64 on the host, exact algebra:
            # R p + t == R (p - c0) + (t + R c0 - c0) + c0.
            h0, w0 = dem.shape
            c0x, c0y = transform.xy((h0 - 1) / 2.0, (w0 - 1) / 2.0)
            c0 = np.array([c0x, c0y, 0.0])
            matrix = matrix.copy()
            matrix[:3, 3] = matrix[:3, 3] + matrix[:3, :3] @ c0 - c0
            centroid = (float(c0x), float(c0y), 0.0)
        return _iterate_affine_regrid_small_rotations(dem, transform, matrix, centroid, resampling=resampling), \
            transform

    # Tier 4: large rotations — host point transform and Delaunay regrid (rare path).
    from scipy.interpolate import griddata

    arr = dem.detach().cpu().numpy().astype(np.float64)
    h, w = arr.shape
    rr, cc = np.nonzero(np.isfinite(arr))
    x, y = transform.xy(rr, cc)
    xt, yt, zt = _apply_matrix_pts_arr(x, y, arr[rr, cc], matrix, centroid=centroid)
    cgrid, rgrid = np.meshgrid(np.arange(w), np.arange(h))
    gx, gy = transform.xy(rgrid, cgrid)
    out = griddata((xt, yt), zt, (gx, gy), method="linear")
    return torch.from_numpy(out.astype(np.float32)).to(dem.device), transform


def _reproject_horizontal_shift_samecrs(raster: torch.Tensor, src_transform: Affine,
                                        dst_transform: Affine | None = None,
                                        resampling: str = "linear") -> torch.Tensor:
    """Subpixel same-CRS horizontal-shift reprojection as a gather interpolation."""
    h, w = raster.shape
    dst_transform = dst_transform or src_transform
    # Compose dst-pixel -> src-pixel on the host in f64: world coordinates in f32 would lose
    # up to ~1 m at UTM northings. The composed affine has small offsets, so f32 grids suffice.
    comp = src_transform.invert() * dst_transform
    a, b, c, d, e, f = (float(v) for v in tuple(comp))
    cols = torch.arange(w, dtype=torch.float32, device=raster.device) + 0.5
    rows = torch.arange(h, dtype=torch.float32, device=raster.device) + 0.5
    rgrid, cgrid = torch.meshgrid(rows, cols, indexing="ij")
    src_col = a * cgrid + b * rgrid + (c - 0.5)
    src_row = d * cgrid + e * rgrid + (f - 0.5)
    return interp_rowcol(raster, src_row, src_col, method=resampling)


def apply_matrix(
    elev: Any,
    matrix: np.ndarray,
    invert: bool = False,
    centroid: tuple[float, float, float] | None = None,
    resample: bool = True,
    resampling: str = "linear",
    transform: Affine | None = None,
    crs: Any = None,
    z_name: str = "z",
    force_regrid_method: str | None = None,
    **kwargs: Any,
) -> Any:
    """Apply a 4x4 rigid transform, about `centroid` (default the origin), to a point cloud
    (a moved copy, float64 on its device), a data frame with x/y columns and the elevation in
    `z_name` (a moved copy, read and written by column), or a gridded DEM (array or tensor
    with `transform`, giving (tensor, transform)).

    `resample=True` resamples a grid back onto the input georeferencing; with
    `resample=False` a translation only moves the returned transform (lossless). `crs` is
    accepted for the signature of xdem_tpu: the matrix acts in the projected coordinates the
    input carries. Other keywords are accepted and ignored, as xdem_tpu ignores them.
    """
    resampling = {"bilinear": "linear", "cubic_spline": "cubic"}.get(resampling, resampling)
    if invert:
        matrix = invert_matrix(matrix)
    if isinstance(elev, PointCloud):
        return _apply_matrix_pts(elev, matrix, centroid=centroid)
    if hasattr(elev, "columns"):  # a data frame: x/y and z_name columns
        cols = {str(c).lower(): c for c in elev.columns}
        xcol, ycol = cols.get("x"), cols.get("y")
        if xcol is None or ycol is None or z_name not in elev.columns:
            raise ValueError(f"Dataframe input needs x/y columns and elevation in z_name={z_name!r}.")
        ox, oy, oz = _apply_matrix_pts_arr(np.asarray(elev[xcol], np.float64), np.asarray(elev[ycol], np.float64),
                                           np.asarray(elev[z_name], np.float64), matrix, centroid=centroid)
        out_df = elev.copy()
        out_df[xcol], out_df[ycol], out_df[z_name] = ox, oy, oz
        return out_df
    if not _is_grid(elev):
        raise ValueError(f"apply_matrix takes a point cloud, a data frame or a 2-D grid, got {type(elev).__name__}.")
    if transform is None:
        raise ValueError("'transform' must be given for array input.")
    transform = _as_affine(transform)
    data, new_transform = _apply_matrix_rst(as_tensor(elev), transform, matrix, centroid=centroid,
                                            resampling=resampling, force_regrid_method=force_regrid_method)
    if resample and not new_transform.almost_equals(transform):
        data = _reproject_horizontal_shift_samecrs(data, new_transform, transform, resampling)
        new_transform = transform
    return data, new_transform


# ------------------------------------------------------------------ input preprocessing


def _as_affine(transform: Any) -> Affine | None:
    """Accept any 6-value affine form (Affine, rasterio-style tuple/list/iterable)."""
    if transform is None or isinstance(transform, Affine):
        return transform
    vals = [float(v) for v in tuple(transform)]
    if len(vals) < 6:
        raise ValueError(f"'transform' must have 6 affine coefficients, got {len(vals)}.")
    return Affine(*vals[:6])


def _is_grid(elev: Any) -> bool:
    return isinstance(elev, Raster) or (not isinstance(elev, PointCloud) and np.ndim(elev) == 2)


def _cast_area_or_point(ref: Raster, tba: Raster) -> str | None:
    """Equal pixel interpretations pass through; a mismatch warns (unless the config says not
    to) and is cast to undefined, as xdem_tpu does."""
    from xdem_tpu_torch.config import config

    if ref.area_or_point == tba.area_or_point:
        return ref.area_or_point
    if config["warn_area_or_point"]:
        warnings.warn(
            f"The reference and to-be-aligned rasters have different pixel interpretations "
            f"({ref.area_or_point!r} vs {tba.area_or_point!r}), which "
            f"implies a half-pixel georeferencing offset between them; the interpretation "
            f"is cast to undefined. Harmonize them before coregistering.",
            UserWarning,
        )
    return None


def _to_crs_of(pc: PointCloud, crs: Any) -> PointCloud:
    """`pc` in `crs` (itself when already there or when `crs` is None)."""
    if crs is None or pc.crs == CRS(crs):
        return pc
    return pc.to_crs(crs)


def _preprocess_coreg_fit(reference_elev: Any, to_be_aligned_elev: Any, inlier_mask: Any,
                          transform: Any, crs: Any = None, area_or_point: str | None = None,
                          ) -> tuple[Any, Any, torch.Tensor | None, Affine, Any, str | None]:
    """Normalize a fit's inputs. Raster-raster: two Rasters (the to-be-aligned one reprojected
    onto the reference grid when they differ), a Raster and an array on its grid, or two
    arrays or tensors with `transform`. Raster-point: the point cloud in the raster's CRS, and
    for a "Point" raster the working transform moved by half a pixel (the gathers assume
    pixel centres). Point-point: the to-be-aligned cloud in the reference's CRS. Returns (ref,
    tba, inlier mask on the raster side's grid, transform, crs, area_or_point), a grid side as
    a tensor and a point side as a PointCloud."""
    transform = _as_affine(transform)
    ref_pts, tba_pts = isinstance(reference_elev, PointCloud), isinstance(to_be_aligned_elev, PointCloud)
    ref_r = reference_elev if isinstance(reference_elev, Raster) else None
    tba_r = to_be_aligned_elev if isinstance(to_be_aligned_elev, Raster) else None
    if ref_pts and tba_pts:
        return reference_elev, _to_crs_of(to_be_aligned_elev, reference_elev.crs), None, transform, \
            reference_elev.crs, area_or_point
    if not all(pts or _is_grid(e) for pts, e in ((ref_pts, reference_elev), (tba_pts, to_be_aligned_elev))):
        raise NotImplementedError(
            "xdem_tpu_torch coregistration takes gridded elevations (Rasters/DEMs, or 2-D arrays or tensors "
            "on one grid) and point clouds (PointCloud/EPC)."
        )
    if ref_pts or tba_pts:
        grid_in = to_be_aligned_elev if ref_pts else reference_elev
        grid_r = grid_in if isinstance(grid_in, Raster) else None
        if grid_r is not None:
            transform, crs, area_or_point = grid_r.transform, grid_r.crs, grid_r.area_or_point
        elif transform is None:
            raise ValueError("'transform' must be given for a plain-array elevation.")
        grid = as_tensor(grid_in)
        pts = _to_crs_of(reference_elev if ref_pts else to_be_aligned_elev, crs)
        mask = mask_on(inlier_mask, grid_r, tuple(grid.shape), grid.device)
        from xdem_tpu_torch.config import config

        if area_or_point == "Point" and config["shift_area_or_point"]:
            t = transform
            transform = t.translation(-0.5 * (t.a + t.b), -0.5 * (t.d + t.e))
        return (pts, grid, mask, transform, crs, area_or_point) if ref_pts else \
            (grid, pts, mask, transform, crs, area_or_point)
    if ref_r is not None and tba_r is not None:
        if ref_r.shape != tba_r.shape or not ref_r.transform.almost_equals(tba_r.transform) or tba_r.crs != ref_r.crs:
            tba_r = tba_r.reproject(ref_r)
        transform, crs = ref_r.transform, ref_r.crs
        area_or_point = _cast_area_or_point(ref_r, tba_r)
    elif ref_r is not None or tba_r is not None:
        # A Raster and a plain array: the raster's georeferencing applies to both grids.
        one = ref_r if ref_r is not None else tba_r
        arr_side = to_be_aligned_elev if ref_r is not None else reference_elev
        if tuple(np.shape(arr_side)) != one.shape:
            raise ValueError(
                f"A plain-array elevation ({tuple(np.shape(arr_side))}) must already be on the "
                f"raster input's grid ({one.shape}); reproject or pass two Rasters."
            )
        if transform is not None:
            warnings.warn("A raster was passed alongside an explicit 'transform'; the raster's own "
                          "transform is used.", UserWarning)
        transform = one.transform
        crs = one.crs if crs is None else crs
        area_or_point = one.area_or_point if area_or_point is None else area_or_point
    elif transform is None:
        raise ValueError("'transform' must be given if both inputs are plain arrays.")
    ref = as_tensor(reference_elev)
    tba = as_tensor(tba_r if tba_r is not None else to_be_aligned_elev, device=ref.device)
    if ref.shape != tba.shape:
        raise ValueError(f"Both elevations must share one grid, got shapes {tuple(ref.shape)} and {tuple(tba.shape)}.")
    mask = mask_on(inlier_mask, ref_r if ref_r is not None else tba_r, tuple(ref.shape), ref.device)
    return ref, tba, mask, transform, crs, area_or_point


def _raster_to_pointcloud(arr: torch.Tensor, transform: Affine, crs: Any) -> PointCloud:
    """The finite pixels of a grid as a point cloud at their centres, on the grid's device."""
    h, w = arr.shape
    idx = torch.nonzero(torch.isfinite(arr.reshape(-1))).reshape(-1)
    x, y = transform.xy(torch.div(idx, w, rounding_mode="floor").to(torch.float64), (idx % w).to(torch.float64))
    return PointCloud(x=x, y=y, z=arr.reshape(-1)[idx], crs=crs if crs is not None else 32633)


def _grid_side(ref: Any, tba: Any) -> torch.Tensor:
    """The gridded elevation of a raster-raster or raster-point pair (the reference when both
    are grids)."""
    return tba if isinstance(ref, PointCloud) else ref


def _bias_vars_on(bias_vars: dict[str, Any] | None, device: torch.device) -> dict[str, torch.Tensor] | None:
    """Bias variables as float32 tensors on `device` (masked arrays NaN-filled, Rasters by
    their data)."""
    if bias_vars is None:
        return None
    return {k: as_tensor(v, device=device) for k, v in bias_vars.items()}


# ------------------------------------------------------------------ pickles of fitted state


class _MetaUnpickler(pickle.Unpickler):
    """Unpickles a saved meta tree: builtins and numpy's array/scalar reconstruction only, so
    loading runs no other code and imports no other package."""

    _ALLOWED = {
        ("builtins", "complex"), ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "slice"), ("builtins", "range"),
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
        ("numpy.random", "default_rng"), ("numpy.random._pickle", "__randomstate_ctor"),
        ("numpy.random._pickle", "__generator_ctor"), ("numpy.random._pickle", "__bit_generator_ctor"),
    }

    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        if module == "pandas" or module.startswith("pandas."):
            raise pickle.UnpicklingError(
                f"This coreg state holds a pandas object ({module}.{name}), such as the "
                "'bin_dataframe' of a binned bias correction saved by xdem_tpu. xdem_tpu_torch does "
                "not use pandas and cannot read it: save the fit in 'fit' mode, or fit it with "
                "xdem_tpu_torch, whose bin tables are dicts of numpy arrays."
            )
        raise pickle.UnpicklingError(f"Refusing to load {module}.{name} from a coreg state file.")


# Modules whose stored callables map onto xdem_tpu_torch.fit (the fit models and optimizers).
_FIT_MODULES = ("xdem_tpu.fit", "xdem_tpu_torch.fit")


def _restore_tree(o: Any) -> Any:
    """Restore a sanitized meta tree. Callables stored by qualified name come back when they
    are numpy's, or a function of ``xdem_tpu.fit`` or ``xdem_tpu_torch.fit`` (both restored
    from ``xdem_tpu_torch.fit``); any other name becomes None."""
    if isinstance(o, dict):
        if set(o.keys()) == {"__callable__"}:
            mod_name, _, qual = o["__callable__"].rpartition(".")
            if mod_name in _FIT_MODULES:
                mod_name = "xdem_tpu_torch.fit"
            elif not (mod_name == "numpy" or mod_name.startswith("numpy.")):
                return None
            obj: Any = importlib.import_module(mod_name)
            for part in qual.split("."):
                obj = getattr(obj, part, None)
            return obj if callable(obj) else None
        return {k: _restore_tree(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_restore_tree(v) for v in o)
    return o


def _sanitize(obj: Any) -> Any:
    """Meta tree with callables replaced by their qualified names (the xdem_tpu format)."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_sanitize(v) for v in obj)
    if callable(obj) and not isinstance(obj, type):
        return {"__callable__": f"{getattr(obj, '__module__', '')}.{getattr(obj, '__qualname__', '')}"}
    return obj


# ------------------------------------------------------------------ metadata typing
# Typed views of the nested Coreg metadata dict, copies of xdem_tpu/coreg/base.py's (held
# equal in keys to the originals by a test). total=False: every key is optional; methods
# populate only the sections they use. Where xdem_tpu keeps a pandas frame under
# "bin_dataframe", the port keeps a dict of numpy arrays.


class InRandomDict(TypedDict, total=False):
    """Inputs associated with randomization and subsampling."""

    subsample: int | float
    random_state: int | np.random.Generator | None


class OutRandomDict(TypedDict, total=False):
    """Outputs associated with randomization and subsampling."""

    subsample_final: int


class InFitOrBinDict(TypedDict, total=False):
    """Inputs associated with binning and/or fitting."""

    fit_or_bin: Literal["fit", "bin", "bin_and_fit"]
    fit_func: Callable[..., Any]
    fit_optimizer: Callable[..., Any]
    fit_minimizer: Callable[..., Any]
    fit_loss_func: Callable[..., Any]
    bin_sizes: int | dict[str, int | Iterable[float]]
    bin_statistic: Callable[..., Any]
    bin_apply_method: Literal["linear", "per_bin"]
    bias_var_names: list[str]
    nd: int | None


class OutFitOrBinDict(TypedDict, total=False):
    """Outputs associated with binning and/or fitting."""

    fit_params: Any
    fit_perr: Any
    bin_dataframe: Any


class InIterativeDict(TypedDict, total=False):
    """Inputs associated with iterative methods."""

    max_iterations: int
    tolerance: float


class OutIterativeDict(TypedDict, total=False):
    """Outputs associated with iterative methods."""

    last_iteration: int
    all_tolerances: list[float]


class InSpecificDict(TypedDict, total=False):
    """Inputs specific to a single method (terrain attribute, angle, poly order, ...)."""

    terrain_attribute: str
    angle: float
    poly_order: int
    best_poly_order: int
    best_nb_sin_freq: int


class OutSpecificDict(TypedDict, total=False):
    """Outputs specific to a single method."""

    partition: Any


class InAffineDict(TypedDict, total=False):
    """Inputs associated with affine methods."""

    vshift_reduc_func: Callable[[Any], Any]
    initial_shift: tuple[float, float] | None
    standardize: bool
    only_translation: bool
    picky: bool


class OutAffineDict(TypedDict, total=False):
    """Outputs associated with affine methods."""

    centroid: tuple[float, float, float]
    matrix: Any
    shift_x: float
    shift_y: float
    shift_z: float


class InputCoregDict(TypedDict, total=False):
    random: InRandomDict
    fitorbin: InFitOrBinDict
    iterative: InIterativeDict
    specific: InSpecificDict
    affine: InAffineDict


class OutputCoregDict(TypedDict, total=False):
    random: OutRandomDict
    fitorbin: OutFitOrBinDict
    iterative: OutIterativeDict
    specific: OutSpecificDict
    affine: OutAffineDict


class CoregDict(TypedDict, total=False):
    """Type of the full metadata dictionary of Coreg classes."""

    inputs: InputCoregDict
    outputs: OutputCoregDict


# ------------------------------------------------------------------ Coreg class


class Coreg:
    """Generic coregistration class with fit/apply and serializable metadata."""

    _fit_called = False
    _is_affine: bool | None = None
    _supports_mesh_fit = False  # True on methods whose fit() honours mesh= (parallel/coreg.py)

    # Known meta keys route to their section; anything else lands in "specific".
    _META_KEY_SECTIONS: dict[str, str] = {
        "subsample": "random", "random_state": "random",
        "fit_or_bin": "fitorbin", "fit_func": "fitorbin", "fit_optimizer": "fitorbin",
        "bin_sizes": "fitorbin", "bin_statistic": "fitorbin",
        "bin_apply_method": "fitorbin", "bias_var_names": "fitorbin", "nd": "fitorbin",
        "max_iterations": "iterative", "tolerance": "iterative",
        "offset_threshold": "iterative",
        "matrix": "affine", "shift_x": "affine", "shift_y": "affine", "shift_z": "affine",
        "centroid": "affine", "only_translation": "affine", "standardize": "affine",
    }

    def __init__(self, meta: dict[str, Any] | None = None):
        inputs: dict[str, dict[str, Any]] = {
            "random": {"subsample": 1.0, "random_state": None},
            "fitorbin": {},
            "iterative": {},
            "specific": {},
            "affine": {},
        }
        if meta:
            for k, v in meta.items():
                section = self._META_KEY_SECTIONS.get(k)
                if section is None:
                    for name, sec in inputs.items():
                        if k in sec:
                            section = name
                            break
                inputs[section or "specific"][k] = v
        self._meta: dict[str, Any] = {"inputs": inputs, "outputs": {}}

    @property
    def meta(self) -> dict[str, Any]:
        return self._meta

    def info(self, as_str: bool = False) -> None | str:
        """Summarize the coreg metadata; print it, or return the text with ``as_str=True``."""
        import json

        text = json.dumps(self._meta, indent=2,
                          default=lambda o: o.tolist() if isinstance(o, np.ndarray) else str(o))
        if as_str:
            return text
        print(text)
        return None

    @property
    def is_affine(self) -> bool:
        if self._is_affine is not None:
            return self._is_affine
        return "affine" in self._meta["outputs"]

    @property
    def is_translation(self) -> bool | None:
        """Whether the fitted transform is a pure translation; None before there is one."""
        try:
            matrix = self.to_matrix()
        except (AttributeError, KeyError, ValueError, NotImplementedError):
            return None
        return bool(np.allclose(np.asarray(matrix)[:3, :3], np.eye(3), rtol=1e-2))

    # ------------------------------- fit / apply

    @_profile("xdem_tpu_torch.coreg.Coreg.fit", memprof=True)
    def fit(
        self,
        reference_elev: Any,
        to_be_aligned_elev: Any,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        weights: np.ndarray | None = None,
        subsample: float | int | None = None,
        transform: Affine | None = None,
        crs: Any = None,
        area_or_point: str | None = None,
        z_name: str = "z",
        random_state: int | None = None,
        **kwargs: Any,
    ) -> "Coreg":
        """Estimate the coregistration from a reference and a to-be-aligned elevation: two
        Rasters (the to-be-aligned one reprojected onto the reference grid when they differ),
        2-D arrays or tensors on the grid `transform` (and `crs`), or a grid and a point cloud
        (PointCloud/EPC, moved to the grid's CRS)."""
        if weights is not None:
            raise NotImplementedError(f"{type(self).__name__} does not support weighted fitting yet; leave weights=None.")
        if kwargs.get("mesh") is not None and not self._supports_mesh_fit:
            # A mesh= the method cannot honour would otherwise look like a working sharded fit.
            raise NotImplementedError(
                f"{type(self).__name__} does not support mesh= fitting; mesh= is available on "
                "every affine method (NuthKaab, VerticalShift, DhMinimize, ICP, CPD, LZD; "
                "BlockwiseCoreg takes mesh= at construction)."
            )
        ref, tba, mask, transform, crs, area_or_point = _preprocess_coreg_fit(
            reference_elev, to_be_aligned_elev, inlier_mask, transform, crs, area_or_point)
        if subsample is not None:
            self._meta["inputs"]["random"]["subsample"] = subsample
        if random_state is not None:
            self._meta["inputs"]["random"]["random_state"] = random_state
        bias_vars = _bias_vars_on(bias_vars, _grid_side(ref, tba).device)

        # Initial shift: pre-translate the to-be-aligned DEM, re-add the shift afterwards.
        initial_shift = self._meta["inputs"].get("affine", {}).get("initial_shift")
        if initial_shift is not None:
            sx0, sy0 = initial_shift[0], initial_shift[1]
            sz0 = initial_shift[2] if len(initial_shift) > 2 else 0.0
            if isinstance(tba, PointCloud):
                tba = tba.translate(sx0, sy0, sz0)
            else:
                tba, _ = apply_matrix(tba, matrix_from_translations_rotations(t_x=sx0, t_y=sy0, t_z=sz0),
                                      transform=transform)

        self._fit_func(ref_elev=ref, tba_elev=tba, inlier_mask=mask, transform=transform,
                       crs=crs, z_name=z_name, bias_vars=bias_vars, **kwargs)
        if initial_shift is not None:
            aff = self._meta["outputs"].get("affine", {})
            for key, add in (("shift_x", sx0), ("shift_y", sy0), ("shift_z", sz0)):
                if key in aff:
                    aff[key] = aff[key] + add
            if "matrix" in aff:
                m = np.asarray(aff["matrix"]).copy()
                m[:3, 3] += [sx0, sy0, sz0]
                aff["matrix"] = m

        # A fit that produced non-finite parameters must not be applied.
        aff_out = self._meta["outputs"].get("affine", {})
        for key in ("matrix", "shift_x", "shift_y", "shift_z"):
            if key in aff_out and not np.all(np.isfinite(np.asarray(aff_out[key]))):
                raise ValueError(
                    f"Coregistration failed: fitted '{key}' contains non-finite values "
                    f"(degenerate input data — check valid-pixel overlap and terrain variety)."
                )
        self._fit_called = True
        return self

    def _fit_func(self, **kwargs: Any) -> None:
        """Dispatch the fit by input types, falling back rst-rst -> rst-pts -> pts-pts: a grid
        the method cannot fit as a grid is turned into points."""
        ref, tba = kwargs["ref_elev"], kwargs["tba_elev"]
        ref_pts, tba_pts = isinstance(ref, PointCloud), isinstance(tba, PointCloud)
        if ref_pts and tba_pts:
            self._fit_pts_pts(**kwargs)
            return
        sub = dict(kwargs)
        if not ref_pts and not tba_pts:
            try:
                self._fit_rst_rst(**kwargs)
                return
            except NotImplementedCoregFit:
                sub["ref_elev"] = _raster_to_pointcloud(ref, kwargs["transform"], kwargs["crs"])
        try:
            self._fit_rst_pts(**sub)
        except NotImplementedCoregFit:
            for key in ("ref_elev", "tba_elev"):
                if not isinstance(sub[key], PointCloud):
                    sub[key] = _raster_to_pointcloud(sub[key], kwargs["transform"], kwargs["crs"])
            self._fit_pts_pts(**sub)

    def _fit_rst_rst(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement raster-raster fit.")

    def _fit_rst_pts(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement raster-point fit.")

    def _fit_pts_pts(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement point-point fit.")

    @_profile("xdem_tpu_torch.coreg.Coreg.apply", memprof=True)
    def apply(
        self,
        elev: Any,
        bias_vars: dict[str, Any] | None = None,
        resample: bool = True,
        resampling: str | None = None,
        transform: Affine | None = None,
        crs: Any = None,
        z_name: str = "z",
        **kwargs: Any,
    ) -> Any:
        """Apply the estimated transform: a Raster gives a Raster (on its grid when
        `resample`), an array or tensor gives (tensor, transform), a point cloud a moved copy.
        `resampling=None` uses the package default (`xdem_tpu_torch.config["resampling"]`)."""
        if not self._fit_called and not (self.is_affine and "matrix" in self._meta["outputs"].get("affine", {})):
            raise AssertionError(".fit() does not seem to have been called yet")
        if resampling is None:
            from xdem_tpu_torch.config import config

            resampling = config["resampling"]
        resampling = {"bilinear": "linear", "cubic_spline": "cubic"}.get(resampling, resampling)
        if isinstance(elev, PointCloud):
            try:
                return self._apply_func(elev=elev, bias_vars=bias_vars, transform=transform, crs=crs,
                                        resample=resample, resampling=resampling, **kwargs)
            except NotImplementedCoregApply:
                if not self.is_affine:
                    raise
                return apply_matrix(elev, self.to_matrix(), centroid=self._meta["outputs"].get("affine", {}).get("centroid"))
        if not _is_grid(elev):
            raise NotImplementedError("xdem_tpu_torch applies a coregistration to Rasters, point clouds, 2-D arrays "
                                      "or tensors.")
        raster = elev if isinstance(elev, Raster) else None
        if raster is not None:
            transform, crs = raster.transform, raster.crs
        else:
            transform = _as_affine(transform)
        elev = as_tensor(elev)
        bias_vars = _bias_vars_on(bias_vars, elev.device)
        try:
            data, new_transform = self._apply_func(elev=elev, bias_vars=bias_vars, transform=transform, crs=crs,
                                                   resample=resample, resampling=resampling, **kwargs)
        except NotImplementedCoregApply:
            if not self.is_affine:
                raise
            data, new_transform = apply_matrix(elev, self.to_matrix(),
                                               centroid=self._meta["outputs"].get("affine", {}).get("centroid"),
                                               resample=resample, resampling=resampling, transform=transform)
        if raster is None:
            return data, new_transform
        out = raster.copy(new_array=data)
        out.transform = new_transform
        return out

    def _apply_func(self, **kwargs: Any) -> Any:
        raise NotImplementedCoregApply(f"{type(self).__name__} has no custom apply.")

    def fit_and_apply(
        self,
        reference_elev: Any,
        to_be_aligned_elev: Any,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        fit_kwargs: dict[str, Any] | None = None,
        apply_kwargs: dict[str, Any] | None = None,
        **kwargs: Any,
    ) -> Any:
        """Fit, then apply to the to-be-aligned DEM (a Raster gives a Raster, an array
        (tensor, transform)). Shared keywords (subsample, transform,
        crs, random_state, ...) passed flat go to fit(), the rest to apply(); transform and
        crs reach both. The explicit fit_kwargs/apply_kwargs dicts take precedence."""
        fkw = {
            k: kwargs.pop(k)
            for k in ("weights", "subsample", "transform", "crs", "area_or_point", "z_name",
                      "random_state", "mesh")
            if k in kwargs
        }
        akw = dict(kwargs)
        for k in ("transform", "crs", "z_name"):
            if k in fkw and k not in akw:
                akw[k] = fkw[k]
        fkw.update(fit_kwargs or {})
        akw.update(apply_kwargs or {})
        self.fit(reference_elev, to_be_aligned_elev, inlier_mask=inlier_mask, bias_vars=bias_vars, **fkw)
        return self.apply(to_be_aligned_elev, bias_vars=bias_vars, **akw)

    def residuals(self, reference_elev: Any, to_be_aligned_elev: Any, **kwargs: Any) -> np.ndarray:
        """Host array of the reference minus the aligned to-be-aligned Raster (keywords go to
        apply)."""
        aligned = self.apply(to_be_aligned_elev, **kwargs)
        if isinstance(reference_elev, Raster) and isinstance(aligned, Raster):
            return (reference_elev - aligned).data.cpu().numpy()
        raise NotImplementedError("Residuals currently require raster inputs.")

    # ------------------------------- serialization of the fitted state

    def save(self, path: str) -> None:
        """Write the fitted state in the pickle format of xdem_tpu's Coreg.save."""
        payload: dict[str, Any] = {"class": type(self).__name__, "meta": _sanitize(self._meta),
                                   "fit_called": self._fit_called}
        steps = getattr(self, "pipeline", None)
        if steps is not None:  # CoregPipeline: the fitted state lives in the steps
            payload["steps"] = [{"class": type(st).__name__, "meta": _sanitize(st._meta),
                                 "fit_called": st._fit_called} for st in steps]
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @classmethod
    def from_meta(cls, meta: dict[str, Any], fit_called: bool = True) -> "Coreg":
        """An instance of this class carrying a (sanitized or live) meta tree."""
        obj = cls()
        obj._meta = _restore_tree(_copy.deepcopy(meta))
        obj._fit_called = bool(fit_called)
        return obj

    @staticmethod
    def load(path: str) -> "Coreg":
        """Load a state written by xdem_tpu's or this package's ``Coreg.save``: the stored
        class name maps onto this package's class of that name."""
        with open(path, "rb") as f:
            payload = _MetaUnpickler(io.BytesIO(f.read())).load()
        if "steps" in payload:
            steps = [_ported_class(st["class"]).from_meta(st["meta"], fit_called=st["fit_called"])
                     for st in payload["steps"]]
            obj = CoregPipeline(steps)
            obj._meta = _restore_tree(_copy.deepcopy(payload["meta"]))
            obj._fit_called = bool(payload["fit_called"])
            return obj
        return _ported_class(payload["class"]).from_meta(payload["meta"], fit_called=payload["fit_called"])

    # ------------------------------- matrix access

    def to_matrix(self) -> np.ndarray:
        """The affine transform matrix of the fitted method."""
        return self._to_matrix_func()

    def to_translations(self) -> tuple[float, float, float]:
        t = translations_rotations_from_matrix(self.to_matrix())
        return t[0], t[1], t[2]

    def to_rotations(self, return_degrees: bool = True) -> tuple[float, float, float]:
        t = translations_rotations_from_matrix(self.to_matrix(), return_degrees=return_degrees)
        return t[3], t[4], t[5]

    def _to_matrix_func(self) -> np.ndarray:
        affine_out = self._meta["outputs"].get("affine", {})
        if "matrix" in affine_out:
            return np.asarray(affine_out["matrix"])
        if {"shift_x", "shift_y", "shift_z"} <= set(affine_out):
            return matrix_from_translations_rotations(
                t_x=affine_out["shift_x"], t_y=affine_out["shift_y"], t_z=affine_out["shift_z"]
            )
        raise NotImplementedError("This coreg method does not produce a transform matrix.")

    # ------------------------------- pipeline composition

    def __add__(self, other: "Coreg") -> "CoregPipeline":
        if not isinstance(other, Coreg):
            raise ValueError(f"Incompatible add type: {type(other)}. Expected 'Coreg' subclass")
        return CoregPipeline([self, other])

    def copy(self) -> "Coreg":
        return _copy.deepcopy(self)


def _ported_class(name: str) -> type:
    """This package's Coreg class of a stored class name."""
    from xdem_tpu_torch import coreg as _coreg_pkg

    cls = getattr(_coreg_pkg, name, None)
    if not (isinstance(cls, type) and issubclass(cls, Coreg)):
        raise NotImplementedError(f"{name!r} is not a Coreg method of xdem_tpu_torch: Coreg.load reads the state "
                                  "of a Coreg or a CoregPipeline.")
    return cls


class CoregPipeline(Coreg):
    """A sequential pipeline of Coreg steps: each step is fitted on the to-be-aligned DEM as
    the steps before it left it, and the applies chain."""

    def __init__(self, pipeline: list[Coreg]):
        self.pipeline = pipeline
        super().__init__()

    def __repr__(self) -> str:
        return f"Pipeline: {self.pipeline}"

    def copy(self) -> "CoregPipeline":
        return CoregPipeline([step.copy() for step in self.pipeline])

    def __iter__(self):
        return iter(self.pipeline)

    def __getitem__(self, idx: int) -> Coreg:
        return self.pipeline[idx]

    def _parse_bias_vars(self, step_idx: int, bias_vars: dict[str, Any] | None) -> dict[str, Any] | None:
        """The bias variables a step needs: none for steps that make their own."""
        step = self.pipeline[step_idx]
        if not getattr(step, "_needs_vars", False) or bias_vars is None:
            return None
        needed = step._meta["inputs"]["fitorbin"].get("bias_var_names")
        if needed is None:
            return bias_vars
        return {k: bias_vars[k] for k in needed if k in bias_vars}

    def fit(self, reference_elev: Any, to_be_aligned_elev: Any, inlier_mask: Any = None,
            bias_vars: dict[str, Any] | None = None, **kwargs: Any) -> "CoregPipeline":
        """Fit each step on the running to-be-aligned DEM; the transform each apply returns
        threads into the next step."""
        tba = to_be_aligned_elev
        apply_kw = {k: kwargs[k] for k in ("transform", "crs", "z_name") if k in kwargs}
        for i, step in enumerate(self.pipeline):
            logging.info("Running pipeline step: %d / %d", i + 1, len(self.pipeline))
            step_bias = self._parse_bias_vars(i, bias_vars)
            step_kwargs = kwargs
            if kwargs.get("mesh") is not None and not step._supports_mesh_fit:
                # mesh= applies to the steps that can shard their fit; the others run on one device.
                logging.info("Pipeline step %d (%s) has no mesh= fit path; running single-device.",
                             i + 1, type(step).__name__)
                step_kwargs = {k: v for k, v in kwargs.items() if k != "mesh"}
            step.fit(reference_elev, tba, inlier_mask=inlier_mask, bias_vars=step_bias, **step_kwargs)
            tba = step.apply(tba, bias_vars=step_bias, **apply_kw)
            if isinstance(tba, tuple):  # an array gives (tensor, transform)
                tba, apply_kw["transform"] = tba
        self._fit_called = True
        return self

    def apply(self, elev: Any, bias_vars: dict[str, Any] | None = None, **kwargs: Any) -> Any:
        """Chain the apply of each step; returns what Coreg.apply returns for `elev`."""
        out = elev
        for i, step in enumerate(self.pipeline):
            out = step.apply(out, bias_vars=self._parse_bias_vars(i, bias_vars), **kwargs)
            if isinstance(out, tuple):
                out, kwargs["transform"] = out
        return out if isinstance(elev, (Raster, PointCloud)) else (out, kwargs["transform"])

    def _to_matrix_func(self) -> np.ndarray:
        """Product of the step matrices."""
        out = np.eye(4)
        for step in self.pipeline:
            out = step.to_matrix() @ out
        return out
