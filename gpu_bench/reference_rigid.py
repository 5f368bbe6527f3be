"""Plain reference of rigid coregistration and of the small-rotation regrid of a DEM.

It imports nothing of the program and computes in the dtype it is given (float64 for the
check, a lower precision for the control). A georeferencing is the six numbers (a, b, c, d,
e, f) of x = a (col + 0.5) + b (row + 0.5) + c, y = d (col + 0.5) + e (row + 0.5) + f; a
rigid matrix is a 4 x 4 float64 numpy array that moves points about a centroid:
p -> R (p - centroid) + t + centroid, R = Rz Ry Rx (extrinsic x, y, z).

ICP (Besl & McKay 1992; point-to-plane after Chen & Medioni 1992, as xdem documents it):
the reference's heights and plane normals and the to-be-aligned heights at a subsample of
the pixels where all are finite; both clouds less the reference cloud's median and over the
mean NMAD of its three coordinates; then, until the step's summed translation falls below
the tolerance (after at least three steps) or for at most `max_iterations`: the
to-be-aligned cloud moved by the running matrix, each point's nearest reference point,
Picky (for each matched reference point only the closest query), and Low's (2004)
linearised point-to-plane step. Normals are xdem's: with (g_row, g_col) the DEM's gradient
per pixel, east = -sin(atan(g_col / yres)), north = sin(atan(g_row / xres)), up = 1 -
hypot(east, north).

LZD (Rosenholm & Torlegård 1988): the to-be-aligned heights at a subsample of the pixels
where both DEMs are finite, about their mean point; until the step's summed translation falls
below the tolerance (after at least three steps) or for at most `max_iterations`: the points
moved by the running matrix, the reference's height and gradient (d/dx, d/dy) there by
bilinear interpolation, and the six-parameter linearised model dh = -gx tx - gy ty + tz +
(y + gy z) wx - (x + gx z) wy + (gx y - gy x) wz solved by least squares.

The regrid: each output node (X, Y) takes the height of the forward-transformed source point
that lands on it; the source point is found by fixed-point steps (inverse-transform (X, Y,
z), read the DEM there, forward-transform, z takes the new height) from the node's own
height, until every finite node's horizontal residual is below `tolerance` pixels. Bilinear,
NaN outside the grid or next to a NaN pixel; computed in row bands.

Departures from xdem's text, none of which changes what is computed:
  * nearest neighbours by a blocked brute search of direct differences (xdem: scipy's
    KD-tree), ties to the lowest reference index; Picky's ties to the lowest query index;
  * every step's least squares is solved in float64 on the host whatever the dtype (torch has
    no solver below float32), on inputs computed in the dtype; the matrices compose in float64;
  * the subsample is xdem's own draw, numpy's ``default_rng(random_state).choice`` over the
    flat indices of the pixels where the fit's inputs are all finite, or explicit (rows,
    cols) so that a test can hand it another draw;
  * the fitted rotation is re-orthogonalised by an SVD (a composed float matrix drifts off
    orthogonality by rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_bench.reference_coreg import bilinear


# ------------------------------------------------------------------ matrices


def rotation_xyz(ax: float, ay: float, az: float) -> np.ndarray:
    """Rz @ Ry @ Rx of three angles in radians."""
    ca, sa, cb, sb, cg, sg = math.cos(ax), math.sin(ax), math.cos(ay), math.sin(ay), math.cos(az), math.sin(az)
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]])
    return rz @ ry @ rx


def rigid(translation, angles_deg=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The 4 x 4 matrix of a translation (m) and rotations about x, y and z (degrees)."""
    m = np.eye(4)
    m[:3, :3] = rotation_xyz(*np.deg2rad(np.asarray(angles_deg, np.float64)))
    m[:3, 3] = translation
    return m


def angles_deg(matrix: np.ndarray) -> np.ndarray:
    """The rotations about x, y and z (degrees) of a rigid matrix, with |y| < 90 degrees."""
    r = np.asarray(matrix, np.float64)[:3, :3]
    return np.rad2deg([math.atan2(r[2, 1], r[2, 2]), math.asin(max(-1.0, min(1.0, -r[2, 0]))),
                       math.atan2(r[1, 0], r[0, 0])])


def _orthogonal(matrix: np.ndarray) -> np.ndarray:
    out = np.asarray(matrix, np.float64).copy()
    u, _, vt = np.linalg.svd(out[:3, :3])
    out[:3, :3] = u @ vt
    return out


def about(matrix: np.ndarray, centroid, point) -> np.ndarray:
    """The same motion as `matrix` about `centroid`, written about `point`."""
    m = np.asarray(matrix, np.float64).copy()
    d = np.asarray(point, np.float64) - np.asarray(centroid, np.float64)
    m[:3, 3] = m[:3, 3] + m[:3, :3] @ d - d
    return m


def gaps(got, want, point) -> tuple[float, float]:
    """(largest translation gap in m, largest rotation gap in degrees) between two (matrix,
    centroid) motions, both written about `point`; inf where either is not finite."""
    a, b = about(*got, point), about(*want, point)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return math.inf, math.inf
    return float(np.max(np.abs(a[:3, 3] - b[:3, 3]))), float(np.max(np.abs(angles_deg(a) - angles_deg(b))))


# ------------------------------------------------------------------ grids and draws


def centre(transform, shape, dem: torch.Tensor) -> tuple[float, float, float]:
    """(x, y) of a grid's centre and the DEM's mean finite height: the point about which a
    tilt is applied and two motions are compared."""
    a, b, c, d, e, f = (float(v) for v in transform)
    h, w = shape
    z = dem.double()
    return a * w / 2 + b * h / 2 + c, d * w / 2 + e * h / 2 + f, float(z[torch.isfinite(z)].mean())


def _xy(transform, rows: torch.Tensor, cols: torch.Tensor):
    a, b, c, d, e, f = (float(v) for v in transform)
    r, q = rows.double() + 0.5, cols.double() + 0.5
    return a * q + b * r + c, d * q + e * r + f


def numpy_draw(valid: torch.Tensor, count: int, random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of xdem's draw of `count` of the True pixels: numpy's
    ``default_rng(random_state).choice`` of their flat indices without replacement (all of
    them where there are no more)."""
    idx = np.flatnonzero(valid.cpu().numpy())
    if int(count) < idx.size:
        idx = np.random.default_rng(random_state).choice(idx, int(count), replace=False)
    return np.unravel_index(idx, tuple(valid.shape))


def _picks(valid: torch.Tensor, count: int, random_state, rows, cols):
    """(rows, cols) of the subsample: the explicit ones, or xdem's draw from `random_state`."""
    if rows is None:
        rows, cols = numpy_draw(valid, count, random_state)
    return torch.as_tensor(rows, device=valid.device).long(), torch.as_tensor(cols, device=valid.device).long()


def _median(v: torch.Tensor) -> torch.Tensor:
    s = torch.sort(v).values
    n = s.numel()
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """The least-squares solution of a x = b, in float64 on the host (numpy's, which repeats
    to the bit; torch's CPU solver does not)."""
    return np.linalg.lstsq(a.double().cpu().numpy(), b.double().cpu().numpy(), rcond=None)[0]


# ------------------------------------------------------------------ ICP


def icp_normals(dem: torch.Tensor, xres: float, yres: float):
    """xdem's plane normals (east, north, up) of a DEM, in its dtype."""
    g_row, g_col = torch.gradient(dem)
    east = -torch.sin(torch.atan(g_col / yres))
    north = torch.sin(torch.atan(g_row / xres))
    return east, north, 1 - torch.hypot(east, north)


def nearest(ref: torch.Tensor, query: torch.Tensor, block: int = 1024):
    """(index, squared distance) of each query point's nearest reference point, (N, 3)
    clouds, by direct differences over blocks of reference points; ties to the lowest index."""
    best_d = torch.full((query.shape[0],), math.inf, dtype=query.dtype, device=query.device)
    best_i = torch.zeros(query.shape[0], dtype=torch.long, device=query.device)
    for k in range(0, ref.shape[0], block):
        d2 = sum((query[:, j, None] - ref[None, k:k + block, j]) ** 2 for j in range(3))
        d, i = torch.min(d2, dim=1)
        take = d < best_d
        best_d, best_i = torch.where(take, d, best_d), torch.where(take, i + k, best_i)
    return best_i, best_d


def picky(ind: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Query indices that are, for their matched reference point, the closest query (ties to
    the lowest query index): stable sorts by distance, then by reference index."""
    order = torch.sort(d2, stable=True).indices
    order = order[torch.sort(ind[order], stable=True).indices]
    si = ind[order]
    first = torch.ones_like(si, dtype=torch.bool)
    first[1:] = si[1:] != si[:-1]
    return order[first]


def icp(ref: torch.Tensor, tba: torch.Tensor, transform, count: int, random_state: int | None = None,
        dtype=torch.float64, rows=None, cols=None, max_iterations: int = 20, tolerance: float = 0.01):
    """Point-to-plane ICP of `tba` onto `ref` (grids on `transform`): (matrix, centroid,
    steps), the matrix moving `tba` onto `ref` about the centroid."""
    z, t = ref.to(dtype), tba.to(dtype)
    xres, yres = math.hypot(float(transform[0]), float(transform[3])), math.hypot(float(transform[1]),
                                                                                  float(transform[4]))
    normals = icp_normals(z, xres, yres)
    valid = torch.isfinite(z) & torch.isfinite(t)
    for v in normals:
        valid &= torch.isfinite(v)
    r, c = _picks(valid, count, random_state, rows, cols)
    x, y = _xy(transform, r, c)
    nrm = torch.stack([v[r, c] for v in normals], 1)
    # The standardisation in float64 (the centroid is a coordinate of 1e5-1e6 m), the clouds in dtype.
    ref64 = torch.stack([x, y, z[r, c].double()], 1)
    mid = torch.stack([_median(ref64[:, k]) for k in range(3)])
    cen = ref64 - mid
    scale = float(torch.stack([1.4826 * _median(torch.abs(cen[:, k] - _median(cen[:, k]))) for k in range(3)]).mean())
    ref_pts = ((ref64 - mid) / scale).to(dtype)
    tba_pts = ((torch.stack([x, y, t[r, c].double()], 1) - mid) / scale).to(dtype)
    tol = tolerance / scale
    matrix = np.eye(4)
    it = 0
    for it in range(1, max_iterations + 1):
        m = torch.as_tensor(matrix, dtype=dtype, device=z.device)
        tq = tba_pts @ m[:3, :3].T + m[:3, 3]
        ind, d2 = nearest(ref_pts, tq)
        keep = picky(ind, d2)
        q, p, n = tq[keep], ref_pts[ind[keep]], nrm[ind[keep]]
        a = torch.cat([torch.linalg.cross(q, n, dim=1), n], 1)
        sol = _lstsq(a, ((p - q) * n).sum(1))
        step = rigid(sol[3:], np.rad2deg(sol[:3]))
        matrix = step @ matrix
        if it >= 3 and abs(float(np.sum(step[:3, 3]))) < tol:
            break
    matrix = _orthogonal(matrix)
    matrix[:3, 3] *= scale
    return matrix, tuple(float(v) for v in mid), it


# ------------------------------------------------------------------ LZD


def lzd(ref: torch.Tensor, tba: torch.Tensor, transform, count: int, random_state: int | None = None,
        dtype=torch.float64, rows=None, cols=None, max_iterations: int = 200, tolerance: float = 0.01):
    """LZD of `tba` onto `ref` (grids on `transform`): (matrix, centroid, steps), the matrix
    moving `tba` onto `ref` about the centroid (the subsample's mean point)."""
    z, t = ref.to(dtype), tba.to(dtype)
    a_, b_, c_, d_, e_, f_ = (float(v) for v in transform)
    xres, yres = math.hypot(a_, d_), math.hypot(b_, e_)
    g_row, g_col = torch.gradient(z)
    gradx, grady = g_col / xres, -g_row / yres  # rows run south
    r, c = _picks(torch.isfinite(z) & torch.isfinite(t), count, random_state, rows, cols)
    x, y = _xy(transform, r, c)
    pz = t[r, c].double()
    cen = (float(x.mean()), float(y.mean()), float(pz.mean()))
    pts = torch.stack([x - cen[0], y - cen[1], pz - cen[2]], 1).to(dtype)
    # Pixel coordinates of a centred point: the inverse georeferencing with the centroid folded in.
    det = a_ * e_ - b_ * d_
    ia, ib, id_, ie = e_ / det, -b_ / det, -d_ / det, a_ / det
    col0 = ia * (cen[0] - c_) + ib * (cen[1] - f_) - 0.5
    row0 = id_ * (cen[0] - c_) + ie * (cen[1] - f_) - 0.5
    matrix = np.eye(4)
    it = 0
    for it in range(1, max_iterations + 1):
        m = torch.as_tensor(matrix, dtype=dtype, device=z.device)
        xc, yc, zc = (pts @ m[:3, :3].T + m[:3, 3]).unbind(1)
        cols_, rows_ = ia * xc + ib * yc + col0, id_ * xc + ie * yc + row0
        h, gx, gy = (bilinear(g, rows_, cols_) for g in (z, gradx, grady))
        dh = h - (zc + cen[2])
        ok = torch.isfinite(dh) & torch.isfinite(gx) & torch.isfinite(gy)
        if not bool(ok.any()):
            break
        xc, yc, zc, dh, gx, gy = (v[ok] for v in (xc, yc, zc, dh, gx, gy))
        a = torch.stack([-gx, -gy, torch.ones_like(gx), yc + gy * zc, -xc - gx * zc, gx * yc - gy * xc], 1)
        sol = _lstsq(a, dh)
        step = rigid(sol[:3], np.rad2deg(sol[3:]))
        matrix = step @ matrix
        if it >= 3 and abs(float(np.sum(sol[:3]))) < tolerance:
            break
    return _orthogonal(matrix), cen, it


# ------------------------------------------------------------------ the regrid


def regrid(dem: torch.Tensor, transform, matrix: np.ndarray, centroid, dtype=torch.float64,
           rows: tuple[int, int] | None = None, tolerance: float = 1e-6, max_iterations: int = 50) -> torch.Tensor:
    """Rows r0:r1 (default all) of `dem` moved by `matrix` about `centroid` and resampled onto
    its own grid, in `dtype`."""
    h, w = dem.shape
    r0, r1 = rows or (0, h)
    a, b, c, d, e, f = (float(v) for v in transform)
    cx, cy, cz = (float(v) for v in centroid)
    fwd = np.asarray(matrix, np.float64)
    inv = np.linalg.inv(fwd)
    det = a * e - b * d
    src = dem if dem.dtype == dtype else dem.to(dtype)
    dev = dem.device
    cc = torch.arange(w, dtype=torch.float64, device=dev)[None, :] + 0.5
    rr = torch.arange(r0, r1, dtype=torch.float64, device=dev)[:, None] + 0.5
    X, Y = (a * cc + b * rr + (c - cx)).to(dtype), (d * cc + e * rr + (f - cy)).to(dtype)
    xres, yres = math.hypot(a, d), math.hypot(b, e)
    # Pixel coordinates of a centred point (x, y): the inverse georeferencing, centroid folded in.
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    col0, row0 = ia * (cx - c) + ib * (cy - f) - 0.5, id_ * (cx - c) + ie * (cy - f) - 0.5
    zg = src[r0:r1] - cz
    for _ in range(max_iterations):
        xs = inv[0, 0] * X + inv[0, 1] * Y + inv[0, 2] * zg + inv[0, 3]
        ys = inv[1, 0] * X + inv[1, 1] * Y + inv[1, 2] * zg + inv[1, 3]
        zs = bilinear(src, id_ * xs + ie * ys + row0, ia * xs + ib * ys + col0) - cz
        xf = fwd[0, 0] * xs + fwd[0, 1] * ys + fwd[0, 2] * zs + fwd[0, 3]
        yf = fwd[1, 0] * xs + fwd[1, 1] * ys + fwd[1, 2] * zs + fwd[1, 3]
        zg = fwd[2, 0] * xs + fwd[2, 1] * ys + fwd[2, 2] * zs + fwd[2, 3]
        res = torch.hypot((xf - X) / xres, (yf - Y) / yres)
        if float(torch.where(torch.isfinite(zg), res, 0.0).max()) < tolerance:
            break
    return zg + cz


def regrid_bands(dem: torch.Tensor, transform, matrix: np.ndarray, centroid, dtype=torch.float64,
                 band_rows: int = 1024) -> torch.Tensor:
    """The whole of `dem` moved by `matrix` about `centroid`, in `dtype`, band by band."""
    src = dem.to(dtype)
    out = torch.empty(dem.shape, dtype=dtype, device=dem.device)
    for r0 in range(0, dem.shape[0], band_rows):
        r1 = min(r0 + band_rows, dem.shape[0])
        out[r0:r1] = regrid(src, transform, matrix, centroid, dtype, rows=(r0, r1))
    return out
