"""Plain reference of xdem's H2022 uncertainty of a DEM pair (Hugonnet et al., 2022): the
error sigma(x, y) and the correlation rho(lag) of the elevation differences.

It imports nothing of the program and computes in the dtype it is given (float64 for the
check, a lower precision for the control); the fill of empty bins and the variogram fit use
scipy on the host, as xdem states them. With dh = other - dem:
  * sigma: slope (degrees) and maximum curvature of `dem`; a seeded draw of `count` pixels
    where dh and both variables are finite; per variable 10 equal bins between the draw's
    extremes; the NMAD of dh in each 2-D bin, bins of fewer than 100 values emptied and filled
    linearly inside the hull of the others, then by the nearest; each pixel's value multilinear
    between the bin mids (flat beyond the outer mids); then the two-step standardization: the
    NMAD of the draw's dh over that value, after dropping the values beyond 7 NMAD, scales it;
  * rho: the variogram of dh / sigma by equidistant disk and ring sampling: runs and samples
    from the subsample as Hugonnet et al. choose them, a disk of radius diagonal / sqrt(2)^10
    and 10 rings each sqrt(2) wider around a seeded valid centre a run, `samples` valid
    pixels of each drawn uniformly by area, pairs of each disk pixel with every pixel of its
    run; Dowd's estimator in lag bins sqrt(2) apart from sqrt(2) pixels to the diagonal (the
    last dropped); a gaussian plus a spherical model fitted by bounded least squares; rho is
    one minus the model over its total sill.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_bench import reference

NMAD_FACTOR = 1.4826
N_BINS = 10
MIN_COUNT = 100
OUTLIERS = 7.0
NB_RINGS = 10


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of the finite values of `x`: the mean of the two middle ones, NaN if none."""
    x = x[torch.isfinite(x)]
    if not x.numel():
        return x.new_tensor(float("nan"))
    s = torch.sort(x).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def nmad(x: torch.Tensor) -> torch.Tensor:
    return NMAD_FACTOR * median(torch.abs(x - median(x)))


def _draw(valid: torch.Tensor, count: int, seed: int) -> torch.Tensor:
    """`count` flat indices of valid pixels, drawn without replacement from `seed`."""
    g = torch.Generator(device=valid.device).manual_seed(int(seed))
    scores = torch.where(valid.reshape(-1), torch.rand(valid.numel(), generator=g, device=valid.device), -1.0)
    return torch.topk(scores, min(count, int(valid.sum())), sorted=False).indices


def _grid_interp(mids_ext: list[torch.Tensor], grid_ext: torch.Tensor, xs: list[torch.Tensor]) -> torch.Tensor:
    """Bilinear interpolation of the (len(m0), len(m1)) grid at (xs[0], xs[1]), flat beyond
    its outer mids; NaN where a coordinate is NaN."""
    idx, frac = [], []
    for m, x in zip(mids_ext, xs):
        i = torch.clamp(torch.searchsorted(m, x.contiguous(), right=True) - 1, 0, m.numel() - 2)
        t = torch.clamp((x - m[i]) / (m[i + 1] - m[i]), 0, 1)
        idx.append(i)
        frac.append(t)
    (i, j), (t, u) = idx, frac
    v = ((grid_ext[i, j] * (1 - u) + grid_ext[i, j + 1] * u) * (1 - t)
         + (grid_ext[i + 1, j] * (1 - u) + grid_ext[i + 1, j + 1] * u) * t)
    return torch.where(torch.isfinite(xs[0]) & torch.isfinite(xs[1]), v, torch.nan)


def _fill(grid: np.ndarray, mids: list[np.ndarray]) -> np.ndarray:
    """Empty bins filled linearly inside the hull of the others, the rest by the nearest."""
    from scipy.interpolate import griddata

    pts = np.stack(np.meshgrid(*mids, indexing="ij"), axis=-1).reshape(-1, 2)
    for method in ("linear", "nearest"):
        valid = np.isfinite(grid)
        if valid.all() or valid.sum() <= (2 if method == "linear" else 0):
            continue
        try:
            filled = griddata(pts[valid.ravel()], grid[valid], pts, method=method).reshape(grid.shape)
        except Exception:  # a degenerate hull: left to the nearest
            continue
        grid = np.where(valid, grid, filled)
    return grid


def sigma(dem: torch.Tensor, other: torch.Tensor, res: float, count: int, seed: int, dtype=torch.float64,
          band_rows: int = 2048) -> torch.Tensor:
    """The error sigma(x, y) of other - dem, in `dtype`, on the DEMs' device."""
    n_r, n_c = dem.shape
    slope = torch.empty((n_r, n_c), dtype=dtype, device=dem.device)
    curv = torch.empty_like(slope)
    for r0 in range(0, n_r, band_rows):
        r1 = min(r0 + band_rows, n_r)
        att = reference.terrain_block(dem, (r0, r1), (0, n_c), res, ["slope", "max_curvature"], dtype)
        slope[r0:r1], curv[r0:r1] = att["slope"], att["max_curvature"]
    dh = other.to(dtype) - dem.to(dtype)
    valid = torch.isfinite(dh) & torch.isfinite(slope) & torch.isfinite(curv)
    pick = _draw(valid, count, seed)
    d, xs = dh.reshape(-1)[pick], [slope.reshape(-1)[pick], curv.reshape(-1)[pick]]

    ids, mids = [], []
    for x in xs:
        lo, hi = x.min(), x.max()
        edges = lo + (hi - lo) * torch.linspace(0, 1, N_BINS + 1, dtype=torch.float64, device=x.device).to(dtype)
        ids.append(torch.clamp(torch.searchsorted(edges, x.contiguous(), right=True) - 1, 0, N_BINS - 1))
        e = edges.double().cpu().numpy()
        mids.append((e[:-1] + e[1:]) / 2)
    flat = ids[0] * N_BINS + ids[1]
    grid = np.full((N_BINS, N_BINS), np.nan)
    for b in torch.unique(flat).tolist():
        vals = d[flat == b]
        if vals.numel() >= MIN_COUNT:
            grid[b // N_BINS, b % N_BINS] = float(nmad(vals))
    grid = _fill(grid, mids)
    mids_ext = [torch.tensor(np.r_[2 * m[0] - m[1], m, 2 * m[-1] - m[-2]], dtype=dtype, device=dem.device)
                for m in mids]
    grid_ext = torch.tensor(np.pad(grid, 1, mode="edge"), dtype=dtype, device=dem.device)

    z = d / _grid_interp(mids_ext, grid_ext, xs)
    z = torch.where(torch.abs(z) > OUTLIERS * nmad(z), torch.nan, z)
    scale = nmad(z)
    out = torch.empty_like(slope)
    for r0 in range(0, n_r, band_rows):
        r1 = min(r0 + band_rows, n_r)
        out[r0:r1] = scale * _grid_interp(mids_ext, grid_ext, [slope[r0:r1], curv[r0:r1]])
    return out


def sampling(shape: tuple[int, int], res: float, subsample: int) -> tuple[int, int, float, float]:
    """(runs, samples, radius of the disk in m, diagonal in m) of the equidistant sampling."""
    per_disk = math.ceil(subsample**2 / (2 * NB_RINGS))
    runs = int(per_disk / 4) if per_disk < 10 else int(min(100, 10 * math.ceil((per_disk / 40) ** (1 / 3))))
    samples = int(math.ceil(math.sqrt(per_disk / runs)))
    diagonal = math.hypot((shape[0] - 1) * res, (shape[1] - 1) * res)
    return runs, samples, diagonal / math.sqrt(2) ** NB_RINGS, diagonal


def _model(h: np.ndarray, r_gauss: float, s_gauss: float, r_sph: float, s_sph: float) -> np.ndarray:
    """A gaussian (effective range r: a = r / 2) plus a spherical (range r) variogram."""
    gauss = s_gauss * (1 - np.exp(-(h**2) / (r_gauss / 2) ** 2)) if r_gauss > 0 else np.where(h > 0, s_gauss, 0.0)
    hr = np.clip(h / r_sph, 0, 1) if r_sph > 0 else np.where(h > 0, 1.0, 0.0)
    return gauss + s_sph * (1.5 * hr - 0.5 * hr**3)


def variogram(z: torch.Tensor, res: float, subsample: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(lags: the right edges of the kept lag bins in m, Dowd's gamma in each) of the grid `z`."""
    n_r, n_c = z.shape
    runs, samples, radius0, diagonal = sampling((n_r, n_c), res, subsample)
    dev = z.device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    valid = torch.isfinite(z)
    if int(valid.sum()) < 2:
        lags = lag_grid((n_r, n_c), res)
        return lags, np.full(len(lags), np.nan)
    centres = _draw(valid, runs, int(torch.randint(0, 2**62, (1,), generator=g, device=dev)))
    cr, cc = (centres // n_c).double(), (centres % n_c).double()
    hi = radius0 / res * math.sqrt(2) ** torch.arange(NB_RINGS + 1, dtype=torch.float64, device=dev)
    lo = torch.cat([hi.new_zeros(1), hi[:-1]])
    m = 8 * samples
    theta = 2 * math.pi * torch.rand((runs, NB_RINGS + 1, m), generator=g, device=dev, dtype=torch.float64)
    u = torch.rand((runs, NB_RINGS + 1, m), generator=g, device=dev, dtype=torch.float64)
    r = torch.sqrt(lo[None, :, None] ** 2 + u * (hi[None, :, None] ** 2 - lo[None, :, None] ** 2))
    ii = torch.round(cr[:, None, None] + r * torch.cos(theta)).long()
    jj = torch.round(cc[:, None, None] + r * torch.sin(theta)).long()
    ok = (ii >= 0) & (ii < n_r) & (jj >= 0) & (jj < n_c)
    ok &= valid[ii.clamp(0, n_r - 1), jj.clamp(0, n_c - 1)]
    first = torch.argsort((~ok).to(torch.int8), dim=-1, stable=True)[..., :samples]  # the first valid ones
    keep = torch.gather(ok, -1, first)
    ii, jj = torch.gather(ii, -1, first), torch.gather(jj, -1, first)
    vals = torch.where(keep, z[ii.clamp(0, n_r - 1), jj.clamp(0, n_c - 1)], torch.nan)
    pos = torch.stack([ii, jj], -1).double() * res

    edges = [0.0, *lag_grid((n_r, n_c), res), diagonal]
    n_bins = len(edges) - 1
    edges_t = torch.tensor(edges, dtype=torch.float64, device=dev)
    a_val, b_val = vals[:, 0], vals.reshape(runs, -1)
    a_pos, b_pos = pos[:, 0], pos.reshape(runs, -1, 2)
    diffs = torch.abs(a_val[:, :, None] - b_val[:, None, :]).reshape(-1)
    dists = torch.cdist(a_pos, b_pos).reshape(-1)
    use = torch.isfinite(diffs) & (dists > 0) & (dists <= diagonal)
    diffs, bins = diffs[use], torch.clamp(torch.searchsorted(edges_t, dists[use], right=True) - 1, 0, n_bins - 1)
    gamma = np.full(n_bins, np.nan)
    order = torch.argsort(bins)
    counts = torch.bincount(bins, minlength=n_bins).tolist()
    for k, part in enumerate(torch.split(diffs[order], counts)):
        if part.numel():
            gamma[k] = 2.198 * float(median(part)) ** 2 / 2
    return np.asarray(edges[1:], dtype=np.float64)[:-1], gamma[:-1]


def rho(z: torch.Tensor, res: float, subsample: int, seed: int):
    """The correlation rho(lag in m) of the standardized grid `z`: a gaussian plus a spherical
    model fitted to its variogram (bounds and start as xdem sets them)."""
    from scipy.optimize import curve_fit

    lags, gamma = variogram(z, res, subsample, seed)
    ok = np.isfinite(gamma)
    if ok.sum() < 4:  # nothing to fit: no correlation
        return lambda h: np.full(np.shape(h), np.nan)
    lags, gamma = lags[ok], gamma[ok]
    n_avg = max(int(np.ceil(len(gamma) / 10)), 1)
    top = float(np.max(np.convolve(gamma, np.ones(n_avg) / n_avg, mode="valid")))
    p0 = [0.5 * lags[-1], 0.5 * top, lags[-1], top]
    bounds = ([0.0] * 4, [lags[-1], top, lags[-1], top])
    cof, _ = curve_fit(lambda h, *p: _model(h, *p), lags, gamma, p0=p0, bounds=bounds, method="trf", maxfev=20000)
    sill = cof[1] + cof[3]
    return lambda h: 1.0 - _model(np.asarray(h, np.float64), *cof) / sill


def lag_grid(shape: tuple[int, int], res: float) -> np.ndarray:
    """The lags (m) at which two correlation functions are compared: the variogram's lag bins'
    right edges, sqrt(2) pixels to the diagonal."""
    diagonal = math.hypot((shape[0] - 1) * res, (shape[1] - 1) * res)
    out, right = [], math.sqrt(2) * res
    while right < diagonal:
        out.append(right)
        right *= math.sqrt(2)
    return np.asarray(out, dtype=np.float64)
