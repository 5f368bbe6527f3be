"""Blockwise (tiled) coregistration: an affine fit per tile, RANSAC planes through the tiles'
shifts, and a warp by the plane shift field.

Port of xdem_tpu/coreg/blockwise.py. ``BlockwiseCoreg.fit`` loops the tiles through the
step's own fit; ``BlockwiseNuthKaab.fit`` solves every uniform tile in one batched Nuth &
Kääb solve on the device of the DEM (``affine._nuth_kaab_solve_batched``), with one seeded
top-k draw per tile from one ``torch.Generator``. The RANSAC is this package's own, in numpy
(there is no scikit-learn dependency): the pre-filter and the small-sample rules of
xdem_tpu's, then scikit-learn's ``RANSACRegressor`` rules with its own draws. ``apply`` and
``apply_tiled`` build the pixel-centre world coordinates and the source positions in float64
on the device, in row bands.
"""

from __future__ import annotations

import functools
import itertools
import logging
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from xdem_tpu_torch.coreg.base import Coreg
from xdem_tpu_torch.ops.interp import interp_rowcol
from xdem_tpu_torch.ops.sampling import seed_from, topk_subsample
from xdem_tpu_torch.raster import Raster, band_coords, mask_on, row_bands

# RANSACRegressor's defaults that the aggregation keeps: three points define a plane, and the
# trial budget shrinks once a consensus makes further trials unlikely to find a better one.
RANSAC_MIN_SAMPLES = 3
RANSAC_STOP_PROBABILITY = 0.99
_EPSILON = np.spacing(1)


class MultiprocConfig:
    """Tile size and output destination of blockwise processing: ``chunk_size`` is the fit
    and apply tile size and ``outfile`` the destination of :meth:`BlockwiseCoreg.apply_tiled`.
    Tiles are solved together on one device, so there is no process pool: a ``cluster``
    raises."""

    def __init__(self, chunk_size: int = 500, outfile: str | Path = "aligned_dem.tif",
                 driver: str = "GTiff", cluster: Any = None):
        if cluster is not None:
            raise ValueError(
                "Process-pool clusters do not exist on this backend: blockwise tiles are "
                "solved together on one device. Leave cluster=None."
            )
        self.chunk_size = int(chunk_size)
        self.outfile = str(outfile)
        self.driver = driver


def _gate_diverged_tiles(shifts_x: np.ndarray, shifts_y: np.ndarray, shifts_z: np.ndarray,
                         block_size: int, res_x: float, res_y: float,
                         shape: tuple[int, int] | None = None,
                         tiling: tuple[int, int] | None = None) -> np.ndarray:
    """NaN-out tiles whose fitted shift exceeds the tile's own extent: a tile cannot evidence
    a translation larger than itself, so such fits are divergent solves on ill-posed tiles.
    Mutates in place and returns the diverged mask.

    When ``shape`` (raster H, W) and ``tiling`` (n_rows, n_cols) are given, edge tiles are
    gated against their actual (clipped) extent. A warning names the gated count, because a
    true displacement larger than one tile trips the same gate as a divergent solve."""
    if shape is not None and tiling is not None:
        n_rows, n_cols = tiling
        h, w = shape
        ti, tj = np.divmod(np.arange(n_rows * n_cols), n_cols)
        tile_h = np.minimum((ti + 1) * block_size, h) - ti * block_size
        tile_w = np.minimum((tj + 1) * block_size, w) - tj * block_size
    else:
        tile_h = tile_w = block_size  # type: ignore[assignment]
    lim_x = tile_w * abs(res_x)
    lim_y = tile_h * abs(res_y)
    with np.errstate(invalid="ignore"):
        diverged = (np.abs(shifts_x) > lim_x) | (np.abs(shifts_y) > lim_y)
    for s in (shifts_x, shifts_y, shifts_z):
        s[diverged] = np.nan
    if diverged.any():
        logging.warning(
            "NaN-gated %d/%d blockwise tile(s) whose fitted shift exceeds the tile's own "
            "extent (~%.0f x %.0f m) — divergent solves on ill-posed tiles. If the TRUE "
            "displacement between the elevations is larger than one tile, enlarge "
            "block_size_fit or pre-align with a global coregistration first.",
            int(diverged.sum()), diverged.size,
            float(block_size * abs(res_x)), float(block_size * abs(res_y)),
        )
    return diverged


def _plane_fit(xy: np.ndarray, z: np.ndarray) -> tuple[float, float, float]:
    """Least-squares plane z = a x + b y + c, solved on centred data as scikit-learn's
    LinearRegression solves it."""
    x_mean, z_mean = xy.mean(axis=0), z.mean()
    coef = np.linalg.lstsq(xy - x_mean, z - z_mean, rcond=None)[0]
    return float(coef[0]), float(coef[1]), float(z_mean - x_mean @ coef)


def _plane_r2(plane: tuple[float, float, float], xy: np.ndarray, z: np.ndarray) -> float:
    """Coefficient of determination of a plane on points (1 for a perfect fit, and for a
    constant z fitted exactly)."""
    res = np.sum((z - (plane[0] * xy[:, 0] + plane[1] * xy[:, 1] + plane[2])) ** 2)
    tot = np.sum((z - z.mean()) ** 2)
    if tot == 0:
        return 1.0 if res == 0 else 0.0
    return float(1 - res / tot)


def _dynamic_max_trials(n_inliers: int, n_samples: int, min_samples: int, probability: float) -> float:
    """Trials after which a draw of `min_samples` inliers has happened with `probability`."""
    nom = max(_EPSILON, 1 - probability)
    denom = max(_EPSILON, 1 - (n_inliers / float(n_samples)) ** min_samples)
    if nom == 1:
        return 0
    if denom == 1:
        return float("inf")
    return abs(float(np.ceil(np.log(nom) / np.log(denom))))


def _ransac_plane(xy: np.ndarray, z: np.ndarray, residual_threshold: float, max_trials: int,
                  random_state: int) -> tuple[float, float, float]:
    """RANSAC plane with RANSACRegressor's rules: planes through three random points, the
    points within `residual_threshold` of a plane are its consensus set; a larger set wins,
    an equal one wins on a higher R^2 of its plane; the trial budget shrinks with the best
    set's size; the answer is the least-squares plane of the winning set."""
    rng = np.random.default_rng(random_state)
    n = len(z)
    best_n, best_score, best_mask = 1, -np.inf, None
    trials, budget = 0, max_trials
    while trials < budget:
        trials += 1
        pick = rng.choice(n, RANSAC_MIN_SAMPLES, replace=False)
        plane = _plane_fit(xy[pick], z[pick])
        inliers = np.abs(z - (plane[0] * xy[:, 0] + plane[1] * xy[:, 1] + plane[2])) <= residual_threshold
        n_in = int(inliers.sum())
        if n_in < best_n:
            continue
        score = _plane_r2(plane, xy[inliers], z[inliers])
        if n_in == best_n and score < best_score:
            continue
        best_n, best_score, best_mask = n_in, score, inliers
        budget = min(budget, _dynamic_max_trials(best_n, n, RANSAC_MIN_SAMPLES, RANSAC_STOP_PROBABILITY))
    if best_mask is None:
        raise ValueError("RANSAC could not find a valid consensus set.")
    return _plane_fit(xy[best_mask], z[best_mask])


def _warp_band(data: torch.Tensor, lo: int, transform: Any, r0: int, r1: int, coeffs, resampling: str,
               apply_z: bool) -> torch.Tensor:
    """Rows [r0, r1) of the warped DEM: the source is read at the pixel centres moved back by
    the plane shift field, from `data` holding source rows [lo, lo + len(data)); the vertical
    plane is added when `apply_z`. Coordinates are float64; the result is float32."""
    (ax, bx, cx), (ay, by, cy), (az, bz, cz) = coeffs
    x, y = band_coords(transform, r0, r1, data.shape[1], data.device)
    src_r, src_c = transform.rowcol(x - (ax * x + bx * y + cx), y - (ay * x + by * y + cy))
    out = interp_rowcol(data, src_r - lo, src_c, method=resampling)
    if apply_z:
        out = out + (az * x + bz * y + cz)
    return out.to(torch.float32)


class BlockwiseCoreg:
    """Tile-by-tile coregistration: an affine step fitted per tile, aggregated by RANSAC
    planes of the tiles' shifts.

    ``mp_config`` / ``parent_path`` set the streamed output of :meth:`apply_tiled` (at most
    one of the two; ``mp_config.chunk_size`` sets the tile sizes). Both may be omitted: the
    in-memory :meth:`apply` needs no output file.
    """

    def __init__(
        self,
        step: Coreg,
        block_size_fit: int = 500,
        block_size_apply: int = 500,
        mp_config: MultiprocConfig | None = None,
        parent_path: str | None = None,
    ):
        if mp_config is not None and parent_path is not None:
            raise ValueError("Pass at most one of 'mp_config' and 'parent_path'.")
        if isinstance(step, type):
            raise ValueError(
                "The 'step' argument must be an instantiated Coreg subclass. Hint: write e.g. ICP() instead of ICP"
            )
        if not step.is_affine:
            raise ValueError("The blockwise coregistration only supports affine coregistration methods.")
        inputs = step.meta.get("inputs", {})
        only_translation = inputs.get("specific", {}).get(
            "only_translation", inputs.get("affine", {}).get("only_translation", True)
        )
        if not only_translation:
            raise ValueError(
                "Blockwise aggregation fits planes through per-tile translations, so the step "
                "must be translation-only. Construct it with only_translation=True."
            )
        self.procstep = step
        self.block_size_fit = block_size_fit
        self.block_size_apply = block_size_apply
        from xdem_tpu_torch.coreg.affine import NuthKaab

        self.apply_z_correction = step.vertical_shift if isinstance(step, NuthKaab) else True

        self.mp_config: MultiprocConfig | None = None
        self.parent_path: Path | None = None
        self.output_path_aligned: Path | None = None
        if mp_config is not None:
            if not hasattr(mp_config, "outfile"):
                raise TypeError(
                    "mp_config must provide an 'outfile' attribute (and optionally "
                    "'chunk_size'): use xdem_tpu_torch.coreg.MultiprocConfig."
                )
            self.mp_config = mp_config
            chunk = getattr(mp_config, "chunk_size", None)
            if chunk:
                self.block_size_fit = self.block_size_apply = int(chunk)
            self.parent_path = Path(mp_config.outfile).parent
            self.output_path_aligned = Path(mp_config.outfile)
        elif parent_path is not None:
            self.parent_path = Path(parent_path)
            self.output_path_aligned = self.parent_path / "aligned_dem.tif"
        if self.parent_path is not None:
            os.makedirs(self.parent_path, exist_ok=True)

        self.meta: dict[str, Any] = {"inputs": {}, "outputs": {}}
        self.shape_tiling_grid = (0, 0)

    @staticmethod
    def _on_ref_grid(ref: Raster, tba: Raster) -> Raster:
        if tba.shape != ref.shape or not tba.transform.almost_equals(ref.transform) or tba.crs != ref.crs:
            return tba.reproject(ref)
        return tba

    def fit(self, reference_elev: Raster, to_be_aligned_elev: Raster, inlier_mask: Any = None) -> "BlockwiseCoreg":
        """Fit the per-tile shifts on a tiling of the reference grid, one step fit per tile
        (edge tiles clipped); a tile whose fit fails gets NaN shifts."""
        self.meta["inputs"] = self.procstep.meta["inputs"]
        ref = reference_elev
        tba = self._on_ref_grid(ref, to_be_aligned_elev)
        h, w = ref.shape
        mask = mask_on(inlier_mask, ref, (h, w), ref.data.device)
        bs = self.block_size_fit
        n_rows, n_cols = int(np.ceil(h / bs)), int(np.ceil(w / bs))
        self.shape_tiling_grid = (n_rows, n_cols)

        xs, ys, sxs, sys_, szs = [], [], [], [], []
        for ti, tj in itertools.product(range(n_rows), range(n_cols)):
            r0, r1 = ti * bs, min((ti + 1) * bs, h)
            c0, c1 = tj * bs, min((tj + 1) * bs, w)
            ref_tile = ref.icrop((r0, r1), (c0, c1))
            tba_tile = tba.icrop((r0, r1), (c0, c1))
            mask_tile = mask[r0:r1, c0:c1] if mask is not None else None
            shift = (np.nan, np.nan, np.nan)
            if bool(torch.isfinite(ref_tile.data).any()) and bool(torch.isfinite(tba_tile.data).any()):
                step = self.procstep.copy()
                try:
                    step.fit(ref_tile, tba_tile, inlier_mask=mask_tile)
                    aff = step.meta["outputs"]["affine"]
                    shift = (aff.get("shift_x", np.nan), aff.get("shift_y", np.nan), aff.get("shift_z", np.nan))
                except (ValueError, TypeError) as e:
                    logging.error("Failed to fit tile (%d, %d): %s", ti, tj, e)
            x, y = ref.transform.xy(r0 + bs / 2, c0 + bs / 2, offset="ul")
            xs.append(x)
            ys.append(y)
            sxs.append(shift[0])
            sys_.append(shift[1])
            szs.append(shift[2])
            self.meta["outputs"][f"{ti}_{tj}"] = {"shift_x": shift[0], "shift_y": shift[1], "shift_z": shift[2]}

        self.x_coords, self.y_coords = np.asarray(xs), np.asarray(ys)
        self.shifts_x, self.shifts_y, self.shifts_z = np.asarray(sxs), np.asarray(sys_), np.asarray(szs)
        diverged = _gate_diverged_tiles(self.shifts_x, self.shifts_y, self.shifts_z, bs, ref.transform.xres,
                                        ref.transform.yres, shape=(h, w), tiling=(n_rows, n_cols))
        for t in np.flatnonzero(diverged):
            self.meta["outputs"][f"{t // n_cols}_{t % n_cols}"] = {"shift_x": np.nan, "shift_y": np.nan,
                                                                     "shift_z": np.nan}
        self.meta["outputs"]["n_diverged"] = int(diverged.sum())
        return self

    @staticmethod
    def _ransac(
        x_coords: np.ndarray,
        y_coords: np.ndarray,
        shifts: np.ndarray,
        threshold: float = 0.01,
        max_iterations: int = 2000,
        random_state: int = 42,
    ) -> tuple[float, float, float]:
        """Robust plane shift = a*x + b*y + c through the tiles' shifts, seeded so that apply
        is deterministic. Gross outliers go first (beyond 3 NMAD of the median); fewer than 6
        tiles give the median as a constant shift; tiles on one row or one column give a line;
        otherwise RANSAC with the threshold raised to the NMAD."""
        if np.isnan(shifts).all():
            shifts = np.zeros_like(shifts)
        points = np.column_stack([x_coords, y_coords, shifts])
        points = points[~np.isnan(points).any(axis=1)]
        if points.size == 0:
            raise ValueError("No valid points after removing NaNs.")
        med = np.median(points[:, 2])
        nmad = 1.4826 * np.median(np.abs(points[:, 2] - med))
        keep = np.abs(points[:, 2] - med) <= max(3 * nmad, threshold, 1e-9)
        if keep.sum() >= 2:
            points = points[keep]
        if points.shape[0] < 6:
            return 0.0, 0.0, float(np.median(points[:, 2]))
        threshold = max(threshold, nmad)
        if points.shape[0] < 3 or np.allclose(points[:, 1], points[0, 1]):
            if points.shape[0] == 1:
                return 0.0, 0.0, float(points[0, 2])
            a, c = np.polyfit(points[:, 0], points[:, 2], 1)
            return float(a), 0.0, float(c)
        if np.allclose(points[:, 0], points[0, 0]):
            b, c = np.polyfit(points[:, 1], points[:, 2], 1)
            return 0.0, float(b), float(c)
        return _ransac_plane(points[:, :2], points[:, 2], threshold, max_iterations, random_state)

    def ransac_all(self, threshold: float = 0.01,
                   max_iterations: int = 2000) -> tuple[tuple[float, float, float], ...]:
        coeff_x = self._ransac(self.x_coords, self.y_coords, self.shifts_x, threshold, max_iterations)
        coeff_y = self._ransac(self.x_coords, self.y_coords, self.shifts_y, threshold, max_iterations)
        coeff_z = self._ransac(self.x_coords, self.y_coords, self.shifts_z, threshold, max_iterations)
        return coeff_x, coeff_y, coeff_z

    def apply(self, to_be_aligned_elev: Raster, resampling: str = "linear",
              threshold_ransac: float = 0.01, max_iterations_ransac: int = 2000) -> Raster:
        """Warp with the plane shift field on the DEM's device: every pixel reads the source
        at its centre moved back by (sx, sy), gains sz, in row bands with float64
        coordinates. ``threshold_ransac`` / ``max_iterations_ransac`` tune the planes'
        consensus."""
        elev = to_be_aligned_elev
        coeffs = self.ransac_all(threshold_ransac, max_iterations_ransac)
        h, w = elev.shape
        out = torch.empty((h, w), dtype=torch.float32, device=elev.data.device)
        for r0, r1 in row_bands((h, w)):
            out[r0:r1] = _warp_band(elev.data, 0, elev.transform, r0, r1, coeffs, resampling,
                                    self.apply_z_correction)
        return elev.copy(new_array=out)

    def fit_and_apply(self, reference_elev: Raster, to_be_aligned_elev: Raster,
                      inlier_mask: Any = None) -> Raster:
        self.fit(reference_elev, to_be_aligned_elev, inlier_mask=inlier_mask)
        return self.apply(to_be_aligned_elev)

    def apply_tiled(self, elev: Raster, out_path: str | None = None, tile_rows: int = 1024,
                    resampling: str = "linear", nodata: float = -9999.0) -> str:
        """Warp in bands of `tile_rows` rows streamed into a GeoTIFF: each band reads only its
        source rows plus a halo bounded by the shift plane's extremes (at the raster's
        corners), so the device holds one band at a time. The output equals :meth:`apply`'s.

        ``out_path`` defaults to the destination set at construction (``mp_config`` /
        ``parent_path``)."""
        from xdem_tpu_torch.io import StreamingRasterWriter

        if out_path is None:
            if self.output_path_aligned is None:
                raise ValueError(
                    "No output destination: pass out_path=, or construct the BlockwiseCoreg "
                    "with mp_config=/parent_path=."
                )
            out_path = str(self.output_path_aligned)
        coeffs = self.ransac_all()
        coeff_y = coeffs[1]
        h, w = elev.shape
        t = elev.transform
        corners_x, corners_y = zip(*(t.xy(r, c) for r in (0, h) for c in (0, w)))
        cx, cy = np.asarray(corners_x, np.float64), np.asarray(corners_y, np.float64)
        max_sy = float(np.max(np.abs(coeff_y[0] * cx + coeff_y[1] * cy + coeff_y[2])))
        halo = int(np.ceil(max_sy / abs(t.yres))) + 2
        with StreamingRasterWriter(out_path, (h, w), t, crs=elev.crs, nodata=nodata) as writer:
            for r0 in range(0, h, tile_rows):
                r1 = min(h, r0 + tile_rows)
                lo, hi = max(0, r0 - halo), min(h, r1 + halo)
                out = _warp_band(elev.data[lo:hi], lo, t, r0, r1, coeffs, resampling, self.apply_z_correction)
                writer.write_rows(r0, out.cpu().numpy())
        return out_path


def _tile_picks(valid_tiles: torch.Tensor, count: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile seeded subsample of (T, P) valid masks: (T, count) flat positions in each
    tile and whether each pick is valid, from one generator on the masks' device."""
    generator = torch.Generator(device=valid_tiles.device).manual_seed(seed)
    return topk_subsample(generator, valid_tiles, count)


def _tiles(a: torch.Tensor, bs: int, n_rows: int, n_cols: int) -> torch.Tensor:
    """(n_rows * n_cols, bs, bs) uniform tiles of a grid, row-major; edge remainders dropped."""
    return (a[: n_rows * bs, : n_cols * bs].reshape(n_rows, bs, n_cols, bs).transpose(1, 2)
            .reshape(n_rows * n_cols, bs, bs))


def _blockwise_nuth_kaab_inputs(ref: torch.Tensor, tba: torch.Tensor, inlier: torch.Tensor, seed: int, bs: int,
                                n_rows: int, n_cols: int, count: int) -> dict[str, torch.Tensor]:
    """The batched solve's inputs: slope and aspect of the reference, per-tile picks, and
    the tiles of the to-be-aligned DEM. Picks beyond a tile's valid pixels are NaN-poisoned,
    so neither the medians nor the fit see them."""
    from xdem_tpu_torch.coreg.affine import _nk_slope_aspect_valid

    slope_tan, aspect, valid = _nk_slope_aspect_valid(ref, tba, inlier)
    n_tiles = n_rows * n_cols
    vt = _tiles(valid, bs, n_rows, n_cols).reshape(n_tiles, -1)
    idx, ok = _tile_picks(vt, count, seed)

    def pick(a: torch.Tensor) -> torch.Tensor:
        return torch.gather(_tiles(a, bs, n_rows, n_cols).reshape(n_tiles, -1), 1, idx)

    return {
        "pts_z": torch.where(ok, pick(ref), torch.nan),
        "rows": torch.div(idx, bs, rounding_mode="floor").to(torch.float32),
        "cols": (idx % bs).to(torch.float32),
        "rasters": _tiles(tba, bs, n_rows, n_cols).contiguous(),
        "slope_tan": torch.where(ok, pick(slope_tan), torch.nan),
        "aspect": pick(aspect),
        "n_valid": vt.sum(dim=1),
    }


class BlockwiseNuthKaab(BlockwiseCoreg):
    """Blockwise Nuth & Kääb with every tile solved together: the raster is cut into uniform
    tiles, a fixed-size subsample is drawn per tile, and one batched solve runs every tile's
    iterations (a tile that has converged keeps its values while the others go on).
    Aggregation and apply are BlockwiseCoreg's."""

    def __init__(self, block_size_fit: int = 500, block_size_apply: int = 500,
                 subsample_per_tile: int = 20000, max_iterations: int = 10,
                 tolerance: float = 0.001, random_state: int | None = None,
                 mesh: Any = None, mp_config: MultiprocConfig | None = None,
                 parent_path: str | None = None):
        from xdem_tpu_torch.coreg.affine import NuthKaab

        super().__init__(NuthKaab(max_iterations=max_iterations, offset_threshold=tolerance),
                         block_size_fit=block_size_fit, block_size_apply=block_size_apply,
                         mp_config=mp_config, parent_path=parent_path)
        self.subsample_per_tile = subsample_per_tile
        self.random_state = random_state
        self.mesh = mesh

    def fit(self, reference_elev: Raster, to_be_aligned_elev: Raster, inlier_mask: Any = None) -> "BlockwiseNuthKaab":
        from xdem_tpu_torch.coreg.affine import _nuth_kaab_solve_batched
        from xdem_tpu_torch.parallel.coreg import nuth_kaab_batched_sharded

        ref = reference_elev
        tba = self._on_ref_grid(ref, to_be_aligned_elev)
        h, w = ref.shape
        bs = self.block_size_fit
        n_rows, n_cols = h // bs, w // bs  # uniform full tiles only (edges folded into RANSAC)
        if n_rows == 0 or n_cols == 0:
            raise ValueError(f"Raster {ref.shape} smaller than block_size_fit={bs}.")
        self.shape_tiling_grid = (n_rows, n_cols)
        n_tiles = n_rows * n_cols
        xs, ys = zip(*(ref.transform.xy(ti * bs + bs / 2, tj * bs + bs / 2, offset="ul")
                       for ti in range(n_rows) for tj in range(n_cols)))
        res_x, res_y = ref.transform.xres, ref.transform.yres
        it_cfg = self.procstep.meta["inputs"]["iterative"]
        dev = ref.data.device
        inlier = mask_on(inlier_mask, ref, (h, w), dev)
        if inlier is None:
            inlier = torch.ones((h, w), dtype=torch.bool, device=dev)
        tiles = _blockwise_nuth_kaab_inputs(ref.data.to(torch.float32), tba.data.to(torch.float32), inlier,
                                            seed_from(self.random_state), bs, n_rows, n_cols,
                                            min(self.subsample_per_tile, bs * bs))
        solve = _nuth_kaab_solve_batched if self.mesh is None else functools.partial(nuth_kaab_batched_sharded,
                                                                                        mesh=self.mesh)
        sx, sy, vs, _stat, _it = solve(
            tiles["pts_z"], tiles["rows"], tiles["cols"], tiles["rasters"], tiles["slope_tan"], tiles["aspect"],
            res_x, res_y, it_cfg["tolerance"], max_iterations=int(it_cfg["max_iterations"]))
        sx, sy, vs, n_valid_t = (torch.stack([sx, sy, vs, tiles["n_valid"].to(torch.float32)])
                                 .to(torch.float64).cpu().numpy())
        # Nuth & Kääb's sampling offsets become apply translations (the sign flip of the
        # single-tile class).
        self.x_coords, self.y_coords = np.asarray(xs), np.asarray(ys)
        self.shifts_x, self.shifts_y, self.shifts_z = -sx, -sy, vs.copy()
        empty = n_valid_t < 100  # the sparse-tile gate
        for s in (self.shifts_x, self.shifts_y, self.shifts_z):
            s[empty] = np.nan
        diverged = _gate_diverged_tiles(self.shifts_x, self.shifts_y, self.shifts_z, bs, res_x, res_y)
        self.meta["inputs"] = self.procstep.meta["inputs"]
        self.meta["outputs"]["n_diverged"] = int(diverged.sum())
        for t in range(n_tiles):
            self.meta["outputs"][f"{t // n_cols}_{t % n_cols}"] = {
                "shift_x": self.shifts_x[t], "shift_y": self.shifts_y[t], "shift_z": self.shifts_z[t],
            }
        return self
