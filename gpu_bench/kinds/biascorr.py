"""Kind "biascorr": xdem's bias corrections of a co-registered DEM pair, one pair a call, a
fresh random_state each call: ``coreg.CoregPipeline([coreg.Deramp(subsample=),
coreg.DirectionalBias(angle=, subsample=), coreg.TerrainBias(subsample=)]).fit`` of the DEM to
correct onto the reference (each step's fit on the DEM as the steps before it left it, then its
apply), then the pipeline's ``.apply`` to the DEM to correct. Every other argument is xdem's
default. The corrected DEM stays on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_bench import inputs
from gpu_bench import reference_biascorr as plain


def biased_pair(n: int, seed_terrain: int, seed_error: int, seed_voids: int, config: dict, transform, device,
                band_rows: int):
    """(reference, DEM to correct, the reference's plain float64 maximum curvature): a seeded
    spectral DEM and the same heights plus the configuration's ramp, along-track undulations
    and curvature bias (computed in float64 in row bands), its elevation error and its voids.
    The undulations' wavelengths scale with the side where it is not the configuration's
    (tests), so that a smaller grid holds as many periods."""
    a = config["assumed"]
    res = float(config["pixel_m"])
    (ref,) = inputs.spectral_dem(n, seed_terrain, device, a["terrain"]["exponent"], a["terrain"]["top_m"])
    curvature = plain.max_curvature(ref, res, torch.float64, band_rows)
    q99 = plain.q99(curvature)
    scale = n / float(config["size_px"])
    sines = [(s["amplitude_m"], s["wavelength_m"] * scale, s["phase_rad"]) for s in a["undulations"]["sines"]]
    angle = float(a["undulations"]["angle_deg"])
    tba = torch.empty_like(ref)
    cols = torch.arange(n, device=device)[None, :]
    for r0 in range(0, n, band_rows):
        r1 = min(r0 + band_rows, n)
        rows = torch.arange(r0, r1, device=device)[:, None]
        bias = (plain.ramp(rows, cols, (n, n), a["ramp"])
                + plain.sum_of_sines(plain.along_track(rows, cols, (n, n), transform, angle), sines)
                + plain.curvature_bias(curvature[r0:r1], a["curvature_bias"]["amplitude_m"], q99))
        tba[r0:r1] = (ref[r0:r1].double() + bias).float()
    tba.add_(inputs.error_field(n, seed_error, device, a["error"], res))
    voids = a["voids"]
    inputs.cut_voids(tba, seed_voids, voids["count"], voids["min_px"], min(voids["max_px"], n // 4))
    return ref, tba, curvature


def models(pipe) -> tuple:
    """(Deramp's coefficients, DirectionalBias's sines, TerrainBias's (edges, counts, medians))
    of a fitted pipeline, as numpy."""
    out = [step.meta["outputs"]["fitorbin"] for step in pipe]
    table, binned = out[2]["bin_dataframe"], pipe[2].meta["inputs"]["fitorbin"]
    name, stat = binned["bias_var_names"][0], binned["bin_statistic"].__name__
    edges = np.r_[np.asarray(table[f"{name}_left"], np.float64), float(np.asarray(table[f"{name}_right"])[-1])]
    return (np.asarray(out[0]["fit_params"], np.float64), np.asarray(out[1]["fit_params"], np.float64),
            (edges, np.asarray(table["count"]), np.asarray(table[stat], np.float64)))


class Work:
    """The pipeline on a pool of biased DEM pairs."""

    def __init__(self, config: dict, mix: dict, seed: int, devices: list[torch.device], size: int | None = None):
        from xdem_tpu_torch import Affine

        self.config, self.mix, self.devices, self.seed = config, mix, devices, seed
        self.n = int(size or config["size_px"])
        self.res = float(config["pixel_m"])
        self.transform = Affine.from_origin(*config["origin_m"], self.res, self.res)
        self.t6 = tuple(self.transform)
        self.angle = float(config["assumed"]["undulations"]["angle_deg"])
        self.subsample = int(config["subsample"])
        self.pixels_per_call = self.n * self.n
        rows = int(mix["check"]["band_rows"])
        self.pool = [biased_pair(self.n, inputs.seed_ints(seed, 1, i), inputs.seed_ints(seed, 12, i),
                                 inputs.seed_ints(seed, 2, i), config, self.t6, devices[0], rows)
                     for i in range(int(mix["pool"]))]

    def random_state(self, i: int) -> int:
        return inputs.seed_ints(self.seed, 5, i) % 2**31

    def call(self, i: int, spans: dict):
        from xdem_tpu_torch import coreg

        ref, tba, _ = self.pool[i % len(self.pool)]
        pipe = coreg.CoregPipeline([coreg.Deramp(subsample=self.subsample),
                                    coreg.DirectionalBias(angle=self.angle, subsample=self.subsample),
                                    coreg.TerrainBias(subsample=self.subsample)])
        pipe.fit(ref, tba, transform=self.transform, crs=self.config["crs"], random_state=self.random_state(i))
        corrected, _ = pipe.apply(tba, transform=self.transform)
        return (*models(pipe), corrected)

    def launches_per_call(self) -> None:
        """The terrain kernels' launches are not counted here (K1 runs inside TerrainBias)."""
        return None

    def keep_inputs(self, indices) -> None:
        keep = {i % len(self.pool) for i in indices}
        self.pool = [p if j in keep else None for j, p in enumerate(self.pool)]

    def check(self, kept: list[tuple[int, tuple]], ref_dtype=torch.float64) -> dict[str, float]:
        """The largest over the kept calls of, stage by stage, each on the program's own input
        to it (the plain apply of the call's own models before it), at the pixels xdem draws
        from the call's random_state:
        "deramp", the largest gap (m) over the grid between the call's ramp and the plain
        Deramp's; "directional", the largest gap (m) between the call's sum of sines and the
        plain DirectionalBias fit of the call's Deramp-corrected DEM, over the grid's
        along-track range on a lattice of at most ``check.lattice_m``; "terrain", the mean gap
        (m) between the call's median table and the plain TerrainBias binning of the call's
        DEM corrected by its Deramp and DirectionalBias, over the bins where the plain one
        holds at least ``check.min_count`` values, each bin weighted by its count (a mean, not
        a widest gap: float32 curvatures move values between sparse bins by rounding);
        "corrected", the corrected DEM's mean
        deviation from the plain apply of the call's three models in turn, over that apply's
        mean magnitude, on the pixels both give finite; "corrected_finite", the share of the
        pixels on whose finiteness the two disagree. A non-finite number reads as inf."""
        chk = self.mix["check"]
        rows = int(chk["band_rows"])
        out = dict.fromkeys(("deramp", "directional", "terrain", "corrected", "corrected_finite"), 0.0)

        def worst(key, value):
            out[key] = max(out[key], value if math.isfinite(value) else math.inf)

        shape = (self.n, self.n)
        s_range = plain.along_track_range(shape, self.t6, self.angle)
        for i, (ramp_got, sines_got, table_got, corrected) in kept:
            ref, tba, curvature = self.pool[i % len(self.pool)]
            state = self.random_state(i)
            worst("deramp", plain.ramp_gap(ramp_got, plain.deramp(ref, tba, self.subsample, state, ref_dtype), shape,
                                           ref.device, rows))
            moved = self.plain_apply(tba, ramp_got, None, ref_dtype, rows)
            sines_want, _ = plain.directional(ref, moved, self.t6, self.angle, self.subsample, state, ref_dtype)
            worst("directional", plain.curve_gap(sines_got, sines_want, s_range, float(chk["lattice_m"])))
            moved = self.plain_apply(moved, None, sines_got, ref_dtype, rows)
            _, counts, medians = plain.terrain(ref, moved, curvature, self.subsample, state, ref_dtype)
            worst("terrain", plain.table_gap(table_got[2], counts, medians, int(chk["min_count"])))
            edges_got, _, medians_got = table_got
            moved += plain.table_apply(plain.max_curvature(moved, self.res, ref_dtype, rows), edges_got,
                                       medians_got).to(moved.dtype)
            for key, v in zip(("corrected", "corrected_finite"), dem_gaps(corrected, moved, rows)):
                worst(key, v)
            del corrected, moved
        return out

    def plain_apply(self, dem: torch.Tensor, ramp, sines, dtype, band_rows: int) -> torch.Tensor:
        """`dem` in `dtype` plus the plain ramp of `ramp` or the plain undulations of `sines`."""
        out = dem.to(dtype, copy=True)
        cols = torch.arange(self.n, device=dem.device)[None, :]
        for r0 in range(0, self.n, band_rows):
            r1 = min(r0 + band_rows, self.n)
            rr = torch.arange(r0, r1, device=dem.device)[:, None]
            if ramp is not None:
                corr = plain.polynomial(ramp, rr, cols)
            else:
                corr = plain.sum_of_sines(plain.along_track(rr, cols, (self.n, self.n), self.t6, self.angle), sines)
            out[r0:r1] += corr.to(dtype)
        return out


def dem_gaps(got: torch.Tensor, want: torch.Tensor, band_rows: int) -> tuple[float, float]:
    """(the mean deviation of `got` from `want` over `want`'s mean magnitude on the pixels both
    give finite, the share of the pixels on whose finiteness they differ), in row bands."""
    dev_sum = mag_sum = 0.0
    mism = 0
    for r0 in range(0, want.shape[0], band_rows):
        g, w = got[r0:r0 + band_rows].to(want.device).double(), want[r0:r0 + band_rows].double()
        both = torch.isfinite(g) & torch.isfinite(w)
        mism += int((torch.isfinite(g) != torch.isfinite(w)).sum())
        dev_sum += float(torch.where(both, (g - w).abs(), 0.0).sum())
        mag_sum += float(torch.where(both, w.abs(), 0.0).sum())
    return (dev_sum / mag_sum if mag_sum else math.inf), mism / want.numel()


def control(work: Work, dtype):
    """The call with the plain Deramp, DirectionalBias and TerrainBias fits and applies in
    `dtype` in the program's place, drawing as the program does."""
    rows = int(work.mix["check"]["band_rows"])

    def call(i, spans):
        ref, tba, _ = work.pool[i % len(work.pool)]
        state = work.random_state(i)
        ramp = plain.deramp(ref, tba, work.subsample, state, dtype)
        moved = work.plain_apply(tba, ramp, None, dtype, rows)
        sines, _ = plain.directional(ref, moved, work.t6, work.angle, work.subsample, state, dtype)
        moved = work.plain_apply(moved, None, sines, dtype, rows)
        table = plain.terrain(ref, moved, plain.max_curvature(ref, work.res, dtype, rows), work.subsample, state,
                              dtype)
        moved += plain.table_apply(plain.max_curvature(moved, work.res, dtype, rows), table[0],
                                   table[2]).to(dtype)
        return ramp, sines.ravel(), table, moved.float()

    return call
