"""Kind "rigid": rigid coregistration of a tilted DEM pair, one pair a call, a fresh
random_state each call: ``(coreg.ICP(subsample=) + coreg.LZD(subsample=)).fit`` of the
to-be-aligned DEM onto the reference (ICP's fit, its apply, LZD's fit and its apply), then the
pipeline's ``.apply`` to the to-be-aligned DEM (ICP's apply, then LZD's). Every apply of a
rotation takes the small-rotation regrid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpu_bench import inputs, reference_rigid


def tilted_pair(n: int, seed_terrain: int, seed_error: int, seed_voids: int, config: dict, transform, device,
                band_rows: int):
    """(reference, to-be-aligned, centre): a seeded spectral DEM, the same surface moved by the
    configuration's rigid motion about its centre (the plain float64 regrid, in row bands), plus
    its elevation error and its voids; `centre` is the tile's centre at the reference's mean height."""
    terrain_cfg, voids, rigid = config["assumed"]["terrain"], config["assumed"]["voids"], config["assumed"]["rigid"]
    (ref,) = inputs.spectral_dem(n, seed_terrain, device, terrain_cfg["exponent"], terrain_cfg["top_m"])
    centre = reference_rigid.centre(transform, ref.shape, ref)
    motion = reference_rigid.rigid(rigid["translation_m"], rigid["rotation_deg"])
    tba = reference_rigid.regrid_bands(ref, transform, motion, centre, torch.float64, band_rows).float()
    tba.add_(inputs.error_field(n, seed_error, device, rigid["error"], float(config["pixel_m"])))
    inputs.cut_voids(tba, seed_voids, voids["count"], voids["min_px"], min(voids["max_px"], n // 4))
    return ref, tba, centre


class Work:
    """The pipeline on a pool of tilted DEM pairs."""

    def __init__(self, config: dict, mix: dict, seed: int, devices: list[torch.device], size: int | None = None):
        from xdem_tpu_torch import Affine

        self.config, self.mix, self.devices, self.seed = config, mix, devices, seed
        self.n = int(size or config["size_px"])
        res = float(config["pixel_m"])
        self.transform = Affine.from_origin(*config["origin_m"], res, res)
        self.t6 = tuple(self.transform)
        self.pixels_per_call = self.n * self.n
        rows = int(mix["check"]["band_rows"])
        self.pool = [tilted_pair(self.n, inputs.seed_ints(seed, 1, i), inputs.seed_ints(seed, 12, i),
                                 inputs.seed_ints(seed, 2, i), config, self.t6, devices[0], rows)
                     for i in range(int(mix["pool"]))]

    def random_state(self, i: int) -> int:
        return inputs.seed_ints(self.seed, 5, i) % 2**31

    def call(self, i: int, spans: dict):
        from xdem_tpu_torch import coreg

        ref, tba, _ = self.pool[i % len(self.pool)]
        pipe = coreg.ICP(subsample=self.mix["icp"]["subsample"]) + coreg.LZD(subsample=self.mix["lzd"]["subsample"])
        pipe.fit(ref, tba, transform=self.transform, crs=self.config["crs"], random_state=self.random_state(i))
        aligned, _ = pipe.apply(tba, transform=self.transform)
        motion = [(step.to_matrix(), step.meta["outputs"]["affine"]["centroid"]) for step in pipe]
        return motion[0], motion[1], aligned

    def launches_per_call(self) -> None:
        """No terrain kernel runs here."""
        return None

    def keep_inputs(self, indices) -> None:
        keep = {i % len(self.pool) for i in indices}
        self.pool = [p if j in keep else None for j, p in enumerate(self.pool)]

    def check(self, kept: list[tuple[int, tuple]], ref_dtype=torch.float64) -> dict[str, float]:
        """The largest over the kept calls of: "icp_t" and "icp_r", the largest translation (m)
        and rotation (degrees) gaps between the call's ICP motion and the plain ICP's on the same
        pair and the same pixels (xdem's draw from the call's random_state), both written about
        the tile's centre; "lzd_t" and "lzd_r", the same for LZD against the plain LZD on the
        plain regrid of the pair by the call's own ICP motion (its draw from the same
        random_state over that regrid's pixels, which the program's ICP apply leaves finite but
        for a few at void borders), so that they read LZD alone; "regrid", the aligned DEM's
        mean deviation from the plain regrid of the call's own two motions applied in turn, over
        that regrid's mean magnitude, on the pixels both give finite; "regrid_finite", the share
        of the pixels on whose finiteness the two disagree (apart, so that a few pixels at a
        void's border, which rounding may put on either side, do not hide a deviation). The
        chain is so checked stage by stage, each stage on the program's own input to it, and not
        end to end. A non-finite number reads as inf."""
        rows = int(self.mix["check"]["band_rows"])
        icp_n, lzd_n = int(self.mix["icp"]["subsample"]), int(self.mix["lzd"]["subsample"])
        out = dict.fromkeys(("icp_t", "icp_r", "lzd_t", "lzd_r", "regrid", "regrid_finite"), 0.0)

        def worst(key, value):
            out[key] = max(out[key], value if math.isfinite(value) else math.inf)

        for i, (icp_got, lzd_got, aligned) in kept:
            ref, tba, centre = self.pool[i % len(self.pool)]
            state = self.random_state(i)
            icp_want = reference_rigid.icp(ref, tba, self.t6, icp_n, state, ref_dtype)[:2]
            for key, v in zip(("icp_t", "icp_r"), reference_rigid.gaps(icp_got, icp_want, centre)):
                worst(key, v)
            if not all(np.isfinite(np.asarray(m)).all() for m, _ in (icp_got, lzd_got)):
                for key in ("lzd_t", "lzd_r", "regrid", "regrid_finite"):
                    worst(key, math.inf)
                continue
            moved = reference_rigid.regrid_bands(tba, self.t6, *icp_got, ref_dtype, rows)
            lzd_want = reference_rigid.lzd(ref, moved, self.t6, lzd_n, state, ref_dtype)[:2]
            for key, v in zip(("lzd_t", "lzd_r"), reference_rigid.gaps(lzd_got, lzd_want, centre)):
                worst(key, v)
            gaps = regrid_gaps(aligned, moved, self.t6, lzd_got, ref_dtype, rows)
            for key, v in zip(("regrid", "regrid_finite"), gaps):
                worst(key, v)
            del aligned, moved
        return out


def regrid_gaps(aligned, moved: torch.Tensor, transform, second, ref_dtype, band_rows: int) -> tuple[float, float]:
    """The gaps of an aligned DEM to the plain regrid of `moved` (the plain regrid of the
    to-be-aligned DEM by the call's first motion) by the (matrix, centroid) motion `second`:
    (the mean deviation over the result's mean magnitude on the pixels both give finite, the
    share of the pixels on whose finiteness they differ)."""
    dev_sum = mag_sum = 0.0
    mism = 0
    for r0 in range(0, moved.shape[0], band_rows):
        r1 = min(r0 + band_rows, moved.shape[0])
        want = reference_rigid.regrid(moved, transform, *second, ref_dtype, rows=(r0, r1)).double()
        got = aligned[r0:r1].to(want.device).double()
        both = torch.isfinite(got) & torch.isfinite(want)
        mism += int((torch.isfinite(got) != torch.isfinite(want)).sum())
        dev_sum += float(torch.where(both, (got - want).abs(), 0.0).sum())
        mag_sum += float(torch.where(both, want.abs(), 0.0).sum())
    return (dev_sum / mag_sum if mag_sum else math.inf), mism / moved.numel()


def control(work: Work, dtype):
    """The call with the plain ICP, regrid, LZD and regrid in `dtype` in the program's place,
    drawing as the program does."""
    rows = int(work.mix["check"]["band_rows"])

    def call(i, spans):
        ref, tba, _ = work.pool[i % len(work.pool)]
        state = work.random_state(i)
        first = reference_rigid.icp(ref, tba, work.t6, int(work.mix["icp"]["subsample"]), state, dtype)[:2]
        moved = reference_rigid.regrid_bands(tba, work.t6, *first, dtype, rows)
        second = reference_rigid.lzd(ref, moved, work.t6, int(work.mix["lzd"]["subsample"]), state, dtype)[:2]
        aligned = reference_rigid.regrid_bands(moved, work.t6, *second, dtype, rows).float()
        return first, second, aligned

    return call
