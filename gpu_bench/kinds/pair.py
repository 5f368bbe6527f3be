"""Kind "pair": the accuracy chain of a DEM pair, one pair a call, a fresh random_state each
call: ``coreg.NuthKaab(subsample=).fit`` of the to-be-aligned DEM onto the reference, its
``.apply``, then ``uncertainty.estimate_uncertainty(reference, aligned, subsample=)`` (H2022:
sigma binned by slope and maximum curvature, rho from a gaussian plus a spherical variogram).
A host-clock span around each stage, closed by a wait on every card, times it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpu_bench import compare, inputs
from gpu_bench.traffic import wait


class Work:
    """The chain on a pool of DEM pairs (the to-be-aligned DEM moved by the configuration's
    shift, with its elevation error and its voids)."""

    def __init__(self, config: dict, mix: dict, seed: int, devices: list[torch.device], size: int | None = None):
        from xdem_tpu_torch import Affine

        self.config, self.mix, self.devices, self.seed = config, mix, devices, seed
        self.n = int(size or config["size_px"])
        self.res = float(config["pixel_m"])
        self.transform = Affine.from_origin(*config["origin_m"], self.res, self.res)
        self.pixels_per_call = self.n * self.n
        terrain_cfg, voids, pair = config["assumed"]["terrain"], config["assumed"]["voids"], config["assumed"]["pair"]
        self.pool = []
        for i in range(int(mix["pool"])):
            ref, tba = inputs.spectral_dem(self.n, inputs.seed_ints(seed, 1, i), devices[0], terrain_cfg["exponent"],
                                           terrain_cfg["top_m"], tuple(pair["shift_m"]), self.res)
            tba.add_(inputs.error_field(self.n, inputs.seed_ints(seed, 12, i), devices[0], pair["error"], self.res))
            inputs.cut_voids(tba, inputs.seed_ints(seed, 2, i), voids["count"], voids["min_px"],
                             min(voids["max_px"], self.n // 4))
            self.pool.append((ref, tba))

    def random_state(self, i: int) -> int:
        return inputs.seed_ints(self.seed, 5, i) % 2**31

    def call(self, i: int, spans: dict):
        from xdem_tpu_torch import coreg, uncertainty

        ref, tba = self.pool[i % len(self.pool)]
        record = torch.profiler.record_function
        state = self.random_state(i)
        t0 = time.perf_counter()
        with record("gpu_bench.nk_fit"):
            nk = coreg.NuthKaab(subsample=self.mix["nuth_kaab"]["subsample"])
            nk.fit(ref, tba, transform=self.transform, crs=self.config["crs"], random_state=state)
            wait(self.devices)
        t1 = time.perf_counter()
        with record("gpu_bench.nk_apply"):
            aligned, _ = nk.apply(tba, transform=self.transform)
            wait(self.devices)
        t2 = time.perf_counter()
        with record("gpu_bench.uncertainty"):
            sig, rho = uncertainty.estimate_uncertainty(ref, aligned, subsample=self.mix["uncertainty"]["subsample"],
                                                        random_state=state, transform=self.transform,
                                                        crs=self.config["crs"])
            wait(self.devices)
        t3 = time.perf_counter()
        spans["nk_fit"], spans["nk_apply"], spans["uncertainty"] = t1 - t0, t2 - t1, t3 - t2
        return nk.to_translations(), aligned, sig, rho

    def launches_per_call(self) -> None:
        """The terrain kernels' launches are not counted here (K1 runs inside the uncertainty call)."""
        return None

    def keep_inputs(self, indices) -> None:
        keep = {i % len(self.pool) for i in indices}
        self.pool = [p if j in keep else None for j, p in enumerate(self.pool)]

    def check(self, kept: list[tuple[int, tuple]], ref_dtype=torch.float64) -> dict[str, float]:
        """The largest over the kept calls of: "shift", the distance (m) between the call's
        translation and the plain Nuth & Kääb's on the same pair (its own seeded subsample);
        "aligned", the gap of the aligned DEM to the reference's apply of the reference's
        translation; "sigma", the mean deviation of the call's sigma from the reference's
        (on the reference's aligned DEM, its own seeded draw) over the reference's mean, plus
        the share of pixels on whose finiteness they disagree; "rho", the widest gap between
        the call's correlation and the reference's (its own seeded rings) over the lag bins (1,
        the widest two correlations can differ by, where one is not finite there)."""
        from gpu_bench import reference_coreg, reference_uncertainty

        unc = self.mix["uncertainty"]
        rows = int(self.mix["check"]["band_rows"])
        out = {"shift": 0.0, "aligned": 0.0, "sigma": 0.0, "rho": 0.0}
        for i, (shift, aligned, sig, rho) in kept:
            ref, tba = self.pool[i % len(self.pool)]
            want = reference_coreg.nuth_kaab(ref, tba, self.res, int(self.mix["nuth_kaab"]["subsample"]),
                                             inputs.seed_ints(self.seed, 6, i), ref_dtype)
            out["shift"] = max(out["shift"], float(np.linalg.norm(np.subtract(shift, want))))
            out["aligned"] = max(out["aligned"], compare.aligned_gap(aligned, tba, self.res, want, ref_dtype, rows))
            del aligned
            ref_aligned = reference_coreg.apply_translation(tba, self.res, want, ref_dtype)
            want_sig = reference_uncertainty.sigma(ref, ref_aligned, self.res, int(unc["sigma_draw"]),
                                                   inputs.seed_ints(self.seed, 8, i), ref_dtype)
            z = (ref_aligned - ref.to(ref_dtype)) / want_sig
            del ref_aligned
            out["sigma"] = max(out["sigma"], compare.plane_gap(sig, want_sig))
            del want_sig, sig
            want_rho = reference_uncertainty.rho(z, self.res, int(unc["subsample"]), inputs.seed_ints(self.seed, 9, i))
            del z
            lags = reference_uncertainty.lag_grid(tuple(ref.shape), self.res)
            gap = np.abs(np.asarray(rho(lags), np.float64) - want_rho(lags))
            out["rho"] = max(out["rho"], float(np.max(gap)) if np.isfinite(gap).all() else 1.0)
        return out


def control(work: Work, dtype):
    """The call with the plain Nuth & Kääb, apply and uncertainty in `dtype` in the program's place."""
    from gpu_bench import reference_coreg, reference_uncertainty

    def call(i, spans):
        ref, tba = work.pool[i % len(work.pool)]
        unc = work.mix["uncertainty"]
        shift = reference_coreg.nuth_kaab(ref, tba, work.res, int(work.mix["nuth_kaab"]["subsample"]),
                                          inputs.seed_ints(work.seed, 7, i), dtype)
        aligned = reference_coreg.apply_translation(tba, work.res, shift, dtype)
        sig = reference_uncertainty.sigma(ref, aligned, work.res, int(unc["sigma_draw"]),
                                          inputs.seed_ints(work.seed, 10, i), dtype)
        rho = reference_uncertainty.rho((aligned - ref.to(dtype)) / sig, work.res, int(unc["subsample"]),
                                        inputs.seed_ints(work.seed, 11, i))
        return shift, aligned.float(), sig.float(), rho

    return call
