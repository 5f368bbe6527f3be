"""Comparisons that decide `correct`: the program's outputs against the plain reference.

Terrain: for each attribute, a gap: the mean absolute deviation of the program's plane from
the reference over the reference's mean magnitude, on the pixels both give finite, plus the
share of the compared pixels on whose finiteness they disagree. Aspect is compared as the
horizontal gradient vector: the chord between the two directions, 2 |sin(d / 2)|, times the
reference's tan(slope), over the mean tan(slope), so that the direction of a flat pixel,
which rounding alone decides, weighs nothing. A mean, and not a widest gap: the curvatures
and TPI of a smooth DEM are second differences of float32 heights, which float32 arithmetic
resolves on some pixels only, so their widest gap reads what rounding happened to do there.

Coregistration: the distance between the fitted translation and the plain Nuth & Kääb's, and
the aligned DEM's gap to the reference's apply of the reference's own translation.

Uncertainty: sigma's gap as a plane's (``plane_gap``); rho by the widest gap over lags.
"""

from __future__ import annotations

import torch

from gpu_bench import reference

def _deviation(attr: str, got: torch.Tensor, want: torch.Tensor, tan_slope: torch.Tensor | None) -> torch.Tensor:
    if attr == "aspect":
        d = torch.deg2rad(got.double() - want.double())
        return 2 * torch.abs(torch.sin(d / 2)) * tan_slope
    return torch.abs(got.double() - want.double())


def _magnitude(attr: str, want: torch.Tensor, tan_slope: torch.Tensor | None) -> torch.Tensor:
    return tan_slope if attr == "aspect" else torch.abs(want.double())


def terrain_gaps(dem: torch.Tensor, got, regions, res: float, attrs, window_size_fractal: int = 13,
                 ref_dtype=torch.float64) -> dict[str, float]:
    """{attribute: gap} over the pixels of `regions`: the mean deviation from the reference
    over its mean magnitude, on the pixels both give finite, plus the share of the pixels on
    whose finiteness they disagree. `got(r0, r1, c0, c1)` gives the program's planes of that
    window (a list in `attrs` order); `regions` are (r0, r1, c0, c1) windows of `dem`."""
    attrs = list(attrs)
    need = attrs if "slope" in attrs or "aspect" not in attrs else attrs + ["slope"]
    dev_sum = {a: 0.0 for a in attrs}
    mag_sum = {a: 0.0 for a in attrs}
    mism = {a: 0 for a in attrs}
    total = 0
    for r0, r1, c0, c1 in regions:
        want = reference.terrain_block(dem, (r0, r1), (c0, c1), res, need, ref_dtype, window_size_fractal)
        tan_slope = torch.tan(torch.deg2rad(want["slope"].double())) if "aspect" in attrs else None
        for a, g in zip(attrs, got(r0, r1, c0, c1)):
            w = want[a]
            g = g.to(w.device)
            both = torch.isfinite(g) & torch.isfinite(w)
            mism[a] += int((torch.isfinite(g) != torch.isfinite(w)).sum())
            dev = torch.where(both, _deviation(a, g, w, tan_slope), 0.0)
            mag = torch.where(both, _magnitude(a, w, tan_slope), 0.0)
            dev_sum[a] += float(dev.sum())
            mag_sum[a] += float(mag.sum())
        total += (r1 - r0) * (c1 - c0)
        del want
    return {a: (dev_sum[a] / mag_sum[a] if mag_sum[a] else dev_sum[a]) + mism[a] / total for a in attrs}


def aligned_gap(aligned, tba: torch.Tensor, res: float, shift, ref_dtype, band_rows: int) -> float:
    """The gap of an aligned DEM to the reference's apply of `shift` to `tba`: the mean
    deviation over the mean correction the reference applies (|its aligned - tba|), on the
    pixels both give finite, plus the share of the pixels on whose finiteness they disagree."""
    from gpu_bench import reference_coreg

    dev_sum = corr_sum = 0.0
    mism = 0
    for r0, r1, _, _ in band_regions(tuple(tba.shape), band_rows):
        want = reference_coreg.apply_translation(tba, res, shift, ref_dtype, rows=(r0, r1))
        got = aligned[r0:r1].to(want.device)
        both = torch.isfinite(got) & torch.isfinite(want) & torch.isfinite(tba[r0:r1])
        mism += int((torch.isfinite(got) != torch.isfinite(want)).sum())
        dev_sum += float(torch.where(both, (got.double() - want.double()).abs(), 0.0).sum())
        corr_sum += float(torch.where(both, (want.double() - tba[r0:r1].double()).abs(), 0.0).sum())
    return (dev_sum / corr_sum if corr_sum else dev_sum) + mism / tba.numel()


def plane_gap(got: torch.Tensor, want: torch.Tensor, band_rows: int = 1024) -> float:
    """The mean deviation of a plane from the reference's over the reference's mean magnitude,
    on the pixels both give finite, plus the share of the pixels on whose finiteness they
    disagree (1 where no pixel is finite on both)."""
    dev_sum = mag_sum = 0.0
    mism = 0
    for r0, r1, _, _ in band_regions(tuple(want.shape), band_rows):
        w = want[r0:r1].double()
        g = got[r0:r1].to(w.device).double()
        both = torch.isfinite(g) & torch.isfinite(w)
        mism += int((torch.isfinite(g) != torch.isfinite(w)).sum())
        dev_sum += float(torch.where(both, (g - w).abs(), 0.0).sum())
        mag_sum += float(torch.where(both, w.abs(), 0.0).sum())
    return (dev_sum / mag_sum if mag_sum else 1.0) + mism / want.numel()


def band_regions(shape: tuple[int, int], rows: int) -> list[tuple[int, int, int, int]]:
    """The whole raster as bands of `rows` rows."""
    n_r, n_c = shape
    return [(r, min(r + rows, n_r), 0, n_c) for r in range(0, n_r, rows)]


def crop_regions(points, side: int, shape: tuple[int, int]) -> list[tuple[int, int, int, int]]:
    """side x side windows centred on each (row, col) point, kept inside the raster."""
    n_r, n_c = shape
    out = []
    for r, c in points:
        r0 = min(max(r - side // 2, 0), n_r - side)
        c0 = min(max(c - side // 2, 0), n_c - side)
        out.append((r0, r0 + side, c0, c0 + side))
    return out
