"""Seeded inputs made on the device: 1/f^2.7 spectral DEMs, their voids, and DEM pairs.

The recipe is the repository's example terrain: a half spectrum of amplitude f^-2.7 and
uniform random phase, inverse-transformed and scaled to [0, 1000] m. Everything large is
drawn and transformed on the device in row or column bands (no transform of the whole grid at
once), with a ``torch.Generator`` on that device; only the voids' corners are drawn on the host.
A pair's second DEM is the first with its terrain moved by (dx east, dy north, dz up) metres,
by a phase ramp on the same spectrum, plus its seeded elevation error (``error_field``), before
the voids are cut into it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BAND = 2048  # rows or columns per band of the spectrum's draws and transforms


def seed_ints(seed: int, *tags: int) -> int:
    """A 63-bit seed for one input, derived from the run's seed and the input's tags."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF] + [int(t) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _spectrum(n: int, seed: int, device: torch.device, exponent: float, gaussian_px: float | None = None) -> torch.Tensor:
    """The (n, n // 2 + 1) complex64 half spectrum of amplitude f^-exponent, or with
    `gaussian_px` = s of exp(-2 pi^2 s^2 f^2) (white noise smoothed by a gaussian of s pixels),
    random phase; no mean."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    fy, fx = torch.fft.fftfreq(n, device=device), torch.fft.rfftfreq(n, device=device)
    spec = torch.empty((n, fx.numel()), dtype=torch.complex64, device=device)
    for r0 in range(0, n, BAND):
        amp = torch.hypot(fy[r0:r0 + BAND, None], fx[None, :])
        if gaussian_px is not None:
            amp = torch.exp(amp.square_().mul_(-2 * math.pi**2 * gaussian_px**2))
        else:
            if r0 == 0:
                amp[0, 0] = 1.0
            amp.pow_(-exponent)
        if r0 == 0:
            amp[0, 0] = 0.0
        phase = torch.rand(amp.shape, generator=g, device=device).mul_(2 * math.pi)
        spec[r0:r0 + BAND] = torch.polar(amp, phase)
    return spec


def _heights(spec: torch.Tensor, n: int, shift_px: tuple[float, float] | None) -> torch.Tensor:
    """The (n, n) float32 field of a half spectrum, moved by (rows, cols) pixels if asked."""
    device = spec.device
    work = spec.clone() if shift_px is not None else spec
    if shift_px is not None:
        # f(r - dr, c - dc) <-> F * exp(-2i pi (fy dr + fx dc)), in float64 phases.
        dr, dc = shift_px
        fy = torch.fft.fftfreq(n, device=device, dtype=torch.float64)
        fx = torch.fft.rfftfreq(n, device=device, dtype=torch.float64)
        ry = torch.polar(torch.ones_like(fy), -2 * math.pi * fy * dr).to(torch.complex64)
        rx = torch.polar(torch.ones_like(fx), -2 * math.pi * fx * dc).to(torch.complex64)
        for r0 in range(0, n, BAND):
            work[r0:r0 + BAND].mul_(ry[r0:r0 + BAND, None] * rx[None, :])
    for c0 in range(0, work.shape[1], BAND):
        work[:, c0:c0 + BAND] = torch.fft.ifft(work[:, c0:c0 + BAND], dim=0)
    z = torch.empty((n, n), dtype=torch.float32, device=device)
    for r0 in range(0, n, BAND):
        z[r0:r0 + BAND] = torch.fft.irfft(work[r0:r0 + BAND], n=n, dim=1)
    return z


def error_field(n: int, seed: int, device: torch.device, components, pixel_m: float) -> torch.Tensor:
    """A (n, n) float32 elevation error: the sum of one seeded field per component, each white
    noise smoothed by a gaussian, so that its covariance is the gaussian model of effective range
    component["range_m"] (exp(-h^2 / (range / 2)^2)), scaled to standard deviation component["sd_m"]."""
    out = torch.zeros((n, n), dtype=torch.float32, device=device)
    for k, comp in enumerate(components):
        f = _heights(_spectrum(n, seed_ints(seed, k), device, 0.0, comp["range_m"] / 4 / pixel_m), n, None)
        f64 = f.double()
        f.sub_(float(f64.mean())).mul_(float(comp["sd_m"]) / float(f64.std()))
        del f64
        out.add_(f)
        del f
    return out


def cut_voids(z: torch.Tensor, seed: int, count: int, min_px: int, max_px: int,
              mesh_shape: tuple[int, int] | None = None) -> None:
    """Set `count` seeded rectangular voids of min_px to max_px - 1 pixels a side to NaN, and
    with `mesh_shape` one more across the middle of every seam segment and every inner corner
    of that mesh of blocks."""
    n_r, n_c = z.shape
    rng = np.random.default_rng(seed)
    for _ in range(count):
        r, c = int(rng.integers(0, n_r - max_px)), int(rng.integers(0, n_c - max_px))
        z[r:r + int(rng.integers(min_px, max_px)), c:c + int(rng.integers(min_px, max_px))] = float("nan")
    for r, c in seam_points(z.shape, mesh_shape) if mesh_shape else ():
        z[r - 5:r + 4, c - 7:c + 3] = float("nan")


def seam_points(shape: tuple[int, int], mesh_shape: tuple[int, int]) -> list[tuple[int, int]]:
    """(row, col) of the middle of each seam segment and of each inner corner of a mesh of
    blocks of ceil(side / mesh) pixels over a raster."""
    n_r, n_c = shape
    my, mx = mesh_shape
    bh, bw = -(-n_r // my), -(-n_c // mx)
    rows = [bh * i for i in range(1, my)]
    cols = [bw * j for j in range(1, mx)]
    r_mid = [min(bh * i + bh // 2, n_r - 1) for i in range(my)]
    c_mid = [min(bw * j + bw // 2, n_c - 1) for j in range(mx)]
    pts = [(r, c) for r in rows for c in c_mid] + [(r, c) for r in r_mid for c in cols]
    return pts + [(r, c) for r in rows for c in cols]


def spectral_dem(n: int, seed: int, device: torch.device, exponent: float = 2.7, top_m: float = 1000.0,
                 shift_m: tuple[float, float, float] | None = None, pixel_m: float = 1.0) -> list[torch.Tensor]:
    """[dem] or, with `shift_m` = (dx, dy, dz), [dem, moved]: float32 (n, n) heights on `device`
    scaled to [0, top_m] by the unmoved field's range; `moved` is the terrain moved by dx east
    and dy north (rows by -dy / pixel_m, columns by +dx / pixel_m) and raised by dz."""
    spec = _spectrum(n, seed, device, exponent)
    moved = None
    if shift_m is not None:  # first: the unmoved field is transformed in the spectrum's place
        dx, dy, dz = shift_m
        moved = _heights(spec, n, (-dy / pixel_m, dx / pixel_m))
    z = _heights(spec, n, None)
    del spec
    zmin, zmax = z.min(), z.max()
    scale = top_m / (zmax - zmin)
    out = [z.sub_(zmin).mul_(scale)]
    if moved is not None:
        out.append(moved.sub_(zmin).mul_(scale).add_(dz))
    return out
