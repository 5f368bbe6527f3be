#!/usr/bin/env python3
"""Drive xdem_tpu_torch's main path once on one NVIDIA GPU and check every step.

Run from the repository root:  python3 chip_smoke.py   (phases 1-13 on one card)
                               python3 chip_smoke.py --cards 4
The second needs four cards (it exits 1 before doing anything with fewer) and runs the build,
phase 3 on each of the four cards, phase 13 over them and phase 14. Both end with the same
last line, whose "count" is the number of cards the run used.

Phases:
  1. device: the card's name and power limit; exits non-zero without CUDA;
  2. build: compiles the CUDA kernels K1, K2, K3, the centre and tier 3's step from ``xdem_tpu_torch/csrc``
     with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, on a seeded
     2047 x 2061 DEM with NaN holes, a NaN border strip, an inf and a -inf pixel. All three
     are held to the bit (max abs error 0, identical NaN masks), on the ragged width (scalar
     stores) and on a 2060-wide crop (vector stores). K1: every fit and curvature method, a
     hillshade z factor of 2, the two- and one-attribute sets of the uncertainty call and of
     TerrainBias, requests out of the table's order, an attribute named twice, and `center=`
     given. K2 on every route: w = 3 with Riley's and Wilson's TRI and all four attributes, each
     attribute alone, a request out of the table's order and one that names an attribute twice;
     w = 5, 6 and 21 over a shared tile; the last window whose tile fits in shared memory and
     the next (global reads) on a 512 x 520 DEM. K3 on every route: windows 5, 8, 13, 21 on
     the whole DEM, and the last window whose box-maxima planes fit in shared memory and the
     next (global reads) on a 512 x 520 crop. The centre (the mean of the finite pixels that K1
     removes) within one float32 ulp of the float64 mean, on the DEM and on a view of it that
     starts off a 16-byte boundary;
  4. main path at 10 000 x 10 000 (20 m pixels): the 14-attribute terrain suite and a
     Nuth & Kääb fit + apply on a seeded spectral DEM pair shifted by (-9.2, 4.6, -2.35) m.
     Every kernel must have launched; the fit must recover the shift within 5 % and cut
     var(dh) below 1 %; suite, kernel (beside plain and the kernel's bound, with the card's
     name and power limit) and fit times are printed. K1 is timed three ways: the kernel
     alone (`center=` given), the centre alone, and the wrapper (both); K2 and K3 through
     their wrappers one launch at a time and alone (five launches per event pair), K2 also
     without rugosity, with rugosity only, and at the runtime windows 5 and 21. The centre on both
     DEMs of the pair within one float32 ulp of the float64 mean, the same bits over five calls,
     timed beside that float64 mean, torch's nanmean chain and its one-read bound.
  5. uncertainty at 10 000 x 10 000 (20 m): estimate_uncertainty (H2022, subsample 10 000) of
     a seeded spectral DEM against itself plus 0.004 x an independent field, as bench.py's
     10k^2 leg builds the pair. K1 must launch in each call; sigma must stay on the card,
     be finite over >= 99 % with a positive median; the binned sample must hold 5e6 picks
     and the variogram form 55 193 600 pairs; rho(0) = 1, rho non-increasing to 3e5 m and
     |rho(1e7 m)| <= 0.05. On a 1024^2 crop the same code runs on the card and on the CPU
     with identical injected inputs (terrain variables, subsample indices, ring draw):
     identical counts, sigma within 5e-3 (p99.9) and 1e-2 (max) of its mean, gamma within
     1e-5. First, steady and per-stage times and a 1 km^2 Hugonnet n_eff are printed.
  6. coregistration at 10 000 x 10 000 on phase 4's DEM: ICP (5e4 points, which must take the
     brute search on the card), LZD and CPD recover RIGID_TRUTH, applied about the lower-left
     corner by the tier-3 regrid, re-expressed about each fit's centroid (ICP 2 m / 5e-3 deg,
     LZD 1 m / 5e-3 deg, CPD 0.1 deg in rotation); the ICP and LZD applies (tier 3 over 1e8
     pixels) leave var(dh / std(dh0)) < 0.05. DhMinimize recovers phase 4's shift within 5 %
     and cuts var(dh) below 1 %. A Deramp + DirectionalBias(30) + TerrainBias pipeline fitted on
     the DEM plus a +-5 m order-2 ramp, a 1 m 20 km sinusoid at 30 deg and 1 m x the clipped
     maximum curvature removes >= 90 % of each field's variance (TerrainBias read at the
     reference's curvature, which defines its field), K1 launches in its fit and its apply,
     and a saved and loaded copy applies to the same bits. On a 1024^2 crop each method fits
     on the card and the CPU from one draw: matrices within 1e-4, tier-3 applies within 1e-3 m
     with identical NaN masks. Tier 3's step kernel (csrc/regrid.cu) launches in the rigid pair's
     build and in the ICP and LZD applies; the build equals the ATen loop in the kernel's place
     on the card to the bit, with identical NaN masks and as many steps, and one step of each is
     timed beside the kernel's byte bound. ICP's scan kernel (csrc/nn_scan.cu) launches once a
     step in ICP's two fits; on 5e4 x 5e4 standardised points of the rigid pair it equals the ATen scan to the bit
     (indices and squared distances), and each is timed beside the kernel's operation bound, as
     is one kernel scan of 5e5 x 5e5 points. Fit, apply and host-draw times are printed.
  7. volume change and the rest of the statistics at 10 000 x 10 000 on phase 4's DEM, a dDEM
     that is VOLUME_LAW of elevation plus 0.5 m of noise with 10 % voids, and 36 labelled
     glacier blocks: hypsometric_binning (fixed, count and quantile bins) must recover the law
     and count every valid pixel, the regional signal must count every valid glacier pixel, and
     the volume change from the interpolated bins and their areas must equal the law summed
     over the raster within 1 %. get_terrain_attribute(slope, texture_shading) must launch K1
     once and answer both; texture shading also runs at a padded size (4000 x 5003 -> 4000 x
     5040) against a float64 transform. patches_method over three areas (kernels of 10, 32
     and 100 pixels) must give the noise's standard error sigma / sqrt(valid pixels per
     patch) within 10 %; the Genton variogram on the raster and the four point, disk and ring
     subsamples on a 2048^2 crop must give the noise's variance within 15 % over the bins' median. On a 1024^2 crop
     the card is held against the CPU (hypsometric and regional counts identical, values 1e-4
     of their mean magnitude, medians 1e-5, std 1e-4; texture shading 1e-3 with identical NaN
     masks; patches 1e-4; Genton counts identical, gamma 1e-5) and the convolutions against
     scipy.ndimage in float64 (1e-5 of the mean magnitude, counts exact), with cuDNN's
     float32 precision flags read before and after. Times are printed.
  8. Raster and DEM from files at 10 000 x 10 000: phase 4's spectral DEM at 20 m in EPSG:32633
     with vcrs EGM96, and the same terrain moved by (-9.2, 4.6, -2.35) m on a grid whose origin is
     moved by (0.37, -0.61) px, with 0.4 m of white noise and 15 m lost inside six glacier outlines, are written as DEFLATE GeoTIFFs (in a temporary folder under the git-ignored
     outputs/) and read back by DEM(path) to the bit. From there, with the kernels' counts set
     to 0: tba.reproject(ref) and ref.reproject(crs=32632) at full size, each held to a float64
     host oracle (the projections with numpy, scipy's order-1 map_coordinates) at 1e6 pixels
     within 1e-5 of its mean magnitude; to_vcrs("Ellipsoid") on the card; the DEM's 14
     attributes launch K1, K2 and K3 once each and equal the array path to the bit;
     tba.coregister_3d(ref) with the outlines' complement as inlier mask recovers the shift
     within 5 %; ref.estimate_uncertainty(aligned) passes phase 5's checks on sigma and rho. On a
     1024^2 pair made the same way the card is held against the CPU: reprojections 1e-6 of the mean magnitude,
     to_vcrs 1e-6 m, attributes 1e-3 (both removing the card's centre), the fitted shift 1e-4 (the fit's subsample drawn on the card
     and replayed on the CPU: the two generators draw other points from one seed), and with one
     aligned DEM on both sigma 5e-3 (p99.9) and 1e-2 (max), rho 5e-3. Times and the phase's peak
     memory are printed.
  9. point clouds and blockwise coregistration at 10 000 x 10 000 on phase 4's pair, with an EPC of
     1e7 points (uniform positions drawn with numpy, the bilinear heights of the reference terrain
     moved by (-9.2, 4.6, -2.35) m, 0.1 m of noise: examples.get_epc's recipe at the density of
     ICESat-2 segments over 200 km x 200 km): a LAS round trip in the git-ignored outputs/ gives
     the points back to the millimetre; to_vcrs("Ellipsoid") runs on the card; Nuth & Kääb on (DEM,
     EPC) and (EPC, DEM) recovers the shift within 5 %; epc.coregister_3d(dem) moves the points by
     the fit; ICP (5e4 picks, brute search on the card, one launch of the scan kernel a step) and
     LZD on the DEM against the reference terrain's points moved by RIGID_TRUTH meet phase 6's limits; dem.estimate_uncertainty(epc)
     launches K1 once and passes phase 5's checks on sigma and rho; BlockwiseNuthKaab (400 tiles of
     500 px, 20 000 picks each) finds the shift within 5 % and its apply cuts var(dh) below 5 %;
     apply_tiled on a 4096^2 crop equals apply; the generic BlockwiseCoreg(NuthKaab()) runs on a
     2048^2 crop. On a 1024^2 pair with 1e5 points the card is held against the CPU: raster-point
     fits 1e-4 from one draw, blockwise shifts 1e-4 with the card's picks replayed (tiles that
     converge on both devices), sigma 5e-3 (p99.9) / 1e-2 (max), rho 5e-3. Times, each fit's host
     draw and the phase's peak memory are printed.
 10. dDEM and DEMCollection at 10 000 x 10 000 on phase 4's terrain: three DEMs of 2000, 2010 (the
     reference) and 2020, the first the reference minus VOLUME_LAW's dh(z) inside phase 8's six
     outlines (named "glacier 1" to "glacier 6"), the last the terrain plus it on a grid moved by
     GRID_OFFSET_PX (so subtract_dems runs its cubic-spline reprojection), both with 10 % voids in
     16-pixel blocks inside the outlines. With the kernels' counts set to 0: subtract_dems,
     interpolate_ddems("local_hypsometric"), the dh, dv and both cumulative series with and without
     an outlines_filter that picks glacier 1, dDEM.interpolate by idw, local_hypsometric and
     regional_hypsometric on one dDEM, subtract_dems_intervalwise and its series. Every series
     recovers the law over the outlines (or glacier 1) within 1 %; each method fills the voids.
     idw's time is split into its filter rounds and its hull. The examples' coregistered DEM and
     dDEM are generated on the card: a new Nuth & Kaab fit on them leaves under 5 % of
     examples.TBA_SHIFT, and the dDEM is ref minus that DEM. On a 1024^2 collection the card is
     held against the CPU: dh series 1e-5 of the mean magnitude, filled arrays 1e-4 with
     identical NaN masks.
 11. terrain attributes out of core at 20 000 x 20 000 (20 m, EPSG:32633): phase 4's recipe written
     as an uncompressed striped GeoTIFF under the git-ignored outputs/ (the phase fails if the
     6.4 GB it writes are not free), then tiled_terrain_attribute from the path with tile_rows=1024
     and slope, the terrain ruggedness index and fractal roughness: each kernel launches once in
     each of the 20 bands, the peak device memory stays under 2 GB above the phase's start, and
     each band's read, copies, kernels (CUDA events) and writes are timed. On an in-memory
     10 000^2 crop, tiled= with xdem_tpu's seven-attribute test set (windows 5 and 13) is held
     to the whole-array suite: the K2 and K3 attributes to the bit, the K1 attributes within
     1e-3 of the mean magnitude (aspect 0.1 deg) with identical NaN masks.
 12. the Accuracy and Topo workflows from dict configurations on phase 8's two files, at output
     level 1: Accuracy (default Nuth & Kaab, the outlines' GeoJSON as path_to_mask) recovers the
     shift within 5 % and lowers the NMAD of dh; Topo with slope, aspect, maximum curvature, the
     terrain ruggedness index and fractal roughness launches K1 three times, K2 and K3 once, and
     each attribute's statistics table equals get_stats of the attribute computed directly. Each
     workflow's time is split into loading, host statistics, plots (or their absence without
     matplotlib) and the rest.
 13. the multi-device path at 10 000 x 10 000 (parallel/): a 2 x 2 mesh of four cards with --cards 4,
     else four shards of one card. The 14-attribute suite of phase 4's DEM with mesh= launches K1, K2
     and K3 once per shard, leaves every plane on its shards' cards, and once assembled equals the
     whole-array planes to the bit (NaN masks included), as does a 2047 x 2061 DEM with NaN holes
     over 2 x 2 and 1 x 4. VerticalShift, NuthKaab, DhMinimize and ICP with mesh= on phase 4's pair
     (ICP's scan kernel once a shard a step, on the shard's card) equal their single-device fits
     to the bit, LZD and CPD within 1e-3, BlockwiseNuthKaab (phase 9's 400 tiles) within 2e-3;
     estimate_uncertainty(mesh=) on phase 5's pair gives the single-device
     sigma and rho to the bit. A cluster: on four cards launch_local_cluster(4, 1) on its default
     route (NCCL, a card a process); on one card, which cannot hold two NCCL ranks,
     launch_local_cluster(2, 2) with XDEM_TPU_PLATFORM=cpu (gloo); its Dowd bins and K1 planes
     equal one process's to the bit. First and steady times beside the single-device ones; the one
     scatter of the DEM, the exchange of K1's halo and the assembly of K1's planes on one card; each
     kernel on each card's block by CUDA events on that card's stream, beside the plain versions on
     the first block; on several cards, peer access between each pair and one 2.5 GB peer copy.
 14. (--cards 4 only) the 14-attribute suite at 50 000 x 50 000 float32 (20 m) over a 2 x 2 mesh of
     four cards: 140 GB of planes that no one card holds. A seeded spectral DEM with NaN voids, some
     across every seam, made on the first card. Every plane stays on the four cards (any assembly
     during the suite fails the phase), each kernel launches once a card, each card's peak memory is
     printed; a 1024^2 crop around the middle of each seam segment and the central corner, computed
     whole on one card with the whole DEM's centre, equals the sharded window to the bit with
     identical NaN masks. First and steady suite times on the host clock between waits on every
     card, the one scatter, each halo exchange, and each kernel on each card's block. The centre of
     the 10 GB DEM on the first card, held and timed as in phase 4.
The line before the last is a JSON summary of the kernels (with their launches on each path; the
centre's once a call, whatever the shards) and of
the phases; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

TOL = 1e-3  # terrain parity: max deviation <= 1e-3 of the mean magnitude
TBA_SHIFT = (-9.2, 4.6, -2.35)  # (east, north, up) metres applied to the tba DEM
RES = 20.0
MAIN_SIZE = 10000  # side of the main-path DEM in pixels (SURVEY §6 north-star cell)
SUITE = ("slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
         "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature",
         "topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity",
         "fractal_roughness")
UNC_CROP = 1024  # side of the card-against-CPU crop of phase 5
COREG_CROP = 1024  # side of the card-against-CPU crop of phase 6
VOLUME_CROP = 1024  # side of the card-against-CPU crop of phase 7
VOLUME_LAW = (-12.0, 0.01)  # phase 7's dDEM: dh = a + b * elevation (m), plus noise
VOLUME_NOISE = 0.5  # standard deviation of that noise (m)
VOLUME_VOIDS = 0.1  # share of the dDEM's pixels that are NaN
PATCH_KERNELS = (10, 32, 100)  # diameters in pixels of phase 7's circular patches
RIGID_TRUTH = (20, 5, 0.1, 0.1, 0.05, 0.01)  # tx, ty, tz (m), rotations about x, y, z (deg) of phase 6
UNC_HETERO_PICKS = 5_000_000  # estimate_uncertainty's heteroscedasticity sample
UNC_PAIRS = 100 * 224 * (11 * 224)  # runs x samples x (nb_rings + 1) * samples at subsample 10 000
# H100 SXM f32 peak outside the tensor cores (NVIDIA's data sheet, 700 W). It counts a fused
# multiply-add as two operations: unfused f32 instructions issue at half this rate.
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
RASTER_ORIGIN = (5e5, 8e6)  # upper-left corner (UTM 33N) of phase 4's and phase 8's DEMs
GRID_OFFSET_PX = (0.37, -0.61)  # phase 8: the to-be-aligned DEM's grid origin moved by (x, y) pixels
GLACIER_THINNING = 15.0  # metres lost inside phase 8's outlines by the to-be-aligned DEM
RASTER_NOISE = 0.4  # standard deviation (m) of phase 8's white noise on the to-be-aligned DEM
ORACLE_POINTS = 1_000_000  # pixels of each phase-8 reprojection held to the float64 oracle
RASTER_CROP = 1024  # side of the card-against-CPU crop of phase 8
POINTS = 10_000_000  # phase 9's EPC: ICESat-2 segments gathered over a 200 km x 200 km region
POINT_NOISE = 0.1  # standard deviation (m) of the points' heights, as examples.get_epc draws them
BLOCK = (500, 20_000)  # phase 9's blockwise tiles: side in pixels, picks per tile (400 tiles at 10 000^2)
TILED_CROP = 4096  # side of phase 9's crop where apply_tiled is held to apply
GENERIC_CROP = 2048  # side of phase 9's crop for the generic BlockwiseCoreg(NuthKaab()) loop
POINTS_CROP = (1024, 100_000)  # phase 9's card-against-CPU pair: side, points
DDEM_YEARS = (2000, 2010, 2020)  # phase 10's acquisitions; the middle one is the reference DEM
TILED_SIZE = 20000  # side of phase 11's out-of-core DEM (20 m, EPSG:32633)
TILED_ROWS = 1024  # rows of each of phase 11's bands
TILED_ATTRS = ("slope", "terrain_ruggedness_index", "fractal_roughness")  # one attribute per kernel
TILED_CROP_ATTRS = ("slope", "aspect", "hillshade", "max_curvature", "topographic_position_index", "roughness",
                    "fractal_roughness")  # xdem_tpu's tiled test set, windows 5 and 13
TILED_DISK_BYTES = 6_400_000_000  # phase 11's source file and its three attributes at TILED_SIZE^2 in float32
TOPO_ATTRS = ("slope", "aspect", "max_curvature", "terrain_ruggedness_index", "fractal_roughness")
DDEM_CROP = 1024  # side of phase 10's card-against-CPU collection
DDEM_VOID_PX = 16  # side of phase 10's voids: square blocks, as clouds and shadows leave them
MESH_SHARDS = (2, 2)  # phase 13's mesh on a one-card machine: four shards of cuda:0
MESH_SMALL = (2047, 2061)  # phase 13's ragged DEM, sharded 2 x 2 and 1 x 4
MESH_LAGS = (20.0, 200.0, 2000.0)  # phase 13's rho comparison lags (m)
BIG_SIZE = 50_000  # side of phase 14's DEM: 100 km x 100 km at 2 m, here read at 20 m pixels
BIG_CROP = 1024  # side of phase 14's crops around the seams
BIG_MARGIN = 8  # their margin: at least the largest halo (6, fractal roughness at w = 13)
BIG_VOIDS = 200  # seeded NaN voids of 1-63 px in phase 14's DEM
KERNELS = {
    "surface_fit": ("xdem_tpu_torch/csrc/surface_fit.cu", "xdem_tpu/terrain/pallas_kernels.py:219"),
    "windowed": ("xdem_tpu_torch/csrc/windowed.cu", "xdem_tpu/terrain/pallas_kernels.py:518"),
    "fractal": ("xdem_tpu_torch/csrc/fractal.cu", "xdem_tpu/terrain/pallas_kernels.py:370"),
}
CENTER_SOURCE = "xdem_tpu_torch/csrc/center.cu"  # replaces no TPU kernel: XLA takes that mean
REGRID_SOURCE = "xdem_tpu_torch/csrc/regrid.cu"  # tier 3's step: replaces no TPU kernel, XLA runs that loop
NN_SCAN_SOURCE = "xdem_tpu_torch/csrc/nn_scan.cu"  # ICP's scan: replaces no TPU kernel, XLA fuses that scan


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync_all() -> None:
    """Wait for every visible card (torch.cuda.synchronize() waits for the current one only)."""
    from xdem_tpu_torch._device import synchronize

    synchronize()


def empty_all() -> None:
    """Return every card's cached blocks (torch.cuda.empty_cache() frees the current card's)."""
    import torch

    for i in range(torch.cuda.device_count()):
        with torch.cuda.device(i):
            torch.cuda.empty_cache()


def device_ms(fn, reps: int = 3, calls: int = 1, device=None) -> float:
    """Median device time of one fn() in ms, by CUDA events on `device`'s current stream
    (default: the current card) around `calls` calls in a row, after one warm-up call. With
    several calls the host's work on each hides behind the device's work on the one before,
    so the figure is the device's time alone. Every card is waited for after each round."""
    import torch

    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    fn()
    times = []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(calls):
                fn()
            end.record(stream)
            sync_all()
            times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def mesh_ms(fn, mesh, reps: int = 3) -> float:
    """Median time of one fn() over `mesh` in ms, after a warm-up call: by CUDA events when
    every shard lies on one card, else on the host clock between waits on every card."""
    devices = {d for d in mesh.devices.flat}
    if len(devices) == 1:
        return device_ms(fn, reps=reps, device=next(iter(devices)))
    fn()
    times = []
    for _ in range(reps):
        _, secs = _synced(fn)
        times.append(secs * 1e3)
    return statistics.median(times)


def spectral_dem(n: int, seed: int, shift_px: tuple[float, float] = (0.0, 0.0), device="cpu"):
    """Seeded 1/f^2.7 spectral DEM on an n x n grid (the recipe of the repository's example
    DEM), optionally translated by (rows, cols) pixels through a Fourier phase ramp.
    Returns float64 heights normalised to [0, 1000] m by the unshifted field's range."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    f = np.hypot(fx, fy)
    f[0, 0] = 1.0
    amp = f**-2.7
    amp[0, 0] = 0
    phase = rng.uniform(0, 2 * np.pi, amp.shape)
    spec = torch.polar(torch.from_numpy(amp).to(device), torch.from_numpy(phase).to(device))
    z = torch.fft.irfft2(spec, s=(n, n))
    zmin, zmax = z.min(), z.max()
    out = []
    for dr, dc in ((0.0, 0.0), shift_px):
        # f(r - dr, c - dc) <-> F * exp(-2i*pi*(fy*dr + fx*dc))
        ramp = torch.from_numpy(-2 * np.pi * (fy * dr + fx * dc)).to(device)
        zs = torch.fft.irfft2(spec * torch.polar(torch.ones_like(ramp), ramp), s=(n, n))
        out.append((zs - zmin) / (zmax - zmin) * 1000.0)
    return out


def scaled_dev(got, want, circular: bool = False) -> tuple[float, float, bool]:
    """(max |got - want| / mean |want|, max |got - want|, NaN masks equal) over the jointly
    finite pixels; `circular` measures angle differences around 2*pi."""
    import torch

    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    both = torch.isfinite(got) & torch.isfinite(want)
    if not bool(both.any()):
        return 0.0, 0.0, same_nan
    d = torch.abs(got[both].double() - want[both].double())
    if circular:
        d = torch.minimum(d, 2 * math.pi - d)
    scale = float(torch.abs(want[both].double()).mean()) or 1.0
    err = float(d.max())
    return err / scale, err, same_nan


def fractal_ops_per_pixel(w: int) -> int:
    """f32 operations K3 does per pixel at window w: a subtraction, a max, a min and an add
    per box, a row and a column max per plane value for each factor of a plane's build, the
    five operations of log(Ns / q) into the two sums per scale, and the slope's six."""
    hw = w // 2
    ops = 6
    for q in (d for d in range(1, hw + 1) if hw % d == 0):
        nq = (w - 1) // q
        ops += 4 * nq * nq + 5
        if q > 1:
            src = max(d for d in range(1, q) if q % d == 0)
            ops += 2 * (q // src - 1)
    return ops


def kernel_bounds(pixels: int, sf_attrs, windowed_attrs, fractal_w: int) -> dict[str, tuple[float, str]]:
    """(least time in ms, "bytes" or "operations") of each kernel's call on the main path: the
    larger of its bytes (the DEM read once, each output plane written once) over HBM's rate
    and its f32 operations over the f32 peak (which counts an FMA as two). K1 counts a multiply and an add per stencil
    tap, two per derivative (centring, divisor) and 20 per attribute formula; K2 at w = 3
    counts TPI 13, TRI 28, roughness 19 and rugosity 193 (16 half-lengths of 6, 8 Heron
    triangles of 12, one division); K3 as fractal_ops_per_pixel."""
    import numpy as np

    from xdem_tpu_torch.terrain import surfit

    roles, names, _ = surfit.fit_plan(sf_attrs, "Florinsky")
    taps = sum(int(np.count_nonzero(surfit.ALL_STENCILS[n])) for n in names)
    k2_ops = {"topographic_position_index": 13, "terrain_ruggedness_index": 28, "roughness": 19, "rugosity": 193}
    work = {  # (bytes, operations) per pixel
        "surface_fit": (4 * (1 + len(sf_attrs)), 2 * taps + 2 * len(roles) + 20 * len(sf_attrs)),
        "windowed": (4 * (1 + len(windowed_attrs)), sum(k2_ops[a] for a in windowed_attrs)),
        "fractal": (8, fractal_ops_per_pixel(fractal_w)),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes * pixels / HBM_BYTES_PER_S, ops * pixels / F32_OPS_PER_S
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def plain_center(z):
    """The mean of z's finite values in float64 (0 where none is finite) as a 0-dim tensor on
    z's card, in chunks of 2^28 values (no float64 copy of a large DEM) and with no read-back."""
    import torch

    total = torch.zeros((), dtype=torch.float64, device=z.device)
    count = torch.zeros((), dtype=torch.int64, device=z.device)
    for part in z.reshape(-1).split(1 << 28):
        valid = torch.isfinite(part)
        total += torch.where(valid, part, 0.0).sum(dtype=torch.float64)
        count += valid.sum()
    return torch.where(count > 0, total / count.clamp(min=1), 0.0)


def center_ulps(got, want) -> float:
    """Distance of the centre kernel's float32 value from the float64 mean rounded to float32, in
    units of that float32's last place."""
    import numpy as np

    w = np.float32(float(want))
    return abs(float(got) - float(w)) / float(np.spacing(abs(w)))


def phase_center(z, label: str) -> dict:
    """The centre kernel on `z` (on its card): within one float32 ulp of the float64 mean, the
    same bits over five calls, and its time by CUDA events (five calls per event pair) beside the
    float64 mean, torch's nanmean chain (surfit.dem_center, which the kernel replaced) and one
    read of the DEM at HBM's rate."""
    import torch

    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit

    got, want = ck.dem_center(z), plain_center(z)
    ulps = center_ulps(got, want)
    check(ulps <= 1, f"{label}: the centre {float(got)!r} is {ulps:.1f} ulps from the float64 mean {float(want)!r}")
    same = all(torch.equal(ck.dem_center(z).view(torch.int32), got.view(torch.int32)) for _ in range(5))
    check(same, f"{label}: the centre's bits changed between calls")
    out = {"value": float(got), "float64": float(want), "ulps": ulps, "max_abs_err": abs(float(got) - float(want)),
           "ms": device_ms(lambda: ck.dem_center(z), calls=5, device=z.device),
           "plain_ms": device_ms(lambda: plain_center(z), device=z.device),
           "library_ms": device_ms(lambda: surfit.dem_center(z), device=z.device),
           "bound_ms": 4 * z.numel() / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"  centre of {label}: {out['value']!r} against the float64 mean {out['float64']!r} ({ulps:.2f} ulp), the same "
          f"bits over five calls; kernel {out['ms']:.3f} ms, float64 plain {out['plain_ms']:.3f} ms, torch's nanmean "
          f"chain {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms (one read), roofline share "
          f"{out['bound_ms'] / out['ms']:.3f}")
    return out


def center_summary(stats: dict, launches: dict[str, int]) -> dict:
    """The centre's entry in the summary's list of kernels."""
    return {"name": "center", "route": "cuda", "source": CENTER_SOURCE, "replaces": None,
            "launches": next(iter(launches.values())), "launches_by_path": launches, "max_abs_err": stats["max_abs_err"],
            "ulps": stats["ulps"], "ms": stats["ms"], "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"], "library_ms": stats["library_ms"]}


def phase_kernels(dev, shape=(2047, 2061), seed=7, verbose: bool = True) -> dict[str, float]:
    """Each kernel against its plain version on the card `dev`; returns max abs error per
    kernel. Every case is printed when `verbose`, else one line for the card."""
    import numpy as np
    import torch

    from xdem_tpu_torch import _build
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit, window

    h, w = shape
    rng = np.random.default_rng(seed)
    z = spectral_dem(max(shape), seed, device=dev)[0][:h, :w].float().contiguous()
    for _ in range(12):
        r, c = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
        z[r:r + int(rng.integers(1, 40)), c:c + int(rng.integers(1, 40))] = float("nan")
    z[:, -3:] = float("nan")  # NaN border strip
    max_err = {k: 0.0 for k in KERNELS}
    counted = {k: 0 for k in KERNELS}

    def compare_exact(kernel: str, label: str, names, got, want) -> None:
        for i, a in enumerate(names):
            same = bool(torch.equal(torch.isnan(got[i]), torch.isnan(want[i])))
            num, fin = ~torch.isnan(want[i]), torch.isfinite(want[i]) & torch.isfinite(got[i])
            err = float((got[i][fin].double() - want[i][fin].double()).abs().max()) if bool(fin.any()) else 0.0
            exact = bool(torch.equal(got[i][num], want[i][num]))  # infinite values too
            finite = int(torch.isfinite(want[i]).sum())
            if verbose:
                print(f"  {kernel:11s} {label:38s} {a:28s} max_abs={err:.3e} bit_equal={exact} nan_mask_equal={same} "
                      f"finite={finite}")
            counted[kernel] += 1
            check(same and exact, f"{kernel} {label} {a}: not bit-equal to the plain version (max abs {err:.3e}, NaN masks equal {same})")
            check(finite > 10000, f"{kernel} {label} {a}: too few finite pixels to compare")
            max_err[kernel] = max(max_err[kernel], err)

    # An inf and a -inf pixel: inf - centre stays inf, so K1's windows over them are NaN, and
    # K3's inf - inf is NaN.
    zf = z.clone()
    zf[1000, 1000], zf[300, 1700] = float("inf"), -float("inf")
    # K1 to the bit. The 2061-wide DEM takes the scalar stores, its 2060-wide crop the vector
    # stores.
    z4 = zf[:, :w - w % 4].contiguous()
    check(w % 4 != 0, f"width {w} does not take the scalar stores")
    all10 = surfit.SURFACE_FIT_ATTRS
    two, one = ("slope", "max_curvature"), ("max_curvature",)  # the uncertainty call's, TerrainBias's
    mixed = ("min_curvature", "hillshade", "planform_curvature", "slope", "flowline_curvature", "aspect", "slope")
    k1_cases = [(dem, fit, curv, attrs, zfac, None) for dem in (zf, z4) for fit, curv, attrs, zfac in (
        ("Horn", "geometric", ("slope", "aspect", "hillshade"), 1.0),
        ("ZevenbergThorne", "directional", all10, 1.0),
        ("Florinsky", "geometric", all10, 1.0),
        ("Florinsky", "geometric", all10, 2.0),
        ("Florinsky", "geometric", two, 1.0),
        ("Florinsky", "geometric", one, 1.0),
        ("Florinsky", "geometric", mixed, 2.0))]
    k1_cases += [(z4, "ZevenbergThorne", "geometric", all10, 1.0, None),
                 (zf, "Florinsky", "directional", mixed, 1.0, None),
                 (z4, "Florinsky", "directional", all10[::-1], 1.0, torch.tensor(500.0, device=dev)),
                 (zf, "ZevenbergThorne", "directional", ("aspect", "tangential_curvature"), 1.0, 431.3)]
    for dem, fit, curv, attrs, zfac, center in k1_cases:
        kw = dict(surface_fit=fit, curv_method=curv, hillshade_z_factor=zfac, center=center)
        got = ck.surface_attributes(dem, RES, attrs, **kw)
        if center is None:  # the plain version takes the centre kernel's value, as K1's wrapper does
            kw["center"] = ck.dem_center(dem)
        want = surfit.surface_attributes(dem, RES, attrs, **kw)
        label = f"{fit[:10]} {curv[:3]} z={zfac} W={dem.shape[1]} n={len(attrs)}" + ("" if center is None else " center=")
        compare_exact("surface_fit", label, attrs, got, want)
    # K2 to the bit on each route: the 3 x 3 instances (Riley and Wilson, with and without
    # rugosity, each attribute alone, a request out of the table's order, an attribute named
    # twice), runtime windows over a shared tile, and the last such window and the next (global
    # reads) on a 512 x 520 DEM of its own with a NaN and an inf pixel near two corners.
    wa = window.WINDOWED_ATTRS
    top = _build.load().windowed_max_shared_window()
    wide = spectral_dem(520, seed + 1, device=dev)[0][:512].float().contiguous()
    wide[5, 7], wide[500, 510] = float("nan"), float("inf")
    k2_cases = [(dem, 3, tri, attrs) for dem in (zf, z4) for tri, attrs in (
        ("Riley", wa), ("Wilson", wa), *(("Riley", (a,)) for a in wa), ("Wilson", wa[1:2]), ("Wilson", wa[::-1]),
        ("Riley", ("rugosity", "roughness", "topographic_position_index", "roughness")))]
    k2_cases += [(dem, ws, tri, wa[:3]) for dem in (zf, z4) for ws, tri in ((5, "Riley"), (6, "Riley"), (21, "Wilson"))]
    k2_cases += [(wide, top, "Riley", wa[:3]), (wide, top + 1, "Wilson", wa[:3])]
    for dem, ws, tri, attrs in k2_cases:
        got = ck.windowed_indexes(dem, RES, attrs, ws, tri)
        want = window.windowed_indexes(dem, RES, attrs, ws, tri)
        compare_exact("windowed", f"w={ws} {tri} W={dem.shape[1]} n={len(attrs)}", attrs, got, want)
    # K3 to the bit on each route.
    top = _build.load().fractal_max_shared_window()
    crop = zf[800:1312, 900:1420].contiguous()
    crop[200, 100], crop[400, 300] = float("inf"), -float("inf")
    for ws, zz in ((5, zf), (8, zf), (13, zf), (21, zf), (top, crop), (top + 1, crop)):
        got = ck.fractal_roughness(zz, ws)
        want = window.fractal_roughness(zz, ws)
        compare_exact("fractal", f"w={ws} ({tuple(zz.shape)[0]}x{tuple(zz.shape)[1]})", ("fractal_roughness",),
                      got[None], want[None])
    # The centre within one float32 ulp of the float64 mean, on the DEM and on a view that starts
    # off a 16-byte boundary (the kernel's scalar head).
    for label, zz in (("DEM", zf), ("view at an offset", zf.reshape(-1)[3:])):
        ulps = center_ulps(ck.dem_center(zz), plain_center(zz))
        check(ulps <= 1, f"center on the {label}: {ulps:.1f} ulps from the float64 mean")
        if verbose:
            print(f"  {'center':11s} {label:38s} {ulps:.2f} ulp from the float64 mean")
    torch.cuda.synchronize(dev)
    check(got.device == torch.device(dev), f"the kernels' outputs are not on {dev}")
    if not verbose:
        print(f"  {dev}: " + ", ".join(f"{k} {counted[k]} planes bit-equal (max abs {max_err[k]:.1e})" for k in KERNELS))
    return max_err


def main_pair(dev, n: int, seed: int = 0):
    """The main path's pair at n x n: a spectral DEM and the same with its terrain moved by
    TBA_SHIFT, with 20 seeded NaN holes in the moved copy (float32, on `dev`)."""
    import numpy as np

    dx, dy, dz = TBA_SHIFT
    # Terrain moved by (+dx east, +dy north): rows shift by -dy/RES, columns by +dx/RES.
    ref64, tba64 = spectral_dem(n, seed, shift_px=(-dy / RES, dx / RES), device=dev)
    ref = ref64.float().contiguous()
    tba = (tba64 + dz).float().contiguous()
    del ref64, tba64
    rng = np.random.default_rng(seed + 1)
    for _ in range(20):
        r, c = int(rng.integers(0, n - 200)), int(rng.integers(0, n - 200))
        tba[r:r + int(rng.integers(5, 200)), c:c + int(rng.integers(5, 200))] = float("nan")
    return ref, tba


def phase_main(dev, n: int, card: str, seed: int = 0) -> dict:
    """The main path at n x n: terrain suite, Nuth & Kääb fit and apply. Returns timings."""
    import torch

    from xdem_tpu_torch import Affine, coreg, terrain
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit, window

    dx, dy, dz = TBA_SHIFT
    t0 = time.perf_counter()
    ref, tba = main_pair(dev, n, seed)
    torch.cuda.synchronize()
    print(f"  pair {n}x{n} made on the card in {time.perf_counter() - t0:.2f} s")

    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    suite = terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES)
    torch.cuda.synchronize()
    t_suite_first = time.perf_counter() - t0
    nk = coreg.NuthKaab(subsample=5e5)
    t0 = time.perf_counter()
    nk.fit(ref, tba, transform=transform, crs=32633, random_state=42)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    aligned, _ = nk.apply(tba, transform=transform)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    center_launches = ck.CALL_LAUNCHES["center"]
    print(f"  launches on the main path: {launches}, center {center_launches}")
    for k, v in {**launches, "center": center_launches}.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    # Suite outputs: shape, finiteness, ranges, and agreement with the plain versions on a
    # crop (pixels at least 8 from the crop edge, so no window reaches past it).
    for a, v in zip(SUITE, suite):
        check(tuple(v.shape) == (n, n), f"{a}: shape {tuple(v.shape)}")
        frac = float(torch.isfinite(v[8:-8, 8:-8]).float().mean())  # ref has no nodata
        check(frac > 0.999, f"{a}: only {frac:.4f} of the interior pixels are finite")
    check(float(suite[2].nan_to_num(0).max()) <= 255 and float(suite[2].nan_to_num(0).min()) >= 0,
          "hillshade outside [0, 255]")
    cs, m = min(512, n // 2), 8
    c0 = (n - cs) // 2
    crop = ref[c0:c0 + cs, c0:c0 + cs].contiguous()
    plain = [torch.rad2deg(p) if a in ("slope", "aspect") else p for a, p in zip(
        SUITE[:9], surfit.surface_attributes(crop, RES, SUITE[:9], center=ck.dem_center(ref)))]
    plain[2] = torch.clamp(plain[2], 0, 255)
    plain += list(window.windowed_indexes(crop, RES, SUITE[9:13])) + [window.fractal_roughness(crop, 13)]
    # The crop is centred on the whole DEM's mean: with its own mean the stencil sums would
    # round differently, and the curvatures of this smooth DEM are mostly f32 rounding.
    worst = 0.0
    for a, v, p in zip(SUITE, suite, plain):
        v = v[c0 + m:c0 + cs - m, c0 + m:c0 + cs - m]
        p = p[m:-m, m:-m]
        if a == "aspect":
            v, p = torch.deg2rad(v), torch.deg2rad(p)
        rel, _, _ = scaled_dev(v, p, circular=a == "aspect")
        check(rel <= TOL, f"{a}: main-path output departs from the plain version by {rel:.3e}")
        worst = max(worst, rel)
    print(f"  suite outputs: 14 planes of {n}x{n}, >99.9% of the interior finite; on a {cs}x{cs} crop "
          f"they agree with the plain versions to {worst:.3e} of the mean magnitude")

    # Coregistration: the fitted translation is minus the applied shift.
    tx, ty, tz = nk.to_translations()
    mag = math.hypot(dx, dy)
    it = nk.meta["outputs"]["iterative"]["last_iteration"]
    print(f"  Nuth & Kaab: {it} iterations in {t_fit:.3f} s; translation ({tx:.4f}, {ty:.4f}, {tz:.4f}) m, "
          f"truth ({-dx}, {-dy}, {-dz}) m")
    check(abs(tx + dx) <= 0.05 * mag and abs(ty + dy) <= 0.05 * mag,
          f"horizontal shift ({tx:.3f}, {ty:.3f}) not within 5% of ({-dx}, {-dy})")
    dh_before = ref - tba
    dh_after = ref - aligned
    var_b = float(dh_before[torch.isfinite(dh_before)].double().var())
    var_a = float(dh_after[torch.isfinite(dh_after)].double().var())
    print(f"  var(dh) before {var_b:.6g}, after {var_a:.6g} (ratio {var_a / var_b:.3e})")
    check(var_a < 0.01 * var_b, f"var(dh) after apply is {var_a / var_b:.3e} of before, not below 1%")
    del dh_before, dh_after, aligned

    # Steady suite time: median of 5 runs after one warm-up, host clock around synchronize.
    terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    t_suite = statistics.median(runs)
    print(f"  suite steady {t_suite * 1e3:.2f} ms (median of 5: {[round(r * 1e3, 2) for r in runs]}), "
          f"first call {t_suite_first * 1e3:.2f} ms")
    del suite

    # Steady fit time: median of 3 fits after the first, which pays one-off CUDA set-up.
    fits = []
    for _ in range(3):
        t0 = time.perf_counter()
        coreg.NuthKaab(subsample=5e5).fit(ref, tba, transform=transform, crs=32633, random_state=42)
        torch.cuda.synchronize()
        fits.append(time.perf_counter() - t0)
    t_fit_steady = statistics.median(fits)
    print(f"  Nuth & Kaab fit steady {t_fit_steady * 1e3:.2f} ms (median of 3: {[round(f * 1e3, 2) for f in fits]}), "
          f"first call {t_fit * 1e3:.2f} ms")

    # Each kernel beside its plain version on the same card and input, in turns.
    sf_attrs = SUITE[:9]
    cases = {
        "surface_fit": (lambda: ck.surface_attributes(ref, RES, sf_attrs),
                        lambda: surfit.surface_attributes(ref, RES, sf_attrs)),
        "windowed": (lambda: ck.windowed_indexes(ref, RES, SUITE[9:13], 3),
                     lambda: window.windowed_indexes(ref, RES, SUITE[9:13], 3)),
        "fractal": (lambda: ck.fractal_roughness(ref, 13),
                    lambda: window.fractal_roughness(ref, 13)),
    }
    bounds = kernel_bounds(n * n, sf_attrs, SUITE[9:13], 13)
    times = {}
    for k, (kern, plain_fn) in cases.items():
        p1 = device_ms(plain_fn)
        k1 = device_ms(kern)
        k2 = device_ms(kern)
        p2 = device_ms(plain_fn)
        times[k] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
        bound, by = bounds[k]
        print(f"  {k:11s} kernel {times[k][0]:.3f} ms   plain {times[k][1]:.3f} ms   bound {bound:.3f} ms ({by}), "
              f"roofline share {bound / times[k][0]:.3f}   (plain, kernel, kernel, plain: "
              f"{p1:.3f}, {k1:.3f}, {k2:.3f}, {p2:.3f})")
        torch.cuda.empty_cache()
    # The centre on both DEMs of the pair (tba has voids).
    centers = {name: phase_center(z, f"{name} {n}x{n}") for name, z in (("ref", ref), ("tba", tba))}
    torch.cuda.empty_cache()
    # K1 three ways: the kernel alone (the centre given, five launches per event pair, so the
    # host's work hides behind the device's), the centre alone, and the wrapper (both, above).
    center = ck.dem_center(ref)
    two = ("slope", "max_curvature")  # the uncertainty call's request
    k1 = {"kernel": device_ms(lambda: ck.surface_attributes(ref, RES, sf_attrs, center=center), calls=5),
          "center": centers["ref"]["ms"],
          "wrapper": times["surface_fit"][0],
          "kernel_two": device_ms(lambda: ck.surface_attributes(ref, RES, two, center=center), calls=5),
          "wrapper_two": device_ms(lambda: ck.surface_attributes(ref, RES, two))}
    bound, by = bounds["surface_fit"]
    nbytes = 4 * (1 + len(sf_attrs)) * n * n
    rate = nbytes / (k1["kernel"] * 1e-3)
    print(f"  K1 surface fit, {len(sf_attrs)} attributes, Florinsky, {n}x{n} on {card}: kernel alone {k1['kernel']:.3f} ms "
          f"({nbytes / 1e9:.1f} GB at {rate / 1e12:.3f} TB/s, {100 * rate / HBM_BYTES_PER_S:.1f} % of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"bound {bound:.3f} ms by {by}), the centre alone {k1['center']:.3f} ms, wrapper (centre + kernel) "
          f"{k1['wrapper']:.3f} ms")
    bound_two = kernel_bounds(n * n, two, SUITE[9:13], 13)["surface_fit"]
    print(f"  K1 surface fit, {two}, Florinsky, {n}x{n} on {card}: kernel alone {k1['kernel_two']:.3f} ms, wrapper "
          f"{k1['wrapper_two']:.3f} ms, bound {bound_two[0]:.3f} ms by {bound_two[1]}")
    torch.cuda.empty_cache()
    # K2 and K3 alone: five launches per event pair, as K1's kernel above. K2 also without
    # rugosity and with rugosity only, which is what the half-length planes and Heron cost.
    wa = SUITE[9:13]
    k2 = {"kernel": device_ms(cases["windowed"][0], calls=5), "wrapper": times["windowed"][0],
          "kernel_no_rugosity": device_ms(lambda: ck.windowed_indexes(ref, RES, wa[:3], 3), calls=5),
          "kernel_rugosity_only": device_ms(lambda: ck.windowed_indexes(ref, RES, wa[3:], 3), calls=5)}
    bound, by = bounds["windowed"]
    nbytes = 4 * (1 + len(wa)) * n * n
    rate = nbytes / (k2["kernel"] * 1e-3)
    print(f"  K2 windowed indexes, {len(wa)} attributes, w = 3, Riley, {n}x{n} on {card}: kernel alone {k2['kernel']:.3f} ms "
          f"({nbytes / 1e9:.1f} GB at {rate / 1e12:.3f} TB/s, {100 * rate / HBM_BYTES_PER_S:.1f} % of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"bound {bound:.3f} ms by {by}), through its wrapper one launch at a time {k2['wrapper']:.3f} ms; without rugosity "
          f"{k2['kernel_no_rugosity']:.3f} ms, rugosity only {k2['kernel_rugosity_only']:.3f} ms")
    # K2's runtime windows (off the main path, which runs w = 3): three attributes at w = 5 and
    # w = 21, and each attribute alone at w = 21.
    k2["runtime_windows"] = {
        f"w = {w}, {'TPI + TRI + roughness' if len(attrs) == 3 else attrs[0]}":
            device_ms(lambda: ck.windowed_indexes(ref, RES, attrs, w), calls=2)
        for w, attrs in ((5, wa[:3]), (21, wa[:3]), (21, wa[:1]), (21, wa[1:2]), (21, wa[2:3]))}
    print(f"  K2 runtime windows, {n}x{n}, kernel alone: " + "; ".join(f"{k} {v:.3f} ms" for k, v in k2["runtime_windows"].items()))
    k3 = {"kernel": device_ms(cases["fractal"][0], calls=5), "wrapper": times["fractal"][0]}
    torch.cuda.empty_cache()
    bound, by = bounds["fractal"]
    print(f"  K3 fractal roughness, w = 13, {n}x{n}: kernel alone {k3['kernel']:.3f} ms, through its wrapper one launch at "
          f"a time {times['fractal'][0]:.3f} ms against a bound of {bound:.3f} ms "
          f"({fractal_ops_per_pixel(13)} f32 operations per pixel at the FMA-counted peak, {by}): "
          f"{100 * bound / times['fractal'][0]:.1f} % of the roofline, {200 * bound / times['fractal'][0]:.1f} % of "
          f"the unfused issue rate (none of its operations fuses) on {card}")
    return {"launches": launches, "center_launches": center_launches, "center": centers["ref"],
            "center_tba": centers["tba"], "times": times, "bounds": bounds, "suite_ms": t_suite * 1e3,
            "fit_ms": t_fit_steady * 1e3, "first_fit_ms": t_fit * 1e3, "k1_ms": k1, "k2_ms": k2, "k3_ms": k3}


class Stages:
    """Wraps functions of the uncertainty path's modules to keep their last result and, with
    `sync`, their time on the host clock between two ``torch.cuda.synchronize()``. Names
    are looked up on the module at call time, so the path calls the wrappers."""

    def __init__(self, spec: dict[str, tuple], sync: bool):
        self.spec, self.sync = spec, sync
        self.ms: dict[str, float] = {}
        self.last: dict[str, object] = {}
        self._undo: list[tuple] = []

    def __enter__(self):
        import torch

        for label, (module, name) in self.spec.items():
            orig = getattr(module, name)

            def wrapped(*args, _orig=orig, _label=label, **kwargs):
                if self.sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*args, **kwargs)
                if self.sync:
                    torch.cuda.synchronize()
                self.ms[_label] = self.ms.get(_label, 0.0) + (time.perf_counter() - t0) * 1e3
                self.last[_label] = out
                return out

            setattr(module, name, wrapped)
            self._undo.append((module, name, orig))
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


class CardScans:
    """Counts ICP's scan kernel launches by card: wraps ``coreg.affine._nn_scan_on_card``, which
    the single-device and the sharded solves look up at call time, so that each scan of a
    reference cloud (one a shard on a mesh) counts under that cloud's card."""

    def __init__(self):
        self.by_card: dict[str, int] = {}

    def __enter__(self):
        from xdem_tpu_torch.coreg import affine

        self._orig = orig = affine._nn_scan_on_card

        def on_card(ref_pts):
            nn, card = orig(ref_pts), str(ref_pts.device)

            def counted(*args):
                found = nn(*args)
                self.by_card[card] = self.by_card.get(card, 0) + 1
                return found

            return counted

        affine._nn_scan_on_card = on_card
        return self

    def __exit__(self, *exc):
        from xdem_tpu_torch.coreg import affine

        affine._nn_scan_on_card = self._orig


def _replay(module, name: str):
    """Patch module.name so that its first result is returned again to every later call,
    moved to that call's device (the device of its first tensor argument)."""
    import torch

    orig = getattr(module, name)
    memo = []

    def to(x, dev):
        return x.to(dev) if isinstance(x, torch.Tensor) else type(x)(to(v, dev) for v in x)

    def replayed(*args, **kwargs):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        if not memo:
            memo.append(orig(*args, **kwargs))
        return to(memo[0], dev)

    setattr(module, name, replayed)
    return lambda: setattr(module, name, orig)


def uncertainty_stage_spec():
    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import terrain

    return {
        "terrain (K1)": (terrain, "get_terrain_attribute"),
        "prepare / top-k": (ss, "_hetero_prepare_device"),
        "bin tables": (ss, "_hetero_bin_tables_device"),
        "tables to host + grid": (ss, "_table_from_device_bins"),
        "sigma evaluation": (ss, "_scale_and_sigma_device"),
        "standardize": (ss, "_standardize_masked_device"),
        "ring draw": (ss, "_draw_rings_from_arr"),
        "pair estimator": (ss, "_grid_variogram_device"),
        "pair estimator (chunked)": (ss, "_grid_variogram_device_chunked"),
        "curve_fit": (ss, "fit_sum_model_variogram"),
    }


def phase_uncertainty(dev, n: int) -> dict:
    """The uncertainty path at n x n, its checks, the card-against-CPU crop and n_eff."""
    import numpy as np
    import torch

    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import Affine, terrain, uncertainty
    from xdem_tpu_torch.ops.reductions import masked_median
    from xdem_tpu_torch.terrain import cuda_kernels as ck

    t0 = time.perf_counter()
    dem = spectral_dem(n, 11, device=dev)[0].float().contiguous()
    other = (dem + 0.004 * spectral_dem(n, 12, device=dev)[0]).float().contiguous()
    torch.cuda.synchronize()
    print(f"  pair {n}x{n} made on the card in {time.perf_counter() - t0:.2f} s")
    transform = Affine(20.0, 0.0, 4e5, 0.0, -20.0, 9e6)
    kw = dict(transform=transform, crs=32633, subsample=10000)

    def call(seed: int):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sig, rho = uncertainty.estimate_uncertainty(dem, other, random_state=seed, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(ck.LAUNCHES["surface_fit"] > 0, "K1 was not launched by estimate_uncertainty")
        return sig, rho, seconds, dict(ck.LAUNCHES)

    with Stages(uncertainty_stage_spec(), sync=False) as first_run:
        sig, rho, t_first, launches = call(42)
    sig, rho, t_steady, launches_steady = call(43)
    with Stages(uncertainty_stage_spec(), sync=True) as split:
        _, _, t_split, _ = call(43)
    print(f"  estimate_uncertainty first {t_first:.3f} s, steady {t_steady:.3f} s; launches {launches} / {launches_steady}")

    check(dem.is_cuda and other.is_cuda and sig.is_cuda, "the pair or sigma is not on the card")
    finite = float(torch.isfinite(sig).float().mean())
    med = float(masked_median(sig, torch.isfinite(sig)))
    check(tuple(sig.shape) == (n, n) and finite >= 0.99, f"sigma finite over {finite:.4f} of the raster")
    check(med > 0, f"median sigma {med} is not positive")
    gathered = first_run.last["prepare / top-k"]
    tables = first_run.last["bin tables"][0]
    picks = int(tables[0][0].sum())
    check(tuple(gathered.shape) == (3, UNC_HETERO_PICKS) and picks == UNC_HETERO_PICKS,
          f"the binned sample holds {picks} valid picks of {tuple(gathered.shape)}, not {UNC_HETERO_PICKS}")
    ija, ijb = first_run.last["ring draw"]
    pairs = ija.shape[0] * ija.shape[1] * ijb.shape[1]
    check(pairs == UNC_PAIRS, f"the variogram formed {pairs} pairs, not {UNC_PAIRS}")
    gamma, counts = first_run.last["pair estimator"]
    _, params = first_run.last["curve_fit"]
    lags = np.linspace(0.0, 3e5, 3001)
    r = rho(lags)
    r0, r_far = float(rho(np.array([0.0]))[0]), float(rho(np.array([1e7]))[0])
    check(abs(r0 - 1.0) < 1e-12 and bool(np.all(np.diff(r) <= 1e-12)) and abs(r_far) <= 0.05,
          f"rho(0) = {r0}, rho(1e7) = {r_far}, non-increasing: {bool(np.all(np.diff(r) <= 1e-12))}")
    print(f"  sigma: {finite:.5f} finite, median {med:.6f} m; sample {picks} picks; {pairs} pairs formed, "
          f"{int(counts.sum())} in lag bins; fit {dict((k, [str(v) for v in params[k]] if k == 'model' else [float(x) for x in params[k]]) for k in params)}; "
          f"rho(20, 200, 2000 m) = {[round(float(x), 6) for x in rho(np.array([20.0, 200.0, 2000.0]))]}")
    stages = {k: round(v, 3) for k, v in split.ms.items()}
    print(f"  steady call split by stage (host clock, synchronized; total {t_split * 1e3:.1f} ms, "
          f"stages {sum(split.ms.values()):.1f} ms): {stages}")
    del gathered, tables, ija, ijb, first_run, split, sig

    # Card against CPU on a crop, with identical injected inputs.
    c0 = (n - UNC_CROP) // 2
    dem_c = dem[c0:c0 + UNC_CROP, c0:c0 + UNC_CROP].contiguous()
    other_c = other[c0:c0 + UNC_CROP, c0:c0 + UNC_CROP].contiguous()
    undo = [_replay(terrain, "get_terrain_attribute"), _replay(ss, "_hetero_sample_indices"),
            _replay(ss, "_draw_rings_from_arr")]
    runs = []
    try:
        for d in (dev, torch.device("cpu")):
            with Stages(uncertainty_stage_spec(), sync=False) as st:
                sig_c, _ = uncertainty.estimate_uncertainty(dem_c.to(d), other_c.to(d), random_state=42,
                                                            transform=transform, crs=32633, subsample=2000)
            runs.append((sig_c.cpu().double(), st.last["bin tables"][0], st.last["pair estimator"]))
    finally:
        for u in undo:
            u()
    (s_gpu, t_gpu, v_gpu), (s_cpu, t_cpu, v_cpu) = runs
    same_counts = all(torch.equal(a[0].cpu(), b[0]) for a, b in zip(t_gpu, t_cpu)) and torch.equal(v_gpu[1].cpu(), v_cpu[1])
    check(same_counts, "hetero or variogram counts differ between the card and the CPU")
    check(torch.equal(torch.isnan(s_gpu), torch.isnan(s_cpu)), "sigma NaN masks differ between the card and the CPU")
    both = torch.isfinite(s_cpu)
    dsig = torch.abs(s_gpu[both] - s_cpu[both]) / s_cpu[both].abs().mean()
    p999, dmax = float(torch.quantile(dsig, 0.999)), float(dsig.max())
    g_gpu, g_cpu = v_gpu[0].cpu().numpy(), v_cpu[0].numpy()
    ok = np.isfinite(g_cpu)
    dgam = float(np.max(np.abs(g_gpu[ok] - g_cpu[ok]) / np.abs(g_cpu[ok]))) if ok.any() else 0.0
    print(f"  card vs CPU on {UNC_CROP}^2: counts identical; sigma p99.9 {p999:.3e}, max {dmax:.3e} of its mean; "
          f"gamma max rel {dgam:.3e} over {int(ok.sum())} bins")
    check(p999 <= 5e-3 and dmax <= 1e-2, f"sigma card vs CPU: p99.9 {p999:.3e}, max {dmax:.3e}")
    check(dgam <= 1e-5 and np.array_equal(np.isnan(g_gpu), np.isnan(g_cpu)), f"gamma card vs CPU: {dgam:.3e}")

    # n_eff of a 1 km^2 square of 20 m pixels, with the fitted model, on the card.
    xs, ys = np.meshgrid(4e5 + 10.0 + 20.0 * np.arange(50), 9e6 - 10.0 - 20.0 * np.arange(50))
    coords = np.column_stack([xs.ravel(), ys.ravel()])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        neff = ss.neff_hugonnet_approx(coords, np.ones(len(coords)), params, subsample=1000, random_state=42)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    neff_disk = ss.neff_circular_approx_numerical(1e6, params)
    check(math.isfinite(neff) and neff > 0, f"n_eff {neff}")
    print(f"  neff_hugonnet_approx (1 km^2, 2500 px, subsample 1000): {neff:.4f} in {times[-1]:.3f} ms "
          f"(calls: {[round(t, 3) for t in times]}); disk integral {neff_disk:.4f}")
    return {"first_s": t_first, "steady_s": t_steady, "split_s": t_split, "stages_ms": stages,
            "launches": launches_steady, "sigma_p999": p999, "sigma_max": dmax, "gamma_rel": dgam,
            "neff": neff, "neff_ms": times[-1]}


def _synced(fn):
    """(fn(), seconds) on the host clock between two waits on every card."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def _removed_share(field, corr) -> float:
    """Share of var(field) that the correction `corr` (expected near -field) removes."""
    import torch

    ok = torch.isfinite(field) & torch.isfinite(corr)
    f = field[ok].double()
    return 1.0 - float((f + corr[ok].double()).var()) / float(f.var())


def regrid_step_stats(dem, transform, matrix, centroid, got, launches: int) -> dict:
    """Tier 3's step kernel at the main path's size: `got`, the apply that launched it
    `launches` times, against the ATen passes in the kernel's place on the same card (the same
    bits, NaNs and steps), and one step of each timed as the loop runs it (the launch, then the
    read of the largest residual), beside the kernel's bound: the guess read and written and
    the DEM read once."""
    import torch

    from xdem_tpu_torch import coreg
    from xdem_tpu_torch.coreg import base
    from xdem_tpu_torch.profiler import span

    steps = {"aten": 0}
    make_aten = base._regrid_step_aten

    def counted(*args):
        step = make_aten(*args)

        def one(zg):
            steps["aten"] += 1
            return step(zg)

        return one

    make_card, base._regrid_step_on_card = base._regrid_step_on_card, counted
    try:
        want, _ = coreg.apply_matrix(dem, matrix, centroid=centroid, transform=transform)
    finally:
        base._regrid_step_on_card = make_card
    same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
    num = ~torch.isnan(want)
    err = float((got[num] - want[num]).abs().max())
    check(same_nan and torch.equal(got[num], want[num]),
          f"tier 3's step kernel differs from the ATen loop: NaN masks equal {same_nan}, max abs {err:.3e} m")
    check(launches == steps["aten"], f"tier 3 took {launches} kernel steps and {steps['aten']} ATen steps")

    k = base._regrid_constants(transform, matrix, centroid)
    with span("xdem_tpu_torch.coreg.regrid", devices=[dem.device]) as regrid:
        card, aten = (make(dem, k, "linear", regrid) for make in (make_card, make_aten))
        zg = dem - k.cz
        ms, plain_ms = (device_ms(lambda: step(zg), reps=5) for step in (card, aten))
    bound_ms = 3 * 4 * dem.numel() / HBM_BYTES_PER_S * 1e3
    print(f"  tier 3's step kernel against the ATen loop at {tuple(dem.shape)}: bit-equal, NaN masks identical, "
          f"{launches} steps each; a step {ms:.3f} ms (ATen {plain_ms:.3f} ms), bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / ms:.1f} %)")
    return {"steps": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


def nn_scan_stats(ref, tba, transform, counts=(50_000, 500_000)) -> dict:
    """ICP's scan kernel at the main path's size: clouds of counts[0] pixels drawn from the
    finite pixels of `ref` and `tba` (their centres, heights and the same pixels' moved heights,
    standardised as ICP does), the kernel against the ATen scan on the same card (indices and
    squared distances to the bit), each timed by CUDA events (the kernel through its wrapper, a
    launch an event pair, and alone, ten in a row), beside its bound by operations; then one
    kernel scan of counts[1] x counts[1] points, ICP's default subsample."""
    import numpy as np
    import torch

    from xdem_tpu_torch.coreg import affine, base

    finite = np.flatnonzero((torch.isfinite(ref) & torch.isfinite(tba)).cpu().numpy().ravel())
    out = {}
    for count in counts:
        pick = np.sort(np.random.default_rng(7).choice(finite, count, replace=False))
        rows, cols = np.unravel_index(pick, tuple(ref.shape))
        flat = torch.from_numpy(pick).to(ref.device)
        x, y = transform.c + (cols + 0.5) * transform.a, transform.f + (rows + 0.5) * transform.e
        z_ref, z_tba = (t.reshape(-1)[flat].double().cpu().numpy() for t in (ref, tba))
        ref_c, tba_c, _, _ = affine._standardize_epc(np.vstack((x, y, z_ref)), np.vstack((x, y, z_tba)))
        r, q = (torch.from_numpy(a.T.astype(np.float32)).to(ref.device) for a in (ref_c, tba_c))
        nn = affine._nn_planes_scan(r)
        launches = base.LAUNCHES["nn_scan"]
        got_i, got_d = nn(q)
        check(base.LAUNCHES["nn_scan"] == launches + 1, "the scan of a CUDA float32 cloud did not launch its kernel")
        ms = device_ms(lambda: nn(q), reps=5)
        alone_ms = device_ms(lambda: nn(q), reps=3, calls=10)
        bound_ms = 9 * count * count / F32_OPS_PER_S * 1e3
        row = {"ms": ms, "alone_ms": alone_ms, "bound_ms": bound_ms, "bound_by": "operations"}
        if count == counts[0]:
            aten = affine._nn_scan_aten(r)
            want_i, want_d = aten(q)
            same = torch.equal(got_i, want_i) and torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
            check(same, f"the scan kernel differs from the ATen scan at {count} x {count}: "
                        f"{int((got_i != want_i).sum())} indices, {int((got_d != want_d).sum())} distances")
            row["plain_ms"] = device_ms(lambda: aten(q), reps=3)
            row["max_abs_err"] = 0.0
            del want_i, want_d
        print(f"  ICP's scan kernel at {count} x {count}: "
              + ("bit-equal to the ATen scan (indices and squared distances); " if "plain_ms" in row else "")
              + f"{ms:.3f} ms through its wrapper, {alone_ms:.3f} ms alone"
              + (f" (ATen {row['plain_ms']:.3f} ms)" if "plain_ms" in row else "")
              + f"; bound {bound_ms:.3f} ms by operations ({100 * bound_ms / alone_ms:.1f} %)")
        out[count] = row
        del r, q, got_i, got_d
    return {**out[counts[0]], "at_default_subsample": out[counts[-1]]}


def phase_coreg(dev, n: int) -> dict:
    """Coregistration at n x n on phase 4's DEM: rigid fits (ICP, LZD, CPD) of a pair moved by
    RIGID_TRUTH through tier 3, DhMinimize on phase 4's translated pair, a bias-correction
    pipeline on known fields with a save/load round trip, and card against CPU on a crop."""
    import tempfile

    import numpy as np
    import torch

    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import Affine, coreg, fit, terrain
    from xdem_tpu_torch.coreg import affine, base, biascorr
    from xdem_tpu_torch.terrain import cuda_kernels as ck

    transform = Affine.from_origin(5e5, 8e6, RES, RES)
    kw = dict(transform=transform, crs=32633)
    ref, tba_shift = main_pair(dev, n)
    out: dict = {"fits": {}}

    # Rigid pair: the truth applied about the lower-left corner at the mean height (tier 3).
    truth = coreg.matrix_from_translations_rotations(*RIGID_TRUTH)
    c1 = (transform.c, transform.f - n * RES, float(ref.double().mean()))
    base.LAUNCHES["regrid_step"] = base.LAUNCHES["nn_scan"] = 0
    (tba_rigid, _), t_build = _synced(lambda: coreg.apply_matrix(ref, truth, centroid=c1, transform=transform))
    build_launches = base.LAUNCHES["regrid_step"]
    frac = float(torch.isfinite(tba_rigid).float().mean())
    check(tba_rigid.is_cuda and frac > 0.9, f"tier 3 left {frac:.4f} of the moved DEM finite")
    print(f"  rigid pair: tier 3 moved {n}x{n} by {RIGID_TRUTH} in {t_build:.3f} s ({frac:.5f} finite)")
    dh0 = ref - tba_rigid
    std0 = float(dh0[torch.isfinite(dh0)].double().std())
    del dh0

    def fit_twice(make, ref_, tba_):
        """First and steady fit of a fresh method, each with the draw's time and the steps of
        the brute ICP solve on the card (0 where it did not run)."""
        res = []
        for _ in range(2):
            with Stages({"draw": (affine, "_draw_pixels"), "brute": (affine, "_icp_solve_device")}, sync=True) as st:
                c, secs = _synced(lambda: make().fit(ref_, tba_, random_state=42, **kw))
            res.append((c, secs, st.ms.get("draw", 0.0) / 1e3, st.last["brute"][1] if "brute" in st.last else 0))
        return res

    for name, make, atol_t, atol_r in (("ICP", lambda: coreg.ICP(subsample=50000), 2.0, 5e-3),
                                       ("LZD", lambda: coreg.LZD(), 1.0, 5e-3),
                                       ("CPD", lambda: coreg.CPD(), None, 0.1)):
        (c, t_first, d_first, steps), (_, t_steady, d_steady, steps_steady) = fit_twice(make, ref, tba_rigid)
        if name == "ICP":  # the scan kernel's launches in the two fits alone
            scan_launches = base.LAUNCHES["nn_scan"]
        aff = c.meta["outputs"]["affine"]
        # The fit is stored about its own centroid c2: re-express the truth about c2.
        d = np.asarray(c1) - np.asarray(aff["centroid"])
        want_m = truth.copy()
        want_m[:3, 3] = truth[:3, 3] + d - truth[:3, :3] @ d
        got = coreg.translations_rotations_from_matrix(coreg.invert_matrix(aff["matrix"]))
        want = coreg.translations_rotations_from_matrix(want_m)
        err_t = max(abs(g - w) for g, w in zip(got[:3], want[:3]))
        err_r = max(abs(g - w) for g, w in zip(got[3:], want[3:]))
        row = {"first_s": t_first, "steady_s": t_steady, "draw_first_s": d_first, "draw_steady_s": d_steady,
               "err_t_m": err_t, "err_r_deg": err_r, "count": c.meta["outputs"]["random"]["subsample_final"]}
        print(f"  {name}: fit first {t_first:.3f} s, steady {t_steady:.3f} s (draw {d_first:.3f} / "
              f"{d_steady:.3f} s); {row['count']} points; got {[round(v, 4) for v in got]}, "
              f"want {[round(v, 4) for v in want]}: |dt| {err_t:.4f} m, |drot| {err_r:.5f} deg")
        if name == "ICP":
            print(f"  ICP nn_method='auto' resolved to {'brute on the card' if steps else 'kdtree on the host'}; "
                  f"the two fits took {steps} + {steps_steady} steps and launched the scan kernel {scan_launches} times")
            check(steps > 0, "ICP auto did not take the brute device search on the card")
            check(scan_launches == steps + steps_steady,
                  f"ICP's two fits took {steps} + {steps_steady} steps but launched the scan kernel {scan_launches} times")
        if atol_t is not None:
            check(err_t <= atol_t, f"{name} translation off by {err_t:.4f} m > {atol_t} m")
        check(err_r <= atol_r, f"{name} rotation off by {err_r:.5f} deg > {atol_r} deg")
        if name in ("ICP", "LZD"):
            (aligned, _), t_apply = _synced(lambda: c.apply(tba_rigid, transform=transform))
            dh = ref - aligned
            ratio = float((dh[torch.isfinite(dh)].double() / std0).var())
            row.update(apply_s=t_apply, var_ratio=ratio)
            print(f"  {name}: tier-3 apply over {n}x{n} in {t_apply:.3f} s; var(dh / std(dh0)) = {ratio:.5f}")
            check(ratio < 0.05, f"{name}: var(dh / std(initial dh)) = {ratio:.4f}, not below 0.05")
            del dh, aligned
        out["fits"][name] = row
    out["tier3_build_s"] = t_build
    # The step kernel's launches over the build and the ICP and LZD applies, then the build
    # against the ATen loop.
    out["regrid_launches"] = base.LAUNCHES["regrid_step"]
    check(build_launches >= 1 and out["regrid_launches"] >= build_launches + 2,
          f"tier 3's step kernel launched {build_launches} times in the build, {out['regrid_launches']} in all")
    out["regrid_step"] = regrid_step_stats(ref, transform, truth, c1, tba_rigid, build_launches)
    out["nn_scan"] = {**nn_scan_stats(ref, tba_rigid, transform), "launches": scan_launches}

    # Translated pair: DhMinimize on phase 4's pair.
    dx, dy, dz = TBA_SHIFT
    (dm, t_first, d_first, _), (_, t_steady, d_steady, _) = fit_twice(lambda: coreg.DhMinimize(), ref, tba_shift)
    tx, ty, tz = dm.to_translations()
    mag = math.hypot(dx, dy)
    aligned, _ = dm.apply(tba_shift, transform=transform)
    dh_b, dh_a = ref - tba_shift, ref - aligned
    var_b = float(dh_b[torch.isfinite(dh_b)].double().var())
    var_a = float(dh_a[torch.isfinite(dh_a)].double().var())
    it = dm.meta["outputs"]["iterative"]["last_iteration"]
    print(f"  DhMinimize: fit first {t_first:.3f} s, steady {t_steady:.3f} s (draw {d_first:.3f} / {d_steady:.3f} s), "
          f"{it} Nelder-Mead iterations; translation ({tx:.4f}, {ty:.4f}, {tz:.4f}) m, truth ({-dx}, {-dy}, {-dz}) m; "
          f"var(dh) {var_b:.6g} -> {var_a:.6g}")
    check(abs(tx + dx) <= 0.05 * mag and abs(ty + dy) <= 0.05 * mag,
          f"DhMinimize shift ({tx:.3f}, {ty:.3f}) not within 5% of ({-dx}, {-dy})")
    check(var_a < 0.01 * var_b, f"DhMinimize: var(dh) after apply is {var_a / var_b:.3e} of before")
    out["fits"]["DhMinimize"] = {"first_s": t_first, "steady_s": t_steady, "draw_first_s": d_first,
                                 "draw_steady_s": d_steady, "iterations": it, "shift": [tx, ty, tz],
                                 "var_ratio": var_a / var_b}
    del dh_b, dh_a, aligned

    # Bias corrections: known fields added to the reference, then a pipeline.
    cols = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    u, v = 2 * cols / (n - 1) - 1, 2 * rows / (n - 1) - 1
    theta = math.radians(30.0)
    along = cols * (RES * math.cos(theta)) + ((n - 1) - rows) * (RES * math.sin(theta))
    ck.reset_launch_counts()
    curv = terrain.get_terrain_attribute(ref, "max_curvature", resolution=RES)
    absc = curv[::4, ::4].abs()
    absc = absc[torch.isfinite(absc)]
    q99 = float(torch.kthvalue(absc, int(0.99 * absc.numel())).values)  # on every 16th pixel
    fields = {"Deramp": 2.5 * (u * u - v * v) + 2.5 * u * v,  # order 2 in pixel coordinates, within +-5 m
              "DirectionalBias": torch.sin(2 * math.pi * along / 20000.0),
              "TerrainBias": torch.clamp(curv / q99, -1.0, 1.0)}
    del absc, along, u, v
    tba_bias = ref + fields["Deramp"] + fields["DirectionalBias"] + fields["TerrainBias"]
    steps = [coreg.Deramp(subsample=5e5), coreg.DirectionalBias(angle=30, subsample=5e5),
             coreg.TerrainBias(subsample=5e5)]
    pipe = coreg.CoregPipeline(steps)
    # The first fit and a steady fit of a copy, each split by stage.
    split_spec = {"draw": (affine, "_draw_pixels"), "terrain (K1)": (terrain, "get_terrain_attribute"),
                  "binning (host)": (ss, "nd_binning"), "periodogram (host)": (fit, "_periodogram_best_wavelength"),
                  "LM polish (host)": (fit, "_polish_sumsin"), "in-fit applies": (biascorr.BiasCorr, "_apply_func")}
    ck.reset_launch_counts()
    with Stages(split_spec, sync=True) as split_first:
        _, t_pfit = _synced(lambda: pipe.fit(ref, tba_bias, random_state=42, **kw))
    fit_launches = ck.LAUNCHES["surface_fit"]
    with Stages(split_spec, sync=True) as split:
        _, t_pfit_steady = _synced(lambda: pipe.copy().fit(ref, tba_bias, random_state=42, **kw))
    pfit_split_first = {k: round(v, 3) for k, v in split_first.ms.items()}
    pfit_split = {k: round(v, 3) for k, v in split.ms.items()}
    ck.reset_launch_counts()
    (corrected, _), t_papply = _synced(lambda: pipe.apply(tba_bias, transform=transform))
    apply_launches = ck.LAUNCHES["surface_fit"]
    print(f"  pipeline Deramp + DirectionalBias(30) + TerrainBias(max_curvature): fit first {t_pfit:.3f} s "
          f"(K1 launches {fit_launches}), steady {t_pfit_steady:.3f} s; apply {t_papply:.3f} s (K1 launches "
          f"{apply_launches}); q99 |max_curvature| {q99:.6g}")
    print(f"  pipeline fit split (ms, synchronized; K1 is also inside the in-fit applies): first {pfit_split_first}, "
          f"steady {pfit_split}")
    check(fit_launches > 0 and apply_launches > 0, "K1 did not launch in the pipeline's fit and apply")
    # What each step removes of its own field, step by step as the apply chains them.
    removed, x = {}, tba_bias
    for step in steps:
        y, _ = step.apply(x, transform=transform)
        removed[type(step).__name__] = _removed_share(fields[type(step).__name__], y - x)
        x = y
    # TerrainBias evaluates the curvature of the DEM it corrects; the field it learned is
    # defined by the reference's curvature, so its correction is also read there.
    at_ref, _ = steps[2].apply(ref, transform=transform)
    removed["TerrainBias at the reference's curvature"] = _removed_share(fields["TerrainBias"], at_ref - ref)
    check(torch.equal(torch.isnan(x), torch.isnan(corrected)) and torch.equal(x.nan_to_num(), corrected.nan_to_num()),
          "the step-by-step apply differs from the pipeline's apply")
    print(f"  share of each field's variance removed: {dict((k, round(r, 5)) for k, r in removed.items())}")
    for k in ("Deramp", "DirectionalBias", "TerrainBias at the reference's curvature"):
        check(removed[k] >= 0.9, f"{k} removed {removed[k]:.4f} of its field's variance, not 0.9")
    del x, y, at_ref
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline.pkl")
        pipe.save(path)
        again, _ = coreg.Coreg.load(path).apply(tba_bias, transform=transform)
    same = torch.equal(torch.isnan(again), torch.isnan(corrected)) and torch.equal(again.nan_to_num(),
                                                                                   corrected.nan_to_num())
    print(f"  saved, loaded and applied again: bitwise equal {same}")
    check(same, "the loaded pipeline's apply differs from the first apply")
    out["pipeline"] = {"fit_first_s": t_pfit, "fit_steady_s": t_pfit_steady, "fit_split_first_ms": pfit_split_first,
                       "fit_split_ms": pfit_split, "apply_s": t_papply, "k1_fit": fit_launches,
                       "k1_apply": apply_launches, "removed": removed}
    del tba_bias, corrected, again, fields, curv

    # Card against CPU on a crop: the same draw, so the same points on both devices.
    k, c0 = COREG_CROP, (n - COREG_CROP) // 2
    crop_kw = dict(transform=Affine.from_origin(transform.c + c0 * RES, transform.f - c0 * RES, RES, RES),
                   crs=32633, random_state=42)
    ref_c, rig_c, sh_c = (a[c0:c0 + k, c0:c0 + k].contiguous() for a in (ref, tba_rigid, tba_shift))
    worst, worst_apply = {}, {}
    for name, make, tba_c in (("ICP", lambda: coreg.ICP(nn_method="brute", subsample=10000), rig_c),
                              ("LZD", lambda: coreg.LZD(subsample=100000), rig_c),
                              ("CPD", lambda: coreg.CPD(subsample=2000), rig_c),
                              ("DhMinimize", lambda: coreg.DhMinimize(subsample=100000), sh_c)):
        on_card = make().fit(ref_c, tba_c, **crop_kw)
        on_cpu = make().fit(ref_c.cpu(), tba_c.cpu(), **crop_kw)
        m_card, m_cpu = on_card.to_matrix(), on_cpu.to_matrix()
        worst[name] = float(np.abs(m_card - m_cpu).max() / np.abs(m_cpu).max())
        check(worst[name] <= 1e-4, f"{name} card vs CPU on the crop: {worst[name]:.3e} relative")
        if name in ("ICP", "LZD"):
            a_card = on_cpu.apply(tba_c, transform=crop_kw["transform"])[0].cpu()
            a_cpu = on_cpu.apply(tba_c.cpu(), transform=crop_kw["transform"])[0]
            check(torch.equal(torch.isnan(a_card), torch.isnan(a_cpu)), f"{name} tier-3 NaN masks differ")
            fin = torch.isfinite(a_cpu)
            worst_apply[name] = float((a_card[fin] - a_cpu[fin]).abs().max())
            check(worst_apply[name] <= 1e-3, f"{name} tier 3 card vs CPU: {worst_apply[name]:.3e} m")
    print(f"  card vs CPU on {k}^2: matrices max rel {dict((a, f'{b:.2e}') for a, b in worst.items())}; "
          f"tier-3 applies max abs {dict((a, f'{b:.2e}') for a, b in worst_apply.items())} m, NaN masks identical")
    out.update(crop_matrix_rel=worst, crop_apply_abs_m=worst_apply)
    return out


def _cudnn_flags() -> dict:
    """cuDNN's float32 precision switches as this torch build names them."""
    import torch

    flags = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        flags["cudnn.conv.fp32_precision"] = conv.fp32_precision
    return flags


def volume_inputs(dev, n: int, seed: int = 0):
    """Phase 7's rasters on `dev`: the main path's DEM, the noise field with its voids (NaN), the
    dDEM (VOLUME_LAW of elevation plus that noise) and the glacier index map: a 6 x 6 grid of
    labelled blocks, each 90 % of a cell wide, 0 between them."""
    import torch

    dem = spectral_dem(n, seed, device=dev)[0].float().contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    noise = VOLUME_NOISE * torch.randn((n, n), generator=gen, device=dev)
    noise = torch.where(torch.rand((n, n), generator=gen, device=dev) < VOLUME_VOIDS, torch.nan, noise)
    dh = VOLUME_LAW[0] + VOLUME_LAW[1] * dem + noise
    cell = n // 6
    idx = torch.arange(n, device=dev)
    block = torch.div(idx, cell, rounding_mode="floor")
    inside = (idx % cell >= cell // 20) & (idx % cell < cell - cell // 20) & (block < 6)
    gid = torch.where(inside[:, None] & inside[None, :], block[:, None] * 6 + block[None, :] + 1, 0)
    return dem, noise, dh, gid


def phase_volume(dev, n: int) -> dict:
    """Volume change, texture shading, the patches method, the Genton estimator and the point
    subsamples at n x n, their checks, and the card against the CPU on a crop."""
    import numpy as np
    import torch
    from scipy import ndimage

    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import terrain, volume
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import freq

    out: dict = {}
    (dem, noise, dh, gid), t_make = _synced(lambda: volume_inputs(dev, n))
    print(f"  DEM, dDEM and index map {n}x{n} made on the card in {t_make:.2f} s")
    a, b = VOLUME_LAW
    valid = torch.isfinite(dh)
    n_valid = int(valid.sum())
    ck.reset_launch_counts()

    # 1. Hypsometric bins, the regional signal, and a volume change from the tables.
    bins, t_first = _synced(lambda: volume.hypsometric_binning(dh, dem, bins=50.0))
    bins, t_steady = _synced(lambda: volume.hypsometric_binning(dh, dem, bins=50.0))
    mids = 0.5 * (bins["bin_left"] + bins["bin_right"])
    full = bins["count"] >= n * n // 1000
    full[[0, -1]] = False
    dev_law = float(np.abs(bins["value"] - (a + b * mids))[full].max())
    print(f"  hypsometric_binning, {len(mids)} bins of 50 m: first {t_first:.3f} s, steady {t_steady:.3f} s; "
          f"{int(bins['count'].sum())} of {n_valid} valid pixels binned; {int(full.sum())} populated interior bins follow "
          f"dh = {a} + {b} z to {dev_law:.4f} m")
    check(int(bins["count"].sum()) == n_valid, f"the fixed bins hold {int(bins['count'].sum())} pixels, not {n_valid}")
    check(int(full.sum()) >= 10 and dev_law <= 0.15, f"bin medians depart from the law by {dev_law:.4f} m")
    by_count, t_count = _synced(lambda: volume.hypsometric_binning(dh, dem, bins=20, kind="count"))
    by_quant, t_quant = _synced(lambda: volume.hypsometric_binning(dh, dem, bins=20, kind="quantile"))
    spread = float(by_quant["count"].max() / by_quant["count"].min())
    print(f"  kind='count' (20 bins) {t_count:.3f} s, {int(by_count['count'].sum())} pixels; kind='quantile' (20 bins) "
          f"{t_quant:.3f} s, {int(by_quant['count'].sum())} pixels, largest over smallest bin {spread:.4f}")
    # Both kinds close their last bin 1e-6 or less above the highest pixel, which float32 edges
    # round away (as in xdem_tpu): the pixels at the maximum elevation fall outside.
    check(all(0 <= n_valid - int(t["count"].sum()) <= 2 for t in (by_count, by_quant)),
          "the count or quantile bins lose more than the pixels at the maximum elevation")
    check(len(by_quant["count"]) == 20 and spread <= 1.05, f"quantile bins are uneven: {spread:.4f}")
    signal, t_sig_first = _synced(lambda: volume.get_regional_hypsometric_signal(dh, dem, gid))
    signal, t_sig = _synced(lambda: volume.get_regional_hypsometric_signal(dh, dem, gid))
    in_glaciers = int((valid & (gid > 0)).sum())
    med = signal["median"]
    print(f"  get_regional_hypsometric_signal, 36 glaciers, 20 bins: first {t_sig_first:.3f} s, steady {t_sig:.3f} s; "
          f"{int(signal['count'].sum())} of {in_glaciers} valid glacier pixels; median from {med[0]:.4f} (top) to "
          f"{med[-1]:.4f} (bottom), std {np.nanmean(signal['std']):.4f}")
    check(int(signal["count"].sum()) == in_glaciers, "the regional signal does not count every valid glacier pixel")
    check(bool(np.isfinite(med).all()) and med[0] > med[-1] and bool(np.all(np.abs(med) <= 1)),
          "the regional signal is not a finite normalized curve that rises with elevation")
    (filled, area), t_tables = _synced(lambda: (volume.interpolate_hypsometric_bins(bins),
                                               volume.calculate_hypsometry_area(bins, dem, pixel_size=RES)))
    dv = float(np.nansum(filled["value"] * area["area"]))
    dv_law = float((a + b * dem.double()).sum()) * RES * RES
    print(f"  interpolate_hypsometric_bins + calculate_hypsometry_area (host) {t_tables:.3f} s; area {area['area'].sum():.6g} m2; "
          f"volume change {dv:.6g} m3 against the law's {dv_law:.6g} m3 ({abs(dv / dv_law - 1):.3e} relative)")
    check(float(area["area"].sum()) == n * n * RES * RES, "the bins' areas do not sum to the raster's area")
    check(bool(np.isfinite(filled["value"][bins["count"] > 0]).all()) and abs(dv / dv_law - 1) <= 1e-2,
          f"volume change {dv:.6g} m3 departs from {dv_law:.6g} m3")
    out["hypsometric"] = {"first_s": t_first, "steady_s": t_steady, "count_s": t_count, "quantile_s": t_quant,
                          "law_dev_m": dev_law, "regional_first_s": t_sig_first, "regional_s": t_sig,
                          "tables_s": t_tables, "dv_m3": dv, "dv_rel": abs(dv / dv_law - 1)}
    del by_count, by_quant, valid
    torch.cuda.empty_cache()

    # 2. Slope (K1) and texture shading from one call, and texture shading at a padded size.
    before = ck.LAUNCHES["surface_fit"]
    (slope, tex), t_attr_first = _synced(lambda: terrain.get_terrain_attribute(dem, ["slope", "texture_shading"], resolution=RES))
    k1_launches = ck.LAUNCHES["surface_fit"] - before
    out["launches"] = dict(ck.LAUNCHES)  # of the path's first pass, up to and including this call
    _, t_attr = _synced(lambda: terrain.get_terrain_attribute(dem, ["slope", "texture_shading"], resolution=RES))
    _, t_tex = _synced(lambda: terrain.texture_shading(dem))
    check(k1_launches == 1, f"K1 launched {k1_launches} times for the slope of phase 7, not once")
    check(tuple(tex.shape) == (n, n) and tex.is_cuda and bool(torch.isfinite(tex).all()), "texture shading is not finite over the DEM")
    check(float(torch.isfinite(slope[8:-8, 8:-8]).float().mean()) > 0.999, "slope is not finite over the interior")
    print(f"  get_terrain_attribute(slope, texture_shading) {n}x{n}: first {t_attr_first:.3f} s, steady {t_attr * 1e3:.2f} ms "
          f"(K1 launches {k1_launches}); texture shading alone {t_tex * 1e3:.2f} ms, mean |t| {float(tex.abs().mean()):.5f}")
    del slope, tex
    ph, pw = (4000, 5003) if n >= 5003 else (n // 2, n // 2 + 3)
    padded = dem[:ph, :pw].contiguous()
    fr, fc = freq.next_fast_fft_size(ph), freq.next_fast_fft_size(pw)
    tex_p, t_pad_first = _synced(lambda: terrain.texture_shading(padded))
    tex_p, t_pad = _synced(lambda: terrain.texture_shading(padded))
    rel64, _, same = scaled_dev(tex_p, freq._texture_core(padded.double(), 0.8, fr, fc).float())
    print(f"  texture shading {ph} x {pw} padded to {fr} x {fc}: first {t_pad_first * 1e3:.2f} ms, steady {t_pad * 1e3:.2f} ms; against the float64 transform "
          f"{rel64:.3e} of the mean magnitude")
    check((fr, fc) != (ph, pw) and same and tuple(tex_p.shape) == (ph, pw) and rel64 <= TOL,
          f"padded texture shading departs from float64 by {rel64:.3e}")
    out["texture"] = {"attr_first_s": t_attr_first, "attr_ms": t_attr * 1e3, "alone_ms": t_tex * 1e3,
                      "padded_first_ms": t_pad_first * 1e3, "padded_ms": t_pad * 1e3, "padded_vs_f64": rel64, "k1_launches": k1_launches}
    del tex_p, padded
    torch.cuda.empty_cache()

    # 3. The patches method on the noise, and the mean filter alone at the largest kernel.
    areas = [math.pi * (k * RES / 2) ** 2 for k in PATCH_KERNELS]
    patches, t_patch_first = _synced(lambda: ss.patches_method(noise, areas=areas, gsd=RES))
    patches, t_patch = _synced(lambda: ss.patches_method(noise, areas=areas, gsd=RES))
    expect = VOLUME_NOISE / np.sqrt((1 - VOLUME_VOIDS) * patches["exact_areas"] / RES**2)
    ratio = patches["nmad"] / expect
    print(f"  patches_method, kernels {PATCH_KERNELS} px: first {t_patch_first:.3f} s, steady {t_patch:.3f} s; NMAD of patch "
          f"means {[round(float(v), 6) for v in patches['nmad']]} m, {[round(float(v), 4) for v in ratio]} of "
          f"sigma / sqrt(valid pixels); independent patches {[round(float(v), 1) for v in patches['nb_indep_patches']]}")
    check(bool(np.all(np.abs(ratio - 1) <= 0.1)), f"patch spreads are {ratio} of the noise's standard error")
    (mean, cnts, nb), t_filter = _synced(lambda: ss.mean_filter_nan(noise, PATCH_KERNELS[-1]))
    print(f"  mean_filter_nan, {PATCH_KERNELS[-1]} px circular kernel ({nb} pixels): {t_filter:.3f} s")
    check(mean.is_cuda and float(cnts.max()) <= nb and float(cnts[n // 2, n // 2]) > 0.8 * nb, "mean filter counts are off")
    out["patches"] = {"first_s": t_patch_first, "steady_s": t_patch, "mean_filter_s": t_filter,
                      "nmad": [float(v) for v in patches["nmad"]], "ratio": [float(v) for v in ratio]}
    del mean, cnts
    torch.cuda.empty_cache()

    # 4. Genton on the raster, and the point, disk and ring subsamples on a crop.
    var = VOLUME_NOISE**2

    def flat_variogram(label, table, min_count, tol_median, tol_worst):
        """White noise has a flat variogram at its variance: the relative departure of the bins
        with at least `min_count` pairs, as (of their median, of the worst bin), each held."""
        ok = table["count"] >= min_count
        ratio = table["exp"][ok] / var
        mid, worst = (abs(float(np.median(ratio)) - 1), float(np.abs(ratio - 1).max())) if ok.any() else (math.inf,) * 2
        check(int(ok.sum()) >= 3 and mid <= tol_median and worst <= tol_worst,
              f"{label}: gamma over the noise's variance departs from 1 by {mid:.3f} (median) and {worst:.3f} (worst bin)")
        return mid, worst

    emp, t_genton = _synced(lambda: ss.sample_empirical_variogram(noise, gsd=RES, estimator="genton", random_state=42))
    # A thousand-odd sampled points carry the variance to about 5 %, and every bin shares them;
    # the Qn of at most 400 pairs that share points spreads by about a tenth a bin besides.
    mid, worst = flat_variogram("Genton", emp, 400, 0.15, 0.5)
    print(f"  sample_empirical_variogram(estimator='genton') {n}x{n}: {t_genton:.3f} s, {int(emp['count'].sum())} pairs in "
          f"{len(emp['count'])} bins, gamma / {var}: median within {mid:.3f} of 1, worst bin {worst:.3f}")
    out["variogram"] = {"genton_s": t_genton}
    sub = noise[:min(n, 2048), :min(n, 2048)].contiguous()
    for method in ("cdist_point", "pdist_point", "pdist_disk", "pdist_ring"):
        emp, secs = _synced(lambda: ss.sample_empirical_variogram(sub, gsd=RES, subsample_method=method, random_state=42))
        mid, worst = flat_variogram(method, emp, 5000, 0.15, 0.3)
        print(f"  subsample_method='{method}' on {sub.shape[0]}^2: {secs:.3f} s, {int(emp['count'].sum())} pairs, Dowd gamma "
              f"/ {var}: median within {mid:.3f} of 1, worst bin {worst:.3f}")
        out["variogram"][method + "_s"] = secs
    check(ck.LAUNCHES["windowed"] == 0 and ck.LAUNCHES["fractal"] == 0, f"phase 7 launched {dict(ck.LAUNCHES)}")

    # 5. Card against CPU on a crop, and the convolutions against scipy.ndimage in float64.
    k, c0 = min(VOLUME_CROP, n // 2), (n - min(VOLUME_CROP, n // 2)) // 2
    crops = [x[c0:c0 + k, c0:c0 + k].contiguous() for x in (dem, noise, dh)]
    crops[0][100:110, 200:230] = float("nan")
    cell = k // 3
    gid_c = (torch.arange(k, device=dev)[:, None] // cell * 3 + torch.arange(k, device=dev)[None, :] // cell + 1)
    gid_c[:, ::cell] = 0
    flags = _cudnn_flags()
    on = []
    undo = _replay(ss, "_draw_rings_from_arr")
    try:
        for d in (dev, torch.device("cpu")):
            dem_d, noise_d, dh_d = (x.to(d) for x in crops)
            on.append({
                "bins": volume.hypsometric_binning(dh_d, dem_d, bins=50.0),
                "signal": volume.get_regional_hypsometric_signal(dh_d, dem_d, gid_c.to(d)),
                "texture": terrain.texture_shading(dem_d).cpu(),
                "patches": ss.patches_method(noise_d, areas=areas[:2], gsd=RES),
                "genton": ss.sample_empirical_variogram(noise_d, gsd=RES, estimator="genton", random_state=42),
                "mean": [x.cpu() for x in ss.mean_filter_nan(noise_d, 32)[:2]],
                "conv": ss.convolution(dem_d[None], np.random.default_rng(3).normal(size=(2, 5, 4))).cpu(),
            })
    finally:
        undo()
    gpu, cpu = on

    def rel(got, want):
        ok = np.isfinite(want)
        return float(np.abs(np.asarray(got, np.float64) - want)[ok].max() / np.abs(want[ok]).mean())

    same_nan = np.array_equal(np.isnan(gpu["bins"]["value"]), np.isnan(cpu["bins"]["value"]))
    d_bins = rel(gpu["bins"]["value"], cpu["bins"]["value"])
    check(np.array_equal(gpu["bins"]["count"], cpu["bins"]["count"]) and same_nan and d_bins <= 1e-4,
          f"hypsometric bins card vs CPU: {d_bins:.3e}")
    d_med = float(np.nanmax(np.abs(gpu["signal"]["median"] - cpu["signal"]["median"])))
    d_std = float(np.nanmax(np.abs(gpu["signal"]["std"] - cpu["signal"]["std"])))
    check(np.array_equal(gpu["signal"]["count"], cpu["signal"]["count"]) and d_med <= 1e-5 and d_std <= 1e-4,
          f"regional signal card vs CPU: median {d_med:.3e}, std {d_std:.3e}")
    d_tex, _, same_tex = scaled_dev(gpu["texture"], cpu["texture"])
    fk = freq.next_fast_fft_size(k)
    d_tex64, _, _ = scaled_dev(gpu["texture"], freq._texture_core(crops[0].double(), 0.8, fk, fk).float().cpu())
    check(same_tex and d_tex <= TOL and int(torch.isnan(gpu["texture"]).sum()) == 300, f"texture shading card vs CPU: {d_tex:.3e}")
    d_patch = float(np.abs(gpu["patches"]["nmad"] / cpu["patches"]["nmad"] - 1).max())
    check(d_patch <= 1e-4 and all(np.array_equal(gpu["patches"][c], cpu["patches"][c]) for c in ("nb_indep_patches", "exact_areas")),
          f"patches card vs CPU: {d_patch:.3e}")
    d_gen = rel(gpu["genton"]["exp"], cpu["genton"]["exp"])
    check(np.array_equal(gpu["genton"]["count"], cpu["genton"]["count"]) and d_gen <= 1e-5, f"Genton card vs CPU: {d_gen:.3e}")
    noise_h = crops[1].cpu().numpy().astype(np.float64)
    ok_h = np.isfinite(noise_h)
    kernel = ss._mean_filter_kernel(32, "circular").astype(np.float64)
    cnt64 = ndimage.convolve(ok_h.astype(np.float64), kernel, mode="constant", cval=0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean64 = ndimage.convolve(np.where(ok_h, noise_h, 0.0), kernel, mode="constant", cval=0.0) / cnt64
    d_mean = rel(gpu["mean"][0].numpy(), mean64)
    check(np.array_equal(gpu["mean"][1].numpy(), cnt64) and d_mean <= 1e-5, f"mean_filter_nan against scipy in float64: {d_mean:.3e}")
    dem_h = crops[0].cpu().numpy().astype(np.float64)
    conv64 = np.stack([ndimage.convolve(dem_h, kern, mode="constant", cval=0.0)
                       for kern in np.random.default_rng(3).normal(size=(2, 5, 4))])
    d_conv = rel(gpu["conv"][0].numpy(), conv64)
    check(np.array_equal(np.isnan(gpu["conv"][0].numpy()), np.isnan(conv64)) and d_conv <= 1e-5,
          f"convolution against scipy in float64: {d_conv:.3e}")
    check(_cudnn_flags() == flags, f"cuDNN's precision flags changed: {flags} -> {_cudnn_flags()}")
    print(f"  card vs CPU on {k}^2: hypsometric counts identical, values {d_bins:.3e} of their mean; regional counts identical, "
          f"median {d_med:.3e}, std {d_std:.3e}; texture shading {d_tex:.3e} of its mean (NaN masks identical; {d_tex64:.3e} "
          f"against float64); patches {d_patch:.3e}; Genton counts identical, gamma {d_gen:.3e}")
    print(f"  against scipy.ndimage in float64 on {k}^2: mean_filter_nan {d_mean:.3e} of the mean magnitude with exact counts, "
          f"convolution (5 x 4 kernels) {d_conv:.3e}; cuDNN flags before and after: {flags}")
    out["crop"] = {"bins": d_bins, "median": d_med, "std": d_std, "texture": d_tex, "texture_vs_f64": d_tex64,
                   "patches": d_patch, "genton": d_gen, "mean_filter_vs_scipy": d_mean, "convolution_vs_scipy": d_conv}
    return out


def raster_outlines(n: int):
    """Phase 8's glacier outlines: six ellipses over the n x n grid of RES pixels whose upper-left
    corner is RASTER_ORIGIN (UTM 33N), 181 vertices each."""
    import numpy as np

    from xdem_tpu_torch import Vector

    x0, y0 = RASTER_ORIGIN
    ang = np.linspace(0.0, 2 * np.pi, 181)
    polygons = [[np.column_stack([x0 + n * RES * (cx + rx * np.cos(ang)), y0 - n * RES * (cy + ry * np.sin(ang))])]
                for cx, cy, rx, ry in ((0.2, 0.25, 0.08, 0.05), (0.55, 0.2, 0.06, 0.09), (0.8, 0.45, 0.07, 0.06),
                                       (0.3, 0.65, 0.1, 0.06), (0.65, 0.75, 0.05, 0.08), (0.15, 0.85, 0.06, 0.05))]
    return Vector(polygons, crs=32633)


def raster_pair(dev, n: int, seed: int = 0):
    """Phase 8's pair of DEMs on `dev`: phase 4's spectral DEM at RASTER_ORIGIN in EPSG:32633 with
    vcrs EGM96, and the to-be-aligned DEM: the same terrain moved by TBA_SHIFT, sampled on a grid
    whose origin is moved by GRID_OFFSET_PX, with RASTER_NOISE m of white noise (the examples'
    instrument noise) and GLACIER_THINNING m lost inside raster_outlines(n)."""
    import torch

    from xdem_tpu_torch import DEM, Affine

    dx, dy, dz = TBA_SHIFT
    ox, oy = GRID_OFFSET_PX
    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    # Pixel (r, c) of the moved grid reads the reference terrain at (r - oy + dy / RES,
    # c + ox - dx / RES): spectral_dem's shift is minus that offset.
    ref64, tba64 = spectral_dem(n, seed, shift_px=(oy - dy / RES, dx / RES - ox), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    tba64 += dz + RASTER_NOISE * torch.randn((n, n), generator=gen, device=dev, dtype=torch.float64)
    ref = DEM.from_array(ref64.float().contiguous(), transform, 32633, vcrs="EGM96")
    del ref64
    tba = DEM.from_array(tba64.float().contiguous(), transform.translation(ox * RES, oy * RES), 32633, vcrs="EGM96")
    del tba64
    glaciers = raster_outlines(n).create_mask(tba).to(dev)
    tba.data = torch.where(glaciers, tba.data - GLACIER_THINNING, tba.data)
    return ref, tba


def reproject_oracle(src, dst_crs, dst_transform, rows, cols):
    """Float64 host values of a bilinear reprojection of Raster `src` at destination pixels
    (rows, cols): the port's projections with numpy, then scipy's order-1 map_coordinates,
    NaN where a neighbour is NaN or the point is off the source grid."""
    import numpy as np
    from scipy import ndimage

    from xdem_tpu_torch.georef import transform_points

    x, y = dst_transform.xy(rows.astype(np.float64), cols.astype(np.float64))
    sx, sy = transform_points(dst_crs, src.crs, x, y)
    r, c = src.transform.rowcol(sx, sy)
    data = src.get_nanarray()
    h, w = data.shape
    bad = np.isnan(data)
    vals = ndimage.map_coordinates(np.where(bad, np.float32(0), data), [r, c], order=1, output=np.float64)
    near_bad = ndimage.map_coordinates(bad.astype(np.float32), [r, c], order=1, output=np.float64)
    inside = (r >= 0) & (r <= h - 1) & (c >= 0) & (c <= w - 1)
    return np.where(inside & (near_bad == 0), vals, np.nan)


def check_against_oracle(label: str, out, src, seed: int) -> dict:
    """`out` (a reprojection of `src`) against reproject_oracle at ORACLE_POINTS seeded pixels:
    within 1e-5 of the oracle's mean magnitude, NaN in the same places but for 1e-3 of them
    (centres within float64 rounding of the source's edge)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h, w = out.shape
    k = min(ORACLE_POINTS, h * w)
    flat = rng.choice(h * w, k, replace=False)
    rows, cols = np.divmod(flat, w)
    got = out.data.reshape(-1)[torch.from_numpy(flat).to(out.data.device)].double().cpu().numpy()
    t0 = time.perf_counter()
    want = reproject_oracle(src, out.crs, out.transform, rows, cols)
    t_oracle = time.perf_counter() - t0
    both = np.isfinite(got) & np.isfinite(want)
    rel = float(np.abs(got[both] - want[both]).max() / np.abs(want[both]).mean())
    nan_diff = float(np.mean(np.isnan(got) != np.isnan(want)))
    print(f"  {label}: against the float64 oracle at {k} pixels ({int(both.sum())} finite, oracle {t_oracle:.2f} s on "
          f"the host): {rel:.3e} of the mean magnitude, NaN masks differ at {nan_diff:.2e} of them")
    check(both.mean() > 0.5 and rel <= 1e-5 and nan_diff <= 1e-3,
          f"{label}: {rel:.3e} of the oracle's mean magnitude, NaN masks differ at {nan_diff:.2e}")
    return {"rel": rel, "nan_diff": nan_diff, "points": k}


def phase_raster(dev, n: int, folder: str) -> dict:
    """Raster and DEM from files at n x n: GeoTIFF write and read, reprojection onto the reference
    grid and to EPSG:32632 against a float64 oracle, the vertical CRS, the 14 attributes of a DEM
    against the array path, coregister_3d with a Vector's mask, estimate_uncertainty of two DEMs,
    and the card against the CPU on a RASTER_CROP^2 pair."""
    import numpy as np
    import torch

    import xdem_tpu_torch.coreg.affine as coreg_affine
    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import DEM, Raster, coreg, terrain
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit

    dx, dy, dz = TBA_SHIFT
    out: dict = {}
    (ref_w, tba_w), t_make = _synced(lambda: raster_pair(dev, n))
    paths = {name: os.path.join(folder, f"{name}.tif") for name in ("ref", "tba")}
    out["write_s"] = {name: _synced(lambda: dem.save(paths[name]))[1] for name, dem in (("ref", ref_w), ("tba", tba_w))}
    print(f"  two {n}x{n} DEMs made on the card in {t_make:.2f} s and written as DEFLATE GeoTIFFs on the host: ref "
          f"{out['write_s']['ref']:.2f} s, tba {out['write_s']['tba']:.2f} s ({os.path.getsize(paths['ref']) / 1e6:.1f} and "
          f"{os.path.getsize(paths['tba']) / 1e6:.1f} MB)")
    outlines = raster_outlines(n)

    # The path a user drives, once, with the kernels' counts set to 0 just before it and read
    # just after; its checks and steady times follow.
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t_path = time.perf_counter()
    ref, t_read_ref = _synced(lambda: DEM(paths["ref"]))
    tba, t_read_tba = _synced(lambda: DEM(paths["tba"]))
    on_ref, t_rep_first = _synced(lambda: tba.reproject(ref))
    utm32, t_utm_first = _synced(lambda: ref.reproject(crs=32632))
    ell, t_vcrs_first = _synced(lambda: ref.to_vcrs("Ellipsoid"))
    attrs, t_attr_first = _synced(lambda: ref.get_terrain_attribute(list(SUITE)))
    stable, t_mask = _synced(lambda: ~outlines.create_mask(ref))
    nk = coreg.NuthKaab()
    aligned, t_fit = _synced(lambda: tba.coregister_3d(ref, nk, inlier_mask=stable, random_state=42))
    (sig, rho), t_unc = _synced(lambda: ref.estimate_uncertainty(aligned, stable_terrain=stable, subsample=10000,
                                                                 random_state=42))
    t_path = time.perf_counter() - t_path
    launches = dict(ck.LAUNCHES)
    center_launches = ck.CALL_LAUNCHES["center"]
    peak = torch.cuda.max_memory_allocated()
    print(f"  the file-to-result path in {t_path:.2f} s: DEM(path) ref {t_read_ref:.2f} s, tba {t_read_tba:.2f} s; "
          f"tba.reproject(ref) {t_rep_first:.3f} s; ref.reproject(crs=32632) {t_utm_first:.3f} s; to_vcrs('Ellipsoid') "
          f"{t_vcrs_first:.3f} s (the built-in geoid's fit on the host); 14 attributes {t_attr_first * 1e3:.2f} ms; "
          f"outlines.create_mask(ref) {t_mask:.3f} s (host); coregister_3d {t_fit:.3f} s; estimate_uncertainty {t_unc:.3f} s")
    print(f"  launches on the file-to-result path: {launches}; peak memory {peak / 1e9:.2f} GB")
    check(launches == {"surface_fit": 2, "windowed": 1, "fractal": 1},
          f"the path launched {launches}, not K1 twice (attributes, uncertainty), K2 and K3 once")
    out.update(read_s={"ref": t_read_ref, "tba": t_read_tba}, path_s=t_path, launches=launches,
               center_launches=center_launches, peak_gb=peak / 1e9)

    for name, dem, want in (("ref", ref, ref_w), ("tba", tba, tba_w)):
        same = bool(torch.equal(torch.isnan(dem.data), torch.isnan(want.data))) and bool(
            torch.equal(torch.nan_to_num(dem.data), torch.nan_to_num(want.data)))
        check(dem.data.device == want.data.device and same and dem.vcrs_name == "EGM96" and dem.crs == 32633
              and tuple(dem.transform) == tuple(want.transform), f"DEM({name}.tif) does not read back what was written")
    print("  DEM(path): bits, transform, CRS and vcrs EGM96 read back")
    del ref_w, tba_w

    # Reprojections: against the float64 oracle, steady times, and the byte bound.
    check(on_ref.data.device == ref.data.device and on_ref.shape == ref.shape, "tba.reproject(ref) left the grid or the card")
    out["reproject"] = {"first_s": t_rep_first, "oracle": check_against_oracle("tba.reproject(ref)", on_ref, tba, 1)}
    out["reproject_32632"] = {"first_s": t_utm_first, "oracle": check_against_oracle("ref.reproject(crs=32632)", utm32, ref, 2)}
    shape_32632, res_32632 = utm32.shape, utm32.res[0]
    del on_ref, utm32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.max_memory_allocated()
    _, t_rep = _synced(lambda: tba.reproject(ref))
    rep_peak = torch.cuda.max_memory_allocated() - base
    _, t_utm = _synced(lambda: ref.reproject(crs=32632))
    bound_ms = 2 * 4 * n * n / HBM_BYTES_PER_S * 1e3
    print(f"  tba.reproject(ref) {n}x{n}, bilinear, same CRS: steady {t_rep * 1e3:.2f} ms against a byte bound of "
          f"{bound_ms:.3f} ms (the source read once and the result written once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"{rep_peak / 1e9:.2f} GB above its inputs; ref.reproject(crs=32632) to {shape_32632[0]}x{shape_32632[1]} at "
          f"{res_32632:.3f} m: steady {t_utm * 1e3:.2f} ms")
    out["reproject"].update(steady_ms=t_rep * 1e3, bound_ms=bound_ms, peak_gb=rep_peak / 1e9)
    out["reproject_32632"]["steady_ms"] = t_utm * 1e3

    # The vertical CRS on the card: EGM96 to the ellipsoid (the built-in geoid, ~30 m here).
    und = (ell.data.double() - ref.data.double())
    lo, hi = float(und.min()), float(und.max())
    check(ell.data.device == ref.data.device and ell.vcrs_name == "Ellipsoid" and 15 < lo <= hi < 50 and hi - lo < 10,
          f"to_vcrs('Ellipsoid') moved the elevations by {lo:.3f} to {hi:.3f} m")
    del ell, und
    _, t_vcrs = _synced(lambda: ref.to_vcrs("Ellipsoid"))
    print(f"  to_vcrs('Ellipsoid') on the card: undulation {lo:.3f} to {hi:.3f} m; steady {t_vcrs * 1e3:.2f} ms")
    out["to_vcrs"] = {"first_s": t_vcrs_first, "steady_ms": t_vcrs * 1e3, "undulation_m": [lo, hi]}

    # The 14 attributes of the DEM: the array path's bits, and its time beside the array path's.
    plain = terrain.get_terrain_attribute(ref.data, list(SUITE), resolution=RES)
    for a, r, p in zip(SUITE, attrs, plain):
        check(isinstance(r, Raster) and r.nodata == -99999 and tuple(r.transform) == tuple(ref.transform)
              and bool(torch.equal(torch.isnan(r.data), torch.isnan(p))) and bool(torch.equal(torch.nan_to_num(r.data), torch.nan_to_num(p))),
              f"{a}: the DEM's attribute is not the array path's, bit for bit")
    del attrs, plain
    turns = {"dem": [], "array": []}
    for which in ("array", "dem", "dem", "array", "array", "dem"):
        fn = (lambda: ref.get_terrain_attribute(list(SUITE))) if which == "dem" else (
            lambda: terrain.get_terrain_attribute(ref.data, list(SUITE), resolution=RES))
        turns[which].append(_synced(fn)[1] * 1e3)
    t_dem, t_arr = statistics.median(turns["dem"]), statistics.median(turns["array"])
    print(f"  dem.get_terrain_attribute(14 attributes): equal to the array path to the bit; steady {t_dem:.2f} ms against "
          f"the array path's {t_arr:.2f} ms (DEM {[round(t, 2) for t in turns['dem']]}, array {[round(t, 2) for t in turns['array']]})")
    out["attributes"] = {"dem_ms": t_dem, "array_ms": t_arr, "first_ms": t_attr_first * 1e3}

    # Coregistration and uncertainty.
    tx, ty, tz = nk.to_translations()
    mag = math.hypot(dx, dy)
    print(f"  coregister_3d: {nk.meta['outputs']['iterative']['last_iteration']} iterations, ({tx:.4f}, {ty:.4f}, {tz:.4f}) m, "
          f"truth ({-dx}, {-dy}, {-dz}) m; {float(stable.float().mean()):.4f} of the pixels outside the outlines")
    check(isinstance(aligned, DEM) and aligned.shape == tba.shape and tuple(aligned.transform) == tuple(tba.transform),
          "coregister_3d did not return a DEM on the to-be-aligned grid")
    check(abs(tx + dx) <= 0.05 * mag and abs(ty + dy) <= 0.05 * mag,
          f"horizontal shift ({tx:.3f}, {ty:.3f}) not within 5% of ({-dx}, {-dy})")
    out["coreg"] = {"fit_apply_s": t_fit, "mask_s": t_mask, "translation": [tx, ty, tz]}
    finite = float(torch.isfinite(sig.data).float().mean())
    med = float(torch.nanmedian(sig.data))
    lags = np.linspace(0.0, 3e5, 3001)
    r0, r_far = float(rho(np.array([0.0]))[0]), float(rho(np.array([1e7]))[0])
    monotone = bool(np.all(np.diff(rho(lags)) <= 1e-12))
    print(f"  estimate_uncertainty: sigma {finite:.5f} finite, median {med:.6f} m; rho(0) = {r0}, rho(1e7 m) = {r_far:.3e}, "
          f"rho(20, 200, 2000 m) = {[round(float(x), 6) for x in rho(np.array([20.0, 200.0, 2000.0]))]}")
    check(isinstance(sig, Raster) and sig.data.device == ref.data.device and sig.shape == ref.shape and finite >= 0.99 and med > 0,
          f"sigma: {finite:.4f} finite, median {med}")
    check(abs(r0 - 1.0) < 1e-12 and monotone and abs(r_far) <= 0.05, f"rho(0) = {r0}, rho(1e7) = {r_far}, non-increasing: {monotone}")
    out.update(uncertainty_s=t_unc, sigma_median_m=med)
    del sig, aligned, ref, tba, stable
    torch.cuda.empty_cache()

    # The card against the CPU on a RASTER_CROP^2 pair made the same way (a crop of the pair above
    # is 20 km of one hillside, where Nuth & Kaab has no aspects to fit). The card's and the CPU's
    # generators draw other points from one seed, so the fit's draw and the uncertainty call's
    # draws are the card's, replayed on the CPU as in phase 5.
    k = min(RASTER_CROP, n)
    pair_c = raster_pair(torch.device("cpu"), k, seed=3)
    stable_c = ~raster_outlines(k).create_mask(pair_c[0])
    # The attributes on both remove the card's centre of the reference (the float64 mean rounded
    # once; the CPU's nanmean may sit an ulp away): the same mathematics, but the curvatures of
    # this smooth DEM are float32 rounding, and one ulp of the centre moves its flowline curvature
    # by 6.5 of the mean magnitude at the worst pixel. Phase 3 holds the centre itself.
    card_center = ck.dem_center(pair_c[0].data.to(dev))
    on = []
    undo = _replay(coreg_affine, "topk_subsample")
    try:
        for d in (dev, torch.device("cpu")):
            r_c, t_c = (x.copy(new_array=x.data.to(d)) for x in pair_c)
            nk_c = coreg.NuthKaab()
            aligned_c = t_c.coregister_3d(r_c, nk_c, inlier_mask=stable_c.to(d), random_state=42)
            plain_center, surfit.dem_center = surfit.dem_center, lambda dem: card_center.to(dem.device)
            try:
                attrs = [a.data.cpu() for a in r_c.get_terrain_attribute(list(SUITE))]
            finally:
                surfit.dem_center = plain_center
            on.append({"onto": t_c.reproject(r_c).data.cpu(), "utm32": r_c.reproject(crs=32632).data.cpu(),
                       "vcrs": r_c.to_vcrs("Ellipsoid").data.cpu(), "attrs": attrs,
                       "shift": np.array(nk_c.to_translations()), "pair": (r_c, aligned_c)})
    finally:
        undo()
    # The uncertainty call on both devices takes one aligned DEM (the CPU's), so that it compares
    # the uncertainty path alone.
    aligned_c = on[1]["pair"][1]
    undo = [_replay(terrain, "get_terrain_attribute"), _replay(ss, "_hetero_sample_indices"),
            _replay(ss, "_draw_rings_from_arr")]
    try:
        for o in on:
            r_c = o.pop("pair")[0]
            other = aligned_c.copy(new_array=aligned_c.data.to(r_c.data.device))
            sig_c, rho_c = r_c.estimate_uncertainty(other, stable_terrain=stable_c.to(r_c.data.device), subsample=2000,
                                                    random_state=42)
            o.update(sigma=sig_c.data.cpu().double(), rho=rho_c(np.array([20.0, 200.0, 2000.0])))
    finally:
        for u in undo:
            u()
    gpu, cpu = on
    d_rep = {key: scaled_dev(gpu[key], cpu[key])[0] for key in ("onto", "utm32")}
    nan_rep = {key: int((torch.isnan(gpu[key]) != torch.isnan(cpu[key])).sum()) for key in ("onto", "utm32")}
    d_vcrs = float((gpu["vcrs"].double() - cpu["vcrs"].double()).abs().nan_to_num(0).max())
    d_attr = max(scaled_dev(*((torch.deg2rad(g), torch.deg2rad(c)) if a == "aspect" else (g, c)), circular=a == "aspect")[0]
                 for a, g, c in zip(SUITE, gpu["attrs"], cpu["attrs"]))
    nan_attr = all(bool(torch.equal(torch.isnan(g), torch.isnan(c))) for g, c in zip(gpu["attrs"], cpu["attrs"]))
    d_shift = float(np.max(np.abs(gpu["shift"] - cpu["shift"]) / np.abs(cpu["shift"])))
    both = torch.isfinite(cpu["sigma"]) & torch.isfinite(gpu["sigma"])
    dsig = torch.abs(gpu["sigma"][both] - cpu["sigma"][both]) / cpu["sigma"][both].abs().mean()
    p999, dmax = float(torch.quantile(dsig, 0.999)), float(dsig.max())
    d_rho = float(np.abs(gpu["rho"] - cpu["rho"]).max())
    print(f"  card vs CPU on a {k}^2 pair: reproject onto the reference {d_rep['onto']:.3e}, to EPSG:32632 {d_rep['utm32']:.3e} "
          f"of the mean magnitude (NaN masks differ at {nan_rep} pixels); to_vcrs {d_vcrs:.3e} m; 14 attributes {d_attr:.3e} of "
          f"the mean magnitude (NaN masks identical {nan_attr}); Nuth & Kaab shift {d_shift:.3e} relative (card "
          f"{[round(float(v), 4) for v in gpu['shift']]} m); sigma p99.9 {p999:.3e}, max {dmax:.3e} of its mean; rho {d_rho:.3e}")
    check(max(d_rep.values()) <= 1e-6 and max(nan_rep.values()) <= 2, f"reprojection card vs CPU: {d_rep}, NaN {nan_rep}")
    check(d_vcrs <= 1e-6, f"to_vcrs card vs CPU: {d_vcrs:.3e} m")
    check(d_attr <= TOL and nan_attr, f"attributes card vs CPU: {d_attr:.3e}, NaN masks identical {nan_attr}")
    check(d_shift <= 1e-4, f"Nuth & Kaab card vs CPU: {d_shift:.3e}")
    check(p999 <= 5e-3 and dmax <= 1e-2 and d_rho <= 5e-3, f"uncertainty card vs CPU: sigma {p999:.3e} / {dmax:.3e}, rho {d_rho:.3e}")
    out["crop"] = {"reproject": d_rep, "reproject_nan_px": nan_rep, "to_vcrs_m": d_vcrs, "attributes": d_attr,
                   "shift_rel": d_shift, "sigma_p999": p999, "sigma_max": dmax, "rho": d_rho}
    return out


def point_cloud(dev, ref, transform, n_points: int, seed: int, shift=(0.0, 0.0, 0.0)):
    """An EPC of `n_points` uniform positions over the grid (numpy's draw from `seed`), with
    the bilinear heights of the terrain `ref` moved by `shift` (east, north, up metres) and
    POINT_NOISE of noise, as examples.get_epc builds its cloud; float64 on `dev`. Points whose
    source falls off the grid are dropped."""
    import numpy as np
    import torch

    from xdem_tpu_torch import EPC
    from xdem_tpu_torch.ops.interp import interp_rowcol

    rng = np.random.default_rng(seed)
    h, w = ref.shape
    rr = torch.from_numpy(rng.uniform(0, h - 1, n_points)).to(dev)
    cc = torch.from_numpy(rng.uniform(0, w - 1, n_points)).to(dev)
    noise = torch.from_numpy(rng.normal(0, POINT_NOISE, n_points)).to(dev)
    x, y = transform.xy(rr, cc)
    dx, dy, dz = shift
    z = interp_rowcol(ref, *transform.rowcol(x - dx, y - dy)) + dz + noise
    keep = torch.isfinite(z)
    return EPC(x=x[keep], y=y[keep], z=z[keep], crs=32633)


def _replay_rasters(module, name: str):
    """_replay for a function of a Raster that returns Rasters: its first result is returned
    again to every later call, its data moved to the device of that call's Raster."""
    orig = getattr(module, name)
    memo = []

    def replayed(raster, *args, **kwargs):
        if not memo:
            memo.append(orig(raster, *args, **kwargs))
        dev = raster.data.device

        def move(r):
            return r.copy(new_array=r.data.to(dev))

        return [move(r) for r in memo[0]] if isinstance(memo[0], list) else move(memo[0])

    setattr(module, name, replayed)
    return lambda: setattr(module, name, orig)


def _rigid_error(fitted, c1, truth) -> tuple[float, float, list]:
    """Largest translation (m) and rotation (deg) error of a rigid fit against `truth` applied
    about `c1`, the truth re-expressed about the fit's own centroid."""
    import numpy as np

    from xdem_tpu_torch import coreg

    aff = fitted.meta["outputs"]["affine"]
    d = np.asarray(c1) - np.asarray(aff["centroid"])
    want_m = truth.copy()
    want_m[:3, 3] = truth[:3, 3] + d - truth[:3, :3] @ d
    got = coreg.translations_rotations_from_matrix(coreg.invert_matrix(aff["matrix"]))
    want = coreg.translations_rotations_from_matrix(want_m)
    return (max(abs(g - w) for g, w in zip(got[:3], want[:3])), max(abs(g - w) for g, w in zip(got[3:], want[3:])),
            [round(v, 4) for v in got])


def phase_points(dev, n: int, n_points: int, folder: str) -> dict:
    """Point clouds and blockwise coregistration at n x n with an EPC of n_points: LAS round
    trip, the vertical CRS, raster-point fits both ways, coregister_3d, ICP and LZD on a rigid
    pair, estimate_uncertainty against the points, BlockwiseNuthKaab fit and apply,
    apply_tiled, the generic blockwise loop, and card against CPU on a crop."""
    import numpy as np
    import torch

    import xdem_tpu_torch.spatialstats as ss
    from xdem_tpu_torch import DEM, EPC, Affine, coreg, terrain, uncertainty
    from xdem_tpu_torch.coreg import affine, base, blockwise
    from xdem_tpu_torch.epc import read_epc, write_epc
    from xdem_tpu_torch.io import read_raster
    from xdem_tpu_torch.ops.reductions import masked_median
    from xdem_tpu_torch.terrain import cuda_kernels as ck

    torch.cuda.reset_peak_memory_stats()
    out: dict = {"fits": {}}
    dx, dy, dz = TBA_SHIFT
    mag = math.hypot(dx, dy)
    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    ref_t, tba_t = main_pair(dev, n)
    ref, tba = DEM.from_array(ref_t, transform, 32633), DEM.from_array(tba_t, transform, 32633)
    epc, t_make = _synced(lambda: point_cloud(dev, ref_t, transform, n_points, seed=21, shift=TBA_SHIFT))
    check(isinstance(epc, EPC) and epc.x.is_cuda and len(epc) > 0.99 * n_points, f"the EPC holds {len(epc)} points")
    print(f"  EPC of {len(epc)} points (float64 on the card) made in {t_make:.3f} s: the reference terrain moved by "
          f"{TBA_SHIFT} m, {POINT_NOISE} m of noise")

    # LAS round trip in the git-ignored outputs/ folder, then the vertical CRS on the card.
    path = os.path.join(folder, "points.las")
    _, t_write = _synced(lambda: write_epc(path, epc))
    back, t_read = _synced(lambda: read_epc(path))
    dev_las = max(float((getattr(back, k) - getattr(epc, k)).abs().max()) for k in ("x", "y", "z"))
    print(f"  LAS: written in {t_write:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), read back in {t_read:.2f} s; "
          f"EPSG {back.crs.epsg}, {len(back)} points, largest coordinate change {dev_las:.2e} m")
    check(back.crs == 32633 and len(back) == len(epc) and back.x.is_cuda and dev_las <= 5.01e-4,
          f"LAS round trip: EPSG {back.crs}, {len(back)} points, {dev_las:.2e} m")
    del back
    os.remove(path)
    epc.set_vcrs("EGM96")
    ell, t_vcrs = _synced(lambda: epc.to_vcrs("Ellipsoid"))
    und = ell.z - epc.z
    lo, hi = float(und.min()), float(und.max())
    print(f"  to_vcrs('Ellipsoid') of {len(epc)} points on the card: {t_vcrs * 1e3:.1f} ms, undulation {lo:.3f} to {hi:.3f} m")
    check(ell.z.is_cuda and ell.vcrs_name == "Ellipsoid" and 20.0 < lo <= hi < 45.0, f"undulation {lo} to {hi}")
    del ell, und
    out.update(make_s=t_make, las_write_s=t_write, las_read_s=t_read, las_max_dev_m=dev_las, to_vcrs_ms=t_vcrs * 1e3)

    def fit_twice(make, ref_, tba_):
        """First and steady fit of a fresh method, each with the draw's time and the steps of
        the brute ICP solve on the card (0 where it did not run)."""
        res = []
        for _ in range(2):
            with Stages({"draw": (affine, "_draw_valid"), "brute": (affine, "_icp_solve_device")}, sync=True) as st:
                c, secs = _synced(lambda: make().fit(ref_, tba_, random_state=42))
            res.append((c, secs, st.ms.get("draw", 0.0) / 1e3, st.last["brute"][1] if "brute" in st.last else 0))
        return res

    # Nuth & Kaab both ways: the DEM against the points finds -TBA_SHIFT, the points against the
    # DEM +TBA_SHIFT.
    for label, (a, b), sign in (("DEM ref, EPC tba", (ref, epc), -1.0), ("EPC ref, DEM tba", (epc, ref), 1.0)):
        (nk, t_first, d_first, _), (_, t_steady, d_steady, _) = fit_twice(coreg.NuthKaab, a, b)
        tx, ty, tz = nk.to_translations()
        it = nk.meta["outputs"]["iterative"]["last_iteration"]
        count = nk.meta["outputs"]["random"]["subsample_final"]
        print(f"  Nuth & Kaab ({label}): fit first {t_first:.3f} s, steady {t_steady:.3f} s (draw {d_first:.3f} / "
              f"{d_steady:.3f} s, share {d_steady / t_steady:.2f}); {it} iterations, {count} points; translation "
              f"({tx:.4f}, {ty:.4f}, {tz:.4f}) m, truth ({sign * dx}, {sign * dy}, {sign * dz}) m")
        check(abs(tx - sign * dx) <= 0.05 * mag and abs(ty - sign * dy) <= 0.05 * mag and abs(tz - sign * dz) <= 0.05 * abs(dz),
              f"Nuth & Kaab ({label}) ({tx:.3f}, {ty:.3f}, {tz:.3f}) not within 5% of the truth")
        out["fits"][f"nuth_kaab {label}"] = {"first_s": t_first, "steady_s": t_steady, "draw_first_s": d_first,
                                             "draw_steady_s": d_steady, "iterations": it, "shift": [tx, ty, tz]}
    nk = coreg.NuthKaab()
    moved, t_c3d = _synced(lambda: epc.coregister_3d(ref, nk, random_state=42))
    tx, ty, tz = nk.to_translations()
    dmove = max(float((moved.x - epc.x - tx).abs().max()), float((moved.y - epc.y - ty).abs().max()),
                float((moved.z - epc.z - tz).abs().max()))
    print(f"  epc.coregister_3d(dem): {t_c3d:.3f} s; points moved by ({tx:.4f}, {ty:.4f}, {tz:.4f}) m to {dmove:.2e} m")
    check(isinstance(moved, EPC) and moved.x.is_cuda and dmove <= 1e-6, f"coregister_3d moved the points off by {dmove}")
    out["coregister_3d_s"] = t_c3d

    # ICP and LZD on a rigid pair: points of the reference terrain moved by RIGID_TRUTH (exactly,
    # in float64) about the lower-left corner at the mean height.
    truth = coreg.matrix_from_translations_rotations(*RIGID_TRUTH)
    c1 = (transform.c, transform.f - n * RES, float(ref_t.double().mean()))
    rigid = coreg.apply_matrix(point_cloud(dev, ref_t, transform, n_points, seed=22), truth, centroid=c1)
    for name, make, atol_t, atol_r in (("ICP", lambda: coreg.ICP(subsample=50000), 2.0, 5e-3),
                                       ("LZD", lambda: coreg.LZD(), 1.0, 5e-3)):
        base.LAUNCHES["nn_scan"] = 0
        (c, t_first, d_first, steps), (_, t_steady, d_steady, steps_steady) = fit_twice(make, ref, rigid)
        scan_launches = base.LAUNCHES["nn_scan"]
        err_t, err_r, got = _rigid_error(c, c1, truth)
        print(f"  {name} (DEM ref, rigid EPC tba): fit first {t_first:.3f} s, steady {t_steady:.3f} s (draw "
              f"{d_first:.3f} / {d_steady:.3f} s); got {got}: |dt| {err_t:.4f} m, |drot| {err_r:.5f} deg"
              + (f"; nn_method='auto' took {'the brute search on the card' if steps else 'the host KD-tree'}, "
                 f"{steps} + {steps_steady} steps, {scan_launches} launches of the scan kernel" if name == "ICP" else ""))
        if name == "ICP":
            check(steps > 0, "ICP auto did not take the brute device search on the card")
            check(scan_launches == steps + steps_steady,
                  f"ICP's two fits took {steps} + {steps_steady} steps but launched the scan kernel {scan_launches} times")
            out["scan_launches"] = scan_launches
        else:
            check(scan_launches == 0, f"{name} launched ICP's scan kernel {scan_launches} times")
        check(err_t <= atol_t and err_r <= atol_r, f"{name}: |dt| {err_t:.4f} m, |drot| {err_r:.5f} deg")
        out["fits"][name] = {"first_s": t_first, "steady_s": t_steady, "draw_first_s": d_first, "draw_steady_s": d_steady,
                             "err_t_m": err_t, "err_r_deg": err_r}
    del rigid

    # The uncertainty of the DEM against the coregistered points: K1 once, phase 5's checks.
    spec = {"points to the DEM's CRS": (uncertainty, "_point_xyz"), "terrain (K1)": (terrain, "get_terrain_attribute"),
            "heteroscedasticity": (ss, "infer_heteroscedasticity_from_stable"),
            "variogram": (ss, "infer_spatial_correlation_from_stable")}
    ck.reset_launch_counts()
    with Stages(spec, sync=True) as split:
        (sig, rho), t_unc = _synced(lambda: ref.estimate_uncertainty(moved, subsample=10000, random_state=42))
    k1 = ck.LAUNCHES["surface_fit"]
    finite = float(torch.isfinite(sig.data).float().mean())
    med = float(masked_median(sig.data, torch.isfinite(sig.data)))
    lags = np.linspace(0.0, 3e5, 3001)
    r0, r_far = float(rho(np.array([0.0]))[0]), float(rho(np.array([1e7]))[0])
    monotone = bool(np.all(np.diff(rho(lags)) <= 1e-12))
    stages = {k: round(v, 1) for k, v in split.ms.items()}
    print(f"  dem.estimate_uncertainty(epc), {len(moved)} points: {t_unc:.3f} s (K1 launches {k1}), split (ms) {stages}; "
          f"sigma {finite:.5f} finite, median {med:.6f} m; rho(0) = {r0}, rho(1e7 m) = {r_far:.3e}, "
          f"rho(20, 200, 2000 m) = {[round(float(x), 6) for x in rho(np.array([20.0, 200.0, 2000.0]))]}")
    check(k1 == 1, f"K1 launched {k1} times in the uncertainty call, not once")
    check(sig.data.is_cuda and sig.shape == ref.shape and finite >= 0.99 and med > 0, f"sigma: {finite:.4f} finite, median {med}")
    check(abs(r0 - 1.0) < 1e-12 and monotone and abs(r_far) <= 0.05, f"rho(0) = {r0}, rho(1e7) = {r_far}, non-increasing: {monotone}")
    out.update(uncertainty_s=t_unc, uncertainty_stages_ms=stages, uncertainty_k1=k1, sigma_median_m=med)
    del sig, moved, epc

    # Blockwise Nuth & Kaab on phase 4's pair: 400 tiles solved together.
    bs, picks = BLOCK
    fits = []
    for _ in range(2):
        with Stages({"batched solve": (affine, "_nuth_kaab_solve_batched")}, sync=True) as st:
            bw, secs = _synced(lambda: coreg.BlockwiseNuthKaab(block_size_fit=bs, subsample_per_tile=picks,
                                                               random_state=42).fit(ref, tba))
        fits.append((bw, secs, st.ms["batched solve"], st.last["batched solve"][4]))
    (bw, t_bw_first, s_first, iters), (_, t_bw, s_steady, _) = fits
    med_s = [float(np.nanmedian(v)) for v in (bw.shifts_x, bw.shifts_y, bw.shifts_z)]
    n_tiles, n_nan = bw.shifts_x.size, int(np.isnan(bw.shifts_x).sum())
    it_hist = np.bincount(iters.cpu().numpy(), minlength=11).tolist()
    print(f"  BlockwiseNuthKaab ({n_tiles} tiles of {bs} px, {picks} picks each): fit first {t_bw_first:.3f} s, steady "
          f"{t_bw:.3f} s (batched solve {s_first:.1f} / {s_steady:.1f} ms); tiles by iterations {it_hist}; "
          f"{n_nan} gated; median shift ({med_s[0]:.4f}, {med_s[1]:.4f}, {med_s[2]:.4f}) m, truth ({-dx}, {-dy}, {-dz}) m")
    check(n_tiles == (n // bs) ** 2, f"{n_tiles} tiles")
    check(abs(med_s[0] + dx) <= 0.05 * mag and abs(med_s[1] + dy) <= 0.05 * mag and abs(med_s[2] + dz) <= 0.05 * abs(dz),
          f"blockwise median shift {med_s} not within 5% of the truth")
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    aligned, t_apply = _synced(lambda: bw.apply(tba))
    apply_peak = torch.cuda.max_memory_allocated()
    aligned, t_apply = _synced(lambda: bw.apply(tba))
    dh_b, dh_a = ref_t - tba_t, ref_t - aligned.data
    var_b = float(dh_b[torch.isfinite(dh_b)].double().var())
    var_a = float(dh_a[torch.isfinite(dh_a)].double().var())
    print(f"  BlockwiseNuthKaab.apply {n}x{n}: steady {t_apply * 1e3:.2f} ms, peak memory {apply_peak / 1e9:.2f} GB; "
          f"var(dh) {var_b:.6g} -> {var_a:.6g} (ratio {var_a / var_b:.3e})")
    check(aligned.data.is_cuda and var_a < 0.05 * var_b, f"blockwise apply: var(dh) ratio {var_a / var_b:.3e}")
    del dh_b, dh_a, aligned
    out["blockwise"] = {"fit_first_s": t_bw_first, "fit_s": t_bw, "solve_first_ms": s_first, "solve_ms": s_steady,
                        "tiles_by_iterations": it_hist, "gated": n_nan, "median_shift": med_s, "apply_ms": t_apply * 1e3,
                        "apply_peak_gb": apply_peak / 1e9, "var_ratio": var_a / var_b}

    # apply_tiled on a crop equals apply there.
    k = min(TILED_CROP, n)
    tba_k = tba.icrop((0, k), (0, k))
    tiled_path = os.path.join(folder, "tiled.tif")
    _, t_tiled = _synced(lambda: bw.apply_tiled(tba_k, out_path=tiled_path))
    whole = bw.apply(tba_k).data.cpu()
    back = read_raster(tiled_path).data.cpu()
    same = bool(torch.equal(torch.isnan(back), torch.isnan(whole)) and torch.equal(back.nan_to_num(), whole.nan_to_num()))
    print(f"  apply_tiled {k}x{k} (bands of 1024 rows, streamed to a GeoTIFF): {t_tiled:.3f} s; read back equal to apply: {same}")
    check(same, "apply_tiled differs from apply")
    os.remove(tiled_path)
    out["apply_tiled_s"] = t_tiled

    # The generic loop, one NuthKaab fit per tile, on a pair made the same way at GENERIC_CROP^2 (a
    # crop of the pair above is mostly one hillside, whose 10 km tiles leave Nuth & Kaab
    # nothing to fit).
    g = min(GENERIC_CROP, n)
    ref_g, tba_g = (DEM.from_array(a, transform, 32633) for a in main_pair(dev, g, seed=5))
    (gen, t_gen) = _synced(lambda: coreg.BlockwiseCoreg(coreg.NuthKaab(), block_size_fit=bs).fit(ref_g, tba_g))
    med_g = [float(np.nanmedian(v)) for v in (gen.shifts_x, gen.shifts_y, gen.shifts_z)]
    print(f"  BlockwiseCoreg(NuthKaab()) on {g}x{g} ({gen.shifts_x.size} tiles, one fit each): {t_gen:.3f} s; median shift "
          f"({med_g[0]:.4f}, {med_g[1]:.4f}, {med_g[2]:.4f}) m")
    check(abs(med_g[0] + dx) <= 0.05 * mag and abs(med_g[1] + dy) <= 0.05 * mag, f"generic blockwise median {med_g}")
    out["generic_blockwise_s"] = t_gen
    out["peak_gb"] = max(peak_before, torch.cuda.max_memory_allocated()) / 1e9
    print(f"  the phase's peak memory (to here): {out['peak_gb']:.2f} GB")
    del ref, tba, ref_t, tba_t, bw, gen, ref_g, tba_g
    torch.cuda.empty_cache()

    # The card against the CPU on a crop-sized pair and cloud: one numpy draw of the points on
    # both devices; the blockwise picks drawn on the card and replayed on the CPU; the terrain
    # variables of the uncertainty call computed on the card and replayed.
    k, n_c = POINTS_CROP
    cpu = torch.device("cpu")
    t_c = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    ref_c, tba_c = main_pair(cpu, k, seed=3)
    pts_c = point_cloud(cpu, ref_c, t_c, n_c, seed=23, shift=TBA_SHIFT)
    runs = []
    undo = [_replay(blockwise, "_tile_picks"), _replay_rasters(terrain, "get_terrain_attribute")]
    try:
        for d in (dev, cpu):
            r, tb = DEM.from_array(ref_c.to(d), t_c, 32633), DEM.from_array(tba_c.to(d), t_c, 32633)
            p = EPC(x=pts_c.x.to(d), y=pts_c.y.to(d), z=pts_c.z.to(d), crs=32633)
            fits = {"NK DEM-EPC": coreg.NuthKaab().fit(r, p, random_state=42).to_matrix(),
                    "NK EPC-DEM": coreg.NuthKaab().fit(p, r, random_state=42).to_matrix(),
                    "LZD DEM-EPC": coreg.LZD(subsample=20000).fit(r, p, random_state=42).to_matrix()}
            with Stages({"solve": (affine, "_nuth_kaab_solve_batched")}, sync=False) as st:
                bwc = coreg.BlockwiseNuthKaab(block_size_fit=256, subsample_per_tile=picks, random_state=42).fit(r, tb)
            sig_c, rho_c = r.estimate_uncertainty(p, subsample=2000, random_state=42)
            runs.append({"fits": fits, "shifts": np.stack([bwc.shifts_x, bwc.shifts_y, bwc.shifts_z]),
                         "iterations": st.last["solve"][4].cpu().numpy(),
                         "sigma": sig_c.data.cpu().double(), "rho": rho_c(np.array([20.0, 200.0, 2000.0]))})
    finally:
        for u in undo:
            u()
    gpu, cpu_r = runs
    d_fit = {key: float(np.abs(gpu["fits"][key] - cpu_r["fits"][key]).max() / np.abs(cpu_r["fits"][key]).max())
             for key in gpu["fits"]}
    # A tile that oscillates without converging (a 5 km crop of one hillside) amplifies the last
    # bits in which the card's and the CPU's float32 sums differ; the tiles that converge at the
    # same step on both devices are held to 1e-4 of the shifts' mean magnitude.
    sh_g, sh_c = gpu["shifts"], cpu_r["shifts"]
    conv = (gpu["iterations"] == cpu_r["iterations"]) & (cpu_r["iterations"] < 10)
    n_conv = int(conv.sum())
    d_bw = float(np.nanmax(np.abs(sh_g - sh_c)[:, conv], initial=0.0) / np.nanmean(np.abs(sh_c)))
    same_nan_bw = bool(np.array_equal(np.isnan(sh_g[:, conv]), np.isnan(sh_c[:, conv])))
    both = torch.isfinite(cpu_r["sigma"]) & torch.isfinite(gpu["sigma"])
    dsig = torch.abs(gpu["sigma"][both] - cpu_r["sigma"][both]) / cpu_r["sigma"][both].abs().mean()
    p999, dmax = float(torch.quantile(dsig, 0.999)), float(dsig.max())
    d_rho = float(np.abs(gpu["rho"] - cpu_r["rho"]).max())
    print(f"  card vs CPU on a {k}^2 pair with {len(pts_c)} points: fits max rel {dict((a, f'{b:.2e}') for a, b in d_fit.items())}; "
          f"blockwise shifts of the {n_conv}/{conv.size} tiles that converge {d_bw:.3e} of their mean magnitude "
          f"(NaN tiles identical {same_nan_bw}); sigma p99.9 "
          f"{p999:.3e}, max {dmax:.3e} of its mean; rho {d_rho:.3e}")
    check(max(d_fit.values()) <= 1e-4, f"raster-point fits card vs CPU: {d_fit}")
    check(n_conv >= 4 and d_bw <= 1e-4 and same_nan_bw,
          f"blockwise shifts card vs CPU: {n_conv} tiles converged, {d_bw:.3e}, NaN tiles identical {same_nan_bw}")
    check(p999 <= 5e-3 and dmax <= 1e-2 and d_rho <= 5e-3, f"uncertainty card vs CPU: sigma {p999:.3e} / {dmax:.3e}, rho {d_rho:.3e}")
    out["crop"] = {"fits_rel": d_fit, "blockwise_rel": d_bw, "blockwise_converged_tiles": n_conv, "sigma_p999": p999,
                   "sigma_max": dmax, "rho": d_rho}
    return out


def named_outlines(n: int):
    """raster_outlines(n) with a name for each glacier ("glacier 1" to "glacier 6")."""
    from xdem_tpu_torch import Vector

    v = raster_outlines(n)
    return Vector(v.polygons, crs=32633, properties=[{"name": f"glacier {i + 1}"} for i in range(len(v.polygons))])


def ddem_collection_inputs(dev, n: int, seed: int = 0):
    """Phase 10's three DEMs on `dev`, dated DDEM_YEARS: phase 4's terrain at RASTER_ORIGIN (the
    reference, 2010); the same minus the law VOLUME_LAW (dh = a + b z) inside the outlines
    (2000); and the terrain plus the law, sampled on a grid moved by GRID_OFFSET_PX (2020). Both
    others lose VOLUME_VOIDS of their pixels inside the outlines, in blocks of DDEM_VOID_PX.
    Returns (dems, timestamps, outlines)."""
    import datetime

    import torch

    from xdem_tpu_torch import DEM, Affine

    a, b = VOLUME_LAW
    ox, oy = GRID_OFFSET_PX
    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    moved = transform.translation(ox * RES, oy * RES)
    ref64, moved64 = spectral_dem(n, seed, shift_px=(oy, -ox), device=dev)
    outlines = named_outlines(n)
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    blocks = -(-n // DDEM_VOID_PX)
    dems = []
    for z, t, sign in ((ref64, transform, -1.0), (ref64, transform, 0.0), (moved64, moved, 1.0)):
        dem = DEM.from_array(z.float().contiguous(), t, 32633)
        if sign:
            inside = outlines.create_mask(dem).to(dev)
            lost = torch.rand((blocks, blocks), generator=gen, device=dev) < VOLUME_VOIDS
            lost = lost.repeat_interleave(DDEM_VOID_PX, 0).repeat_interleave(DDEM_VOID_PX, 1)[:n, :n]
            voids = inside & lost
            dem.data = torch.where(voids, torch.nan, torch.where(inside, dem.data + sign * (a + b * dem.data), dem.data))
        dems.append(dem)
    del ref64, moved64
    times = [datetime.datetime(y, 8, 1) for y in DDEM_YEARS]
    return dems, times, outlines


def phase_ddem(dev, n: int, folder: str) -> dict:
    """dDEM and DEMCollection at n x n: reference-wise and interval-wise dDEMs of three DEMs, the
    hypsometric gap filling of the collection, the three interpolate methods of one dDEM, the dh,
    dv and cumulative series against the law, the examples' coregistered DEM and dDEM, and the
    card against the CPU on a DDEM_CROP^2 collection."""
    import numpy as np
    import torch
    from scipy import ndimage

    from xdem_tpu_torch import DEM, DEMCollection, coreg, examples
    from xdem_tpu_torch.terrain import cuda_kernels as ck

    out: dict = {}
    (dems, times, outlines), t_make = _synced(lambda: ddem_collection_inputs(dev, n))
    ref = dems[1]
    print(f"  three {n}x{n} DEMs ({', '.join(str(y) for y in DDEM_YEARS)}; the last on a grid moved by {GRID_OFFSET_PX} px) "
          f"made on the card in {t_make:.2f} s")
    a, b = VOLUME_LAW
    inside = outlines.create_mask(ref).to(dev)
    law = float((a + b * ref.data.double())[inside].mean())
    first = outlines.query("name == 'glacier 1'").create_mask(ref).to(dev)
    law_first = float((a + b * ref.data.double())[first].mean())

    def close(x, want, what):
        rel = abs(x / want - 1)
        check(rel <= 1e-2, f"{what}: {x:.6f} against the law's {want:.6f} ({rel:.3e} relative)")
        return rel

    # The path a user drives, once, with the kernels' counts set to 0 just before it.
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = {}
    col = DEMCollection([dems[2], dems[0], dems[1]], timestamps=[times[2], times[0], times[1]], outlines=outlines,
                        reference_dem=ref)
    _, t["subtract_dems"] = _synced(col.subtract_dems)
    _, t["interpolate_ddems"] = _synced(lambda: col.interpolate_ddems("local_hypsometric"))
    dh, t["dh_series"] = _synced(col.get_dh_series)
    dv, t["dv_series"] = _synced(col.get_dv_series)
    cum_dh, t["cumulative_dh"] = _synced(lambda: col.get_cumulative_series("dh"))
    cum_dv, t["cumulative_dv"] = _synced(lambda: col.get_cumulative_series("dv"))
    dh_first, t["dh_series_filtered"] = _synced(lambda: col.get_dh_series(outlines_filter="name == 'glacier 1'"))
    cum_first, t["cumulative_filtered"] = _synced(lambda: col.get_cumulative_series("dh", outlines_filter="name == 'glacier 1'"))
    ddem = col.ddems[0]  # [2000, 2010]
    fills = {}
    for method, kw in (("idw", {}), ("local_hypsometric", {"reference_elevation": ref, "mask": outlines}),
                       ("regional_hypsometric", {"reference_elevation": ref, "mask": outlines})):
        filled, t[f"interpolate_{method}"] = _synced(lambda: ddem.interpolate(method, **kw))
        check(filled is not None and filled.shape == (n, n) and ddem.fill_method == method,
              f"dDEM.interpolate({method!r}) gave no filled array of the dDEM's shape")
        fills[method] = filled
    # Each method's values in the voids against the law (hypsometric bins are 50 m, 0.5 m of the law).
    holes = (torch.isnan(ddem.data) & inside).cpu().numpy()
    law_holes = a + b * ref.get_nanarray()[holes].astype(np.float64)
    for method, filled in fills.items():
        got = filled[holes]
        share, err = float(np.isfinite(got).mean()), float(np.nanmedian(np.abs(got - law_holes)))
        print(f"  dDEM.interpolate({method!r}): {share:.4f} of the {int(holes.sum())} void pixels filled, median |dh - law| "
              f"{err:.4f} m there")
        check(share >= 0.8 and err <= 1.0, f"{method} fills {share:.4f} of the voids, {err:.4f} m from the law")
        out.setdefault("fill", {})[method] = {"share": share, "median_err_m": err}
    del fills
    _, t["subtract_dems_intervalwise"] = _synced(col.subtract_dems_intervalwise)
    dh_iv, t["dh_series_intervalwise"] = _synced(lambda: col.get_dh_series(nans_ok=True))
    cum_iv, t["cumulative_intervalwise"] = _synced(lambda: col.get_cumulative_series("dh", nans_ok=True))
    launches = dict(ck.LAUNCHES)
    center_launches = ck.CALL_LAUNCHES["center"]
    peak = torch.cuda.max_memory_allocated() - base
    print("  first calls: " + "; ".join(f"{k} {v:.3f} s" for k, v in t.items()))
    # Steady: a second call of the subtractions and the series (the gap fillers are host code
    # that caches nothing, so their first call is their steady one).
    steady = {"subtract_dems_intervalwise": _synced(col.subtract_dems_intervalwise)[1],
              "dh_series_intervalwise": _synced(lambda: col.get_dh_series(nans_ok=True))[1]}
    ivw = list(col.ddems)
    steady["subtract_dems"] = _synced(col.subtract_dems)[1]
    steady["dh_series"] = _synced(lambda: col.get_dh_series(nans_ok=True))[1]
    steady["cumulative_dv"] = _synced(lambda: col.get_cumulative_series("dv", nans_ok=True))[1]
    col.ddems, col.ddems_are_intervalwise = ivw, True
    print("  steady calls: " + "; ".join(f"{k} {v:.3f} s" for k, v in steady.items()))
    print(f"  launches on the dDEM path: {launches} (no kernel: the series are reductions, the gap fillers host code); "
          f"peak {peak / 1e9:.2f} GB above the inputs")

    # The law over the outlines: dh of [2000, 2010] is +law, of [2010, 2020] (reference - later) -law;
    # cumulative [0, law, 2 law]; interval-wise (later - earlier) +law twice.
    print(f"  law over the outlines {law:.6f} m (glacier 1 {law_first:.6f} m); dh series {dh['dh'].tolist()}, area "
          f"{dh['area'].tolist()} m2; dv {dv['dv'].tolist()} m3; cumulative dh {cum_dh['dh'].tolist()}; interval-wise dh "
          f"{dh_iv['dh'].tolist()}, cumulative {cum_iv['dh'].tolist()}; glacier 1 {dh_first['dh'].tolist()}")
    check([str(x)[:4] for x in dh["start_time"]] == ["2000", "2010"] and len(dh["dh"]) == 2,
          "the dh series is not the two intervals [2000, 2010] and [2010, 2020]")
    rel = [close(dh["dh"][0], law, "dh [2000, 2010]"), close(-dh["dh"][1], law, "dh [2010, 2020]"),
           close(cum_dh["dh"][1], law, "cumulative dh at 2010"), close(cum_dh["dh"][2], 2 * law, "cumulative dh at 2020"),
           close(dh_iv["dh"][0], law, "interval-wise dh [2000, 2010]"), close(dh_iv["dh"][1], law, "interval-wise dh [2010, 2020]"),
           close(cum_iv["dh"][2], 2 * law, "interval-wise cumulative dh at 2020"),
           close(dh_first["dh"][0], law_first, "glacier 1 dh [2000, 2010]"),
           close(cum_first["dh"][2], 2 * law_first, "glacier 1 cumulative dh at 2020")]
    area = float(inside.sum()) * RES * RES
    check(abs(dh["area"][0] / area - 1) < 1e-9 and np.allclose(dv["dv"], dh["dh"] * dh["area"]) and cum_dh["dh"][0] == 0.0,
          "the areas, the dv series or the cumulative series' start are wrong")
    check(abs(cum_dv["dv"][2] / (2 * law * area) - 1) <= 1e-2, "the cumulative dv series does not recover the law")
    out.update(times_s=t, steady_s=steady, launches=launches, center_launches=center_launches, peak_gb=peak / 1e9,
               law_m=law, worst_rel=max(rel))

    # idw's split: its hull (a dilation and binary_fill_holes of the valid mask) timed alone on the
    # same mask; the rest of the call is the ten filter rounds and the host copies.
    valid = np.isfinite(ddem.get_nanarray())
    _, t_hull = _synced(lambda: ndimage.binary_fill_holes(ndimage.binary_dilation(valid, structure=np.ones((3, 3)))))
    t_idw = t["interpolate_idw"]
    print(f"  idw on the host (float64): {t_idw:.3f} s, of which the hull {t_hull:.3f} s (timed alone) and the ten "
          f"uniform_filter rounds with the copies {t_idw - t_hull:.3f} s")
    out["idw_split_s"] = {"rounds_and_copies": t_idw - t_hull, "hull": t_hull}
    del valid
    del col, ddem, dems, ref, inside, first
    torch.cuda.empty_cache()

    # The examples' coregistered DEM and dDEM, generated on the card.
    ex_dir = os.path.join(folder, "examples")
    _, t_ex = _synced(lambda: (examples.get_path("longyearbyen_tba_dem_coreg", output_dir=ex_dir),
                              examples.get_path("longyearbyen_ddem", output_dir=ex_dir)))
    ex_ref = examples.get_ref_dem()
    ex_coreg = DEM(examples.get_path("longyearbyen_tba_dem_coreg", output_dir=ex_dir))
    ex_ddem = DEM(examples.get_path("longyearbyen_ddem", output_dir=ex_dir))
    nk = coreg.NuthKaab().fit(ex_ref, ex_coreg, inlier_mask=~torch.from_numpy(examples.get_glacier_mask()), random_state=42)
    left = np.array(nk.to_translations())
    mag = float(np.linalg.norm(examples.TBA_SHIFT))
    same = bool(torch.equal(torch.nan_to_num(ex_ddem.data), torch.nan_to_num(ex_ref.data.to(dev) - ex_coreg.data.to(dev))))
    print(f"  examples: the coregistered DEM and the dDEM generated on the card in {t_ex:.2f} s; a new fit on them finds "
          f"{[round(float(v), 4) for v in left]} m left of the {examples.TBA_SHIFT} m shift ({float(np.linalg.norm(left)) / mag:.3e} "
          f"of it); the dDEM is ref minus that DEM: {same}")
    check(ex_coreg.data.is_cuda and float(np.linalg.norm(left)) <= 0.05 * mag and same,
          "the examples' coregistered DEM does not recover TBA_SHIFT within 5 %, or its dDEM is not ref minus it")
    out["examples"] = {"s": t_ex, "left_m": left.tolist()}

    # The card against the CPU on a DDEM_CROP^2 collection made the same way.
    k = min(DDEM_CROP, n)
    dems_c, times_c, outlines_c = ddem_collection_inputs(torch.device("cpu"), k, seed=4)
    on = []
    for d in (dev, torch.device("cpu")):
        ds = [x.copy(new_array=x.data.to(d)) for x in dems_c]
        col = DEMCollection(ds, timestamps=times_c, outlines=outlines_c, reference_dem=ds[1])
        col.subtract_dems()
        filled = col.interpolate_ddems("local_hypsometric")
        on.append((col.get_dh_series()["dh"], [torch.from_numpy(np.asarray(f, np.float64)) for f in filled]))
    (dh_g, f_g), (dh_c, f_c) = on
    d_dh = float(np.abs(dh_g - dh_c).max() / np.abs(dh_c).mean())
    d_fill = max(scaled_dev(g, c)[0] for g, c in zip(f_g, f_c) if bool(torch.isfinite(c).any()) and float(c.abs().nan_to_num().max()) > 0)
    nan_same = all(bool(torch.equal(torch.isnan(g), torch.isnan(c))) for g, c in zip(f_g, f_c))
    print(f"  card vs CPU on a {k}^2 collection: dh series {d_dh:.3e} of the mean magnitude, filled arrays {d_fill:.3e} "
          f"(NaN masks identical {nan_same})")
    check(d_dh <= 1e-5 and d_fill <= 1e-4 and nan_same, f"dDEM card vs CPU: dh {d_dh:.3e}, filled {d_fill:.3e}, NaN {nan_same}")
    out["crop"] = {"dh": d_dh, "filled": d_fill}
    return out


def _timed_calls(targets, card_timed=()):
    """Wrap (owner, name) functions so that each call's seconds add up in the returned dict
    (host clock between two synchronizations; for the names in `card_timed` CUDA events,
    one pair a call). Returns (totals, undo)."""
    import torch

    import inspect

    totals = {name: [] for _, name in targets}
    saved = []

    for owner, name in targets:
        raw = inspect.getattr_static(owner, name)
        orig = getattr(owner, name)
        saved.append((owner, name, raw))

        def wrapped(*args, _orig=orig, _name=name, **kwargs):
            if _name in card_timed and torch.cuda.is_available():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                res = _orig(*args, **kwargs)
                end.record()
                torch.cuda.synchronize()
                totals[_name].append(start.elapsed_time(end) / 1e3)
                return res
            res, s = _synced(lambda: _orig(*args, **kwargs))
            totals[_name].append(s)
            return res

        setattr(owner, name, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)

    def undo():
        for owner, name, orig in saved:
            setattr(owner, name, orig)

    return totals, undo


def phase_tiled(dev, n: int, folder: str) -> dict:
    """Terrain attributes out of core at n x n (20 m, EPSG:32633): phase 4's spectral DEM written as
    an uncompressed striped GeoTIFF, tiled_terrain_attribute from the path in bands of TILED_ROWS
    (one attribute per kernel, each kernel once a band), and on an in-memory crop of 10 000^2
    the tiled= route against the whole-array suite."""
    import shutil

    import numpy as np
    import torch

    from xdem_tpu_torch import Affine, io, terrain
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import tiled

    free = shutil.disk_usage(folder).free
    print(f"  free disk in {folder}: {free / 1e9:.2f} GB (the phase writes {TILED_DISK_BYTES / 1e9:.1f} GB)")
    check(free >= TILED_DISK_BYTES, f"phase 11 needs {TILED_DISK_BYTES / 1e9:.1f} GB of disk, {free / 1e9:.2f} GB are free")
    out: dict = {"free_disk_gb": free / 1e9}
    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    src = os.path.join(folder, "dem.tif")

    def make_and_write():
        dem = spectral_dem(n, 5, device=dev)[0].float()
        with io.StreamingRasterWriter(src, (n, n), transform, crs=32633) as wtr:
            for r0 in range(0, n, 2048):
                wtr.write_rows(r0, dem[r0:r0 + 2048].cpu().numpy())
        del dem

    _, t_write = _synced(make_and_write)
    torch.cuda.empty_cache()
    print(f"  {n}x{n} DEM made on the card and written as an uncompressed striped GeoTIFF in {t_write:.2f} s "
          f"({os.path.getsize(src) / 1e9:.2f} GB)")

    # The path, once: counts set to 0, the per-band split by wrappers that synchronize.
    totals, undo = _timed_calls([(tiled._RowSource, "rows"), (tiled, "_band_on"), (tiled, "get_terrain_attribute"),
                                 (tiled, "_rows_to_host"), (io.StreamingRasterWriter, "write_rows")],
                                card_timed=("get_terrain_attribute",))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ck.reset_launch_counts()
    try:
        paths, t_path = _synced(lambda: terrain.tiled_terrain_attribute(
            src, list(TILED_ATTRS), terrain.TilingConfig(tile_rows=TILED_ROWS, outdir=os.path.join(folder, "out"))))
    finally:
        undo()
    launches = dict(ck.LAUNCHES)
    center_launches = ck.CALL_LAUNCHES["center"]
    peak = torch.cuda.max_memory_allocated() - base
    bands = -(-n // TILED_ROWS)
    split = {k: float(sum(v)) for k, v in totals.items()}
    per_band = {k: 1e3 * float(np.median(v)) for k, v in totals.items() if v}
    print(f"  tiled_terrain_attribute({list(TILED_ATTRS)}) from the file in {bands} bands of {TILED_ROWS} rows: {t_path:.2f} s; "
          f"per band (median ms): read {per_band['rows']:.1f}, copy up {per_band['_band_on']:.1f}, kernels and epilog "
          f"(CUDA events) {per_band['get_terrain_attribute']:.1f}, copy down {per_band['_rows_to_host']:.1f}, write "
          f"{per_band['write_rows'] * len(TILED_ATTRS):.1f} ({len(TILED_ATTRS)} files); sums (s) {({k: round(v, 3) for k, v in split.items()})}")
    print(f"  launches: {launches}; peak device memory {peak / 1e9:.3f} GB above the phase's start")
    check(launches == {k: bands for k in ("surface_fit", "windowed", "fractal")},
          f"the tiled path launched {launches}, not each kernel once in each of its {bands} bands")
    check(peak < 2e9, f"the tiled path's peak device memory is {peak / 1e9:.2f} GB above its start")
    for p, a in zip(paths, TILED_ATTRS):
        rows = io.read_rows(p, n // 2, 64)
        ok = float(np.isfinite(rows[:, 8:-8]).mean())
        check(ok > 0.999 and (a != "slope" or float(np.nanmax(rows)) < 90), f"{a}: the tiled output's middle rows are wrong")
        os.remove(p)
    out.update(path_s=t_path, write_s=t_write, launches=launches, center_launches=center_launches, peak_gb=peak / 1e9, bands=bands, per_band_ms=per_band,
               split_s=split)

    # In memory: a 10 000^2 crop, tiled= against the whole-array suite (windows 5 and 13).
    k = min(10000, n)
    crop = torch.from_numpy(io.read_rows(src, 0, k)[:, :k].copy()).to(dev)
    os.remove(src)
    kw = dict(resolution=RES, window_size=5, window_size_fractal=13)
    cfg = terrain.TilingConfig(tile_rows=TILED_ROWS, outdir=os.path.join(folder, "crop"))
    (paths, t_tiled) = _synced(lambda: terrain.get_terrain_attribute(crop, list(TILED_CROP_ATTRS), tiled=cfg, **kw))
    whole, t_whole = _synced(lambda: terrain.get_terrain_attribute(crop, list(TILED_CROP_ATTRS), **kw))
    # Each band is centred on its own mean before the surface fit, so the K1 planes differ from the
    # whole array's by float32 rounding: slope and hillshade are held at TOL of their mean magnitude;
    # aspect at 0.1 deg where the slope is 1 deg or more (on flatter pixels a rounding of the
    # gradient turns it), and the maximum curvature at xdem_tpu's tolerance for this comparison
    # (|d| <= 1e-3 + 1e-4 |whole|; its mean magnitude on this DEM is rounding-sized).
    devs = {}
    slope_whole = whole[0]
    for p, a, w in zip(paths, TILED_CROP_ATTRS, whole):
        g = io.read_raster(p).data.to(dev)
        same_nan = bool(torch.equal(torch.isnan(g), torch.isnan(w)))
        both = torch.isfinite(g) & torch.isfinite(w)
        if a == "aspect":
            d = (g - w).abs()
            d = torch.where(both, torch.minimum(d, 360 - d), 0.0)
            devs[a] = float(d.max())
            devs["aspect_slope_ge_1deg"] = float(torch.where(slope_whole >= 1.0, d, 0.0).max())
            check(same_nan and devs["aspect_slope_ge_1deg"] <= 0.1,
                  f"tiled aspect departs by {devs['aspect_slope_ge_1deg']:.4f} deg where the slope is >= 1 deg (NaN {same_nan})")
        elif a == "max_curvature":
            devs[a] = scaled_dev(g, w)[0]
            excess = float(torch.where(both, (g - w).abs() - (1e-3 + 1e-4 * w.abs()), -1.0).max())
            check(same_nan and excess <= 0, f"tiled max_curvature exceeds 1e-3 + 1e-4 |whole| by {excess:.3e} (NaN {same_nan})")
        elif a in ("slope", "hillshade"):
            devs[a] = scaled_dev(g, w)[0]
            check(same_nan and devs[a] <= TOL, f"tiled {a}: {devs[a]:.3e} of the mean magnitude (NaN {same_nan})")
        else:
            devs[a] = 0.0 if bool(torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))) and same_nan else float("inf")
            check(devs[a] == 0.0, f"tiled {a} is not the whole-array result to the bit")
        os.remove(p)
        del g
    print(f"  in memory at {k}x{k}: tiled= {t_tiled:.2f} s, whole array {t_whole * 1e3:.1f} ms; deviation from the whole "
          f"array (K1: of the mean magnitude, aspect in degrees over all pixels and where the slope is >= 1 deg; K2, K3: "
          f"0 is bit-equal): {devs}")
    out["crop"] = {"tiled_s": t_tiled, "whole_ms": t_whole * 1e3, "dev": devs}
    return out


def phase_workflows(dev, n: int, folder: str) -> dict:
    """The Accuracy and Topo workflows from dict configurations on phase 8's two GeoTIFFs in
    `folder`, at output level 1, with each one's time split into loading, statistics, plots and
    the rest (the compute)."""
    import csv

    import numpy as np
    import torch

    from xdem_tpu_torch import DEM
    from xdem_tpu_torch.coreg.base import translations_rotations_from_matrix
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.workflows import Accuracy, Topo, Workflows

    try:
        import matplotlib  # noqa: F401

        plots = "drawn"
    except ImportError:
        plots = "skipped (no matplotlib)"
    paths = {name: os.path.join(folder, f"{name}.tif") for name in ("ref", "tba")}
    outlines_path = os.path.join(folder, "outlines.geojson")
    raster_outlines(n).save(outlines_path)
    out: dict = {"plots": plots}

    def table(path):
        with open(path) as f:
            rows = list(csv.DictReader(f))
        return rows

    def run(wf_cls, cfg):
        targets = [(Workflows, "_load_dem"), (Workflows, "_load_mask"), (Workflows, "compute_stats"),
                   (Workflows, "save_raster_plot")]
        if wf_cls is Accuracy:
            targets += [(Accuracy, "_histogram"), (Accuracy, "_sym_limit")]
        totals, undo = _timed_calls(targets)
        ck.reset_launch_counts()
        try:
            wf = wf_cls(cfg)
            _, t_run = _synced(wf.run)
        finally:
            undo()
        sums = {k: float(sum(v)) for k, v in totals.items()}
        split = {"loading": sums["_load_dem"] + sums["_load_mask"], "host statistics": sums["compute_stats"] + sums.get("_sym_limit", 0.0),
                 "plots": sums["save_raster_plot"] + sums.get("_histogram", 0.0)}
        split["compute and the rest"] = t_run - sum(split.values())
        return wf, t_run, split, dict(ck.LAUNCHES), ck.CALL_LAUNCHES["center"]

    # Accuracy: the default coregistration (Nuth & Kaab), the outlines as unstable terrain.
    acc_dir = os.path.join(folder, "accuracy")
    wf, t_acc, split, launches, center_launches = run(Accuracy, {
        "inputs": {"reference_elev": {"path_to_elev": paths["ref"]},
                   "to_be_aligned_elev": {"path_to_elev": paths["tba"], "path_to_mask": outlines_path}},
        "outputs": {"path": acc_dir, "level": 1}})
    tx, ty, tz = translations_rotations_from_matrix(wf.coreg.to_matrix())[:3]
    dx, dy, dz = TBA_SHIFT
    mag = math.hypot(dx, dy)
    before = float(table(os.path.join(acc_dir, "tables", "dh_before_stats.csv"))[0]["nmad"])
    after = float(table(os.path.join(acc_dir, "tables", "dh_after_stats.csv"))[0]["nmad"])
    html = open(os.path.join(acc_dir, "report.html")).read()
    print(f"  Accuracy from a dict config: {t_acc:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in split.items())}); plots "
          f"{plots}; launches {launches}; estimated ({tx:.4f}, {ty:.4f}, {tz:.4f}) m against ({-dx}, {-dy}, {-dz}); "
          f"NMAD of dh {before:.4f} m before, {after:.4f} m after")
    check("Estimated transformation" in html and abs(tx + dx) <= 0.05 * mag and abs(ty + dy) <= 0.05 * mag,
          f"Accuracy's estimated transformation ({tx:.3f}, {ty:.3f}) is not within 5 % of ({-dx}, {-dy})")
    check(after < before, f"Accuracy: the NMAD of dh after ({after}) is not below the NMAD before ({before})")
    out["accuracy"] = {"s": t_acc, "split_s": split, "launches": launches, "center_launches": center_launches,
                       "translation": [tx, ty, tz],
                       "nmad_before": before, "nmad_after": after}
    del wf
    torch.cuda.empty_cache()

    # Topo: the schema's default attributes plus one of each other kernel.
    topo_dir = os.path.join(folder, "topo")
    wf, t_topo, split, launches, center_launches = run(Topo, {"inputs": {"path_to_elev": paths["ref"]},
                                             "terrain_attributes": list(TOPO_ATTRS),
                                             "outputs": {"path": topo_dir, "level": 1}})
    print(f"  Topo from a dict config, {list(TOPO_ATTRS)}: {t_topo:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in split.items())}); "
          f"plots {plots}; launches {launches}")
    check(launches == {"surface_fit": 3, "windowed": 1, "fractal": 1},
          f"Topo launched {launches}, not K1 three times (slope, aspect, max curvature), K2 and K3 once")
    stats_names = wf.config["statistics"]
    dem = DEM(paths["ref"])
    for a in TOPO_ATTRS:
        want = dem.get_terrain_attribute(a).get_stats(stats_names)
        got = table(os.path.join(topo_dir, "tables", f"{a}_stats.csv"))[0]
        check(list(got) == list(want) and all(float(got[k]) == float(want[k]) for k in want),
              f"Topo's {a} table {got} is not get_stats of the attribute {want}")
    print(f"  each attribute's table equals get_stats of the attribute computed directly ({len(stats_names)} statistics)")
    out["topo"] = {"s": t_topo, "split_s": split, "launches": launches, "center_launches": center_launches}
    return out


def mesh_for(cards, shape: tuple[int, int]):
    """A mesh of the given shape over `cards`, each card repeated in turn (one card: every
    shard on it)."""
    from xdem_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[cards[i % len(cards)] for i in range(shape[0] * shape[1])], shape=shape)


def equal_planes(got, want) -> bool:
    """Identical NaN masks and identical values elsewhere (infinities included)."""
    import torch

    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan]))


def on_their_cards(plane, mesh) -> bool:
    """True where `plane` is a ShardedArray whose every block lies on its shard's device."""
    from xdem_tpu_torch.parallel import ShardedArray

    return isinstance(plane, ShardedArray) and all(
        b.device == mesh.devices[iy, ix] for iy, row in enumerate(plane.blocks) for ix, b in enumerate(row))


def first_shards(mesh) -> dict:
    """{card: (iy, ix) of its first shard} in mesh order."""
    import numpy as np

    out = {}
    for (iy, ix), d in np.ndenumerate(mesh.devices):
        out.setdefault(d, (iy, ix))
    return out


def phase_mesh(dev, n: int, card: str, cards) -> dict:
    """The multi-device path at n x n over `cards` (a 2 x 2 mesh of them, or of four shards of
    one card): the sharded suite, the sharded fits, the sharded uncertainty call and a
    cluster, each held to its single-device result and timed beside that result's second
    (steady) call; each kernel on each card's block held to its plain version."""
    import numpy as np
    import torch

    from xdem_tpu_torch import DEM, Affine, coreg, terrain, uncertainty
    from xdem_tpu_torch.coreg import base
    from xdem_tpu_torch.parallel import coreg as pcoreg
    from xdem_tpu_torch.parallel import halo, shard
    from xdem_tpu_torch.parallel._collectives import to
    from xdem_tpu_torch.parallel.distributed import launch_local_cluster
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit, window

    mesh = mesh_for(cards, MESH_SHARDS)
    shards = mesh.devices.size
    distinct = sorted({str(d) for d in mesh.devices.flat})
    print(f"  mesh {tuple(mesh.devices.shape)}: {shards} shards on {len(distinct)} card(s) {distinct}; {card}")
    out: dict = {"shape": list(mesh.devices.shape), "shards": shards, "cards": len(distinct)}
    if len(cards) > 1:
        ids = [d.index for d in cards]
        peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j) for i in ids for j in ids if i != j}
        block = torch.empty(625_000_000, dtype=torch.float32, device=cards[0])  # one 25 000^2 block, 2.5 GB
        t_peer = mesh_ms(lambda: block.to(cards[1]), mesh_for(cards[:2], (1, 2)))
        del block
        out.update(peer_access=peer, peer_copy_ms=t_peer)
        print(f"  peer access: {peer}; one peer copy of a 2.5 GB block {cards[0]} -> {cards[1]}: {t_peer:.3f} ms "
              f"({2.5e3 / t_peer:.1f} GB/s; host clock between waits on every card)")

    # The sharded suite on phase 4's DEM, held to the whole-array planes to the bit.
    ref, tba = main_pair(dev, n)
    whole, _ = _synced(lambda: terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES))
    _, t_whole = _synced(lambda: terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES))
    ck.reset_launch_counts()
    sharded, t_first = _synced(lambda: terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES, mesh=mesh))
    launches = dict(ck.LAUNCHES)
    center_launches = ck.CALL_LAUNCHES["center"]
    print(f"  launches on the sharded suite: {launches}, center {center_launches}")
    for k, v in launches.items():
        check(v == shards, f"kernel {k} launched {v} times on the sharded suite, not once per shard ({shards})")
    check(center_launches == 1, f"the centre launched {center_launches} times on the sharded suite, not once")
    for a, s_, w in zip(SUITE, sharded, whole):
        check(on_their_cards(s_, mesh), f"sharded {a}: a block is not on its shard's card")
        check(equal_planes(s_.to(dev), w), f"sharded {a} differs from the whole-array plane")
    del sharded
    steady = []
    for _ in range(3):
        _, secs = _synced(lambda: terrain.get_terrain_attribute(ref, list(SUITE), resolution=RES, mesh=mesh))
        steady.append(secs * 1e3)
    single_ms = t_whole * 1e3
    out["suite_ms"] = {"first": t_first * 1e3, "steady": statistics.median(steady), "single": single_ms}
    print(f"  sharded suite: all 14 planes left on their shards' cards, equal to the whole array's to the bit once "
          f"assembled; first {t_first * 1e3:.2f} ms, steady {statistics.median(steady):.2f} ms (median of 3: "
          f"{[round(t, 2) for t in steady]}); whole array {single_ms:.2f} ms (its second call)")
    del whole
    empty_all()

    # The decomposition's own costs: the one scatter of the DEM, the exchange of K1's halo
    # between the blocks on the shards, the assembly of K1's nine planes on one card (which
    # the suite no longer does: timed for comparison), and each kernel on each card's block
    # (CUDA events on that card's stream), held to the bit to its plain version on that block
    # and timed beside the plain version on the first block.
    center = ck.dem_center(ref)
    t_scatter = mesh_ms(lambda: shard(ref, mesh), mesh)
    src = shard(ref, mesh)
    t_halo = mesh_ms(lambda: halo._exchange(src, 2), mesh)
    stack = halo.sharded_surface_attributes(src, RES, mesh, SUITE[:9], center=center)
    t_assemble = mesh_ms(lambda: stack.to(dev), mesh)
    del stack
    pads = {h: halo._exchange(src, h) for h in (2, 1, 6)}
    per_card = {}
    for d, (iy, ix) in first_shards(mesh).items():
        c = to(center, d)
        for k, got, want in (
                ("surface_fit", ck.surface_attributes(pads[2][iy][ix], RES, SUITE[:9], center=c),
                 surfit.surface_attributes(pads[2][iy][ix], RES, SUITE[:9], center=c)),
                ("windowed", ck.windowed_indexes(pads[1][iy][ix], RES, SUITE[9:13], 3),
                 window.windowed_indexes(pads[1][iy][ix], RES, SUITE[9:13], 3)),
                ("fractal", ck.fractal_roughness(pads[6][iy][ix], 13), window.fractal_roughness(pads[6][iy][ix], 13))):
            check(equal_planes(got, want), f"{k} on {d}'s block {tuple(pads[6][iy][ix].shape)}: not its plain version")
        del got, want
        per_card[str(d)] = {
            "surface_fit": device_ms(lambda: ck.surface_attributes(pads[2][iy][ix], RES, SUITE[:9], center=c),
                                     calls=5, device=d),
            "windowed": device_ms(lambda: ck.windowed_indexes(pads[1][iy][ix], RES, SUITE[9:13], 3), calls=5, device=d),
            "fractal": device_ms(lambda: ck.fractal_roughness(pads[6][iy][ix], 13), calls=5, device=d)}
    b2, b1, b6 = pads[2][0][0], pads[1][0][0], pads[6][0][0]
    plain = {"surface_fit": device_ms(lambda: surfit.surface_attributes(b2, RES, SUITE[:9], center=center), device=dev),
             "windowed": device_ms(lambda: window.windowed_indexes(b1, RES, SUITE[9:13], 3), device=dev),
             "fractal": device_ms(lambda: window.fractal_roughness(b6, 13), device=dev)}
    bounds = kernel_bounds(b2.numel(), SUITE[:9], SUITE[9:13], 13)
    first = per_card[str(mesh.devices[0, 0])]
    halo_gb = sum(p.numel() for row in pads[2] for p in row) * 4 / 1e9
    print(f"  one scatter of the DEM ({n * n * 4 / 1e9:.1f} GB) {t_scatter:.3f} ms; exchange of K1's halo 2 "
          f"({halo_gb:.2f} GB of padded blocks) {t_halo:.3f} ms; assembly of 9 planes on one card "
          f"({9 * 4 * n * n / 1e9:.1f} GB, not part of the suite) {t_assemble:.3f} ms")
    for d, times in per_card.items():
        print(f"  {d} ({tuple(b2.shape)} block, each kernel equal to its plain version to the bit): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" ({card})")
    print(f"  first block's plain versions: " + ", ".join(f"{k} {v:.3f} ms" for k, v in plain.items()) +
          "; bounds " + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]})" for k, v in bounds.items()))
    out.update(scatter_ms=t_scatter, halo_ms=t_halo, assemble_ms=t_assemble, per_shard_ms=first,
               per_card_ms=per_card, plain_ms=plain, bounds={k: list(v) for k, v in bounds.items()},
               block_pixels=b2.numel())
    del src, pads, b2, b1, b6
    empty_all()

    # A ragged DEM with NaN holes over 2 x 2 and 1 x 4.
    h, w = MESH_SMALL
    rng = np.random.default_rng(13)
    z = spectral_dem(max(MESH_SMALL), 13, device=dev)[0][:h, :w].float().contiguous()
    for _ in range(12):
        r, c = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 40))
        z[r:r + int(rng.integers(1, 40)), c:c + int(rng.integers(1, 40))] = float("nan")
    z_whole = terrain.get_terrain_attribute(z, list(SUITE), resolution=RES)
    for shape in ((2, 2), (1, 4)):
        ck.reset_launch_counts()
        m = mesh_for(cards, shape)
        got = terrain.get_terrain_attribute(z, list(SUITE), resolution=RES, mesh=m)
        check(all(v == 4 for v in ck.LAUNCHES.values()), f"{shape}: launches {dict(ck.LAUNCHES)}")
        for a, s_, w_ in zip(SUITE, got, z_whole):
            check(on_their_cards(s_, m) and equal_planes(s_.to(dev), w_),
                  f"{h}x{w} over {shape}: sharded {a} differs from the whole-array plane")
    print(f"  {h}x{w} with NaN holes over 2 x 2 and 1 x 4: every plane equal to the whole array's, each kernel once a shard")
    del z, z_whole, got

    # The sharded fits on phase 4's pair against the single-device fits.
    transform = Affine.from_origin(*RASTER_ORIGIN, RES, RES)
    kw = dict(transform=transform, crs=32633, random_state=42)
    fits = (("VerticalShift", lambda: coreg.VerticalShift(), None),
            ("NuthKaab", lambda: coreg.NuthKaab(subsample=5e5), None),
            ("DhMinimize", lambda: coreg.DhMinimize(), None),
            ("ICP", lambda: coreg.ICP(subsample=5e4, nn_method="brute"), None),
            ("LZD", lambda: coreg.LZD(), 1e-3),
            ("CPD", lambda: coreg.CPD(), 1e-3))
    out["fits"] = {}
    for name, make, tol in fits:
        one, _ = _synced(lambda: make().fit(ref, tba, **kw).to_matrix())
        _, t_one = _synced(lambda: make().fit(ref, tba, **kw).to_matrix())
        base.LAUNCHES["nn_scan"] = 0
        with CardScans() as scans, Stages({"sharded": (pcoreg, "icp_solve_sharded")}, sync=False) as st:
            got, t_m1 = _synced(lambda: make().fit(ref, tba, mesh=mesh, **kw).to_matrix())
        if name == "ICP":  # one launch a shard a step, each on its shard's card
            steps = st.last["sharded"][1]
            want = {c: steps * sum(str(d) == c for d in mesh.devices.flat) for c in distinct}
            print(f"  ICP with mesh=: {steps} steps, the scan kernel's launches by card {scans.by_card}")
            check(steps > 0 and scans.by_card == want and base.LAUNCHES["nn_scan"] == steps * shards,
                  f"ICP with mesh= took {steps} steps and launched the scan kernel {scans.by_card} by card "
                  f"({base.LAUNCHES['nn_scan']} in all), not {want}")
            out["scan_launches"] = scans.by_card
        else:
            check(base.LAUNCHES["nn_scan"] == 0, f"{name} with mesh= launched ICP's scan kernel")
        _, t_m2 = _synced(lambda: make().fit(ref, tba, mesh=mesh, **kw).to_matrix())
        dev_max = float(np.abs(got - one).max())
        if tol is None:
            check(np.array_equal(got, one), f"{name}: the sharded fit is not the single-device fit to the bit "
                                            f"(max |d| {dev_max:.3e})")
        else:
            check(np.allclose(got, one, rtol=tol, atol=tol), f"{name}: sharded fit departs by {dev_max:.3e}")
        out["fits"][name] = {"single_s": t_one, "first_s": t_m1, "steady_s": t_m2, "max_abs_diff": dev_max}
        print(f"  {name:13s} sharded first {t_m1:.3f} s, steady {t_m2:.3f} s; single-device steady {t_one:.3f} s; "
              f"{'equal to the bit' if tol is None else f'max |d| {dev_max:.3e} (rtol = atol = {tol})'}; "
              f"translation {[round(float(v), 4) for v in got[:3, 3]]}")

    bs, picks = BLOCK
    ref_d, tba_d = DEM.from_array(ref, transform, 32633), DEM.from_array(tba, transform, 32633)
    bw = lambda m: coreg.BlockwiseNuthKaab(block_size_fit=bs, subsample_per_tile=picks, random_state=42,  # noqa: E731
                                           mesh=m).fit(ref_d, tba_d)
    one, t_one = _synced(lambda: bw(None))
    got, t_m1 = _synced(lambda: bw(mesh))
    _, t_m2 = _synced(lambda: bw(mesh))
    for a in ("shifts_x", "shifts_y", "shifts_z"):
        x, y = getattr(got, a), getattr(one, a)
        check(np.array_equal(np.isnan(x), np.isnan(y)) and np.allclose(x, y, rtol=2e-3, atol=2e-3, equal_nan=True),
              f"BlockwiseNuthKaab {a}: sharded tiles depart from the single-device tiles")
    exact = all(np.array_equal(getattr(got, a), getattr(one, a), equal_nan=True) for a in ("shifts_x", "shifts_y", "shifts_z"))
    out["fits"]["BlockwiseNuthKaab"] = {"single_s": t_one, "first_s": t_m1, "steady_s": t_m2, "bitwise": exact}
    print(f"  BlockwiseNuthKaab ({(n // bs) ** 2} tiles) sharded first {t_m1:.3f} s, steady {t_m2:.3f} s; single-device "
          f"{t_one:.3f} s; tiles within 2e-3 ({'equal to the bit' if exact else 'not all to the bit'})")
    del ref, tba, ref_d, tba_d
    empty_all()

    # estimate_uncertainty on phase 5's pair, with and without the mesh.
    dem = spectral_dem(n, 11, device=dev)[0].float().contiguous()
    other = (dem + 0.004 * spectral_dem(n, 12, device=dev)[0]).float().contiguous()
    ukw = dict(transform=Affine(20.0, 0.0, 4e5, 0.0, -20.0, 9e6), crs=32633, subsample=10000, random_state=42)
    lags = np.array(MESH_LAGS)
    (sig1, rho1), _ = _synced(lambda: uncertainty.estimate_uncertainty(dem, other, **ukw))
    _, t_one = _synced(lambda: uncertainty.estimate_uncertainty(dem, other, **ukw))
    ck.reset_launch_counts()
    (sig2, rho2), t_m1 = _synced(lambda: uncertainty.estimate_uncertainty(dem, other, mesh=mesh, **ukw))
    unc_launches = dict(ck.LAUNCHES)
    check(unc_launches["surface_fit"] == shards, f"K1 launched {unc_launches['surface_fit']} times in the sharded "
                                                 f"uncertainty call, not once per shard")
    check(equal_planes(sig2, sig1), "sharded sigma differs from the single-device sigma")
    check(np.array_equal(rho2(lags), rho1(lags)), f"sharded rho {rho2(lags)} != single-device {rho1(lags)}")
    _, t_m2 = _synced(lambda: uncertainty.estimate_uncertainty(dem, other, mesh=mesh, **ukw))
    out["uncertainty"] = {"single_s": t_one, "first_s": t_m1, "steady_s": t_m2}
    print(f"  estimate_uncertainty sharded first {t_m1:.3f} s, steady {t_m2:.3f} s (single-device steady {t_one:.3f} s): "
          f"sigma and rho({list(MESH_LAGS)} m) equal to the bit; launches {unc_launches}")
    del dem, other, sig1, sig2
    empty_all()

    # A cluster: on several cards one process a card on the default route (NCCL); one card
    # cannot hold two NCCL ranks, so there two processes of two shards ask for the CPU (gloo).
    procs, local, platform = (len(cards), 1, None) if len(cards) > 1 else (2, 2, "cpu")
    saved = os.environ.pop("XDEM_TPU_PLATFORM", None)
    if platform:
        os.environ["XDEM_TPU_PLATFORM"] = platform
    try:
        cluster, t_cluster = _synced(lambda: launch_local_cluster(num_processes=procs, local_devices=local,
                                                                  timeout=180.0))
    finally:
        os.environ.pop("XDEM_TPU_PLATFORM", None)
        if saved is not None:
            os.environ["XDEM_TPU_PLATFORM"] = saved
    route = cluster.strip().splitlines()[-1]
    check("DISTRIBUTED OK" in route and f"{procs * local} global devices" in route
          and "equal to one process's to the bit" in route, f"the cluster did not report success: {route}")
    out["cluster"] = {"s": t_cluster, "processes": procs, "local_devices": local,
                      "platform": platform or "default", "route": route}
    print(f"  launch_local_cluster({procs}, {local}) with XDEM_TPU_PLATFORM={platform or '(unset: the default)'} in "
          f"{t_cluster:.2f} s: {route}")
    out["launches"] = launches
    out["center_launches"] = center_launches
    return out


def seam_points(n: int) -> dict[str, tuple[int, int]]:
    """(row, col) of the middle of each seam segment of a 2 x 2 mesh over an n x n raster, and
    of its central corner."""
    h, q = n // 2, n // 4
    return {"row seam, left": (h, q), "row seam, right": (h, h + q), "column seam, top": (q, h),
            "column seam, bottom": (h + q, h), "central corner": (h, h)}


def big_dem(dev, n: int, seed: int):
    """Seeded 1/f^2.7 spectral DEM of n x n float32 pixels on `dev`, normalised to [0, 1000] m:
    the half spectrum drawn in row bands, then inverse transforms one axis at a time in bands
    (no single transform of n^2 points), with BIG_VOIDS seeded NaN voids and one across the
    middle of each seam segment and the central corner of a 2 x 2 mesh."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    fy, fx = torch.fft.fftfreq(n, device=dev), torch.fft.rfftfreq(n, device=dev)
    step = 2048
    spec = torch.empty((n, fx.numel()), dtype=torch.complex64, device=dev)
    for r0 in range(0, n, step):
        amp = torch.hypot(fy[r0:r0 + step, None], fx[None, :])
        if r0 == 0:
            amp[0, 0] = 1.0
        amp.pow_(-2.7)
        if r0 == 0:
            amp[0, 0] = 0.0
        spec[r0:r0 + step] = torch.polar(amp, torch.rand(amp.shape, generator=g, device=dev).mul_(2 * math.pi))
    for c0 in range(0, fx.numel(), step):
        spec[:, c0:c0 + step] = torch.fft.ifft(spec[:, c0:c0 + step], dim=0)
    z = torch.empty((n, n), dtype=torch.float32, device=dev)
    for r0 in range(0, n, step):
        z[r0:r0 + step] = torch.fft.irfft(spec[r0:r0 + step], n=n, dim=1)
    del spec
    zmin, zmax = z.min(), z.max()
    z.sub_(zmin).mul_(1000.0 / (zmax - zmin))
    rng = np.random.default_rng(seed)
    for _ in range(BIG_VOIDS):
        r, c = int(rng.integers(0, n - 64)), int(rng.integers(0, n - 64))
        z[r:r + int(rng.integers(1, 64)), c:c + int(rng.integers(1, 64))] = float("nan")
    for r, c in seam_points(n).values():
        z[r - 5:r + 4, c - 7:c + 3] = float("nan")
    return z


def phase_big(cards, n: int, card_lines: list[str]) -> dict:
    """The 14-attribute suite at n x n over a 2 x 2 mesh of four cards, whose planes no one
    card holds: the planes stay on their cards, each kernel launches once a card, and a crop
    around the middle of every seam segment and the central corner, computed whole on one card
    by the kernels' plain versions with the whole DEM's centre, equals the sharded planes'
    window to the bit (so every card's block is held to the plain versions)."""
    import torch

    from xdem_tpu_torch import terrain
    from xdem_tpu_torch.parallel import halo, make_mesh, shard, sharded
    from xdem_tpu_torch.parallel._collectives import to
    from xdem_tpu_torch.terrain import cuda_kernels as ck
    from xdem_tpu_torch.terrain import surfit, window
    from xdem_tpu_torch.terrain.terrain import _terrain_epilog

    dev = cards[0]
    mesh = make_mesh(devices=cards[:4], shape=(2, 2))
    out: dict = {"size": n, "mesh": [2, 2], "cards": [str(d) for d in cards[:4]]}
    z, t_gen = _synced(lambda: big_dem(dev, n, seed=21))
    finite = float(torch.isfinite(z).float().mean())
    print(f"  DEM {n} x {n} float32 ({z.numel() * 4 / 1e9:.1f} GB) on {dev} in {t_gen:.2f} s, {finite:.6f} finite; "
          f"planes of the suite {len(SUITE) * z.numel() * 4 / 1e9:.0f} GB")
    empty_all()

    def suite():
        return terrain.get_terrain_attribute(z, list(SUITE), resolution=RES, mesh=mesh)

    # The whole DEM's centre, as the suite removes it, held and timed (now: torch's nanmean chain,
    # timed beside it, needs ~25 GB of cuda:0, which the planes fill once they exist).
    center = ck.dem_center(z)
    out["center"] = phase_center(z, f"the {n} x {n} DEM on {dev}")
    empty_all()

    # Any gathering of blocks into one tensor during the suite's calls is counted: none may happen.
    gathered = []
    real_assemble = sharded._assemble
    sharded._assemble = lambda s, *a: gathered.append(s.shape) or real_assemble(s, *a)
    try:
        base = []
        for d in cards[:4]:
            torch.cuda.reset_peak_memory_stats(d)
            base.append(torch.cuda.memory_allocated(d))
        ck.reset_launch_counts()
        planes, t_first = _synced(suite)
        launches = dict(ck.LAUNCHES)
        center_launches = ck.CALL_LAUNCHES["center"]
        peaks = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards[:4]]
        held = [(torch.cuda.memory_allocated(d) - b) / 1e9 for d, b in zip(cards[:4], base)]
    finally:
        sharded._assemble = real_assemble
    print(f"  launches on the suite: {launches}, center {center_launches}")
    for k, v in launches.items():
        check(v == 4, f"kernel {k} launched {v} times on the 50 000^2 suite, not once per card")
    check(center_launches == 1, f"the centre launched {center_launches} times on the 50 000^2 suite, not once")
    bh = -(-n // 2)
    for a, p in zip(SUITE, planes):
        check(on_their_cards(p, mesh) and p.shape == (n, n) and p.block_shape == (bh, bh),
              f"{a}: not a ({n}, {n}) plane in blocks of {bh}^2 on their cards")
    check(not gathered, f"a plane was assembled on one device during the suite: {gathered}")
    for d, line, pk, hd in zip(cards[:4], card_lines, peaks, held):
        print(f"  {d} peak {pk:.2f} GB, holding {hd:.2f} GB of planes after the call ({line})")
    out.update(launches=launches, center_launches=center_launches, peak_gb=peaks, held_gb=held, first_ms=t_first * 1e3)

    # Every seam and the central corner: the crop computed whole on one card by the plain
    # versions with the whole DEM's centre (a margin of BIG_MARGIN >= the largest halo, 6)
    # against the sharded window.
    m, half = BIG_MARGIN, BIG_CROP // 2
    for name, (rc, cc) in seam_points(n).items():
        r0, c0 = rc - half, cc - half
        crop = z[r0 - m:r0 + BIG_CROP + m, c0 - m:c0 + BIG_CROP + m].contiguous()
        stack = torch.cat([surfit.surface_attributes(crop, RES, SUITE[:9], center=center),
                           window.windowed_indexes(crop, RES, SUITE[9:13], 3), window.fractal_roughness(crop, 13)[None]])
        voids = 0
        for i, a in enumerate(SUITE):
            want = _terrain_epilog(stack[i], a, True, torch.float32)[m:-m, m:-m]
            got = planes[i].window(slice(r0, r0 + BIG_CROP), slice(c0, c0 + BIG_CROP), dev)
            check(equal_planes(got, want), f"{name} crop at ({rc}, {cc}): sharded {a} differs from the whole crop")
            voids = max(voids, int(torch.isnan(want).sum()))
        check(voids > 0 and bool(torch.isfinite(crop).any()), f"{name} crop: no void or no finite pixel")
        print(f"  {name} crop ({BIG_CROP}^2 around ({rc}, {cc}), margin {m}): all 14 planes equal to the plain "
              f"versions' whole crop to the bit, NaN masks included ({voids} NaN pixels at most)")
    del planes
    empty_all()

    steady = []
    for _ in range(2):
        res, secs = _synced(suite)
        del res
        steady.append(secs * 1e3)
    out["steady_ms"] = statistics.median(steady)
    print(f"  suite at {n} x {n} over four cards: first {t_first * 1e3:.1f} ms, steady {statistics.median(steady):.1f} ms "
          f"({[round(t, 1) for t in steady]}); host clock between waits on every card; {card_lines[0]}")
    empty_all()

    # The pieces: the one scatter, each family's halo exchange, the centre on the first card (as
    # timed above), each kernel on each card's block (CUDA events on that card's stream).
    t_scatter = mesh_ms(lambda: shard(z, mesh), mesh)
    src = shard(z, mesh)
    t_exchange = {h: mesh_ms(lambda: halo._exchange(src, h), mesh) for h in (2, 1, 6)}
    t_center = out["center"]["ms"]
    pads = {h: halo._exchange(src, h) for h in (2, 1, 6)}
    per_card = {}
    for d, (iy, ix) in first_shards(mesh).items():
        c = to(center, d)
        per_card[str(d)] = {
            "surface_fit": device_ms(lambda: ck.surface_attributes(pads[2][iy][ix], RES, SUITE[:9], center=c), device=d),
            "windowed": device_ms(lambda: ck.windowed_indexes(pads[1][iy][ix], RES, SUITE[9:13], 3), device=d),
            "fractal": device_ms(lambda: ck.fractal_roughness(pads[6][iy][ix], 13), device=d)}
    bounds = kernel_bounds(pads[2][0][0].numel(), SUITE[:9], SUITE[9:13], 13)
    print(f"  one scatter of the DEM ({z.numel() * 3 / 1e9:.1f} GB to three cards) {t_scatter:.2f} ms; halo exchanges "
          + ", ".join(f"h={h} {t:.2f} ms" for h, t in t_exchange.items())
          + f"; the centre on {dev} {t_center:.2f} ms; host clock between waits on every card ({card_lines[0]})")
    for (d, times), line in zip(per_card.items(), card_lines):
        print(f"  {d} ({tuple(pads[2][0][0].shape)} block): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
              + f" ({line})")
    print("  bounds per block: " + ", ".join(f"{k} {v[0]:.3f} ms ({v[1]})" for k, v in bounds.items()))
    out.update(scatter_ms=t_scatter, exchange_ms={str(h): t for h, t in t_exchange.items()}, dem_center_ms=t_center,
               per_card_ms=per_card, bounds={k: list(v) for k, v in bounds.items()})
    del src, pads, z
    empty_all()
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive xdem_tpu_torch on the card and check every step.")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="1 (default): phases 1-13 on one card; 4: the build, phase 3 on each card, phase 13 over "
                         "the four cards and phase 14 (50 000^2 over a 2 x 2 mesh of them)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU.", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} CUDA devices, found {torch.cuda.device_count()}.",
              file=sys.stderr)
        return 1
    from xdem_tpu_torch import _build

    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(args.cards)]
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[1/14] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible, {args.cards} used)")
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 and smi.stdout.strip() else []
    card_lines = (lines + ["nvidia-smi: unavailable"] * args.cards)[:args.cards]
    card = card_lines[0]
    for line in card_lines:
        print(line)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")

    lib, seconds, log = _build.build()
    _build.load()
    print(f"[2/14] build: {lib.relative_to(_build.PACKAGE_DIR.parent)} in {seconds:.2f} s")
    entry = spills = ""
    for line in log.splitlines():  # per nvcc job its seconds, per kernel what ptxas -v says of it
        if line.startswith("nvcc "):
            print("  " + line.strip())
        elif "Compiling entry function" in line:
            entry = line.split("'")[1].split("_cu_")[-1][8:52]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            print(f"    {entry}: {line.split(':', 1)[-1].strip()}; {spills}")

    if args.cards > 1:
        return main_cards(cards, card_lines, name)

    print("[3/14] kernels against their plain versions on the card (2047 x 2061):")
    max_err = phase_kernels(dev)

    print(f"[4/14] main path at {MAIN_SIZE} x {MAIN_SIZE}:")
    res = phase_main(dev, MAIN_SIZE, card)
    torch.cuda.empty_cache()

    print(f"[5/14] uncertainty at {MAIN_SIZE} x {MAIN_SIZE}:")
    unc = phase_uncertainty(dev, MAIN_SIZE)
    torch.cuda.empty_cache()

    print(f"[6/14] coregistration at {MAIN_SIZE} x {MAIN_SIZE}:")
    cor = phase_coreg(dev, MAIN_SIZE)
    torch.cuda.empty_cache()

    print(f"[7/14] volume change and the rest of the statistics at {MAIN_SIZE} x {MAIN_SIZE}:")
    vol = phase_volume(dev, MAIN_SIZE)
    torch.cuda.empty_cache()

    print(f"[8/14] Raster and DEM from files at {MAIN_SIZE} x {MAIN_SIZE}:")
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs")  # git-ignored
    os.makedirs(scratch, exist_ok=True)
    # Phase 8's two files stay until phase 12 has read them.
    with tempfile.TemporaryDirectory(dir=scratch) as raster_folder:
        ras = phase_raster(dev, MAIN_SIZE, raster_folder)
        torch.cuda.empty_cache()

        print(f"[9/14] point clouds and blockwise coregistration at {MAIN_SIZE} x {MAIN_SIZE} with {POINTS} points:")
        with tempfile.TemporaryDirectory(dir=scratch) as folder:
            pts = phase_points(dev, MAIN_SIZE, POINTS, folder)
        torch.cuda.empty_cache()

        print(f"[10/14] dDEM and DEMCollection at {MAIN_SIZE} x {MAIN_SIZE} ({card}):")
        with tempfile.TemporaryDirectory(dir=scratch) as folder:
            ddm = phase_ddem(dev, MAIN_SIZE, folder)
        torch.cuda.empty_cache()

        print(f"[11/14] terrain attributes out of core at {TILED_SIZE} x {TILED_SIZE} ({card}):")
        with tempfile.TemporaryDirectory(dir=scratch) as folder:
            til = phase_tiled(dev, TILED_SIZE, folder)
        torch.cuda.empty_cache()

        print(f"[12/14] the Accuracy and Topo workflows on phase 8's files ({card}):")
        wfl = phase_workflows(dev, MAIN_SIZE, raster_folder)
    torch.cuda.empty_cache()

    print(f"[13/14] the multi-device path at {MAIN_SIZE} x {MAIN_SIZE} (four shards of {dev}):")
    msh = phase_mesh(dev, MAIN_SIZE, card, [dev])
    print(f"[14/14] the suite at {BIG_SIZE} x {BIG_SIZE} over four cards: not run here; it needs four cards "
          f"(python3 chip_smoke.py --cards 4)")

    paths = {"main": res["launches"], "raster": ras["launches"], "ddem": ddm["launches"], "tiled": til["launches"],
             "accuracy": wfl["accuracy"]["launches"], "topo": wfl["topo"]["launches"], "mesh": msh["launches"]}
    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": res["launches"][k],
         "launches_by_path": {p: counts[k] for p, counts in paths.items()},
         "max_abs_err": max_err[k], "ms": res["times"][k][0], "plain_ms": res["times"][k][1],
         "bound_ms": res["bounds"][k][0], "bound_by": res["bounds"][k][1], "library_ms": None}
        for k, (src, rep) in KERNELS.items()
    ] + [center_summary(res["center"], {"main": res["center_launches"], "raster": ras["center_launches"],
                                        "ddem": ddm["center_launches"], "tiled": til["center_launches"],
                                        "accuracy": wfl["accuracy"]["center_launches"],
                                        "topo": wfl["topo"]["center_launches"], "mesh": msh["center_launches"]}),
        {"name": "regrid_step", "route": "cuda", "source": REGRID_SOURCE, "replaces": None,
         "launches": cor["regrid_launches"], "launches_by_path": {"coreg": cor["regrid_launches"]},
         **cor["regrid_step"], "library_ms": None},
        {"name": "nn_scan", "route": "cuda", "source": NN_SCAN_SOURCE, "replaces": None,
         "launches_by_path": {"coreg": cor["nn_scan"]["launches"], "points": pts["scan_launches"],
                              "mesh": msh["scan_launches"]}, **cor["nn_scan"], "library_ms": None}],
        "suite_ms": res["suite_ms"], "nuth_kaab_fit_ms": res["fit_ms"],
        "nuth_kaab_first_fit_ms": res["first_fit_ms"], "main_size": MAIN_SIZE, "surface_fit_ms": res["k1_ms"],
        "windowed_ms": res["k2_ms"], "fractal_ms": res["k3_ms"],
        "uncertainty": unc, "coreg": cor, "volume": vol, "raster": ras, "points": pts,
        "ddem": ddm, "tiled": til, "workflows": wfl, "mesh": msh}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


def main_cards(cards, card_lines: list[str], name: str) -> int:
    """The four-card run after the build: phase 3 on each card, phase 13 over the cards and
    phase 14. Its main path is phase 14's suite: the kernels' launches are counted there; their
    times beside their plain versions and bounds are phase 13's, on one shard's block."""
    print(f"[3/14] kernels against their plain versions on each of the {len(cards)} cards (2047 x 2061):")
    max_err = {k: 0.0 for k in KERNELS}
    for d in cards:
        for k, v in phase_kernels(d, verbose=False).items():
            max_err[k] = max(max_err[k], v)
    print("[4-12/14] not run with --cards: they run on one card (python3 chip_smoke.py)")
    print(f"[13/14] the multi-device path at {MAIN_SIZE} x {MAIN_SIZE} over {len(cards)} cards:")
    msh = phase_mesh(cards[0], MAIN_SIZE, card_lines[0], cards)
    empty_all()
    print(f"[14/14] the 14-attribute suite at {BIG_SIZE} x {BIG_SIZE} over a 2 x 2 mesh of four cards:")
    big = phase_big(cards, BIG_SIZE, card_lines)

    summary = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": big["launches"][k],
         "launches_by_path": {"mesh": msh["launches"][k], "big": big["launches"][k]},
         "max_abs_err": max_err[k], "ms": msh["per_shard_ms"][k], "plain_ms": msh["plain_ms"][k],
         "bound_ms": msh["bounds"][k][0], "bound_by": msh["bounds"][k][1], "library_ms": None,
         "ms_by_card_at_big_size": {d: t[k] for d, t in big["per_card_ms"].items()}}
        for k, (src, rep) in KERNELS.items()
    ] + [center_summary(big["center"], {"big": big["center_launches"], "mesh": msh["center_launches"]}),
        {"name": "nn_scan", "route": "cuda", "source": NN_SCAN_SOURCE, "replaces": None,
         "launches": sum(msh["scan_launches"].values()), "launches_by_path": {"mesh": msh["scan_launches"]}}],
        "mesh": msh, "big": big}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": len(cards)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
