"""The port's rigid coregistration (ICP, LZD, the small-rotation regrid and their pipeline)
against the plain reference on seeded tilted pairs: a 1/f^2.7 spectral DEM and its surface moved
by (20, 5, 0.1) m and (0.1, 0.05, 0.01) degrees about its centre (the plain float64 regrid), plus
a two-range elevation error and voids, on a 10 m grid.

The reference is the benchmark's, ``gpu_bench/reference_rigid.py``. It is given the program's
draw (the pixels numpy picked), so the fits differ by arithmetic alone: the program's float32
against the reference's float64; from the same random_state it draws those pixels itself.
Each tolerance is about ten times the largest gap seen on these pairs, and the reference in
bfloat16 in the program's place fails them.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from gpu_bench import inputs, reference_rigid
from xdem_tpu_torch import coreg
from xdem_tpu_torch.coreg import affine
from xdem_tpu_torch.georef import Affine

RES = 10.0
TRANSFORM = Affine.from_origin(-300000.0, -1000000.0, RES, RES)
T6 = tuple(TRANSFORM)
MOTION = reference_rigid.rigid((20.0, 5.0, 0.1), (0.1, 0.05, 0.01))
ERROR = [{"range_m": 100.0, "sd_m": 0.3}, {"range_m": 2000.0, "sd_m": 0.5}]
CPU = torch.device("cpu")
ICP_POINTS, LZD_POINTS = 3000, 20000
# Motions: the float32 clouds of ICP (standardised to ~1, rounding 6e-8 of a ~1 km spread) and
# LZD's float32 centred coordinates move a fit by up to 9e-5 m and 9e-7 degrees on this pair.
MOTION_M, MOTION_DEG = 1e-3, 1e-5
# A DEM: float32 heights of ~500 m (rounding 3e-5 m) and float32 coordinates about the centroid
# give a mean gap of up to 1.1e-5 of the mean correction on this pair; a source point within
# rounding of the grid's edge or of a void's border may fall on either side of it.
DEM_GAP, FINITE_SHARE = 1e-4, 1e-4


def tilted(n: int, seed: int):
    """(reference, to-be-aligned, centre) of a seeded tilted pair of side n."""
    (ref,) = inputs.spectral_dem(n, seed, CPU, 2.7, 1000.0)
    centre = reference_rigid.centre(T6, ref.shape, ref)
    tba = reference_rigid.regrid_bands(ref, T6, MOTION, centre, torch.float64, 128).float()
    tba.add_(inputs.error_field(n, seed + 1, CPU, ERROR, RES))
    inputs.cut_voids(tba, seed + 2, 6, 5, n // 8)
    return ref, tba, centre


@pytest.fixture(scope="module")
def pair():
    return tilted(384, 21)


@contextlib.contextmanager
def draws():
    """The (rows, cols) of every draw of the program's grid subsample, in order."""
    got = []
    real = affine._draw_pixels

    def draw(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append(out[:2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(affine, "_draw_pixels", draw)
        yield got


def motion(c):
    return c.to_matrix(), c.meta["outputs"]["affine"]["centroid"]


def dem_gap(got: torch.Tensor, want: torch.Tensor, src: torch.Tensor) -> tuple[float, float]:
    """(mean deviation over the mean correction |want - src|, share of pixels whose finiteness differs)."""
    g, w, s = got.double(), want.double(), src.double()
    both = torch.isfinite(g) & torch.isfinite(w) & torch.isfinite(s)
    gap = float((g - w)[both].abs().mean() / (w - s)[both].abs().mean())
    return gap, float((torch.isfinite(g) != torch.isfinite(w)).double().mean())


@pytest.mark.parametrize("fit", ["icp", "lzd"])
def test_the_reference_draws_the_pixels_the_program_draws(pair, fit):
    """Given the random_state alone, the plain fit draws the program's pixels (xdem's numpy
    draw over the pixels where the fit's inputs are all finite): the benchmark's check relies on
    it to compare the fits on the same pixels."""
    ref, tba, _ = pair
    count = {"icp": ICP_POINTS, "lzd": LZD_POINTS}[fit]
    with draws() as got:
        getattr(coreg, fit.upper())(subsample=count).fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=7)
    (rows, cols), = got
    plain = getattr(reference_rigid, fit)
    drawn, given = plain(ref, tba, T6, count, 7), plain(ref, tba, T6, count, rows=rows, cols=cols)
    assert np.array_equal(drawn[0], given[0]) and drawn[1:] == given[1:]


@pytest.mark.parametrize("nn_method", ["brute", "auto"])
def test_icp_matches_the_plain_icp_given_its_draw(pair, nn_method):
    ref, tba, centre = pair
    with draws() as got:
        icp = coreg.ICP(subsample=ICP_POINTS, nn_method=nn_method)
        icp.fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=4)
    (rows, cols), = got
    want = reference_rigid.icp(ref, tba, T6, ICP_POINTS, rows=rows, cols=cols)[:2]
    dt, dr = reference_rigid.gaps(motion(icp), want, centre)
    assert dt <= MOTION_M and dr <= MOTION_DEG, (dt, dr)


def test_lzd_matches_the_plain_lzd_given_its_draw(pair):
    ref, tba, centre = pair
    with draws() as got:
        lzd = coreg.LZD(subsample=LZD_POINTS).fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=5)
    (rows, cols), = got
    want = reference_rigid.lzd(ref, tba, T6, LZD_POINTS, rows=rows, cols=cols)[:2]
    dt, dr = reference_rigid.gaps(motion(lzd), want, centre)
    assert dt <= MOTION_M and dr <= MOTION_DEG, (dt, dr)


def test_the_small_rotation_regrid_matches_the_plain_regrid(pair):
    _, tba, centre = pair
    back = np.linalg.inv(MOTION)  # the motion that undoes the pair's, about the tile's centre
    got, _ = coreg.apply_matrix(tba, back, centroid=centre, transform=TRANSFORM)
    want = reference_rigid.regrid_bands(tba, T6, back, centre, torch.float64, 100)
    gap, share = dem_gap(got, want, tba)
    assert gap <= DEM_GAP and share <= FINITE_SHARE, (gap, share)


def _plain_chain(ref, tba, picks, dtype):
    """The plain ICP, its regrid, the plain LZD and its regrid, given each fit's draw."""
    first = reference_rigid.icp(ref, tba, T6, ICP_POINTS, dtype=dtype, rows=picks[0][0], cols=picks[0][1])[:2]
    moved = reference_rigid.regrid_bands(tba, T6, *first, dtype, 128)
    second = reference_rigid.lzd(ref, moved, T6, LZD_POINTS, dtype=dtype, rows=picks[1][0], cols=picks[1][1])[:2]
    return first, second, reference_rigid.regrid_bands(moved, T6, *second, dtype, 128)


def _chain_gaps(got, want, tba, centre):
    """The fits' motion gaps and the aligned DEM's gaps, and whether each is within its tolerance."""
    numbers = [*reference_rigid.gaps(got[0], want[0], centre), *reference_rigid.gaps(got[1], want[1], centre),
               *dem_gap(got[2], want[2], tba)]
    limits = [MOTION_M, MOTION_DEG, MOTION_M, MOTION_DEG, DEM_GAP, FINITE_SHARE]
    return numbers, [v <= lim for v, lim in zip(numbers, limits)]


@pytest.fixture(scope="module")
def pipeline(pair):
    """The pipeline's fit and apply on the pair, with the program's two draws."""
    ref, tba, _ = pair
    with draws() as picks:
        pipe = coreg.ICP(subsample=ICP_POINTS, nn_method="brute") + coreg.LZD(subsample=LZD_POINTS)
        pipe.fit(ref, tba, transform=TRANSFORM, crs=3413, random_state=6)
        aligned, _ = pipe.apply(tba, transform=TRANSFORM)
    return (motion(pipe[0]), motion(pipe[1]), aligned), picks


def test_the_pipelines_fit_and_apply_match_the_plain_chain(pair, pipeline):
    ref, tba, centre = pair
    got, picks = pipeline
    assert len(picks) == 2  # one draw a fit
    numbers, within = _chain_gaps(got, _plain_chain(ref, tba, picks, torch.float64), tba, centre)
    assert all(within), numbers


def test_the_plain_chain_in_bfloat16_fails_the_tolerances(pair, pipeline):
    ref, tba, centre = pair
    _, picks = pipeline
    want = _plain_chain(ref, tba, picks, torch.float64)
    numbers, within = _chain_gaps(_plain_chain(ref, tba, picks, torch.bfloat16), want, tba, centre)
    assert not all(within), numbers
