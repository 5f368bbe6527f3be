"""The frozen work count against bytes and operations reckoned by hand."""

import numpy as np
import pytest

from gpu_bench import reference, work

SUITE = ["slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature", "planform_curvature",
         "flowline_curvature", "max_curvature", "min_curvature", "topographic_position_index",
         "terrain_ruggedness_index", "roughness", "rugosity", "fractal_roughness"]


def test_florinsky_taps_are_the_reference_stencils():
    for role, (k, _, _) in reference.FLORINSKY.items():
        assert work.FLORINSKY_TAPS[role] == int(np.count_nonzero(np.array(k)))


@pytest.mark.parametrize("w, ops", [(13, 581 + 151 + 73 + 23 + 6), (5, 4 * 16 + 5 + 4 * 4 + 5 + 2 + 6), (9, 4 * 64 + 5 + 4 * 16 + 5 + 2 + 4 * 4 + 5 + 2 + 6)])
def test_fractal_operations_by_hand(w, ops):
    # w = 13: q = 1 (12^2 boxes), 2 (6^2, one doubling), 3 (4^2, two steps from 1), 6 (2^2, one from 3)
    assert work.fractal_ops_per_pixel(w) == ops


def test_suite_work_at_a_small_shape():
    px = 1000 * 1000
    k = work.kernel_work(SUITE, 13)
    # K1: 106 taps of five derivatives (212), 2 x 5 for centring and divisors, 20 x 9 formulas
    assert k["k1"] == (4 * 10, 212 + 10 + 180)
    assert k["k2"] == (4 * 5, 13 + 28 + 19 + 193)
    assert k["k3"] == (8, 834)
    nbytes, ops = work.suite_work(SUITE, 13)
    assert (nbytes, ops) == (4 * 15, 402 + 253 + 834 + 4)  # the epilog: 1 + 1 + 2
    least = work.least_seconds(nbytes * px, ops * px)
    assert least == pytest.approx(1493e6 / 67e12)  # bound by operations: 2.23e-5 s against 1.79e-5 s of bytes
    assert work.least_seconds(nbytes * px, ops * px, chips=4) == pytest.approx(least / 4)


def test_slope_alone_counts_only_the_first_derivatives():
    assert work.kernel_work(["slope"]) == {"k1": (8, 2 * 40 + 4 + 20)}
    assert work.suite_work(["slope"]) == (8, 2 * 40 + 4 + 20 + 1)
