"""Plain PyTorch K1 (xdem_tpu_torch.terrain.surfit) against xdem_tpu's surface-fit attributes.

Tolerance: identical NaN masks; max deviation <= 1e-4 of the mean magnitude of each plane,
except the curvatures that divide by powers of |grad z| (profile, tangential, planform,
flowline), held at their 99th percentile <= 1e-4 and max <= 2e-2 (torch_port_helpers).
Both packages are given the same mean-centring constant (the `center` argument both
take), so what is compared is the stencil pass and the attribute algebra.
"""

import math

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, example_dem, to_np

from xdem_tpu.terrain import surfit as jsurf
from xdem_tpu_torch.terrain import surfit

ALL10 = surfit.SURFACE_FIT_ATTRS


@pytest.fixture(scope="module")
def dem():
    return example_dem()


def _center(dem: np.ndarray) -> np.float32:
    return np.float32(np.mean(dem[np.isfinite(dem)], dtype=np.float64))


CASES = [
    # (surface_fit, curv_method, attrs, hillshade (altitude, azimuth, z_factor))
    ("Horn", "geometric", ("slope", "aspect", "hillshade"), (45.0, 315.0, 1.0)),
    ("ZevenbergThorne", "geometric", ALL10, (45.0, 315.0, 1.0)),
    ("ZevenbergThorne", "directional", ALL10, (45.0, 315.0, 1.0)),
    ("Florinsky", "geometric", ALL10, (30.0, 100.0, 2.0)),
    ("Florinsky", "directional", ALL10, (45.0, 315.0, 1.0)),
]


@pytest.mark.parametrize("fit,curv,attrs,hs", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_surface_attributes_match_jax(dem, fit, curv, attrs, hs):
    alt, az, zf = hs
    c = _center(dem)
    want = np.asarray(jsurf.surface_attributes(
        dem, 20.0, attrs=attrs, surface_fit=fit, curv_method=curv, hillshade_altitude=alt,
        hillshade_azimuth=az, hillshade_z_factor=zf, center=c))
    got = surfit.surface_attributes(torch.from_numpy(dem), 20.0, attrs, fit, curv, alt, az, zf,
                                    center=torch.tensor(c))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(attrs), *dem.shape)
    for i, a in enumerate(attrs):
        assert_plane_close(got[i], want[i], a, circular=2 * math.pi if a == "aspect" else None)


def test_matches_pallas_kernel_in_interpret_mode(dem):
    """One case against the Pallas kernel itself (interpret mode on the CPU). Its polynomial
    atan/atan2 cost ~1e-4 rad on aspect, hence 1e-4 scaled for the angles too."""
    from jax.experimental.pallas import tpu as pltpu

    from xdem_tpu.terrain.pallas_kernels import surface_attributes_pallas

    attrs = ("slope", "aspect", "hillshade", "max_curvature", "planform_curvature")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(surface_attributes_pallas(dem, 20.0, attrs=attrs, surface_fit="Florinsky"))
    got = surfit.surface_attributes(torch.from_numpy(dem), 20.0, attrs, "Florinsky")
    for i, a in enumerate(attrs):
        assert_plane_close(got[i], want[i], a, circular=2 * math.pi if a == "aspect" else None)


@pytest.mark.parametrize("k", [3, 5])
def test_erode_valid_matches_jax(k):
    valid = np.random.default_rng(k).random((37, 41)) > 0.08
    want = np.asarray(jsurf._erode_valid(valid, k))
    got = to_np(surfit._erode_valid(torch.from_numpy(valid), k))
    np.testing.assert_array_equal(got, want)


def test_aspect_is_a_floor_modulo(dem):
    """Aspect lies in [0, 2*pi) everywhere: the remainder is a floor-modulo."""
    asp = to_np(surfit.surface_attributes(torch.from_numpy(dem), 20.0, ("aspect",), "ZevenbergThorne")[0])
    fin = asp[np.isfinite(asp)]
    assert fin.min() >= 0.0 and fin.max() < 2 * math.pi
    # Every quadrant occurs, so the wrap is exercised.
    assert np.histogram(fin, bins=4, range=(0, 2 * math.pi))[0].min() > 0


def test_dem_center_ignores_non_finite_and_defaults_to_zero():
    d = torch.tensor([[1.0, 3.0], [float("inf"), float("nan")]])
    assert float(surfit.dem_center(d)) == 2.0
    assert float(surfit.dem_center(torch.full((2, 2), float("nan")))) == 0.0


def test_horn_refuses_curvatures(dem):
    with pytest.raises(ValueError, match="Horn"):
        surfit.surface_attributes(torch.from_numpy(dem), 20.0, ("max_curvature",), "Horn")


def test_divisors_and_hillshade_constants_are_f32():
    """The kernel receives these as f32 numbers; they must be the plain version's values."""
    d = surfit.divisors(("z_x", "z_xx"), ("fl_p", "fl_r"), 20.0)
    assert [float(v) for v in d] == [float(np.float32(420.0) * np.float32(20.0)),
                                     float(np.float32(35.0) * (np.float32(20.0) * np.float32(20.0)))]
    sin_alt, cos_alt, az = surfit.hillshade_constants(45.0, 315.0)
    assert sin_alt == float(np.float32(sin_alt)) and az == float(np.float32(math.radians(45.0)))
