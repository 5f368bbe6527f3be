"""Plain PyTorch K1 (xdem_tpu_torch.terrain.surfit) against xdem_tpu's surface-fit attributes.

Tolerance: identical NaN masks; max deviation <= 1e-4 of the mean magnitude of each plane,
except the curvatures that divide by powers of |grad z| (profile, tangential, planform,
flowline), held at their 99th percentile <= 1e-4 and max <= 2e-2 (torch_port_helpers).
Both packages are given the same mean-centring constant (the `center` argument both
take), so what is compared is the stencil pass and the attribute algebra.
"""

import math
import re

import numpy as np
import pytest
import torch
from torch_port_helpers import assert_plane_close, example_dem, to_np

from xdem_tpu.terrain import surfit as jsurf
from xdem_tpu_torch import _build
from xdem_tpu_torch.terrain import cuda_kernels, surfit

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


# ---------------------------------------------------------------------- what K1 is built from


def _header_taps(text: str, fit: str, role: str) -> np.ndarray:
    """The k x k flipped stencil that the generated header lists for a fit and a role."""
    k = {m[0]: int(m[1]) for m in re.findall(r"F\((\d+), (\d+), \d+\)", text)}
    fit_id = re.search(rf"#define XDT_FIT_{fit.upper()} (\d+)", text).group(1)
    line = re.search(rf"#define XDT_TAPS_{fit.upper()}_{role.upper()}\(T\) (.*)", text).group(1)
    out = np.zeros((k[fit_id], k[fit_id]))
    taps = re.findall(r"T\((\d+), (\d+), (-?[\d.]+)f\)", line)
    assert " ".join(f"T({u}, {v}, {w}f)" for u, v, w in taps) == line.strip()  # nothing else on the line
    assert [(int(u), int(v)) for u, v, _ in taps] == sorted((int(u), int(v)) for u, v, _ in taps)  # row-major
    for u, v, w in taps:
        assert float(w) != 0.0
        out[int(u), int(v)] = float(w)
    return out


@pytest.mark.parametrize("fit,role", [(f, r) for f, d in surfit._FIT_DERIVS.items() for r in d])
def test_generated_header_holds_the_flipped_stencils(fit, role):
    """The header that _build.py writes for K1, parsed back, is surfit's table flipped as the plain
    version flips it, non-zero taps only, in the row-major order the plain version adds in."""
    text = _build.surface_fit_header()
    name = surfit._FIT_DERIVS[fit][role]
    np.testing.assert_array_equal(_header_taps(text, fit, role), surfit.ALL_STENCILS[name][::-1, ::-1])
    role_id = list(surfit.DIV_POW).index(role)
    fit_id = list(surfit._FIT_DERIVS).index(fit)
    assert f"S({fit_id}, {role_id}, XDT_TAPS_{fit.upper()}_{role.upper()})" in text


def test_generated_header_counts_and_codes():
    text = _build.surface_fit_header()
    counts = {n: int(np.count_nonzero(_header_taps(text, "florinsky", r)))
              for r, n in surfit._FIT_DERIVS["florinsky"].items()}
    assert counts == {"fl_r": 25, "fl_t": 25, "fl_s": 16, "fl_p": 20, "fl_q": 20}
    for code, a in enumerate(surfit.SURFACE_FIT_ATTRS):
        assert f"#define XDT_ATTR_{a.upper()} {code}\n" in text
    assert "#define XDT_SURFIT_FITS(F) F(0, 3, 2) F(1, 3, 5) F(2, 5, 5)\n" in text
    # The header's text is part of the build's key, and the source includes it.
    assert _build.TABLES_HEADER in (_build.CSRC_DIR / "surface_fit.cu").read_text()


def test_build_key_follows_the_stencil_tables(monkeypatch):
    path = _build.library_path()
    monkeypatch.setitem(surfit.ALL_STENCILS, "h1", surfit.ALL_STENCILS["h1"] * 2)
    assert _build.library_path() != path


def test_surface_fit_plan_of_an_out_of_order_request():
    attrs = ("min_curvature", "hillshade", "planform_curvature", "slope", "flowline_curvature", "slope")
    mask, plane_of = cuda_kernels.surface_fit_plan(attrs)
    table = surfit.SURFACE_FIT_ATTRS
    assert mask == sum(1 << table.index(a) for a in set(attrs))
    assert plane_of.dtype == np.int32 and len(plane_of) == len(table)
    for code, a in enumerate(table):
        assert plane_of[code] == (attrs.index(a) if a in attrs else -1)  # the first mention
    with pytest.raises(ValueError, match="Unknown attribute"):
        cuda_kernels.surface_fit_plan(("slope", "roughness"))


@pytest.mark.parametrize("center", [431.3, "tensor", None])
def test_wrapper_on_cpu_takes_center_and_equals_plain(dem, center):
    """On a CPU tensor the wrapper is the plain version, `center=` included, to the bit."""
    t = torch.from_numpy(dem)
    if center == "tensor":
        center = surfit.dem_center(t)
    attrs = ("max_curvature", "slope", "aspect")
    got = cuda_kernels.surface_attributes(t, 20.0, attrs, "Florinsky", "geometric", center=center)
    want = surfit.surface_attributes(t, 20.0, attrs, "Florinsky", "geometric", center=center)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num().view(torch.int32), want.nan_to_num().view(torch.int32))


def test_crop_with_the_whole_dems_center_equals_the_whole():
    """A window of a larger DEM, given the whole DEM's centre, rounds exactly as the whole DEM
    does: away from the crop's edge the planes are the same bits."""
    t = torch.from_numpy(example_dem(shape=(150, 170)))
    center = surfit.dem_center(t)
    attrs = ("slope", "hillshade", "profile_curvature", "max_curvature")
    whole = cuda_kernels.surface_attributes(t, 20.0, attrs, center=center)
    r0, c0, n, m = 37, 43, 96, 2
    crop = cuda_kernels.surface_attributes(t[r0:r0 + n, c0:c0 + n].contiguous(), 20.0, attrs, center=center)
    a, b = crop[:, m:-m, m:-m], whole[:, r0 + m:r0 + n - m, c0 + m:c0 + n - m]
    assert torch.equal(torch.isnan(a), torch.isnan(b)) and int(torch.isfinite(b).sum()) > 1000
    assert torch.equal(a.nan_to_num(), b.nan_to_num())
    own = cuda_kernels.surface_attributes(t[r0:r0 + n, c0:c0 + n].contiguous(), 20.0, attrs)
    assert not torch.equal(own[3].nan_to_num(), crop[3].nan_to_num())  # its own centre rounds otherwise
