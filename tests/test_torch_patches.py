"""The convolutions and the patches method of xdem_tpu_torch.spatialstats against
xdem_tpu.spatialstats and against scipy.ndimage in float64.

The port sums in float64 from row prefix sums and calls no library convolution; xdem_tpu
runs an XLA float32 convolution. Both are held within 1e-5 of the mean magnitude of
scipy.ndimage.convolve in float64 and of each other, with identical NaN footprints and exact
counts. The patches statistic (NMADs in float32 on the device here, float64 on the host
there) is held to 1e-4 relative with identical patch counts and exact areas; the quadrant
loop draws with numpy on both sides, so its tables are equal.
"""

import logging

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from scipy import ndimage

import xdem_tpu.spatialstats as jss
import xdem_tpu_torch.spatialstats as tss

TOL = 1e-5


def _images(seed=0, n=2, shape=(40, 50)):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(100.0, 5.0, (n,) + shape).astype(np.float32)
    imgs[0, 5, 7] = np.nan
    imgs[-1, 20:22, 30] = np.nan
    return imgs


def _field(shape=(150, 160), seed=5):
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.normal(size=shape), 3.0)
    f = f / f.std() * 2.0
    f[20:35, 40:70] = np.nan
    f[:, -3:] = np.nan
    return f.astype(np.float32)


def _scipy_convolution(imgs, filters):
    """scipy.ndimage.convolve in float64 with zero padding; a NaN poisons its footprint."""
    return np.stack([[ndimage.convolve(im.astype(np.float64), k.astype(np.float64), mode="constant", cval=0.0)
                      for k in filters] for im in imgs])


def _rel(got, want):
    ok = np.isfinite(want)
    return np.abs(np.asarray(got, np.float64) - want)[ok].max() / np.abs(want[ok]).mean()


# ---------------------------------------------------------------------- convolution


@pytest.mark.parametrize("ksize", [(3, 3), (2, 2), (4, 4), (5, 2), (1, 1), (6, 7)], ids=str)
def test_convolution_matches_xdem_tpu_and_scipy(ksize):
    """Two images x three kernels, odd and even sides: the NaN footprints identical, values
    within 1e-5 of the mean magnitude of xdem_tpu's and of scipy's float64 result."""
    imgs = _images()
    filters = np.random.default_rng(1).normal(size=(3,) + ksize).astype(np.float32)
    got = tss.convolution(imgs, filters)
    theirs = jss.convolution(imgs, filters)
    exact = _scipy_convolution(imgs, filters)
    assert got.shape == (2, 3, 40, 50) and got.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(theirs))
    assert np.array_equal(np.isnan(got), np.isnan(exact))
    assert _rel(got, theirs.astype(np.float64)) <= TOL
    assert _rel(got, exact) <= TOL
    from_tensor = tss.convolution(torch.from_numpy(imgs), torch.from_numpy(filters))
    assert isinstance(from_tensor, torch.Tensor)
    np.testing.assert_array_equal(from_tensor.numpy(), got)


def test_convolution_even_kernel_small_case():
    """tests/test_spatialstats.py's case: a 10 x 12 image, kernels of side 2 to 5, float64
    inputs, against scipy at 1e-5 absolute."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(1, 10, 12))
    for k in (2, 3, 4, 5):
        kern = rng.normal(size=(1, k, k))
        got = tss.convolution(a, kern)
        assert got.shape == (1, 1, 10, 12)
        np.testing.assert_allclose(got[0, 0], ndimage.convolve(a[0], kern[0], mode="constant", cval=0.0), atol=1e-5)


def test_convolution_nan_poisons_its_footprint_only():
    img = np.ones((1, 9, 9), np.float32)
    img[0, 4, 4] = np.nan
    out = tss.convolution(img, np.ones((1, 3, 3), np.float32))[0, 0]
    assert np.isnan(out[3:6, 3:6]).all() and np.isnan(out).sum() == 9
    assert out[0, 0] == 4.0 and out[1, 1] == 9.0
    even = tss.convolution(img, np.ones((1, 2, 2), np.float32))[0, 0]
    want = ndimage.convolve(img[0].astype(np.float64), np.ones((2, 2)), mode="constant", cval=0.0)
    assert np.array_equal(np.isnan(even), np.isnan(want)) and np.isnan(even).sum() == 4


@pytest.mark.parametrize("call", [
    lambda: tss.convolution(_images(), np.ones((1, 3, 3)), method="fft"),
    lambda: tss.mean_filter_nan(_images()[0], 3, method="fft"),
    lambda: tss.patches_method(_field(), areas=3600.0, gsd=20.0, convolution_method="fft"),
])
def test_bad_convolution_method_raises(call):
    with pytest.raises(ValueError, match="Convolution method must be"):
        call()


def test_convolution_refuses_other_ranks():
    with pytest.raises(ValueError, match=r"\(N, H, W\)"):
        tss.convolution(_images()[0], np.ones((1, 3, 3)))


@pytest.mark.parametrize("kernel", [
    np.array([[0.0, 2.0, 2.0, 0.0, -1.0]]), np.array([[1.0, 1.0, 1.0]]), np.zeros((1, 4)), np.array([[3.0]]),
], ids=["runs", "ones", "zeros", "single"])
def test_kernel_runs_cover_the_nonzero_taps(kernel):
    rebuilt = np.zeros(kernel.shape[1])
    for b0, b1, weight in tss._kernel_runs(kernel[0]):
        assert b1 > b0 and np.all(rebuilt[b0:b1] == 0)
        rebuilt[b0:b1] = weight
    np.testing.assert_array_equal(rebuilt, kernel[0])


# ---------------------------------------------------------------------- mean filter


@pytest.mark.parametrize("size,shape", [(5, "circular"), (4, "circular"), (12, "circular"), (7, "square"),
                                        (2, "square"), (1, "square")])
def test_mean_filter_matches_xdem_tpu_and_scipy(size, shape):
    """Mean within 1e-5 of the mean magnitude, counts and pixels per kernel exact. The
    circular kernel has an integer centre and a strict inequality (9 pixels for side 5)."""
    img = _images()[0]
    mean, cnts, nb = tss.mean_filter_nan(img, size, shape)
    jmean, jcnts, jnb = jss.mean_filter_nan(img, size, shape)
    assert nb == jnb and mean.dtype == np.float32
    if (size, shape) == (5, "circular"):
        assert nb == 9
    np.testing.assert_array_equal(cnts, jcnts)
    assert np.array_equal(np.isnan(mean), np.isnan(jmean))
    assert _rel(mean, jmean.astype(np.float64)) <= TOL
    kernel = tss._mean_filter_kernel(size, shape).astype(np.float64)
    valid = np.isfinite(img)
    sums = ndimage.convolve(np.where(valid, img, 0.0).astype(np.float64), kernel, mode="constant", cval=0.0)
    exact_cnts = ndimage.convolve(valid.astype(np.float64), kernel, mode="constant", cval=0.0)
    np.testing.assert_array_equal(cnts, exact_cnts)
    with np.errstate(invalid="ignore", divide="ignore"):
        assert _rel(mean, sums / exact_cnts) <= TOL
    t_mean, t_cnts, t_nb = tss.mean_filter_nan(torch.from_numpy(img), size, shape)
    assert isinstance(t_mean, torch.Tensor) and t_nb == nb
    np.testing.assert_array_equal(t_mean.numpy(), mean)
    np.testing.assert_array_equal(t_cnts.numpy(), cnts)


def test_mean_filter_is_nan_where_no_pixel_is_valid():
    img = np.full((12, 12), np.nan, np.float32)
    img[:, 8:] = 1.0
    mean, cnts, _ = tss.mean_filter_nan(img, 3, "square")
    assert np.isnan(mean[:, :7]).all() and (cnts[:, :7] == 0).all()
    np.testing.assert_array_equal(mean[:, 7:], 1.0)


# ---------------------------------------------------------------------- patches method

AREAS = [400.0 * 9, 400.0 * 36, 400.0 * 100]


@pytest.mark.parametrize("patch_shape", ["circular", "square"])
def test_patches_vectorized_list_matches_xdem_tpu(patch_shape):
    """A list of areas gives one row per area: statistic within 1e-4 relative,
    nb_indep_patches, exact_areas and areas identical; the per-patch table has the same
    rows, with the in-patch means within 1e-5 of the field's spread."""
    f = _field()
    theirs, theirs_in = jss.patches_method(f, areas=AREAS, gsd=20.0, patch_shape=patch_shape,
                                           return_in_patch_statistics=True)
    ours, ours_in = tss.patches_method(f, areas=AREAS, gsd=20.0, patch_shape=patch_shape,
                                       return_in_patch_statistics=True)
    assert list(ours) == list(theirs.columns) == ["nmad", "nb_indep_patches", "exact_areas", "areas"]
    np.testing.assert_allclose(ours["nmad"], theirs["nmad"].values, rtol=1e-4)
    for c in ("nb_indep_patches", "exact_areas", "areas"):
        np.testing.assert_array_equal(ours[c], theirs[c].values)
    assert list(ours_in) == list(theirs_in.columns)
    np.testing.assert_array_equal(ours_in["count"], theirs_in["count"].values)
    np.testing.assert_array_equal(ours_in["areas"], theirs_in["areas"].values)
    np.testing.assert_array_equal(ours_in["exact_areas"], theirs_in["exact_areas"].values)
    np.testing.assert_allclose(ours_in["nanmean"], theirs_in["nanmean"].values, atol=2e-5, equal_nan=True)
    plain = tss.patches_method(f, areas=AREAS, gsd=20.0, patch_shape=patch_shape)
    np.testing.assert_array_equal(plain["nmad"], ours["nmad"])


@pytest.mark.parametrize("patch_shape", ["circular", "square"])
def test_patches_vectorized_single_area_matches_xdem_tpu(patch_shape):
    """A single number (or the keyword area=) gives (statistic, independent patches):
    1e-4 relative and equal; a tensor input gives what the array gives."""
    f = _field()
    want = jss.patches_method(f, areas=3600.0, gsd=20.0, patch_shape=patch_shape)
    got = tss.patches_method(f, areas=3600.0, gsd=20.0, patch_shape=patch_shape)
    assert got[0] == pytest.approx(want[0], rel=1e-4) and got[1] == want[1]
    assert tss.patches_method(torch.from_numpy(f), area=3600.0, gsd=20.0, patch_shape=patch_shape) == got


def test_patches_custom_statistic_and_masks():
    """A statistic other than the NMAD runs on the host over the strided means (1e-4
    relative); stable and unstable masks restrict the pixels on both paths alike."""
    f = _field()
    stable = np.ones(f.shape, bool)
    stable[:, :30] = False
    unstable = np.zeros(f.shape, bool)
    unstable[100:, :] = True
    kw = dict(areas=[3600.0], gsd=20.0, stable_mask=stable, unstable_mask=unstable)
    want = jss.patches_method(f, statistic_between_patches=np.nanstd, **kw)
    got = tss.patches_method(f, statistic_between_patches=np.nanstd, **kw)
    assert list(got)[0] == "nanstd"
    np.testing.assert_allclose(got["nanstd"], want["nanstd"].values, rtol=1e-4)
    np.testing.assert_array_equal(got["nb_indep_patches"], want["nb_indep_patches"].values)
    nmad_np = tss.patches_method(f, **kw)
    nmad_t = tss.patches_method(torch.from_numpy(f), areas=[3600.0], gsd=20.0, stable_mask=torch.from_numpy(stable),
                                unstable_mask=torch.from_numpy(unstable))
    np.testing.assert_array_equal(nmad_np["nmad"], nmad_t["nmad"])
    np.testing.assert_allclose(nmad_np["nmad"], jss.patches_method(f, **kw)["nmad"].values, rtol=1e-4)


@pytest.mark.parametrize("patch_shape", ["circular", "square"])
def test_patches_quadrant_loop_equals_xdem_tpu(patch_shape):
    """The loop draws with np.random.default_rng: for one random_state the tables are equal
    (tiles, statistics, counts), for a list of areas and for a single one."""
    f = _field()
    kw = dict(gsd=20.0, vectorized=False, random_state=3, n_patches=40, patch_shape=patch_shape,
              statistics_in_patch=(np.nanmean, np.nanmedian, "count"))
    theirs, theirs_in = jss.patches_method(f, areas=[3600.0, 14400.0], return_in_patch_statistics=True, **kw)
    ours, ours_in = tss.patches_method(f, areas=[3600.0, 14400.0], return_in_patch_statistics=True, **kw)
    for c in theirs.columns:
        np.testing.assert_array_equal(ours[c], theirs[c].values)
    assert list(ours_in) == list(theirs_in.columns) == ["tile", "nanmean", "nanmedian", "count", "areas",
                                                        "exact_areas"]
    for c in theirs_in.columns:
        np.testing.assert_array_equal(ours_in[c], theirs_in[c].values)
    single = tss.patches_method(torch.from_numpy(f), areas=14400.0, **kw)
    want = jss.patches_method(f, areas=14400.0, **kw)
    assert list(single) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(single[c], want[c].values)


def test_patches_loop_without_valid_patch_warns():
    f = np.full((40, 40), np.nan, np.float32)
    with pytest.warns(UserWarning, match="No valid patch"):
        out = tss.patches_method(f, areas=[3600.0], gsd=20.0, vectorized=False, random_state=0)
    assert np.isnan(out["nmad"][0]) and out["nb_indep_patches"][0] == 0


def test_patches_refusals_and_logging(caplog):
    f = _field(shape=(40, 40))
    with pytest.raises(ValueError, match="ground sampling distance"):
        tss.patches_method(f, areas=3600.0)
    with pytest.raises(ValueError, match='"square" or "circular"'):
        tss.patches_method(f, areas=3600.0, gsd=20.0, patch_shape="hexagon")
    with pytest.raises(ValueError, match="larger than the array extent"):
        tss.patches_method(f, areas=1e9, gsd=20.0, vectorized=False)
    with caplog.at_level(logging.INFO):
        tss.patches_method(f, areas=3600.0, gsd=20.0, verbose=True)
        tss.patches_method(f, areas=3600.0, gsd=20.0, vectorized=False, verbose=True, n_patches=2, random_state=0)
    assert "convolution variant" in caplog.text and "Working on patch" in caplog.text


@pytest.mark.parametrize("area,shape", [(3600.0, "circular"), (3600.0, "square"), (10.0, "square"), (5e5, "circular")])
def test_patches_kernel_size_equals_original(area, shape):
    assert tss._patches_kernel_size(area, 20.0, shape) == jss._patches_kernel_size(area, 20.0, shape)
