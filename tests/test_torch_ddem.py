"""xdem_tpu_torch's dDEM and DEMCollection against xdem_tpu's on the same seeded arrays.

The cases of tests/test_volume.py (dDEM, DEMCollection, its reference-wise series and its
review regressions), each run through both packages. The gap fillers are float64 host code
in both, held to 1e-9 of their mean magnitude with identical NaN masks; the series' means are
float64 sums on the port's device against numpy's float32 means in xdem_tpu, held to 1e-6 of
the mean magnitude. Where xdem_tpu returns a pandas frame or series, the port returns a dict
of numpy arrays: ``start_time``/``end_time`` for the interval index, ``time`` for a time
index. The timestamp helper is held to ``pd.Timestamp(t).value`` (pandas in the test only).
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from torch_port_helpers import assert_same_nan, scaled_dev

from xdem_tpu.ddem import dDEM as JdDEM
from xdem_tpu.dem import DEM as JDEM
from xdem_tpu.demcollection import DEMCollection as JDEMCollection
from xdem_tpu.georef import Affine as JAffine
from xdem_tpu.raster import Raster as JRaster
from xdem_tpu.vector import Vector as JVector
from xdem_tpu_torch import DEM, Affine, DEMCollection, Raster, Vector, dDEM
from xdem_tpu_torch.demcollection import _timestamp_ns

YEARS = (1990, 2000, 2010)
TIMES = [datetime.datetime(y, 8, 1) for y in YEARS]
ORIGIN = (0, 1000, 10, 10)


def _pair_rasters(arr, origin=ORIGIN):
    return Raster(arr, Affine.from_origin(*origin), 32633), JRaster(arr, JAffine.from_origin(*origin), 32633)


def _dems(seed=0, shape=(50, 50), offsets=(0.0, 5.0, 12.0)):
    """Three DEMs, base minus each offset, in both packages."""
    base = np.random.default_rng(seed).normal(1000, 50, shape).astype(np.float32)
    t, jt = Affine.from_origin(*ORIGIN), JAffine.from_origin(*ORIGIN)
    return ([DEM(base - o, t, 32633) for o in offsets], [JDEM(base - o, jt, 32633) for o in offsets])


def _squares(pkg_vector):
    sq1 = np.array([[0.0, 500.0], [200.0, 500.0], [200.0, 1000.0], [0.0, 1000.0]])
    sq2 = np.array([[300.0, 500.0], [500.0, 500.0], [500.0, 1000.0], [300.0, 1000.0]])
    return (pkg_vector([[sq1]], crs=32633, properties=[{"name": "west"}]),
            pkg_vector([[sq2]], crs=32633, properties=[{"name": "east"}]))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    if ok.any():
        assert np.abs(got[ok] - want[ok]).max() <= tol * max(np.abs(want[ok]).mean(), 1e-12)


def _ns(index) -> np.ndarray:
    return np.array([pd.Timestamp(t).value for t in index], dtype=np.int64)


# ---------------------------------------------------------------------- timestamps

@pytest.mark.parametrize("t", [
    "2010-08-01", "2010-08-01T12:30:15", "2010-08-01 12:30:15.250", datetime.datetime(2010, 8, 1, 6, 5, 4, 321),
    datetime.datetime(2010, 8, 1, 6, tzinfo=datetime.timezone(datetime.timedelta(hours=2))), datetime.date(1990, 1, 31),
    np.datetime64("2020-02-29"), np.datetime64("1969-12-31T23:59:59.123456789"), pd.Timestamp("2001-03-04 05:06:07.000000008"),
], ids=["iso-date", "iso-time", "iso-fraction", "datetime", "aware-datetime", "date", "datetime64-day", "datetime64-ns",
        "pandas"])
def test_timestamp_ns_matches_pandas(t):
    assert _timestamp_ns(t) == pd.Timestamp(t).value


def test_timestamp_ns_refuses_what_is_no_time():
    with pytest.raises(TypeError, match="timestamp"):
        _timestamp_ns(3.5)


# ---------------------------------------------------------------------- dDEM

def test_ddem_construction_and_time():
    r, jr = _pair_rasters(np.ones((10, 10), np.float32))
    d = dDEM(r, start_time=TIMES[0], end_time=TIMES[1])
    jd = JdDEM(jr, start_time=TIMES[0], end_time=TIMES[1])
    assert d.time == jd.time and d.time.days == pytest.approx(3652, abs=1)
    assert isinstance(d, Raster) and d.data.dtype == torch.float32 and d.error is None
    assert dDEM(r).time is None and JdDEM(jr).time is None


def test_ddem_from_array():
    arr = np.arange(100, dtype=np.float32).reshape(10, 10)
    kw = dict(start_time=TIMES[0], end_time=TIMES[1], error=0.5)
    d = dDEM.from_array(arr, Affine.from_origin(*ORIGIN), 32633, **kw)
    jd = JdDEM.from_array(arr, JAffine.from_origin(*ORIGIN), 32633, **kw)
    assert isinstance(d, dDEM) and d.error == jd.error == 0.5 and d.time == jd.time
    np.testing.assert_array_equal(d.get_nanarray(), np.asarray(jd.get_nanarray()))


def test_ddem_interpolate_idw_matches_xdem_tpu():
    rng = np.random.default_rng(1)
    arr = rng.normal(5, 1, (40, 40)).astype(np.float32)
    arr[10:14, 10:14] = np.nan
    arr[30:, 35:] = np.nan  # a gap on the border: outside the data's hull
    r, jr = _pair_rasters(arr, (0, 400, 10, 10))
    d, jd = dDEM(r), JdDEM(jr)
    assert d.filled_data is None and jd.filled_data is None and d.fill_method == jd.fill_method == ""
    got, want = d.interpolate(method="idw"), jd.interpolate(method="idw")
    assert isinstance(got, np.ndarray) and d.fill_method == "idw" and np.isfinite(got[11, 11])
    assert_same_nan(got, want)
    _close(got, want, 1e-9)


def test_filled_data_semantics():
    arr = np.random.default_rng(2).normal(5, 1, (20, 20)).astype(np.float32)
    r, jr = _pair_rasters(arr, (0, 200, 10, 10))
    d, jd = dDEM(r), JdDEM(jr)
    np.testing.assert_array_equal(d.filled_data, np.asarray(jd.filled_data))
    with pytest.raises(ValueError, match="differs from the data shape"):
        d.filled_data = np.zeros((3, 3))
    d.filled_data = np.zeros(arr.size)
    assert d.filled_data.shape == arr.shape
    d.filled_data = None
    np.testing.assert_array_equal(d.filled_data, arr)


def _glacier_case(seed=3, shape=(60, 70)):
    """An elevation ramp, a dh linear in elevation with noise and voids, and two glaciers."""
    rng = np.random.default_rng(seed)
    ref = np.add.outer(np.linspace(2000, 100, shape[0]), np.linspace(0, 300, shape[1])).astype(np.float32)
    dh = (-20 + 0.01 * ref + rng.normal(0, 0.2, shape)).astype(np.float32)
    mask = np.zeros(shape, bool)
    mask[5:30, 5:30] = True
    mask[35:55, 40:65] = True
    dh[rng.random(shape) < 0.15] = np.nan
    dh[10:16, 10:16] = np.nan
    return ref, dh, mask


@pytest.mark.parametrize("method", ["local_hypsometric", "regional_hypsometric"])
@pytest.mark.parametrize("mask_kind", ["numpy", "tensor", "vector"])
def test_hypsometric_interpolation_matches_xdem_tpu(method, mask_kind):
    ref, dh, mask = _glacier_case()
    t, jt = Affine.from_origin(0, 600, 10, 10), JAffine.from_origin(0, 600, 10, 10)
    d, jd = dDEM(Raster(dh, t, 32633)), JdDEM(JRaster(dh, jt, 32633))
    rings = [[np.array([[50.0, 550.0], [300.0, 550.0], [300.0, 300.0], [50.0, 300.0]])],
             [[np.array([[400.0, 250.0], [650.0, 250.0], [650.0, 50.0], [400.0, 50.0]])]]]
    if mask_kind == "vector":
        ours, theirs = Vector(rings, crs=32633), JVector(rings, crs=32633)
    else:
        ours, theirs = (torch.from_numpy(mask) if mask_kind == "tensor" else mask), mask
    got = d.interpolate(method, reference_elevation=DEM(ref, t, 32633), mask=ours)
    want = jd.interpolate(method, reference_elevation=JDEM(ref, jt, 32633), mask=theirs)
    assert d.fill_method == method and isinstance(got, np.ndarray)
    assert np.isfinite(got).sum() > np.isfinite(dh).sum()
    assert_same_nan(got, want)
    _close(got, want, 1e-9)


def test_interpolate_reprojects_reference_elevation():
    rng = np.random.default_rng(4)
    base = np.add.outer(np.linspace(2000, 100, 50), np.zeros(50)).astype(np.float32)
    dh = rng.normal(-2, 0.1, (50, 50)).astype(np.float32)
    dh[10:14, 10:14] = np.nan
    kw = dict(start_time=TIMES[0], end_time=TIMES[1])
    d = dDEM(Raster(dh, Affine.from_origin(0, 1000, 10, 10), 32633), **kw)
    jd = JdDEM(JRaster(dh, JAffine.from_origin(0, 1000, 10, 10), 32633), **kw)
    coarse = Raster(base[::2, ::2], Affine.from_origin(0, 1000, 20, 20), 32633)
    jcoarse = JRaster(base[::2, ::2], JAffine.from_origin(0, 1000, 20, 20), 32633)
    mask = np.ones((50, 50), bool)
    got = d.interpolate("local_hypsometric", reference_elevation=coarse, mask=mask)
    want = jd.interpolate("local_hypsometric", reference_elevation=jcoarse, mask=mask)
    assert np.isfinite(got[10:14, 10:14]).all()
    _close(got, want, 1e-6)
    for kw in (dict(reference_elevation=base[::2, ::2], mask=mask), dict(mask=mask),
               dict(reference_elevation=base)):
        with pytest.raises(ValueError) as ours:
            d.interpolate("local_hypsometric", **kw)
        with pytest.raises(ValueError) as theirs:
            jd.interpolate("local_hypsometric", **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="Unknown interpolation method"):
        d.interpolate("kriging")


# ---------------------------------------------------------------------- DEMCollection

def _series_match(ours, theirs, kind=None, cumulative=False):
    """A dict series of the port against xdem_tpu's frame or series."""
    if cumulative:  # series indexed by time
        np.testing.assert_array_equal(ours["time"].astype(np.int64), _ns(theirs.index))
        _close(ours[kind], theirs.values)
    elif kind is None:  # dh series: frame indexed by intervals
        np.testing.assert_array_equal(ours["start_time"].astype(np.int64), _ns(theirs.index.left))
        np.testing.assert_array_equal(ours["end_time"].astype(np.int64), _ns(theirs.index.right))
        _close(ours["dh"], theirs["dh"].values)
        np.testing.assert_array_equal(ours["area"], theirs["area"].values)
    else:  # dv series
        np.testing.assert_array_equal(ours["start_time"].astype(np.int64), _ns(theirs.index.left))
        _close(ours["dv"], theirs.values)


def test_series_intervalwise():
    (d0, d1, d2), (j0, j1, j2) = _dems(shape=(60, 60))
    col = DEMCollection([d0, d1, d2], timestamps=TIMES, reference_dem=0)
    jcol = JDEMCollection([j0, j1, j2], timestamps=TIMES, reference_dem=0)
    assert col.reference_dem is d0 and col.reference_timestamp == jcol.reference_timestamp == TIMES[0]
    assert len(col.subtract_dems_intervalwise()) == len(jcol.subtract_dems_intervalwise()) == 2
    _series_match(col.get_dh_series(nans_ok=True), jcol.get_dh_series(nans_ok=True))
    assert col.get_dh_series(nans_ok=True)["dh"][1] == pytest.approx(-7, abs=1e-3)
    _series_match(col.get_dv_series(nans_ok=True), jcol.get_dv_series(nans_ok=True), "dv")
    for kind in ("dh", "dv"):
        ours = col.get_cumulative_series(kind=kind, nans_ok=True)
        _series_match(ours, jcol.get_cumulative_series(kind=kind, nans_ok=True), kind, cumulative=True)
    assert ours["dv"][0] == 0 and ours["dv"][-1] == pytest.approx(-12 * 60 * 60 * 100, rel=1e-3)
    with pytest.raises(ValueError, match="Invalid kind"):
        col.get_cumulative_series(kind="dz")


def test_timestamps_required_and_aligned():
    (d,), (jd,) = _dems(shape=(5, 5), offsets=(0.0,))
    for make in (DEMCollection, JDEMCollection):
        dem = d if make is DEMCollection else jd
        with pytest.raises(ValueError, match="Timestamps"):
            make([dem])
        with pytest.raises(ValueError, match="len differs"):
            make([dem], timestamps=TIMES)
    with pytest.raises(ValueError, match="not yet been calculated"):
        DEMCollection([d], timestamps=TIMES[:1]).get_dh_series()


@pytest.mark.parametrize("stamps", ["datetime", "iso", "datetime64"])
def test_subtract_dems_reference_wise(stamps):
    dems, jdems = _dems()
    times = {"datetime": TIMES, "iso": [t.date().isoformat() for t in TIMES],
             "datetime64": [np.datetime64(t.date()) for t in TIMES]}[stamps]
    order = [2, 0, 1]  # given out of time order
    col = DEMCollection([dems[i] for i in order], timestamps=[times[i] for i in order], reference_dem=0)
    # xdem_tpu takes the interval's length as end - start, which strings do not have: it is given
    # the same times as datetimes.
    jcol = JDEMCollection([jdems[i] for i in order], timestamps=[TIMES[i] for i in order], reference_dem=0)
    assert col.reference_dem is dems[2] and col.timestamps == list(times)
    ddems, jddems = col.subtract_dems(), jcol.subtract_dems()
    assert len(ddems) == len(jddems) == 3
    for d, jd in zip(ddems, jddems):
        assert [_timestamp_ns(t) for t in (d.start_time, d.end_time)] == [pd.Timestamp(t).value for t in
                                                                          (jd.start_time, jd.end_time)]
        np.testing.assert_array_equal(d.get_nanarray(), np.asarray(jd.get_nanarray()))
    assert float(ddems[2].data.abs().max()) == 0.0 and ddems[2].error == 0
    dh = col.get_dh_series(nans_ok=True)
    assert len(dh["dh"]) == 2  # the reference's zero dDEM is skipped
    _series_match(dh, jcol.get_dh_series(nans_ok=True))
    for kind in ("dh", "dv"):
        ours, theirs = col.get_cumulative_series(kind=kind, nans_ok=True), jcol.get_cumulative_series(kind=kind, nans_ok=True)
        _series_match(ours, theirs, kind, cumulative=True)
    cum = col.get_cumulative_series(nans_ok=True)
    np.testing.assert_allclose(cum["dh"], [0.0, -5.0, -12.0], atol=1e-3)


def test_subtract_reprojects_a_shifted_transform():
    rng = np.random.default_rng(5)
    base = rng.normal(1000, 50, (50, 50)).astype(np.float32)
    d0 = DEM(base, Affine.from_origin(0, 1000, 10, 10), 32633)
    d1 = DEM(base - 5, Affine.from_origin(5000, 1000, 10, 10), 32633)
    j0 = JDEM(base, JAffine.from_origin(0, 1000, 10, 10), 32633)
    j1 = JDEM(base - 5, JAffine.from_origin(5000, 1000, 10, 10), 32633)
    ours = DEMCollection([d0, d1], timestamps=TIMES[:2]).subtract_dems()
    theirs = JDEMCollection([j0, j1], timestamps=TIMES[:2]).subtract_dems()
    assert torch.isnan(ours[1].data).all() and np.isnan(np.asarray(theirs[1].data)).all()


def test_ddem_mask_cascade_and_outlines_filter():
    dems, jdems = _dems()
    v1, v2 = _squares(Vector)
    j1, j2 = _squares(JVector)
    col = DEMCollection(dems, timestamps=TIMES, outlines={TIMES[0]: v1, TIMES[2]: v2}, reference_dem=2)
    jcol = JDEMCollection(jdems, timestamps=TIMES, outlines={TIMES[0]: j1, TIMES[2]: j2}, reference_dem=2)
    col.subtract_dems()
    jcol.subtract_dems()
    for d, jd in zip(col.ddems, jcol.ddems):
        for filt in (None, "name == 'west'", "name == 'east'"):
            m = col.get_ddem_mask(d, outlines_filter=filt)
            assert isinstance(m, torch.Tensor) and m.dtype == torch.bool
            np.testing.assert_array_equal(m.numpy(), np.asarray(jcol.get_ddem_mask(jd, outlines_filter=filt)))
    for filt in (None, "name == 'west'"):
        _series_match(col.get_dh_series(outlines_filter=filt, nans_ok=True),
                      jcol.get_dh_series(outlines_filter=filt, nans_ok=True))
    west = col.get_dh_series(outlines_filter="name == 'west'", nans_ok=True)
    assert west["area"][0] < col.get_dh_series(nans_ok=True)["area"][0]
    foreign = dDEM(Raster(np.zeros((50, 50), np.float32), Affine.from_origin(*ORIGIN), 32633),
                   start_time=TIMES[0], end_time=TIMES[1])
    with pytest.raises(ValueError, match="part of the DEMCollection"):
        col.get_ddem_mask(foreign)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_dh_series_with_a_mask_and_unfilled_voids(kind):
    dems, jdems = _dems()
    hole = dems[1].data.clone()
    hole[3:6, 3:6] = torch.nan
    dems[1].data = hole
    jdems[1] = JDEM(hole.numpy(), jdems[1].transform, 32633)
    mask = np.zeros((50, 50), bool)
    mask[:25] = True
    col = DEMCollection(dems, timestamps=TIMES, reference_dem=0)
    jcol = JDEMCollection(jdems, timestamps=TIMES, reference_dem=0)
    col.subtract_dems()
    jcol.subtract_dems()
    ours_mask = torch.from_numpy(mask) if kind == "tensor" else mask
    with pytest.raises(ValueError, match="Unfilled NaNs"):
        col.get_dh_series(mask=ours_mask)
    _series_match(col.get_dh_series(mask=ours_mask, nans_ok=True), jcol.get_dh_series(mask=mask, nans_ok=True))
    col.interpolate_ddems("idw")
    jcol.interpolate_ddems("idw")
    _series_match(col.get_dh_series(mask=ours_mask), jcol.get_dh_series(mask=mask))


def test_interpolate_ddems_with_outlines_matches_xdem_tpu():
    ref, dh, _ = _glacier_case(seed=6)
    t, jt = Affine.from_origin(0, 600, 10, 10), JAffine.from_origin(0, 600, 10, 10)
    rings = [[np.array([[50.0, 550.0], [300.0, 550.0], [300.0, 300.0], [50.0, 300.0]])]]
    earlier = (ref - np.nan_to_num(dh)).astype(np.float32)
    earlier[np.isnan(dh)] = np.nan
    col = DEMCollection([DEM(earlier, t, 32633), DEM(ref, t, 32633)], timestamps=TIMES[:2],
                        outlines=Vector(rings, crs=32633), reference_dem=1)
    jcol = JDEMCollection([JDEM(earlier, jt, 32633), JDEM(ref, jt, 32633)], timestamps=TIMES[:2],
                          outlines=JVector(rings, crs=32633), reference_dem=1)
    col.subtract_dems()
    jcol.subtract_dems()
    for ours, theirs in zip(col.interpolate_ddems("local_hypsometric"), jcol.interpolate_ddems("local_hypsometric")):
        assert_same_nan(ours, theirs)
        assert scaled_dev(ours, theirs) <= 1e-9
    _series_match(col.get_dh_series(), jcol.get_dh_series())
