"""mesh= on the port's coregistration (xdem_tpu_torch.parallel.coreg, parallel.cpd) against
the port's single-device fits and against xdem_tpu's own mesh= fits.

Mirrors xdem_tpu's tests/test_coreg.py mesh cases on a 512 x 640 crop of the examples (on
the 256^2 test crop Nuth & Kääb never converges). The port's mesh is 8 CPU shards, xdem_tpu's
the 8 virtual CPU devices of tests/conftest.py. Tolerances: the fits whose statistics are
medians (VerticalShift, NuthKaab, DhMinimize) and the ICP neighbour merge equal the port's
single-device fits to the bit; LZD and CPD sum floats across shards and are held at
rtol/atol 1e-3, the blockwise batch at 2e-3, as xdem_tpu holds its own; against xdem_tpu's
mesh fits, shifts agree to 1 % (ROADMAP).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)
from jax.sharding import Mesh as JaxMesh
from scipy.optimize import least_squares

import xdem_tpu
from xdem_tpu import coreg as jcoreg
from xdem_tpu.coreg import affine as jaffine
from xdem_tpu_torch import coreg, examples
from xdem_tpu_torch.coreg import blockwise
from xdem_tpu_torch.parallel import make_mesh

CROP = ((0, 512), (0, 640))
MESH = make_mesh(devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def pair():
    return examples.get_ref_dem().icrop(*CROP), examples.get_tba_dem().icrop(*CROP)


@pytest.fixture(scope="module")
def jpair():
    return xdem_tpu.examples.get_ref_dem().icrop(*CROP), xdem_tpu.examples.get_tba_dem().icrop(*CROP)


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(np.asarray(jax.devices()[:8]), ("p",))


def _fits(make, pair, jpair=None, jmesh=None, **fit_kw):
    """(port mesh fit, port single-device fit, xdem_tpu mesh fit or None) matrices."""
    ref, tba = pair
    got = make(coreg).fit(ref, tba, mesh=MESH, **fit_kw).to_matrix()
    one = make(coreg).fit(ref, tba, **fit_kw).to_matrix()
    theirs = None
    if jpair is not None:
        theirs = make(jcoreg).fit(*jpair, mesh=jmesh, **fit_kw).to_matrix()
    return got, one, theirs


def _shifts_close(got, theirs, rtol=0.01):
    np.testing.assert_allclose(got[:3, 3], theirs[:3, 3], rtol=rtol, atol=rtol * np.abs(theirs[:3, 3]).max())


@pytest.mark.parametrize("make", [
    lambda m: m.VerticalShift(),
    lambda m: m.VerticalShift(subsample=0.4),
    lambda m: m.VerticalShift(vshift_reduc_func=np.mean, subsample=0.4),
    lambda m: m.NuthKaab(),
    lambda m: m.NuthKaab(subsample=0.5),
    lambda m: m.DhMinimize(subsample=10000),
], ids=["vshift", "vshift_subsampled", "vshift_mean", "nuth_kaab", "nuth_kaab_fraction", "dh_minimize"])
def test_median_fits_equal_single_device_and_xdem_tpu_mesh(make, pair, jpair, jmesh):
    got, one, theirs = _fits(make, pair, jpair, jmesh, random_state=7)
    np.testing.assert_array_equal(got, one)
    _shifts_close(got, theirs)


def test_nuth_kaab_point_input_and_fit_only_mode(pair):
    ref, tba = pair
    epc = ref.to_pointcloud(subsample=40000, random_state=3)
    kw = dict(random_state=7)
    got = coreg.NuthKaab(subsample=30000).fit(epc, tba, mesh=MESH, **kw).to_matrix()
    np.testing.assert_array_equal(got, coreg.NuthKaab(subsample=30000).fit(epc, tba, **kw).to_matrix())
    a = coreg.NuthKaab(bin_before_fit=False).fit(ref, tba, mesh=MESH, **kw).to_matrix()
    b = coreg.NuthKaab(bin_before_fit=False).fit(ref, tba, **kw).to_matrix()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sub", [2000, 2001])
def test_icp_equals_brute_single_device(sub, pair, jpair, jmesh):
    """2001 % 8 != 0: the reference cloud is padded with sentinel points."""
    got, one, theirs = _fits(lambda m: m.ICP(subsample=sub, nn_method="brute"), pair, random_state=7)
    np.testing.assert_array_equal(got, one)
    if sub == 2000:
        theirs = jcoreg.ICP(subsample=sub).fit(*jpair, mesh=jmesh, random_state=7).to_matrix()
        _shifts_close(got, theirs)


@pytest.mark.parametrize("make", [lambda m: m.LZD(subsample=30000), lambda m: m.LZD(subsample=10001),
                                  lambda m: m.CPD(subsample=2000)], ids=["lzd", "lzd_non_divisible", "cpd"])
def test_summed_fits_match_single_device(make, pair, jpair, jmesh):
    got, one, theirs = _fits(make, pair, jpair, jmesh, random_state=7)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=1e-3, atol=1e-3)
    _shifts_close(got, theirs)


def test_refusals(pair):
    ref, tba = pair
    with pytest.raises(NotImplementedError, match="mesh="):
        coreg.Deramp(poly_order=1).fit(ref, tba, mesh=MESH, random_state=1)
    with pytest.raises(NotImplementedError, match="mesh="):
        coreg.Deramp(poly_order=1, subsample=20000).fit_and_apply(ref, tba, mesh=MESH)
    with pytest.raises(ValueError, match="kdtree"):
        coreg.ICP(subsample=5000, nn_method="kdtree").fit(ref, tba, mesh=MESH, random_state=7)
    with pytest.raises(ValueError, match="custom fit_minimizer"):
        coreg.ICP(subsample=5000, fit_minimizer=least_squares).fit(ref, tba, mesh=MESH, random_state=7)
    for cls in (coreg.NuthKaab, coreg.VerticalShift, coreg.DhMinimize, coreg.ICP, coreg.CPD, coreg.LZD):
        assert cls._supports_mesh_fit and cls._supports_mesh_fit == getattr(jcoreg, cls.__name__)._supports_mesh_fit


def test_pipeline_routes_mesh_to_supporting_steps(pair, caplog):
    ref, tba = pair
    pipe = coreg.VerticalShift() + coreg.NuthKaab()
    got = pipe.fit(ref, tba, random_state=42, mesh=MESH).to_matrix()
    np.testing.assert_array_equal(got, (coreg.VerticalShift() + coreg.NuthKaab()).fit(ref, tba, random_state=42)
                                  .to_matrix())
    with caplog.at_level(logging.INFO):
        (coreg.Deramp(poly_order=1, subsample=20000) + coreg.VerticalShift()).fit(ref, tba, random_state=42,
                                                                                   mesh=MESH)
    assert any("no mesh= fit path" in r.message for r in caplog.records)


def test_blockwise_nuth_kaab_mesh(jmesh, monkeypatch):
    """The tile axis is split over the mesh: each tile's shift is the single-device one; with
    xdem_tpu's per-tile picks injected, the fit agrees with xdem_tpu's mesh= fit to 2e-3."""
    ref, tba = examples.get_ref_dem().icrop((0, 512), (0, 768)), examples.get_tba_dem().icrop((0, 512), (0, 768))
    jref = xdem_tpu.examples.get_ref_dem().icrop((0, 512), (0, 768))
    jtba = xdem_tpu.examples.get_tba_dem().icrop((0, 512), (0, 768))
    bs, k = 256, 3000
    kw = dict(block_size_fit=bs, subsample_per_tile=k, random_state=1)
    _, _, valid = jaffine._nk_slope_aspect_valid(jnp.asarray(jref.data), jnp.asarray(jtba.data),
                                                 jnp.ones(jref.shape, bool))
    nr, nc = ref.shape[0] // bs, ref.shape[1] // bs
    vt = np.asarray(valid)[:nr * bs, :nc * bs].reshape(nr, bs, nc, bs).transpose(0, 2, 1, 3).reshape(nr * nc, -1)
    keys = jax.random.split(jax.random.PRNGKey(1), nr * nc)
    idx, ok = jax.vmap(lambda kk, v: jaffine._topk_subsample(kk, v, k))(keys, jnp.asarray(vt))
    idx, ok = torch.from_numpy(np.array(idx, np.int64)), torch.from_numpy(np.array(ok))
    monkeypatch.setattr(blockwise, "_tile_picks", lambda valid, count, seed: (idx, ok))
    p = coreg.BlockwiseNuthKaab(mesh=MESH, **kw).fit(ref, tba)
    q = coreg.BlockwiseNuthKaab(**kw).fit(ref, tba)
    j = jcoreg.BlockwiseNuthKaab(mesh=jmesh, **kw).fit(jref, jtba)
    for a in ("shifts_x", "shifts_y", "shifts_z"):
        np.testing.assert_array_equal(getattr(p, a), getattr(q, a))
        np.testing.assert_allclose(getattr(p, a), getattr(j, a), rtol=2e-3, atol=2e-3, equal_nan=True)
