"""xdem_tpu_torch.uncertainty.estimate_uncertainty against xdem_tpu's on the example test crop.

At this size (256 x 256) the heteroscedasticity sample takes every valid pixel, so sigma does
not depend on either generator: it is held at xdem_tpu's TPU-versus-CPU tolerance
(bench.py:910-921: the 99.9th percentile of |diff| within 5e-3 of the mean sigma, the
maximum within 1e-2). rho is held within 5e-3 at 20, 200 and 2000 m with xdem_tpu's ring
draw injected into the port: its device draw for H2022, its numpy host draw for R2009 and
Basic (xdem_tpu standardizes those on the host).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

import xdem_tpu.spatialstats as jss
import xdem_tpu_torch.spatialstats as tss
from xdem_tpu import examples
from xdem_tpu_torch import Affine, uncertainty
from xdem_tpu_torch.parallel import make_mesh

APPROACHES = ("H2022", "R2009", "Basic")
LAGS = np.array([20.0, 200.0, 2000.0])
KW = dict(subsample=3000, random_state=42)


@pytest.fixture(scope="module")
def crop():
    ref, tba = examples.get_ref_dem_test(), examples.get_tba_dem_test()
    r0, r1, c0, c1 = examples._TEST_ICROP
    mask = ~examples.get_glacier_mask()[r0:r1, c0:c1]
    return ref, tba, mask, Affine(*tuple(ref.transform))


@pytest.fixture(scope="module")
def jax_results(crop):
    ref, tba, mask, _ = crop
    out = {}
    with pytest.warns(UserWarning, match="single range"):  # Basic keeps the first model
        for approach in APPROACHES:
            sig, rho = ref.estimate_uncertainty(tba, stable_terrain=mask, approach=approach, **KW)
            out[approach] = (np.array(sig.data), rho(LAGS))
    return out


def _port(crop, approach, **kw):
    ref, tba, mask, t = crop
    args = dict(stable_terrain=mask, approach=approach, transform=t, crs=32633, **KW)
    args.update(kw)
    if approach == "Basic":
        with pytest.warns(UserWarning, match="single range"):
            return uncertainty.estimate_uncertainty(np.array(ref.data), np.array(tba.data), **args)
    return uncertainty.estimate_uncertainty(np.array(ref.data), np.array(tba.data), **args)


def _xdem_tpu_draw(approach, gsd):
    """xdem_tpu's ring draw for `approach`, in the form of the port's _draw_rings_from_arr."""

    def device(seed, arr, *args):
        ija, ijb = jss._draw_rings_from_arr(np.uint32(seed), jnp.asarray(arr.cpu().numpy()), *args)
        return torch.from_numpy(np.array(ija)).long(), torch.from_numpy(np.array(ijb)).long()

    def host(seed, arr, runs, samples, nb_rings, nx, ny, radius0_px, m):
        # xdem_tpu's host grid mode draws from the child generator of its variogram loop.
        rng = np.random.default_rng(np.random.default_rng(KW["random_state"]).integers(0, 2**31 - 1))
        radius0 = np.hypot((nx - 1) * gsd, (ny - 1) * gsd) / np.sqrt(2) ** nb_rings
        ija, ijb = tss._draw_equidistant_rings_host(rng, np.isfinite(arr.cpu().numpy()), runs, samples,
                                                    nb_rings, radius0, gsd)
        return torch.from_numpy(ija), torch.from_numpy(ijb)

    return device if approach == "H2022" else host


@pytest.mark.parametrize("approach", APPROACHES)
def test_sigma_and_rho_match_xdem_tpu(monkeypatch, crop, jax_results, approach):
    monkeypatch.setattr(tss, "_draw_rings_from_arr", _xdem_tpu_draw(approach, crop[3].xres))
    sig, rho = _port(crop, approach)
    jsig, jrho = jax_results[approach]
    assert isinstance(sig, torch.Tensor) and sig.dtype == torch.float32 and sig.shape == jsig.shape
    torch_port_helpers.assert_same_nan(sig, jsig, "sigma")
    assert torch_port_helpers.scaled_dev(sig, jsig, pct=99.9) <= 5e-3
    assert torch_port_helpers.scaled_dev(sig, jsig) <= 1e-2
    np.testing.assert_allclose(rho(LAGS), jrho, rtol=0, atol=5e-3)


@pytest.mark.parametrize("approach", APPROACHES)
def test_own_draw_properties(crop, approach):
    """With the port's own generator: the properties tests/test_spatialstats.py holds
    xdem_tpu's pipeline to."""
    sig, rho = _port(crop, approach)
    arr = sig.numpy()
    assert np.isfinite(arr).mean() > 0.9
    assert np.nanmedian(arr) > 0
    assert rho(np.array([0.0]))[0] == pytest.approx(1.0)
    assert rho(np.array([1e7]))[0] == pytest.approx(0.0, abs=0.05)
    r = rho(np.linspace(0.0, 3e5, 3001))
    assert np.all(np.diff(r) <= 1e-12)


def test_same_precision_divides_by_sqrt2(crop):
    finer, _ = _port(crop, "R2009")
    same, _ = _port(crop, "R2009", precision_of_other="same")
    assert torch.equal(same, finer / torch.tensor(np.float32(np.sqrt(2))))


def test_custom_spread_estimator_runs_on_the_stable_values(crop):
    ref, tba, mask, _ = crop
    sig, _ = _port(crop, "R2009", spread_estimator=np.std)
    dh = np.array(tba.data, np.float64) - np.array(ref.data, np.float64)
    want = np.std(dh[mask & np.isfinite(dh)].astype(np.float32).astype(np.float64))
    assert float(sig[0, 0]) == pytest.approx(want, rel=1e-6)


class _VectorLike:
    bounds = (0.0, 0.0, 1.0, 1.0)

    def create_mask(self, *args, **kwargs):
        return None


@pytest.mark.parametrize("change,exc,match", [
    (dict(other=pd.DataFrame({"x": [0.0], "y": [0.0], "z": [1.0]})), ValueError, "Too few stable"),
    (dict(stable_terrain=_VectorLike()), ValueError, "raster is needed"),
    (dict(other=pd.DataFrame({"x": [0.0], "y": [0.0], "z": [1.0]}), mesh=make_mesh(devices=[torch.device("cpu")] * 2)),
     ValueError, "point-cloud uncertainty"),
    (dict(other=np.zeros((10, 12), np.float32)), ValueError, "not on the grid"),
    (dict(transform=None), ValueError, "transform="),
    (dict(crs=3.5), TypeError, "Cannot build a CRS"),
    (dict(approach="H2023"), ValueError, "Unknown uncertainty approach"),
    (dict(variogram_estimator="median"), ValueError, "not supported"),
])
def test_refusals(change, exc, match):
    rng = np.random.default_rng(0)
    dem = rng.normal(size=(40, 40)).cumsum(0).astype(np.float32)
    args = dict(other=dem + 0.1, stable_terrain=None, transform=Affine.from_origin(0, 0, 20, 20), crs=32633,
                approach="R2009", subsample=200, list_vario_models=["gaussian"])
    args.update(change)
    other = args.pop("other")
    with pytest.raises(exc, match=match):
        uncertainty.estimate_uncertainty(dem, other, **args)
