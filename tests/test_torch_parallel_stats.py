"""mesh= on the port's statistics (parallel/variogram.py, parallel/neff.py, the row-sharded
heteroscedasticity and estimate_uncertainty) against the port's single-device results and
xdem_tpu's mesh= results.

Mirrors xdem_tpu's tests/test_spatialstats.py mesh cases. The port's mesh is 8 CPU shards,
xdem_tpu's the 8 virtual CPU devices of tests/conftest.py. Tolerances: pair counts identical;
Dowd and Genton bins, the heteroscedastic sigma and estimate_uncertainty's sigma and rho the
same to the bit for any sharding (and equal to the single-device route where it computes the
same estimator); Matheron and Cressie to float64 rounding; n_eff to 1e-4; against xdem_tpu,
sigma and rho within 5e-3 (ROADMAP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch_port_helpers
from jax.sharding import Mesh as JaxMesh

import xdem_tpu.spatialstats as jss
import xdem_tpu_torch.spatialstats as tss
from xdem_tpu import examples as jex
from xdem_tpu import terrain as jterrain
from xdem_tpu.parallel import variogram as jvario
from xdem_tpu_torch import Raster, examples, terrain
from xdem_tpu_torch.parallel import make_mesh
from xdem_tpu_torch.parallel.variogram import sharded_variogram_bins

ESTIMATORS = ("matheron", "cressie", "dowd", "genton")
LAGS = np.array([10.0, 100.0, 1000.0])


def cpu_mesh(n: int):
    return make_mesh(devices=[torch.device("cpu")] * n, shape=(1, n))


def jax_mesh(n: int):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("runs",))


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(12)
    r, n, m = 10, 60, 120  # 10 runs over 8 shards: NaN-padded runs
    return (rng.normal(0, 2.0, (r, n)).astype(np.float32), rng.normal(0, 2.0, (r, m)).astype(np.float32),
            rng.uniform(0, 1000, (r, n, 2)).astype(np.float32), rng.uniform(0, 1000, (r, m, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def pair():
    ref, tba = examples.get_ref_dem_test(), examples.get_tba_dem_test()
    r0, r1, c0, c1 = jex._TEST_ICROP
    return ref, tba, ~jex.get_glacier_mask()[r0:r1, c0:c1]


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_sharded_bins_are_mesh_invariant_and_match(estimator, runs):
    za, zb, ca, cb = runs
    edges = [0.0, 400.0, 900.0, 1500.0]
    g8, c8 = sharded_variogram_bins(za, zb, ca, cb, edges, cpu_mesh(8), estimator=estimator)
    g1, c1 = sharded_variogram_bins(za, zb, ca, cb, edges, cpu_mesh(1), estimator=estimator)
    np.testing.assert_array_equal(c8, c1)
    if estimator in ("dowd", "genton"):
        np.testing.assert_array_equal(g8, g1)
    else:
        np.testing.assert_allclose(g8, g1, rtol=1e-12)
    diffs = torch.from_numpy(za)[:, :, None] - torch.from_numpy(zb)[:, None, :]
    dists = torch.sqrt(((torch.from_numpy(ca)[:, :, None, :] - torch.from_numpy(cb)[:, None, :, :]) ** 2).sum(-1))
    gs, cs = tss._binned_pair_estimator(diffs, torch.where(dists <= 0, torch.nan, dists), np.asarray(edges),
                                        estimator)
    np.testing.assert_array_equal(c8, cs)
    if estimator == "dowd":
        np.testing.assert_array_equal(g8, gs)  # exact order statistics on both routes
    elif estimator != "genton":  # Genton's single-device route draws its own 400 pairs
        np.testing.assert_allclose(g8, gs, rtol=1e-12)
    gj, cj = jvario.sharded_variogram_bins(za, zb, ca, cb, edges, jax_mesh(8), estimator=estimator)
    np.testing.assert_array_equal(c8, np.asarray(cj))
    np.testing.assert_allclose(g8, np.asarray(gj), rtol=5e-3)
    assert np.allclose(g8[c8 > 500], 4.0, rtol=0.25)  # white noise: the sill is sigma^2


@pytest.mark.parametrize("shards, budget", [(8, 115_200), (8, 115_199), (1, 72_000), (1, 71_999)])
def test_sharded_bins_refuse_past_the_pair_budget(runs, monkeypatch, shards, budget):
    """The shards of one device hold their pairs together: 10 runs of 60 x 120 pairs are
    72 000 pairs on one shard, and 16 runs (NaN-padded) or 115 200 pairs over 8 shards of the
    CPU. Up to the budget the call runs; past it, it refuses."""
    monkeypatch.setattr(tss, "_PAIR_CHUNK_BUDGET", budget)
    za, zb, ca, cb = runs
    held = 115_200 if shards == 8 else 72_000
    if held > budget:
        with pytest.raises(ValueError, match="pairs on one device"):
            sharded_variogram_bins(za, zb, ca, cb, [0.0, 1500.0], cpu_mesh(shards))
    else:
        _, counts = sharded_variogram_bins(za, zb, ca, cb, [0.0, 1500.0], cpu_mesh(shards))
        assert 0 < counts.sum() <= 72_000


@pytest.mark.parametrize("estimator", ["dowd", "matheron", "genton"])
def test_sample_empirical_variogram_mesh(estimator, pair):
    """The device grid route: mesh-invariant and, for Dowd and Matheron, the single-device
    route's pairs and values; against xdem_tpu's mesh= run on the host grid (one numpy draw)."""
    dh = pair[0].data
    out = {n: tss.sample_empirical_variogram(dh, gsd=20.0, subsample=150, random_state=3, estimator=estimator,
                                             mesh=cpu_mesh(n)) for n in (1, 8)}
    for k in ("count", "lags"):
        np.testing.assert_array_equal(out[1][k], out[8][k])
    if estimator == "matheron":  # float64 sums in another order
        np.testing.assert_allclose(out[1]["exp"], out[8]["exp"], rtol=1e-12)
    else:
        np.testing.assert_array_equal(out[1]["exp"], out[8]["exp"])
    single = tss.sample_empirical_variogram(dh, gsd=20.0, subsample=150, random_state=3, estimator=estimator)
    np.testing.assert_array_equal(out[8]["count"], single["count"])
    if estimator != "genton":
        np.testing.assert_allclose(out[8]["exp"], single["exp"], rtol=1e-12)
    host = dh.numpy().astype(np.float64)
    got = tss.sample_empirical_variogram(host, gsd=20.0, subsample=150, random_state=3, estimator=estimator,
                                         mesh=cpu_mesh(8))
    want = jss.sample_empirical_variogram(host, gsd=20.0, subsample=150, random_state=3, estimator=estimator,
                                          mesh=jax_mesh(8))
    np.testing.assert_array_equal(got["count"], want["count"].to_numpy())
    np.testing.assert_allclose(got["exp"], want["exp"].to_numpy(), rtol=5e-3)


def test_heteroscedasticity_mesh_exact(pair):
    ref, tba, mask = pair
    dh = Raster(tba.data - ref.data, ref.transform, ref.crs)
    attrs = terrain.get_terrain_attribute(ref, ["slope", "max_curvature"])
    args = dict(dvalues=dh, list_var=attrs, list_var_names=["slope", "max_curvature"], stable_mask=mask,
                subsample=10**6, random_state=0)
    sig1, df1, _ = tss.infer_heteroscedasticity_from_stable(**args)
    sig8, df8, _ = tss.infer_heteroscedasticity_from_stable(**args, mesh=cpu_mesh(8))
    assert torch.equal(torch.nan_to_num(sig1.data, 1e9), torch.nan_to_num(sig8.data, 1e9))
    for k in df1:
        np.testing.assert_array_equal(df1[k], df8[k])
    jref, jtba = jex.get_ref_dem_test(), jex.get_tba_dem_test()
    jdh = type(jref)(jtba.data - jref.data, jref.transform, jref.crs)
    jattrs = jterrain.get_terrain_attribute(jref, ["slope", "max_curvature"])
    jsig, _, _ = jss.infer_heteroscedasticity_from_stable(**dict(args, dvalues=jdh, list_var=jattrs),
                                                          mesh=jax_mesh(8))
    torch_port_helpers.assert_same_nan(sig8.data, np.asarray(jsig.data), "sigma")
    assert torch_port_helpers.scaled_dev(sig8.data, np.asarray(jsig.data), pct=99.9) <= 5e-3


@pytest.mark.parametrize("fn", ["exact", "hugonnet"])
def test_neff_mesh(fn):
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 1000, (700, 2)).astype(np.float32)  # 700: not a multiple of 8
    errors = rng.uniform(0.5, 2.0, 700).astype(np.float32)
    params = {"model": np.array(["spherical"]), "range": np.array([300.0]), "psill": np.array([1.0])}
    jparams = pd.DataFrame({"model": ["spherical"], "range": [300.0], "psill": [1.0], "smooth": [None]})
    kw = {} if fn == "exact" else dict(subsample=300, random_state=7)
    ours, theirs = getattr(tss, f"neff_{fn}" if fn == "exact" else "neff_hugonnet_approx"), \
        getattr(jss, f"neff_{fn}" if fn == "exact" else "neff_hugonnet_approx")
    single = ours(coords, errors, params, **kw)
    sharded = ours(coords, errors, params, mesh=cpu_mesh(8), **kw)
    assert sharded == pytest.approx(single, rel=1e-4)
    assert sharded == pytest.approx(theirs(coords, errors, jparams, mesh=jax_mesh(8), **kw), rel=5e-3)


def test_neff_matern_with_mesh_runs_on_the_host(caplog):
    rng = np.random.default_rng(6)
    coords = rng.uniform(0, 1000, (100, 2))
    errors = rng.uniform(0.5, 2.0, 100)
    params = {"model": np.array(["matern"]), "range": np.array([300.0]), "psill": np.array([1.0]),
              "smooth": np.array([1.5])}
    with caplog.at_level("WARNING"):
        got = tss.neff_exact(coords, errors, params, mesh=cpu_mesh(8))
    assert got == tss.neff_exact(coords, errors, params) and "Matern" in caplog.text


def test_estimate_uncertainty_mesh(pair, monkeypatch):
    """sigma and rho of the mesh run are the single-device ones to the bit (Dowd), for any
    sharding; against xdem_tpu's mesh= run with its ring draw injected, within 5e-3."""
    ref, tba, mask = pair
    outs = {}
    for n in (None, 1, 8):
        sig, rho = ref.estimate_uncertainty(tba, stable_terrain=mask, subsample=150, random_state=42,
                                            mesh=None if n is None else cpu_mesh(n))
        outs[n] = (sig.data.numpy(), rho(LAGS))
    for n in (1, 8):
        np.testing.assert_array_equal(outs[n][0], outs[None][0])
        np.testing.assert_array_equal(outs[n][1], outs[None][1])

    def device_draw(seed, arr, *args):
        ija, ijb = jss._draw_rings_from_arr(np.uint32(seed), jnp.asarray(arr.cpu().numpy()), *args)
        return torch.from_numpy(np.array(ija)).long(), torch.from_numpy(np.array(ijb)).long()

    monkeypatch.setattr(tss, "_draw_rings_from_arr", device_draw)
    sig, rho = ref.estimate_uncertainty(tba, stable_terrain=mask, subsample=150, random_state=42, mesh=cpu_mesh(8))
    jsig, jrho = jex.get_ref_dem_test().estimate_uncertainty(jex.get_tba_dem_test(), stable_terrain=mask,
                                                             subsample=150, random_state=42, mesh=jax_mesh(8))
    torch_port_helpers.assert_same_nan(sig.data, np.asarray(jsig.data), "sigma")
    assert torch_port_helpers.scaled_dev(sig.data, np.asarray(jsig.data), pct=99.9) <= 5e-3
    np.testing.assert_allclose(rho(LAGS), jrho(LAGS), rtol=0, atol=5e-3)
    with pytest.raises(ValueError, match="point-cloud uncertainty"):
        ref.estimate_uncertainty(tba.to_pointcloud(subsample=500, random_state=1), mesh=cpu_mesh(2))
