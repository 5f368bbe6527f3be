"""xdem_tpu_torch stands alone: it imports neither JAX, xdem_tpu, pandas nor scikit-learn (the
card's machine has none of them), its copied constant tables equal xdem_tpu's originals, and
its kernel builder imports without nvcc."""

import math
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

import xdem_tpu
import xdem_tpu_torch
from xdem_tpu.coreg import base as jbase
from xdem_tpu.georef import CRS
from xdem_tpu.georef import Affine as JaxAffine
from xdem_tpu.terrain import surfit as jsurf
from xdem_tpu.terrain import window as jwin
from xdem_tpu_torch import _build, georef
from xdem_tpu_torch.coreg import base as tbase
from xdem_tpu_torch.terrain import cuda_kernels, surfit, window

PKG = Path(xdem_tpu_torch.__file__).resolve().parent


def test_import_loads_neither_jax_nor_xdem_tpu():
    code = (
        "import sys; import xdem_tpu_torch, xdem_tpu_torch.terrain, xdem_tpu_torch.coreg, "
        "xdem_tpu_torch.ops, xdem_tpu_torch.terrain.cuda_kernels, xdem_tpu_torch.spatialstats, "
        "xdem_tpu_torch.uncertainty, xdem_tpu_torch.fit, xdem_tpu_torch.coreg.biascorr, "
        "xdem_tpu_torch.coreg.filters, xdem_tpu_torch.coreg.blockwise, xdem_tpu_torch.volume, "
        "xdem_tpu_torch.terrain.freq, xdem_tpu_torch.projections, xdem_tpu_torch.georef, xdem_tpu_torch.config, "
        "xdem_tpu_torch.io, xdem_tpu_torch.geoid, xdem_tpu_torch.vcrs, xdem_tpu_torch.vector, xdem_tpu_torch._misc, "
        "xdem_tpu_torch.raster, xdem_tpu_torch.dem, xdem_tpu_torch.examples, xdem_tpu_torch.pointcloud, "
        "xdem_tpu_torch.epc, xdem_tpu_torch.ddem, xdem_tpu_torch.demcollection, xdem_tpu_torch.terrain.tiled, "
        "xdem_tpu_torch.workflows, xdem_tpu_torch.cli, xdem_tpu_torch.parallel, xdem_tpu_torch.parallel.coreg, "
        "xdem_tpu_torch.parallel.selection, xdem_tpu_torch.parallel.variogram, xdem_tpu_torch.parallel.distributed, "
        "xdem_tpu_torch.profiler; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.', 'sklearn')) "
        "or m in ('xdem_tpu', 'pandas')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax_or_xdem_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|xdem_tpu|pandas|sklearn)\b", re.M)
    # _build/ holds build outputs (git-ignored), not sources.
    files = [f for f in PKG.rglob("*.py") if "_build" not in f.relative_to(PKG).parts]
    files.append(PKG.parent / "chip_smoke.py")
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_sources_call_no_library_convolution():
    """On an H100 cuDNN's float32 convolutions run in TF32 unless told otherwise: the port's
    convolutions sum shifted slices of float64 prefix sums and call none (nor torch.compile)."""
    pattern = re.compile(r"\b(conv[123]d|conv_transpose[123]d|torch\.compile)\s*\(")
    files = [f for f in PKG.rglob("*.py") if "_build" not in f.relative_to(PKG).parts]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_uncertainty_path_runs_without_pandas():
    """The uncertainty path imports and runs with pandas unavailable, as on the card's machine."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import Affine, uncertainty\n"
        "rng = np.random.default_rng(0)\n"
        "dem = (rng.normal(size=(48, 52)).cumsum(0).cumsum(1) * 3).astype(np.float32)\n"
        "other = dem + rng.normal(0, 0.5, dem.shape).astype(np.float32)\n"
        "sig, rho = uncertainty.estimate_uncertainty(dem, other, transform=Affine.from_origin(0, 0, 20, 20),\n"
        "                                            subsample=200, random_state=1)\n"
        "assert np.isfinite(sig.numpy()).mean() > 0.8 and abs(rho(np.array([0.0]))[0] - 1) < 1e-9\n"
        "assert 'pandas' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_coreg_path_runs_without_pandas_or_sklearn():
    """A pipeline of rigid and bias-correction steps fits, saves, loads and applies with
    pandas and scikit-learn unavailable, as on the card's machine; sklearn is asked for only
    by name, and then its absence is named."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['sklearn'] = None\n"
        "import os, tempfile, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import Affine, coreg, fit\n"
        "rng = np.random.default_rng(0)\n"
        "dem = (rng.normal(size=(64, 64)).cumsum(0).cumsum(1) * 3).astype(np.float32)\n"
        "tba = dem + np.linspace(0, 1, 64, dtype=np.float32)[None, :]\n"
        "t = Affine.from_origin(0, 1280, 20, 20)\n"
        "pipe = coreg.LZD(subsample=2000) + coreg.TerrainBias(\"slope\", bin_sizes=8)\n"
        "out, _ = pipe.fit_and_apply(dem, tba, transform=t, random_state=1)\n"
        "path = os.path.join(tempfile.mkdtemp(), 'p.pkl'); pipe.save(path)\n"
        "again, _ = coreg.Coreg.load(path).apply(tba, transform=t)\n"
        "assert torch.equal(torch.isnan(out), torch.isnan(again)) and bool(torch.nan_to_num(out - again).eq(0).all())\n"
        "try:\n"
        "    fit.robust_norder_polynomial_fit(np.arange(20.0), np.arange(20.0), linear_pkg='sklearn')\n"
        "    raise SystemExit('sklearn did not raise')\n"
        "except ImportError as e:\n"
        "    assert 'scikit-learn' in str(e)\n"
        "assert not [m for m in ('pandas', 'sklearn') if sys.modules.get(m) is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_volume_texture_and_patches_run_without_pandas():
    """The volume functions, texture shading, the convolutions, the patches method, the Genton
    estimator and a point subsample import and run with pandas unavailable and without JAX or
    xdem_tpu in the process, as on the card's machine."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import spatialstats as ss, terrain, volume\n"
        "rng = np.random.default_rng(0)\n"
        "ref = rng.uniform(100, 1100, (60, 70)).astype(np.float32)\n"
        "dh = (-(ref - 100) / 100 + rng.normal(0, 0.3, ref.shape)).astype(np.float32)\n"
        "dh[rng.random(ref.shape) < 0.1] = np.nan\n"
        "gid = np.zeros(ref.shape, int); gid[5:30, 5:60] = 1; gid[35:55, 10:65] = 2\n"
        "for args in ((dh, ref), (torch.from_numpy(dh), torch.from_numpy(ref))):\n"
        "    bins = volume.hypsometric_binning(*args, bins=100.0)\n"
        "    assert bins['count'].sum() == np.isfinite(dh).sum() and abs(bins['value'][5] + 5.5) < 0.3\n"
        "    sig = volume.get_regional_hypsometric_signal(*args, gid)\n"
        "    assert sig['count'].sum() > 1000 and np.isfinite(sig['median']).sum() > 10\n"
        "bins['value'][3] = np.nan\n"
        "filled = volume.interpolate_hypsometric_bins(bins)\n"
        "fitted = volume.fit_hypsometric_bins_poly(bins, degree=1)\n"
        "area = volume.calculate_hypsometry_area(filled, ref, 20.0)\n"
        "assert np.isfinite(filled['value']).all() and area['area'].sum() == ref.size * 400.0\n"
        "assert abs(fitted['value'][5] + 5.5) < 0.3\n"
        "out = volume.hypsometric_interpolation(dh, ref, gid > 0)\n"
        "assert np.isfinite(out.filled(np.nan)[gid > 0]).all()\n"
        "out = volume.norm_regional_hypsometric_interpolation(dh, ref, gid, regional_signal=sig)\n"
        "assert np.isfinite(out.filled(np.nan)[gid > 0]).mean() > 0.9\n"
        "assert np.isfinite(volume.idw_interpolation(dh)).mean() > 0.99\n"
        "slope, tex = terrain.get_terrain_attribute(ref, ['slope', 'texture_shading'], resolution=20.0)\n"
        "assert tex.shape == slope.shape and bool(torch.isfinite(tex).all())\n"
        "table = ss.patches_method(dh, areas=[3600.0, 14400.0], gsd=20.0)\n"
        "assert np.isfinite(table['nmad']).all() and table['nb_indep_patches'][0] > table['nb_indep_patches'][1]\n"
        "assert ss.convolution(dh[None], np.ones((1, 3, 3)))[0, 0].shape == dh.shape\n"
        "for method in ('cdist_equidistant', 'pdist_ring'):\n"
        "    emp = ss.sample_empirical_variogram(torch.from_numpy(dh), gsd=20.0, subsample=200, estimator='genton',\n"
        "                                        subsample_method=method, random_state=1)\n"
        "    assert np.isfinite(emp['exp']).sum() >= 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad and sys.modules['pandas'] is None, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_file_to_result_path_runs_without_pandas(tmp_path):
    """Raster and DEM from files: GeoTIFF I/O, a cross-CRS reprojection, the vertical CRS, a
    Vector mask, the terrain wrappers, coregister_3d and estimate_uncertainty import and run
    with pandas unavailable and without JAX or xdem_tpu in the process, as on the card's
    machine."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import DEM, examples\n"
        f"d = {str(tmp_path)!r}\n"
        "ref = DEM(examples.get_path_test('longyearbyen_ref_dem', output_dir=d))\n"
        "tba = DEM(examples.get_path_test('longyearbyen_tba_dem', output_dir=d))\n"
        "outlines = examples.get_glacier_outlines()\n"
        "assert ref.reproject(crs=32632).shape[0] > 200 and ref.crs == 32633\n"
        "ref.set_vcrs('EGM96'); ell = ref.to_vcrs('Ellipsoid')\n"
        "assert 25 < float(np.nanmedian(ell.get_nanarray() - ref.get_nanarray())) < 40\n"
        "slope = ref.slope(); assert np.isfinite(slope.get_nanarray()).mean() > 0.9\n"
        "aligned = tba.coregister_3d(ref, inlier_mask=~outlines.create_mask(ref), random_state=42)\n"
        "sig, rho = ref.estimate_uncertainty(aligned, stable_terrain=~outlines.create_mask(ref), subsample=500,\n"
        "                                    random_state=1)\n"
        "assert np.isfinite(sig.get_nanarray()).mean() > 0.9 and abs(rho(np.array([0.0]))[0] - 1) < 1e-9\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad and sys.modules['pandas'] is None, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_point_and_blockwise_paths_run_without_pandas_or_sklearn(tmp_path):
    """Point clouds (LAS round trip, the vertical CRS, coregistration both ways, the
    uncertainty of a DEM against points) and blockwise coregistration (the batched fit, the
    RANSAC, the warp, the streamed warp) import and run with pandas and scikit-learn
    unavailable and without JAX or xdem_tpu in the process, as on the card's machine."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import EPC, coreg, examples\n"
        "from xdem_tpu_torch.epc import read_epc, write_epc\n"
        f"d = {str(tmp_path)!r}\n"
        "ref, tba = examples.get_ref_dem().icrop((0, 512), (0, 640)), examples.get_tba_dem().icrop((0, 512), (0, 640))\n"
        "pts = tba.to_pointcloud(subsample=20000, random_state=1)\n"
        "write_epc(d + '/p.las', pts); back = read_epc(d + '/p.las')\n"
        "assert isinstance(back, EPC) and back.crs == 32633 and float((back.z - pts.z).abs().max()) < 1e-3\n"
        "back.set_vcrs('EGM96'); assert back.to_vcrs('Ellipsoid') is not None\n"
        "nk = coreg.NuthKaab(); moved = pts.coregister_3d(ref, nk, random_state=42)\n"
        "assert abs(nk.to_translations()[2] - 2.35) < 0.1 and isinstance(moved, EPC)\n"
        "coreg.LZD(subsample=3000).fit(ref.to_pointcloud(subsample=20000, random_state=2), tba, random_state=1)\n"
        "sig, rho = ref.estimate_uncertainty(pts, subsample=500, random_state=1)\n"
        "assert np.isfinite(sig.get_nanarray()).mean() > 0.9 and abs(rho(np.array([0.0]))[0] - 1) < 1e-9\n"
        "bw = coreg.BlockwiseNuthKaab(block_size_fit=128, subsample_per_tile=3000, random_state=3).fit(ref, tba)\n"
        "out = bw.apply(tba); path = bw.apply_tiled(tba, out_path=d + '/a.tif', tile_rows=200)\n"
        "assert np.isfinite(out.get_nanarray()).mean() > 0.9\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad and sys.modules['pandas'] is None and sys.modules['sklearn'] is None, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ddem_collection_and_tiled_paths_run_without_pandas_or_sklearn(tmp_path):
    """dDEM, DEMCollection (ISO-string timestamps, outlines, the three gap fillers, every
    series) and tiled terrain from a file import and run with pandas and scikit-learn
    unavailable and without JAX or xdem_tpu in the process, as on the card's machine."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import DEMCollection, examples, terrain\n"
        f"d = {str(tmp_path)!r}\n"
        "ref = examples.get_ref_dem().icrop((150, 450), (300, 540)); outlines = examples.get_glacier_outlines()\n"
        "inside = outlines.create_mask(ref)\n"
        "older = ref.copy(new_array=torch.where(inside, ref.data + 5.0, ref.data))\n"
        "older.data[100:110, 100:110] = float('nan')\n"
        "col = DEMCollection([ref, older], timestamps=['2010-08-01', '2000-08-01'], outlines=outlines, reference_dem=0)\n"
        "ddems = col.subtract_dems()\n"
        "for m in ('idw', 'local_hypsometric', 'regional_hypsometric'):\n"
        "    assert ddems[0].interpolate(m, reference_elevation=ref, mask=outlines) is not None\n"
        "dh = col.get_dh_series(); assert abs(dh['dh'][0] + 5.0) < 0.05, dh\n"
        "assert col.get_cumulative_series('dv', nans_ok=True)['dv'][0] == 0.0\n"
        "col.subtract_dems_intervalwise(); assert len(col.get_dv_series(nans_ok=True)['dv']) == 1\n"
        "ref.save(d + '/ref.tif')\n"
        "paths = terrain.get_terrain_attribute(d + '/ref.tif', ['slope', 'roughness', 'fractal_roughness'],\n"
        "                                      tiled=terrain.TilingConfig(tile_rows=100, outdir=d))\n"
        "assert len(paths) == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad and sys.modules['pandas'] is None and sys.modules['sklearn'] is None, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_workflows_run_from_dict_configs_without_yaml_or_matplotlib(tmp_path):
    """Topo and Accuracy from dict configurations run with pandas, scikit-learn, PyYAML and
    matplotlib unavailable: the plots and the PDF are skipped with a logged warning, the
    tables and the report are written, and a YAML configuration names PyYAML in its error."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'sklearn', 'yaml', 'matplotlib', 'matplotlib.pyplot'): sys.modules[m] = None\n"
        "import os, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import examples, workflows\n"
        f"d = {str(tmp_path)!r}\n"
        "ref = examples.get_path_test('longyearbyen_ref_dem', output_dir=d)\n"
        "tba = examples.get_path_test('longyearbyen_tba_dem', output_dir=d)\n"
        "mask = examples.get_path('longyearbyen_glacier_outlines', output_dir=d)\n"
        "workflows.Topo({'inputs': {'path_to_elev': ref}, 'terrain_attributes': ['slope', 'roughness'],\n"
        "                'outputs': {'path': d + '/topo', 'generate_pdf': True}}).run()\n"
        "assert os.path.exists(d + '/topo/tables/slope_stats.csv') and os.path.exists(d + '/topo/report.html')\n"
        "assert not os.listdir(d + '/topo/plots') and not os.path.exists(d + '/topo/report.pdf')\n"
        "acc = workflows.Accuracy({'inputs': {'reference_elev': {'path_to_elev': ref},\n"
        "    'to_be_aligned_elev': {'path_to_elev': tba, 'path_to_mask': mask}}, 'outputs': {'path': d + '/acc'}})\n"
        "acc.run(); assert os.path.exists(d + '/acc/tables/stats_summary.csv')\n"
        "try:\n"
        "    workflows.load_yaml_config(d + '/none.yaml'); raise SystemExit('no error')\n"
        "except ImportError as err:\n"
        "    assert 'PyYAML' in str(err), err\n"
        "assert all(sys.modules[m] is None for m in ('pandas', 'sklearn', 'yaml', 'matplotlib'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "matplotlib unavailable" in proc.stderr


@pytest.mark.parametrize("name", ["COREG_METHODS", "MIN_STATS", "STATS_METHODS", "TERRAIN_ATTRIBUTES_DEFAULT",
                                  "TERRAIN_ATTRIBUTES", "INPUTS_DEM", "OUTPUTS_SCHEMA", "ACCURACY_SCHEMA",
                                  "TOPO_SCHEMA", "COMPLETE_CONFIG_ACCURACY", "COMPLETE_CONFIG_TOPO"])
def test_workflow_schemas_equal_originals(name):
    from xdem_tpu.workflows import schemas as jschemas
    from xdem_tpu_torch.workflows import schemas

    assert getattr(schemas, name) == getattr(jschemas, name)
    for required, method in ((False, None), (True, "LZD")):
        assert schemas.make_coreg_step(required, method) == jschemas.make_coreg_step(required, method)


def test_las_layout_and_geokeys_equal_originals(tmp_path):
    """The port's LAS constants are those of the layout xdem_tpu writes: the header size, the
    GeoKeyDirectory record and the projected, geographic and user-defined keys."""
    import struct

    from xdem_tpu import epc as jepc
    from xdem_tpu_torch import epc as tepc

    for crs, key in ((32633, tepc.LAS_KEY_PROJECTED), (4326, tepc.LAS_KEY_GEOGRAPHIC)):
        path = str(tmp_path / f"{crs}.las")
        jepc.write_epc(path, jepc.EPC(x=[1.0, 2.0], y=[3.0, 4.0], z=[5.0, 6.0], crs=crs))
        buf = open(path, "rb").read()
        assert struct.unpack_from("<H", buf, 94)[0] == tepc.LAS_HEADER_SIZE
        assert struct.unpack_from("<H", buf, tepc.LAS_HEADER_SIZE + 18)[0] == tepc.LAS_GEOKEY_RECORD
        keys = np.frombuffer(buf, "<u2", count=12, offset=tepc.LAS_HEADER_SIZE + 54)
        assert keys[8] == key and keys[11] == crs
        # A user-defined code is no EPSG code: both readers ignore it.
        patched = bytearray(buf)
        struct.pack_into("<H", patched, tepc.LAS_HEADER_SIZE + 54 + 22, tepc.LAS_USER_DEFINED)
        (tmp_path / "u.las").write_bytes(bytes(patched))
        assert tepc._read_las(str(tmp_path / "u.las"))[3] is None is jepc._read_las(str(tmp_path / "u.las"))[3]


def test_blockwise_thresholds_and_ransac_rules_equal_originals():
    """_gate_diverged_tiles gates a shift beyond a tile's extent and keeps one at it, as
    xdem_tpu's does; the RANSAC keeps scikit-learn's RANSACRegressor rules (three points a
    trial, a 0.99 stop probability) and xdem_tpu's defaults (threshold 0.01, 2000 trials,
    seed 42)."""
    import inspect

    from sklearn.linear_model import RANSACRegressor

    from xdem_tpu.coreg import blockwise as jbw
    from xdem_tpu_torch.coreg import blockwise as tbw

    for lim in (500 * 20.0, np.nextafter(500 * 20.0, np.inf)):
        a, b = [np.array([lim, 0.0]), np.array([0.0, -lim]), np.zeros(2)], [np.array([lim, 0.0]), np.array([0.0, -lim]),
                                                                            np.zeros(2)]
        np.testing.assert_array_equal(tbw._gate_diverged_tiles(*a, 500, 20.0, 20.0),
                                      jbw._gate_diverged_tiles(*b, 500, 20.0, 20.0))
    assert RANSACRegressor().stop_probability == tbw.RANSAC_STOP_PROBABILITY and tbw.RANSAC_MIN_SAMPLES == 3
    for name in ("_ransac", "ransac_all", "apply", "apply_tiled", "fit", "fit_and_apply"):
        ours, theirs = (inspect.signature(getattr(m.BlockwiseCoreg, name)).parameters for m in (tbw, jbw))
        assert {k: v.default for k, v in ours.items()} == {k: v.default for k, v in theirs.items()}, name


def _same(a, b) -> bool:
    """Deep equality of copied tables: arrays by value and dtype (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


# The substrate's copied modules, and the names in them that are not tables of the original:
# the projection kernels by family (functions of each package, compared by their keys below),
# the TPU-only config keys, a logger, a path, the codec once loaded (None until a first read or
# write, so its value depends on the tests that ran before), the examples' cache directory, a TypeVar.
_COPIED = {"projections": {"_logger", "_FORWARD", "_INVERSE"}, "geoid": set(), "vcrs": set(),
           "config": {"_DEFAULTS", "config"}, "georef": {"_PROJ_DEFS"}, "io": {"_SRC", "_LIB"}, "dem": set(),
           "examples": {"_CACHE_DIR"}, "_misc": {"T"}}


@pytest.mark.parametrize("module", sorted(_COPIED))
def test_substrate_tables_equal_originals(module):
    """Every module-level table of xdem_tpu's substrate modules (the EPSG, ellipsoid and datum
    tables of projections, the geoid coefficients and stations, the vertical CRS and product
    tables, the examples' grid) is in the port's copy and equal to it."""
    import importlib

    theirs = importlib.import_module(f"xdem_tpu.{module}")
    ours = importlib.import_module(f"xdem_tpu_torch.{module}")
    for name, value in vars(theirs).items():
        if name.startswith("__") or callable(value) or isinstance(value, type(math)) or name in _COPIED[module]:
            continue
        assert hasattr(ours, name), f"{module}.{name} is missing"
        assert _same(value, getattr(ours, name)), f"{module}.{name} differs"
    if module == "projections":
        assert ours._FORWARD.keys() == theirs._FORWARD.keys() == ours._INVERSE.keys() == theirs._INVERSE.keys()
    if module == "config":
        assert ours._DEFAULTS == {k: theirs._DEFAULTS[k] for k in ("resampling", "warn_area_or_point",
                                                                    "shift_area_or_point")}
        assert {"shape_bucketing", "prefer_pallas"} == set(theirs._DEFAULTS) - set(ours._DEFAULTS)


def test_geotiff_codec_is_a_byte_copy():
    theirs = Path(xdem_tpu.__file__).resolve().parent / "native" / "geotiff.cpp"
    assert (PKG / "native" / "geotiff.cpp").read_bytes() == theirs.read_bytes()


def test_codec_build_names_what_is_missing(monkeypatch, tmp_path):
    """No g++ or no zlib header is an error that says so; nothing else is tried."""
    from xdem_tpu_torch import io as tio

    monkeypatch.setattr(tio, "library_path", lambda: tmp_path / "geotiff" / "libxdemtiff.so")
    monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g..? was not found"):
        tio.build_library()


def test_copied_genton_constants_and_fft_sizes_equal_originals():
    """The port keeps its own copy of the Genton reservoir's cap and pair keys (which its
    parallel/variogram.py shares) and of next_fast_fft_size."""
    import jax.numpy as jnp

    from xdem_tpu.parallel import variogram as jvario
    from xdem_tpu.terrain import freq as jfreq
    from xdem_tpu_torch import spatialstats as tss
    from xdem_tpu_torch.terrain import freq as tfreq

    assert tss._GENTON_CAP == jvario._GENTON_CAP == 400
    parked = np.random.default_rng(0).integers(0, 4, 5 * 7 * 11)
    for run0 in (0, 3, 40_000):
        want = np.asarray(jvario._genton_pair_keys(jnp.uint32(run0), 5, 7, 11, jnp.asarray(parked), 3))
        got = tss._genton_pair_keys(run0, 5, 7, 11, torch.from_numpy(parked), 3).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    assert [tfreq.next_fast_fft_size(n) for n in range(1, 3000, 7)] == \
        [jfreq.next_fast_fft_size(n) for n in range(1, 3000, 7)]
    assert set(xdem_tpu_torch.volume.__dict__) >= {
        n for n, v in vars(xdem_tpu.volume).items() if callable(v) and not n.startswith("_")
        and getattr(v, "__module__", "") == "xdem_tpu.volume"}


@pytest.mark.parametrize("name", ["ALL_STENCILS", "DIV_CONST", "DIV_POW", "_FIT_DERIVS",
                                  "SURFACE_FIT_ATTRS", "_CURVATURE_ATTRS"])
def test_surfit_tables_equal_originals(name):
    ours, theirs = getattr(surfit, name), getattr(jsurf, name)
    if name == "ALL_STENCILS":
        assert ours.keys() == theirs.keys()
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    else:
        assert ours == theirs


@pytest.mark.parametrize("name", ["RUGOSITY_CENTER_SEGS", "RUGOSITY_EDGE_SEGS", "RUGOSITY_TRIS",
                                  "WINDOWED_ATTRS", "FRACTAL_ATTRS", "_ENGINE_ALIASES"])
def test_window_tables_equal_originals(name):
    assert getattr(window, name) == getattr(jwin, name)


def test_geographic_epsg_rule_matches_crs():
    """The port's 'projected' rule agrees with xdem_tpu's CRS on every EPSG code it knows."""
    for code in list(range(2000, 10000)) + list(range(32600, 32800)):
        try:
            want = CRS(code).is_projected
        except (ValueError, KeyError, NotImplementedError):
            continue
        assert georef.is_projected(code) == want, code
        assert georef.is_projected(f"EPSG:{code}") == want, code
        assert (code in georef.GEOGRAPHIC_EPSG) == (not want), code


@pytest.mark.parametrize("crs", ["+proj=utm +zone=33 +datum=WGS84", 'PROJCS["x"]', 3.5, None])
def test_non_epsg_crs_not_ported(crs):
    """PROJ strings and WKT go through the CRS engine as in xdem_tpu (a WKT with neither
    parameters nor a code is refused there too); what is no CRS at all raises CRS's error."""
    if isinstance(crs, str):
        try:
            want = CRS(crs).is_projected
        except ValueError as err:
            with pytest.raises(ValueError, match="neither parameters nor an EPSG"):
                georef.is_projected(crs)
            assert "neither parameters" in str(err)
        else:
            assert georef.is_projected(crs) is want is True
            assert georef.is_projected(CRS(crs).to_wkt()) is True
    else:
        with pytest.raises(TypeError, match="Cannot build a CRS"):
            georef.is_projected(crs)


def test_affine_copy_matches_original():
    args = (20.0, 0.5, 5e5, -0.25, -20.0, 8e6)
    ours, theirs = georef.Affine(*args), JaxAffine(*args)
    assert tuple(ours) == tuple(theirs)
    assert tuple(ours.invert()) == tuple(theirs.invert())
    assert tuple(ours * ours.invert()) == tuple(theirs * theirs.invert())
    assert tuple(ours.translation(3.0, -4.0)) == tuple(theirs.translation(3.0, -4.0))
    rows, cols = np.arange(5.0), np.arange(5.0)[::-1]
    np.testing.assert_array_equal(ours.xy(rows, cols), theirs.xy(rows, cols))
    np.testing.assert_array_equal(ours.rowcol(*ours.xy(rows, cols)), theirs.rowcol(*theirs.xy(rows, cols)))
    assert (ours.xres, ours.yres, ours.determinant) == (theirs.xres, theirs.yres, theirs.determinant)
    assert tuple(georef.Affine.from_origin(5e5, 8e6, 20, 20)) == tuple(JaxAffine.from_origin(5e5, 8e6, 20, 20))


def test_build_module_imports_without_nvcc(monkeypatch, tmp_path):
    """_build imports anywhere (this module imported it); building refuses clearly where
    there is no nvcc, and never at import."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {s.name for s in _build.sources()} >= {"surface_fit.cu", "windowed.cu", "fractal.cu"}
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / _build.LIB_NAME)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build()


def test_build_key_follows_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path


def test_kernel_exports_match_launch_signatures():
    """Every ctypes signature names an `extern "C"` function of csrc with as many parameters."""
    text = "".join(p.read_text() for p in PKG.glob("csrc/*.cu"))
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert m, name
        params = [a for a in m.group(1).split(",") if a.strip() not in ("", "void")]
        assert len(params) == len(argtypes), name


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_kernel_signature_types_match_declarations(name):
    """Each ctypes argument type is its `extern "C"` parameter's: a pointer (the stream too) as
    c_void_p, an int as c_int, a float as c_float, in the declaration's order."""
    import ctypes

    text = "".join(p.read_text() for p in PKG.glob("csrc/*.cu"))
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1).split(",")
    want = []
    for param in (p.strip() for p in params if p.strip() not in ("", "void")):
        kind = param.rsplit(None, 1)[0]
        want.append(ctypes.c_void_p if "*" in kind else {"int": ctypes.c_int, "float": ctypes.c_float}[kind])
    assert list(_build.SIGNATURES[name]) == want


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor: any other device raises."""
    dem = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_kernels.surface_attributes(dem, 1.0, ("slope",))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_kernels.windowed_indexes(dem, 1.0, ("roughness",))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_kernels.fractal_roughness(dem, 13)


def test_cpu_wrappers_count_no_launch():
    cuda_kernels.reset_launch_counts()
    dem = torch.zeros((12, 12))
    cuda_kernels.surface_attributes(dem, 1.0, ("slope",))
    cuda_kernels.windowed_indexes(dem, 1.0, ("roughness",))
    cuda_kernels.fractal_roughness(dem, 5)
    assert cuda_kernels.LAUNCHES == {"surface_fit": 0, "windowed": 0, "fractal": 0}


def test_default_device_and_dtype():
    dev = xdem_tpu_torch.default_device()
    assert dev.type == ("cuda" if torch.cuda.is_available() else "cpu")
    t = xdem_tpu_torch.as_tensor(np.ma.masked_array(np.arange(4.0), mask=[0, 1, 0, 0]))
    assert t.dtype == torch.float32 and t.device.type == dev.type
    assert math.isnan(float(t[1])) and float(t[2]) == 2.0
    read_only = np.arange(4.0, dtype=np.float32)
    read_only.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert float(xdem_tpu_torch.as_tensor(read_only)[3]) == 3.0


def test_near_square_factors_equal_original():
    """parallel/mesh.py keeps its own copy of xdem_tpu's mesh factoring."""
    from xdem_tpu.parallel import mesh as jmesh
    from xdem_tpu_torch.parallel import mesh as tmesh

    for n in range(1, 130):
        assert tmesh._near_square_factors(n) == jmesh._near_square_factors(n), n


def test_mesh_paths_and_profiler_run_without_pandas_or_sklearn(tmp_path):
    """The sharded terrain suite, a sharded Nuth & Kääb fit, estimate_uncertainty(mesh=) and
    the profiler's summary import and run with pandas and scikit-learn unavailable and without
    JAX or xdem_tpu in the process, as on the card's machine."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xdem_tpu_torch import coreg, examples, terrain\n"
        "from xdem_tpu_torch.parallel import make_mesh\n"
        "from xdem_tpu_torch.profiler import Profiler\n"
        f"d = {str(tmp_path)!r}\n"
        "mesh = make_mesh(devices=[torch.device('cpu')] * 4)\n"
        "ref, tba = examples.get_ref_dem().icrop((0, 256), (0, 320)), examples.get_tba_dem().icrop((0, 256), (0, 320))\n"
        "Profiler.enable(save_raw_data=True)\n"
        "a = terrain.get_terrain_attribute(ref, ['slope', 'roughness', 'fractal_roughness'], mesh=mesh)\n"
        "b = terrain.get_terrain_attribute(ref, ['slope', 'roughness', 'fractal_roughness'])\n"
        "assert all(torch.equal(torch.nan_to_num(x.data, 1e9), torch.nan_to_num(y.data, 1e9)) for x, y in zip(a, b))\n"
        "nk = coreg.NuthKaab(subsample=5000).fit(ref, tba, random_state=1, mesh=mesh)\n"
        "assert nk.to_translations() == coreg.NuthKaab(subsample=5000).fit(ref, tba, random_state=1).to_translations()\n"
        "sig, rho = ref.estimate_uncertainty(tba, subsample=100, random_state=1, mesh=mesh)\n"
        "assert np.isfinite(sig.get_nanarray()).mean() > 0.9\n"
        "out = Profiler.generate_summary(d); Profiler.disable()\n"
        "assert (out / 'profiling_summary.csv').exists() and (out / 'profiling_raw.csv').exists()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'xdem_tpu.')) or m == 'xdem_tpu']\n"
        "assert not bad and sys.modules['pandas'] is None and sys.modules['sklearn'] is None, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(PKG.parent), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_top_level_lists_every_ported_module():
    """`fit`, `dDEM` and `DEMCollection` are imported and listed as xdem_tpu does, `workflows`
    loads on first use as in xdem_tpu, and nothing listed is missing."""
    assert xdem_tpu_torch.fit.robust_norder_polynomial_fit is not None
    for name in ("fit", "dDEM", "DEMCollection"):
        assert name in xdem_tpu_torch.__all__ and name in xdem_tpu.__all__, name
    assert xdem_tpu_torch.dDEM is xdem_tpu_torch.ddem.dDEM
    assert xdem_tpu_torch.DEMCollection is xdem_tpu_torch.demcollection.DEMCollection
    assert "workflows" in xdem_tpu_torch.__all__ and "workflows" in dir(xdem_tpu_torch)
    assert xdem_tpu_torch.workflows.Topo is not None and xdem_tpu_torch.workflows.Accuracy is not None
    for name in xdem_tpu_torch.__all__:
        assert hasattr(xdem_tpu_torch, name), name
    for word in ("ICP", "DhMinimize", "Deramp", "xdem_tpu_torch.fit", "DEMCollection", "xdem_tpu_torch.workflows"):
        assert word in xdem_tpu_torch.__doc__, word


@pytest.mark.parametrize("kind", ["numpy", "tensor", "masked"])
@pytest.mark.parametrize("nfact", [None, 2.0])
def test_spatialstats_nmad_matches_original(kind, nfact):
    """spatialstats.nmad takes an array or a tensor and nfact=, and returns xdem_tpu's float."""
    rng = np.random.default_rng(5)
    data = rng.normal(3.0, 2.0, (40, 50))
    data[rng.random(data.shape) < 0.1] = np.nan
    kw = {} if nfact is None else {"nfact": nfact}
    with pytest.warns(DeprecationWarning):
        want = xdem_tpu.spatialstats.nmad(data, **kw)
    ours = {"numpy": data, "tensor": torch.from_numpy(data),
            "masked": np.ma.masked_invalid(data)}[kind]
    with pytest.warns(DeprecationWarning, match="nmad"):
        got = xdem_tpu_torch.spatialstats.nmad(ours, **kw)
    assert isinstance(got, float) and got == want
    # The tensor NMAD of ops keeps its name and its fixed factor.
    assert float(xdem_tpu_torch.ops.nmad(torch.from_numpy(data))) == pytest.approx(
        xdem_tpu.spatialstats.nmad(data) if nfact is None else want / nfact * 1.4826, rel=1e-12)


_CORE_DICTS = ["InRandomDict", "OutRandomDict", "InFitOrBinDict", "OutFitOrBinDict", "InIterativeDict",
               "OutIterativeDict", "InSpecificDict", "OutSpecificDict", "InAffineDict", "OutAffineDict",
               "InputCoregDict", "OutputCoregDict", "CoregDict"]


@pytest.mark.parametrize("name", _CORE_DICTS)
def test_coreg_typed_dicts_equal_originals(name):
    ours, theirs = getattr(tbase, name), getattr(jbase, name)
    assert ours.__annotations__.keys() == theirs.__annotations__.keys()
    assert ours.__total__ is theirs.__total__ is False
    assert ours.__optional_keys__ == theirs.__optional_keys__


def test_coreg_typed_dicts_are_all_copied():
    theirs = {n for n, v in vars(jbase).items() if isinstance(v, type) and hasattr(v, "__optional_keys__")}
    assert theirs == set(_CORE_DICTS)
    meta = tbase.Coreg().meta
    assert set(meta) <= set(tbase.CoregDict.__annotations__)
    assert set(meta["inputs"]) <= set(tbase.InputCoregDict.__annotations__)
