"""xdem_tpu_torch's workflows and command line against xdem_tpu's on the same files.

The cases of tests/test_workflows.py that need no TPU: the schemas, Topo and Accuracy from one
small dict configuration run by both packages (the CSV headers, the ``Data`` column included,
equal exactly, the values within 1e-4 of their magnitude), the command line through
``main(argv)``, and the helpers of the Workflows base class. The fits use every pixel
(``subsample: 1.0``), so no random draw separates the packages. The DEMs lie at a small
northing: xdem_tpu's reprojection rounds destination coordinates to float32. Two faults of
xdem_tpu are not copied, and each has a test here: ``generate_plot`` labels its colour bar with
``cbar_title``, and ``Topo.generate_terrain_attributes`` reprojects as ``Topo.run`` does.
"""

import csv
import warnings

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu import workflows as jwf
from xdem_tpu.workflows import schemas as jschemas
from xdem_tpu_torch import DEM, Affine, Raster, cli, examples
from xdem_tpu_torch import workflows as twf
from xdem_tpu_torch.workflows import schemas

CROP = (100, 400, 200, 500)
ORIGIN = (1000.0, 7000.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The examples' pair and glacier mask, cropped to 300 x 300, at a small northing."""
    d = tmp_path_factory.mktemp("data")
    r0, r1, c0, c1 = CROP
    t = Affine.from_origin(*ORIGIN, 20.0, 20.0)
    paths = {}
    for name, arr in (("ref", examples.get_ref_dem().get_nanarray()), ("tba", examples.get_tba_dem().get_nanarray()),
                      ("mask", examples.get_glacier_mask().astype(np.float32))):
        paths[name] = str(d / f"{name}.tif")
        Raster(arr[r0:r1, c0:c1], t, 32633).save(paths[name])
    return paths


def _table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _tables_match(ours_dir, theirs_dir, name):
    """Equal headers and row names; each value within 1e-4 of its row's magnitude (the largest
    |value| of the row's statistics but the counts and the valid share), each count within 1e-4
    of itself."""
    (h1, r1), (h2, r2) = _table(ours_dir / "tables" / name), _table(theirs_dir / "tables" / name)
    assert h1 == h2, name
    assert len(r1) == len(r2), name
    counts = [i for i, col in enumerate(h1) if "count" in col.lower() or "percentage" in col.lower()]
    for a, b in zip(r1, r2):
        if h1[0] == "Data":
            assert a[0] == b[0], name
            a, b = a[1:], b[1:]
        cols = h1[len(h1) - len(a):]
        offset = len(h1) - len(a)
        scale = max(abs(float(v)) for i, v in enumerate(b) if i + offset not in counts and v != "")
        for i, (x, y) in enumerate(zip(a, b)):
            tol = 1e-4 * (abs(float(y)) if i + offset in counts else scale)
            assert abs(float(x) - float(y)) <= tol, (name, cols[i], x, y)


# ---------------------------------------------------------------------- schemas

def _configs(files):
    ref, tba = files["ref"], files["tba"]
    acc = {"inputs": {"reference_elev": {"path_to_elev": ref}, "to_be_aligned_elev": {"path_to_elev": tba}}}
    return {
        "topo_defaults": ({"inputs": {"path_to_elev": ref}}, "TOPO_SCHEMA"),
        "topo_list": ({"inputs": [{"path_to_elev": ref}, {"path_to_elev": tba, "downsample": 2}]}, "TOPO_SCHEMA"),
        "topo_dict_attrs": ({"inputs": {"path_to_elev": ref},
                             "terrain_attributes": {"slope": {"surface_fit": "Horn"}, "hillshade": None}}, "TOPO_SCHEMA"),
        "accuracy_defaults": (acc, "ACCURACY_SCHEMA"),
        "three_steps": (dict(acc, coregistration={"step_one": {"method": "VerticalShift"}, "step_two": {"method": "NuthKaab"},
                                                  "step_three": {"method": "LZD"}}), "ACCURACY_SCHEMA"),
        "missing_path": ({"inputs": {"path_to_elev": "/nonexistent/file.tif"}}, "TOPO_SCHEMA"),
        "unknown_field": ({"inputs": {"path_to_elev": ref}, "bogus": 1}, "TOPO_SCHEMA"),
        "bad_attribute": ({"inputs": {"path_to_elev": ref}, "terrain_attributes": ["slop"]}, "TOPO_SCHEMA"),
        "bad_method": (dict(acc, coregistration={"step_one": {"method": "MagicAlign"}}), "ACCURACY_SCHEMA"),
        "bad_statistic": ({"inputs": {"path_to_elev": ref}, "statistics": ["bogus_stat"]}, "TOPO_SCHEMA"),
        "bad_level": ({"inputs": {"path_to_elev": ref}, "outputs": {"level": 5}}, "TOPO_SCHEMA"),
    }


@pytest.mark.parametrize("case", ["topo_defaults", "topo_list", "topo_dict_attrs", "accuracy_defaults", "three_steps",
                                  "missing_path", "unknown_field", "bad_attribute", "bad_method", "bad_statistic",
                                  "bad_level"])
def test_validation_matches_xdem_tpu(files, case):
    cfg, schema = _configs(files)[case]
    try:
        want = jschemas.validate_configuration(cfg, getattr(jschemas, schema))
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            schemas.validate_configuration(cfg, getattr(schemas, schema))
        assert str(ours.value) == str(err)
        v = schemas.CustomValidator(getattr(schemas, schema))
        assert not v.validate(cfg) and v.document is None and v.errors == {"config": [str(err)]}
    else:
        assert schemas.validate_configuration(cfg, getattr(schemas, schema)) == want


# ---------------------------------------------------------------------- Topo and Accuracy

def test_topo_matches_xdem_tpu(files, tmp_path):
    attrs = ["slope", "hillshade", "max_curvature", "terrain_ruggedness_index", "fractal_roughness"]
    for pkg, name in ((twf, "ours"), (jwf, "theirs")):
        pkg.Topo({"inputs": {"path_to_elev": files["ref"], "path_to_mask": files["mask"]}, "terrain_attributes": attrs,
                  "outputs": {"path": str(tmp_path / name), "level": 2}}).run()
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for table in ["dem_stats.csv"] + [f"{a}_stats.csv" for a in attrs]:
        _tables_match(ours, theirs, table)
    for a in attrs:
        r = Raster.open(str(ours / "rasters" / f"{a}.tif"))
        assert (ours / "plots" / f"{a}.png").exists() and r.crs == 32633
    html = (ours / "report.html").read_text()
    assert all(f"plots/{a}.png" in html for a in attrs)


def test_topo_tables_equal_get_stats(files, tmp_path):
    """Each attribute's table holds get_stats of the attribute computed directly."""
    wf = twf.Topo({"inputs": {"path_to_elev": files["ref"]}, "terrain_attributes": ["slope", "aspect"],
                   "outputs": {"path": str(tmp_path)}})
    wf.run()
    dem = DEM(files["ref"])
    for a in ("slope", "aspect"):
        header, rows = _table(tmp_path / "tables" / f"{a}_stats.csv")
        want = dem.get_terrain_attribute(a).get_stats(wf.config["statistics"])
        assert header == list(want) and [float(v) for v in rows[0]] == [float(want[k]) for k in header]


@pytest.mark.parametrize("steps", [{"step_one": {"method": "NuthKaab", "extra_information": {"subsample": 1.0}}},
                                   {"step_one": {"method": "VerticalShift", "extra_information": {}},
                                    "step_two": {"method": "NuthKaab", "extra_information": {"subsample": 1.0}}}],
                         ids=["nuth_kaab", "two_steps"])
def test_accuracy_matches_xdem_tpu(files, tmp_path, steps):
    cfg = {"inputs": {"reference_elev": {"path_to_elev": files["ref"]},
                      "to_be_aligned_elev": {"path_to_elev": files["tba"], "path_to_mask": files["mask"]}},
           "coregistration": steps}
    runs = {}
    for pkg, name in ((twf, "ours"), (jwf, "theirs")):
        runs[name] = pkg.Accuracy(dict(cfg, outputs={"path": str(tmp_path / name), "level": 2}))
        runs[name].run()
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for table in ("dh_before_stats.csv", "dh_after_stats.csv", "dh_stable_stats.csv", "stats_summary.csv"):
        _tables_match(ours, theirs, table)
    assert _table(ours / "tables" / "stats_summary.csv")[0][0] == "Data"
    np.testing.assert_allclose(runs["ours"].coreg.to_translations(), runs["theirs"].coreg.to_translations(), rtol=1e-4)
    tx, ty, _ = runs["ours"].coreg.to_translations()
    assert tx == pytest.approx(-examples.TBA_SHIFT[0], abs=1.5) and ty == pytest.approx(-examples.TBA_SHIFT[1], abs=1.5)
    html = (ours / "report.html").read_text()
    for section in ("Stable-terrain (inlier) statistics", "Statistics summary", "Estimated transformation",
                    "Coregistration step 1:", "dh_histogram.png", "dh_aligned_vs_tba.png", "Elapsed:"):
        assert section in html, section
    for f in ("dh_before.tif", "dh_after.tif", "dh_aligned_vs_tba.tif", "aligned_dem.tif"):
        assert (ours / "rasters" / f).exists(), f


def test_accuracy_masked_runs_on_the_datas_device():
    r = Raster(torch.arange(12, dtype=torch.float32).reshape(3, 4), Affine.from_origin(0, 30, 10, 10), 32633)
    keep = torch.zeros((3, 4), dtype=torch.bool)
    keep[1] = True
    out = twf.Accuracy._masked(r, keep)
    assert out.data.device == r.data.device
    np.testing.assert_array_equal(torch.isnan(out.data).numpy(), ~keep.numpy())


# ---------------------------------------------------------------------- the command line

def test_cli_topo_run_and_templates(files, tmp_path, capsys):
    yaml = pytest.importorskip("yaml")
    cfg_path = tmp_path / "cfg.yaml"
    yaml.safe_dump({"inputs": {"path_to_elev": files["ref"]}, "terrain_attributes": ["slope"],
                    "outputs": {"path": str(tmp_path / "cli_out")}}, open(cfg_path, "w"))
    assert cli.main(["topo", "--config", str(cfg_path), "--log-level", "ERROR"]) == 0
    assert (tmp_path / "cli_out" / "report.html").exists() and (tmp_path / "cli_out" / "tables" / "slope_stats.csv").exists()
    assert cli.main(["topo", "--template-config"]) == 0
    assert yaml.safe_load(capsys.readouterr().out) == schemas.COMPLETE_CONFIG_TOPO
    dest = tmp_path / "tpl.yaml"
    assert cli.main(arg_list=["accuracy", "--template-config", str(dest)]) == 0
    assert yaml.safe_load(open(dest))["coregistration"]["step_one"]["method"] == "NuthKaab"
    assert cli.main(["topo", "--config", str(cfg_path), "--output", str(tmp_path / "over")]) == 0
    assert (tmp_path / "over" / "report.html").exists()


@pytest.mark.parametrize("argv", [["topo"], ["--help"], ["unknown", "--config", "x.yaml"]])
def test_cli_refusals_exit(argv, capsys):
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    from xdem_tpu import cli as jcli

    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    assert ours.value.code == theirs.value.code
    if argv == ["--help"]:
        assert "topo" in capsys.readouterr().out


# ---------------------------------------------------------------------- the base class

@pytest.fixture()
def topo(files, tmp_path):
    return twf.Topo({"inputs": {"path_to_elev": files["ref"]}, "terrain_attributes": ["slope", "hillshade"],
                     "outputs": {"path": str(tmp_path / "wout"), "level": 1}})


def test_helpers_match_xdem_tpu(topo, files, tmp_path):
    jtopo = jwf.Topo({"inputs": {"path_to_elev": files["ref"]}, "terrain_attributes": ["slope", "hillshade"],
                      "outputs": {"path": str(tmp_path / "jout"), "level": 1}})
    nested = {"a": 1.23456, "b": [2.345, {"c": (3.456, None)}], "d": "x", "statistics": None, "e": [1, None, 2]}
    assert topo.floats_process(nested) == jtopo.floats_process(nested)
    assert topo.remove_none(nested) == jtopo.remove_none(nested)
    for key, val in (("valid_count", 42.7), ("valid percentage", 93.456), ("mean", 1.23456), ("sum", 2.5e6),
                     ("tiny", 2.5e-6)):
        assert topo.format_values_stats(key, val) == jtopo.format_values_stats(key, val)
    assert {k: v for k, v in topo.load_config().items() if k != "outputs"} == \
        {k: v for k, v in jtopo.load_config().items() if k != "outputs"}
    topo.save_stat_as_csv({"mean": np.float32(1.5), "count": 3}, "unit")
    jtopo.save_stat_as_csv({"mean": np.float32(1.5), "count": 3}, "unit")
    assert (topo.outputs_folder / "tables" / "unit_stats.csv").read_text() == \
        (jtopo.outputs_folder / "tables" / "unit_stats.csv").read_text()
    new = tmp_path / "moved"
    topo.create_output_dir(sub_dir=new)
    assert topo.outputs_folder == new and all((new / s).is_dir() for s in ("plots", "rasters", "tables"))


def test_static_load_dem(files):
    dem, inlier, path = twf.Workflows.load_dem({"path_to_elev": files["ref"], "path_to_mask": files["mask"]})
    jdem, jinlier, jpath = jwf.Workflows.load_dem({"path_to_elev": files["ref"], "path_to_mask": files["mask"]})
    assert isinstance(inlier, torch.Tensor) and inlier.dtype == torch.bool and path == jpath
    np.testing.assert_array_equal(inlier.cpu().numpy(), np.asarray(jinlier))
    np.testing.assert_array_equal(dem.get_nanarray(), np.asarray(jdem.get_nanarray()))
    assert twf.Workflows.load_dem(None) == (None, None, None)


def test_generate_plot_labels_the_colour_bar_with_cbar_title(topo, files, monkeypatch):
    """xdem_tpu forwards cbar_title to imshow; the port makes it the colour bar's label."""
    from matplotlib.colorbar import Colorbar

    labels = []
    orig = Colorbar.set_label
    monkeypatch.setattr(Colorbar, "set_label", lambda self, label, **kw: labels.append(label) or orig(self, label, **kw))
    dem = DEM(files["ref"])
    topo.generate_plot(dem, "left", "pair", dem_right=dem, title_dem_right="right", cbar_title="Elevation (m)",
                       interpolation="nearest")
    topo.generate_plot_with_profiles(dem, "with profiles", "prof", cbar_title="Elevation (m)")
    assert [label for label in labels if label] == ["Elevation (m)"] * 3
    assert (topo.outputs_folder / "plots" / "pair.png").stat().st_size > 1000
    assert (topo.outputs_folder / "plots" / "prof.png").stat().st_size > 1000


@pytest.fixture(scope="module")
def geographic(tmp_path_factory):
    """A DEM in EPSG:4326 near Longyearbyen."""
    path = str(tmp_path_factory.mktemp("geo") / "geo.tif")
    arr = examples.get_ref_dem().get_nanarray()[:120, :160]
    Raster(arr, Affine.from_origin(15.5, 78.25, 0.0008, 0.0002), 4326).save(path)
    return path


def test_generate_terrain_attributes_reprojects_as_run(geographic, tmp_path):
    """xdem_tpu's generate_terrain_attributes skips the reproject step of Topo.run; the port's
    takes it, so the attributes come in the DEM's metric CRS, as run's do."""
    # The reprojected pixels are not square, which the surface-fit attributes refuse in both
    # packages: the test takes the terrain ruggedness index.
    wf = twf.Topo({"inputs": {"path_to_elev": geographic}, "reproject": {"crs": True},
                   "terrain_attributes": ["terrain_ruggedness_index"], "outputs": {"path": str(tmp_path)}})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (tri,) = wf.generate_terrain_attributes(export_tif=True)
    metric = DEM(geographic).get_metric_crs()
    assert tri.crs == metric and tri.crs.is_projected
    assert Raster.open(str(tmp_path / "rasters" / "terrain_ruggedness_index.tif")).crs == metric
    assert (tmp_path / "plots" / "terrain_attributes_map.png").exists()


def test_generate_terrain_attributes_warns_on_a_geographic_crs(geographic, tmp_path):
    wf = twf.Topo({"inputs": {"path_to_elev": geographic}, "terrain_attributes": ["terrain_ruggedness_index"],
                   "outputs": {"path": str(tmp_path)}})
    with pytest.warns(UserWarning, match="geographic CRS"):
        wf.generate_terrain_attributes()


def test_pdf_report_is_gated_on_the_config(topo):
    topo.generate_pdf()
    assert not (topo.outputs_folder / "report.pdf").exists()
    topo.config["outputs"]["generate_pdf"] = True
    topo.add_report_section(topo.stats_to_html({"a": 1.0}, "t"))
    topo.add_report_section(topo.table_to_html({"row": {"a": 1.0, "n": 3}}, "table"))
    topo.generate_pdf()
    assert (topo.outputs_folder / "report.pdf").read_bytes()[:5] == b"%PDF-"


def test_topo_multi_dem_and_downsample(files, tmp_path):
    wf = twf.Topo({"inputs": [{"path_to_elev": files["ref"]}, {"path_to_elev": files["tba"], "downsample": 2}],
                   "terrain_attributes": ["slope"], "outputs": {"path": str(tmp_path)}})
    dem = wf._load_dem(wf.config["inputs"][1])
    assert dem.res[0] == pytest.approx(40.0) and dem.shape == (150, 150)
    wf.run()
    assert (tmp_path / "tables" / "slope_stats_dem1.csv").exists() and (tmp_path / "tables" / "slope_stats_dem2.csv").exists()
