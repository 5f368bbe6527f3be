"""The port's bias corrections (Deramp, DirectionalBias along 76.6 degrees, TerrainBias on the
maximum curvature, and their pipeline) against the plain reference on seeded biased pairs: a
1/f^2.7 spectral DEM and the same heights plus an order-2 ramp, two along-track sines and a
bias with the maximum curvature, then a two-range elevation error and voids, on a 10 m grid
(the benchmark's generator, ``gpu_bench/kinds/biascorr.py``, at 256^2: the sines' wavelengths
scale with the side).

The reference is the benchmark's, ``gpu_bench/reference_biascorr.py``. From the same
random_state it draws the pixels the program draws, so the fits differ by arithmetic alone: the
program's float32 curvature and LM polish against the reference's float64 ones. The gaps are
the benchmark check's keys. Each tolerance is about ten times the largest gap seen on these
pairs, and the reference in bfloat16 in the program's place fails them.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from gpu_bench import inputs
from gpu_bench import reference_biascorr as plain
from gpu_bench.kinds import biascorr as kind
from xdem_tpu_torch import coreg
from xdem_tpu_torch.coreg import affine
from xdem_tpu_torch.georef import Affine

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "gpu_bench/configs/arcticdem-10m-biased-pair.json").read_text())
MIX = {**json.loads((ROOT / "gpu_bench/mixes/biascorr_chain.json").read_text()), "pool": 1}
N, COUNT = 256, 20000
RES = float(CONFIG["pixel_m"])
TRANSFORM = Affine.from_origin(*CONFIG["origin_m"], RES, RES)
T6 = tuple(TRANSFORM)
ANGLE = float(CONFIG["assumed"]["undulations"]["angle_deg"])
CPU = torch.device("cpu")
# Deramp: the same float64 least squares on the same float32 differences (gaps ~1e-14 m).
RAMP_M = 1e-9
# DirectionalBias: the float32 LM polish against MINPACK's float64 one, on the same medians
# (gaps up to 3e-3 m at 256-384^2).
CURVE_M = 0.03
# TerrainBias: float32 curvatures (K1) against float64 ones move values across bin edges (the
# count-weighted mean gap up to 2e-3 m on a raw pair at 256^2, 3e-4 m inside the pipeline).
TABLE_M = 0.02
# The corrected DEM: float32 planes and curvatures (gaps up to 6e-8 of the heights); the
# finiteness follows the same footprints.
DEM_GAP, FINITE_SHARE = 5e-7, 1e-4
LIMITS = {"deramp": RAMP_M, "directional": CURVE_M, "terrain": TABLE_M, "corrected": DEM_GAP,
          "corrected_finite": FINITE_SHARE}


@pytest.fixture(scope="module")
def pair():
    """(reference, DEM to correct, the reference's float64 maximum curvature)."""
    return kind.biased_pair(N, 31, 32, 33, CONFIG, T6, CPU, 64)


@contextlib.contextmanager
def draws():
    """The (rows, cols) of every draw of the program's grid subsample, in order."""
    got = []
    real = affine._draw_pixels

    def draw(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append(out[:2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(affine, "_draw_pixels", draw)
        yield got


def _step(name: str):
    return {"deramp": lambda: coreg.Deramp(subsample=COUNT),
            "directional": lambda: coreg.DirectionalBias(angle=ANGLE, subsample=COUNT),
            "terrain": lambda: coreg.TerrainBias(subsample=COUNT)}[name]()


def _plain(name: str, pair, state, **picks):
    ref, tba, curvature = pair
    if name == "deramp":
        return plain.deramp(ref, tba, COUNT, state, **picks)
    if name == "directional":
        return plain.directional(ref, tba, T6, ANGLE, COUNT, state, **picks)
    return plain.terrain(ref, tba, curvature, COUNT, state, **picks)


def _fitted(name: str, pair, state):
    """The step fitted alone on the pair, and the (rows, cols) it drew."""
    ref, tba, _ = pair
    with draws() as got:
        step = _step(name).fit(ref, tba, transform=TRANSFORM, crs=CONFIG["crs"], random_state=state)
    (picks,) = got
    return step, picks


@pytest.mark.parametrize("name", ["deramp", "directional", "terrain"])
def test_the_reference_draws_the_pixels_the_program_draws(pair, name):
    """Given the random_state alone, the plain fit draws the program's pixels (xdem's numpy
    draw over the pixels where the step's inputs are all finite): the benchmark's check relies
    on it to compare the fits on the same pixels."""
    _, (rows, cols) = _fitted(name, pair, 7)
    drawn, given = _plain(name, pair, 7), _plain(name, pair, None, rows=rows, cols=cols)
    if name == "directional":
        drawn, given = drawn[1], given[1]
    for a, b in zip(drawn, given):
        assert np.array_equal(a, b, equal_nan=True)


def test_deramp_matches_the_plain_deramp(pair):
    step, _ = _fitted("deramp", pair, 4)
    want = _plain("deramp", pair, 4)
    assert plain.ramp_gap(step.meta["outputs"]["fitorbin"]["fit_params"], want, (N, N), CPU) <= RAMP_M


def test_directional_matches_the_plain_directional(pair):
    step, _ = _fitted("directional", pair, 5)
    want, _ = _plain("directional", pair, 5)
    got = step.meta["outputs"]["fitorbin"]["fit_params"]
    assert plain.curve_gap(got, want, plain.along_track_range((N, N), T6, ANGLE)) <= CURVE_M, (got, want)


def test_terrain_matches_the_plain_terrain(pair):
    step, _ = _fitted("terrain", pair, 6)
    _, counts, medians = _plain("terrain", pair, 6)
    table = step.meta["outputs"]["fitorbin"]["bin_dataframe"]
    assert len(table["count"]) == len(counts) == 100 and (counts >= 100).any()
    assert plain.table_gap(table["nanmedian"], counts, medians) <= TABLE_M


@pytest.fixture(scope="module")
def work():
    """The benchmark cell's work at 256^2, one pair, a draw of 20 000 pixels a step."""
    return kind.Work({**CONFIG, "subsample": COUNT}, MIX, 2**33 + 5, [CPU], size=N)


def _within(numbers):
    return [numbers[k] <= LIMITS[k] for k in LIMITS]


def test_the_pipelines_fit_and_apply_match_the_plain_chain(work):
    numbers = work.check([(0, work.call(0, {}))])
    assert all(_within(numbers)), numbers


def test_the_plain_chain_in_bfloat16_fails_the_tolerances(work):
    numbers = work.check([(0, kind.control(work, torch.bfloat16)(0, {}))])
    assert not all(_within(numbers)), numbers


def _removed_share(field: torch.Tensor, corr: torch.Tensor) -> float:
    """The share of var(field) that the correction `corr` (near -field) removes."""
    ok = torch.isfinite(field) & torch.isfinite(corr)
    f = field[ok].double()
    return 1.0 - float((f + corr[ok].double()).var()) / float(f.var())


def test_each_step_removes_nine_tenths_of_its_own_field(pair):
    """Each step's correction, applied in turn as the pipeline applies it, takes away at least
    90 % of the variance of the bias it models; TerrainBias's is read at the reference's
    curvature (its table is learned against it; the corrected DEM's own curvature holds the
    other biases' and the error's)."""
    ref, tba, curvature = pair
    a = CONFIG["assumed"]
    rows, cols = torch.arange(N)[:, None], torch.arange(N)[None, :]
    sines = [(s["amplitude_m"], s["wavelength_m"] * N / CONFIG["size_px"], s["phase_rad"])
             for s in a["undulations"]["sines"]]
    fields = [plain.ramp(rows, cols, (N, N), a["ramp"]),
              plain.sum_of_sines(plain.along_track(rows, cols, (N, N), T6, ANGLE), sines),
              plain.curvature_bias(curvature, a["curvature_bias"]["amplitude_m"], plain.q99(curvature))]
    steps = [_step(name) for name in ("deramp", "directional", "terrain")]
    pipe = coreg.CoregPipeline(steps).fit(ref, tba, transform=TRANSFORM, crs=CONFIG["crs"], random_state=8)
    removed, x = [], tba
    for step, field in zip(pipe, fields):
        y, _ = step.apply(x, transform=TRANSFORM)
        removed.append(_removed_share(field, y - x))
        x = y
    at_ref, _ = pipe[2].apply(ref, transform=TRANSFORM)
    removed[2] = _removed_share(fields[2], at_ref - ref)
    assert min(removed) >= 0.9, removed


def test_the_reference_imports_neither_jax_nor_either_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import gpu_bench.reference_biascorr, gpu_bench.kinds.biascorr; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'xdem_tpu', 'xdem_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_the_pairs_draws_differ_by_seed():
    """The generator's fields come from the seed: two seeds give two pairs."""
    a = kind.biased_pair(64, 1, 2, 3, CONFIG, T6, CPU, 32)
    b = kind.biased_pair(64, inputs.seed_ints(9, 1), 2, 3, CONFIG, T6, CPU, 32)
    assert not torch.equal(a[0], b[0]) and torch.isfinite(a[2]).any()
