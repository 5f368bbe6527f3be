"""xdem_tpu_torch.profiler held to tests/test_profiler.py's three cases, plus the trace
directory and the dispatch counter (a CPU run launches no CUDA kernel)."""

import numpy as np
import pytest
import torch
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu_torch import examples, terrain
from xdem_tpu_torch.profiler import Profiler, count_device_dispatches, profile


@pytest.fixture(scope="module")
def ref_dem_test():
    return examples.get_ref_dem_test()


class TestProfiler:
    def test_disabled_no_overhead(self):
        calls = []

        @profile("test.fn")
        def fn(x):
            calls.append(x)
            return x * 2

        Profiler.disable()
        assert fn(3) == 6
        assert Profiler.records() == []

    def test_records_and_summary(self, tmp_path, ref_dem_test):
        Profiler.enable(save_graphs=True, save_raw_data=True, jax_trace_dir=str(tmp_path / "trace"))
        try:
            terrain.get_terrain_attribute(ref_dem_test, "slope")
            terrain.get_terrain_attribute(ref_dem_test, "hillshade")
            recs = Profiler.records()
            assert len(recs) == 2
            assert all(r["name"] == "xdem_tpu_torch.terrain.get_terrain_attribute" for r in recs)
            assert all(r["wall_s"] > 0 for r in recs)
            assert all(np.isfinite(r["peak_mem_mb"]) for r in recs)
            out = Profiler.generate_summary(tmp_path / "prof")
            assert (out / "profiling_summary.csv").exists()
            assert (out / "profiling_raw.csv").exists()
            assert (out / "profiling_graph.png").exists()
            assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 2
        finally:
            Profiler.disable()

    def test_coreg_entry_points_profiled(self, ref_dem_test):
        from xdem_tpu_torch import coreg

        Profiler.enable()
        try:
            c = coreg.VerticalShift()
            tba = ref_dem_test + 2.0
            c.fit(ref_dem_test, tba, random_state=42)
            c.apply(tba)
            names = {r["name"] for r in Profiler.records()}
            assert "xdem_tpu_torch.coreg.Coreg.fit" in names
            assert "xdem_tpu_torch.coreg.Coreg.apply" in names
        finally:
            Profiler.disable()


def test_count_device_dispatches_on_the_cpu():
    result, counts = count_device_dispatches(lambda x: x * 2, torch.ones(4))
    assert result.tolist() == [2.0] * 4
    assert counts == {"executions": 0, "h2d_transfers": 0}
