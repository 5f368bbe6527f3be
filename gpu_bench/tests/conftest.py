"""CPU tests of the benchmark harness: plain versions of the kernels, small sides, few threads.

Run from the repository root:  python -m pytest -q gpu_bench/tests
Tests marked ``cuda`` need a card and skip without one (on the card: ``--noconftest`` is not
needed here, this file imports neither JAX nor the JAX package).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where torch.cuda.is_available() is False")


@pytest.fixture(autouse=True)
def _plain_cpu(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        monkeypatch.setenv("XDEM_TPU_PLATFORM", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
