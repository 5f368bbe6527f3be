"""xdem_tpu_torch.parallel.distributed: clusters of local processes over gloo (two
processes of two CPU shards, four of one). Each worker checks the cluster's Dowd variogram (exact, against the port's
single-process result) and its cross-process halo stencil (against the port's whole-raster
surface fit given the cluster's centre, to the bit). The workers import neither JAX
nor xdem_tpu; xdem_tpu's own cluster is tests/test_graft_entry.py's.

The platform is the card unless XDEM_TPU_PLATFORM=cpu asks for the CPU; without enough cards
for the processes the cluster refuses before it starts a worker."""

import pytest
import torch_port_helpers  # noqa: F401  (thread cap)

from xdem_tpu_torch.parallel import distributed
from xdem_tpu_torch.parallel.distributed import launch_local_cluster


def test_local_cluster_of_two_processes(monkeypatch):
    monkeypatch.setenv("XDEM_TPU_PLATFORM", "cpu")
    out = launch_local_cluster(num_processes=2, local_devices=2, timeout=240.0)
    assert "DISTRIBUTED OK" in out
    assert "4 global devices" in out and "gloo over cpu" in out


def test_local_cluster_of_four_single_shard_processes(monkeypatch):
    """The shape of the four-card cluster (one card a process under NCCL), here over gloo."""
    monkeypatch.setenv("XDEM_TPU_PLATFORM", "cpu")
    out = launch_local_cluster(num_processes=4, local_devices=1, timeout=240.0)
    assert "4 processes x 1 devices = 4 global devices (gloo over cpu)" in out
    assert "equal to one process's to the bit" in out


@pytest.mark.parametrize(
    "env, cards, processes, want",
    [
        (None, 2, 2, "cuda"),
        ("gpu", 8, 2, "cuda"),
        ("cpu", 0, 2, "cpu"),
        ("cpu", 4, 2, "cpu"),
        (None, 0, 2, RuntimeError),
        (None, 1, 2, RuntimeError),
        ("tpu", 1, 1, ValueError),
    ],
)
def test_platform_is_the_card_unless_the_cpu_is_asked_for(monkeypatch, env, cards, processes, want):
    if env is None:
        monkeypatch.delenv("XDEM_TPU_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("XDEM_TPU_PLATFORM", env)
    monkeypatch.setattr(distributed.torch.cuda, "device_count", lambda: cards)
    if isinstance(want, str):
        assert distributed._platform(processes) == want
    else:
        with pytest.raises(want, match="XDEM_TPU_PLATFORM"):
            distributed._platform(processes)


def test_cluster_without_cards_refuses_before_starting(monkeypatch):
    monkeypatch.delenv("XDEM_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(distributed.torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="XDEM_TPU_PLATFORM=cpu"):
        launch_local_cluster(num_processes=2, local_devices=2, timeout=5.0)
