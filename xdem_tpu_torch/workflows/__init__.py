"""Configuration-driven workflows (topo, accuracy), also run by the command line (`cli`)."""

from xdem_tpu_torch.workflows.accuracy import Accuracy
from xdem_tpu_torch.workflows.topo import Topo
from xdem_tpu_torch.workflows.workflows import Workflows, load_yaml_config

__all__ = ["Workflows", "Topo", "Accuracy", "load_yaml_config"]
