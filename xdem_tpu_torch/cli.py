"""Command line: `xdem-tpu-torch {topo, accuracy} --config c.yaml`, or
`python -m xdem_tpu_torch.cli ...`.

Port of xdem_tpu/cli.py: the subcommands topo and accuracy with --config, --template-config,
--output and --log-level.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Any, Sequence


def _add_common(parser: argparse.ArgumentParser) -> None:
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--config", help="Path to YAML configuration file")
    group.add_argument(
        "--template-config",
        nargs="?",
        const="-",
        help="Show or save a YAML configuration file template, optionally with a filename.",
    )
    parser.add_argument("--output", help="Override the output directory", default=None)
    parser.add_argument(
        "--log-level",
        default="WARNING",
        choices=["DEBUG", "INFO", "WARNING", "ERROR"],
        help="Logging verbosity",
    )


def _emit_template(template: dict[str, Any], dest: str) -> None:
    try:
        import yaml
    except ImportError as err:
        raise ImportError("Writing a configuration template needs PyYAML, which is not installed.") from err

    text = yaml.safe_dump(template, sort_keys=False)
    if dest == "-":
        print(text)
    else:
        with open(dest, "w") as f:
            f.write(text)
        print(f"Template written to {dest}")


def main(argv: Sequence[str] | None = None, arg_list: Sequence[str] | None = None) -> int:
    """Command-line entry point; ``arg_list`` (upstream xdem's name for the argument list) is
    an alias of ``argv``."""
    if argv is None and arg_list is not None:
        argv = list(arg_list)
    parser = argparse.ArgumentParser(prog="xdem-tpu-torch", description="DEM analysis workflows on PyTorch")
    subparsers = parser.add_subparsers(dest="command", required=True)

    topo = subparsers.add_parser("topo", help="Terrain-attribute workflow for one or several DEMs")
    _add_common(topo)
    acc = subparsers.add_parser("accuracy", help="Coregistration accuracy workflow for a DEM pair")
    _add_common(acc)

    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level))

    from xdem_tpu_torch.workflows.schemas import COMPLETE_CONFIG_ACCURACY, COMPLETE_CONFIG_TOPO

    if args.template_config is not None:
        template = COMPLETE_CONFIG_TOPO if args.command == "topo" else COMPLETE_CONFIG_ACCURACY
        _emit_template(template, args.template_config)
        return 0

    from xdem_tpu_torch.workflows import Accuracy, Topo

    workflow_cls = Topo if args.command == "topo" else Accuracy
    workflow = workflow_cls(args.config, output_dir=args.output)
    workflow.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
