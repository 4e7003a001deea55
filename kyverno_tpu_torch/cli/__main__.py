"""CLI dispatcher (mirrors kyverno/pkg/kyverno/main.go:18 CLI())."""

from __future__ import annotations

import argparse
import sys

from .. import __version__
from . import (apply_cmd, chart_cmd, dryrun_cmd, lint_cmd, test_cmd,
               validate_cmd)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kyverno-tpu",
        description="TPU-native Kubernetes policy engine CLI",
    )
    parser.add_argument("--version", action="version", version=__version__)
    subparsers = parser.add_subparsers(dest="command")
    apply_cmd.register(subparsers)
    dryrun_cmd.register(subparsers)
    lint_cmd.register(subparsers)
    test_cmd.register(subparsers)
    validate_cmd.register(subparsers)
    chart_cmd.register(subparsers)
    # `version` verb parity (pkg/kyverno/version/command.go)
    version_p = subparsers.add_parser("version", help="print version")
    version_p.set_defaults(func=lambda _a: print(f"Version: {__version__}") or 0)

    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
