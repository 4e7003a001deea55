"""``render-chart``: offline ``helm template`` for the deploy chart.

The chart (deploy/chart/kyverno-tpu) is standard Helm — where helm is
available, ``helm template`` renders it identically; this command covers
air-gapped environments via utils.helmlite's template subset."""

from __future__ import annotations

import sys


def run(args) -> int:
    import yaml

    from ..utils.helmlite import render_chart

    try:
        docs = render_chart(args.chart, set_args=args.set or [],
                            release_name=args.release_name,
                            release_namespace=args.namespace)
    except Exception as e:
        print(f"render failed: {e}", file=sys.stderr)
        return 1
    out = "---\n".join(
        yaml.safe_dump(doc, default_flow_style=False, sort_keys=False)
        for doc in docs)
    print(out, end="")
    return 0


def register(subparsers) -> None:
    p = subparsers.add_parser(
        "render-chart",
        help="render the Helm deploy chart to manifests (helm template)")
    p.add_argument("chart", nargs="?", default="deploy/chart/kyverno-tpu",
                   help="chart directory")
    p.add_argument("--set", action="append", metavar="key=value",
                   help="override a value (repeatable)")
    p.add_argument("--release-name", default="kyverno-tpu")
    p.add_argument("-n", "--namespace", default="")
    p.set_defaults(func=run)
