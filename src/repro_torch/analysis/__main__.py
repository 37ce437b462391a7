"""CLI: ``python -m repro_torch.analysis [--root DIR] [--strict]
[--format text|json] [--output FILE] [--profile port|reference]``.

Exit status is 1 when any unsuppressed finding remains, else 0.  Strict
mode additionally audits the suppressions themselves (missing
justification, unknown rule names, stale allows) and stale role-whitelist
entries — the mode to gate on.  With no ``--root`` the ``repro_torch``
package is analyzed; ``--profile reference`` applies the JAX package's role
map and baseline (``--root src/repro`` gives that package's own findings).
"""

from __future__ import annotations

import argparse
import sys

from . import PROFILES, default_root, render_json, render_text, run_analysis, unsuppressed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant linter + static thread-role race "
                    "checker for the repro_torch offload engine",
    )
    p.add_argument("--root", default=None,
                   help="package dir to analyze (default: the installed "
                        "repro_torch package)")
    p.add_argument("--strict", action="store_true",
                   help="also audit suppressions (justification required, "
                        "no stale/unknown allows) and the role whitelist")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--output", default=None,
                   help="write the report here as well as stdout "
                        "(CI artifact)")
    p.add_argument("--profile", choices=sorted(PROFILES), default="port",
                   help="role map and baseline: the port's (default) or the "
                        "JAX package's, for its own tree")
    args = p.parse_args(argv)

    findings = run_analysis(root=args.root or default_root(),
                            strict=args.strict, profile=args.profile)
    report = (render_json if args.format == "json" else render_text)(
        findings, args.strict)
    print(report)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(report + "\n")
    return 1 if unsuppressed(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
