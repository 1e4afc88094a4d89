"""CLI: python -m cockroach_tpu_torch.analysis [--json] [--changed-only]

Exit status is the per-rule bitmask documented in runner.RULES
(0 = clean). The package docstring gives the rules and the waiver
syntax.
"""

from __future__ import annotations

import argparse
import sys

from .runner import (RULES, changed_files, render_human, render_json,
                     run)
from .rules_registration import repo_root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cockroach_tpu_torch.analysis",
        description="graftlint: AST invariant analysis for "
                    "cockroach_tpu_torch")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--changed-only", action="store_true",
                    help="report findings only in files git sees as "
                         "changed (index stays whole-program)")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings with reasons")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset "
                         f"({', '.join(n for n, _, _ in RULES)})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: autodetect)")
    args = ap.parse_args(argv)

    rules = args.rules.split(",") if args.rules else None
    if rules:
        known = {n for n, _, _ in RULES}
        bad = [r for r in rules if r not in known]
        if bad:
            ap.error(f"unknown rules: {bad}; known: {sorted(known)}")
    only = None
    if args.changed_only:
        only = changed_files(args.root or repo_root())
        if only is None:
            print("graftlint: git unavailable; running the full "
                  "report", file=sys.stderr)
        elif not only:
            print("graftlint: no changed files under cockroach_tpu_torch/; "
                  "nothing to report")
            return 0
    report = run(root=args.root, rules=rules, only_files=only)
    if args.json:
        print(render_json(report))
    else:
        print(render_human(report, show_waived=args.show_waived))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
