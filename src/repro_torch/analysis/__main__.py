"""CLI: ``python -m repro_torch.analysis [paths] [--json] [--baseline FILE]``,
run from the repo root.

Exit status: 0 = no non-baselined findings, 1 = new findings (or
stale-file parse errors), 2 = usage/baseline-file errors. Stdlib-only
and sub-second. The paths default to the port's tree and the baseline to
the port's own (``--baseline ""`` checks against none).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.core import Baseline, analyze_paths, report_json
from repro_torch.analysis.rules import RULES

DEFAULT_PATHS = ("src/repro_torch",)
DEFAULT_BASELINE = "analysis_baseline_torch.json"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "repro-lint: check the port's engine/fleet contracts "
            "(argmin ownership, time_eps discipline, batched hot path, "
            "frozen cache keys, sim-clock purity, unit suffixes)."
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=list(DEFAULT_PATHS),
        help="files or directories to analyze (default: %(default)s)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the machine-readable report on stdout",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        default=DEFAULT_BASELINE,
        help="committed baseline of grandfathered findings; only NEW "
        "findings fail the run (default: %(default)s)",
    )
    parser.add_argument(
        "--write-baseline",
        metavar="FILE",
        help="grandfather the current findings into FILE and exit 0 "
        "(fill in real justifications before committing)",
    )
    parser.add_argument(
        "--select",
        metavar="RULES",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule registry and exit",
    )
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES.values():
            print(f"{rule.id:20s} {rule.description}")
            print(f"{'':20s}   contract: {rule.contract}")
        return 0

    rules = list(RULES.values())
    if args.select:
        wanted = [tok.strip() for tok in args.select.split(",") if tok.strip()]
        unknown = sorted(set(wanted) - set(RULES))
        if unknown:
            print(
                f"unknown rule id(s) {unknown}; known: {sorted(RULES)}",
                file=sys.stderr,
            )
            return 2
        rules = [RULES[rid] for rid in wanted]

    result = analyze_paths(args.paths, rules=rules)

    if args.write_baseline:
        baseline = Baseline.from_findings(
            result.findings, justification="TODO: one-line justification"
        )
        baseline.save(args.write_baseline)
        print(
            f"wrote {len(baseline.entries)} grandfathered finding(s) to "
            f"{args.write_baseline}"
        )
        return 0

    baseline = Baseline()
    if args.baseline:
        try:
            baseline = Baseline.load(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"baseline error: {e}", file=sys.stderr)
            return 2
    new, baselined = baseline.split(result.findings)
    stale = baseline.stale_entries(result.findings)

    if args.json:
        payload = report_json(
            result, new, baselined, paths=args.paths, rules=rules
        )
        json.dump(payload, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        for f in new:
            print(f.render())
        for err in result.parse_errors:
            print(f"parse error: {err}")
        for e in stale:
            print(
                "stale baseline entry (violation fixed — delete it): "
                f"{e['rule']} @ {e['path']}: {e['message']}"
            )
        counts = (
            f"{result.n_files} files, {len(result.findings)} finding(s): "
            f"{len(new)} new, {len(baselined)} baselined, "
            f"{result.n_suppressed} suppressed"
        )
        print(("FAIL: " if new or result.parse_errors else "ok: ") + counts)

    return 1 if new or result.parse_errors else 0


if __name__ == "__main__":
    sys.exit(main())
