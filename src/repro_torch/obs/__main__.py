"""Summarize a recorded flight-recorder trace.

Usage::

    python -m repro_torch.fleet --quick --trace out.json   # record a run
    python -m repro_torch.obs out.json                     # summarize it
    python -m repro_torch.obs out.json --json              # rollup as JSON

The input is the file ``--trace`` writes: Chrome trace-event JSON with
``metrics`` / ``timeline`` / ``meta`` riding alongside ``traceEvents``
(extra top-level keys are legal, so the same file loads in Perfetto).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List


def _span_rollup(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate complete ("X") live spans by name: count + total dur."""
    count: Dict[str, int] = defaultdict(int)
    total_us: Dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).startswith("timeline"):
            continue
        name = ev.get("name", "?")
        count[name] += 1
        total_us[name] += float(ev.get("dur", 0.0))
    rows = [
        {"name": name, "count": count[name], "total_us": total_us[name]}
        for name in count
    ]
    rows.sort(key=lambda r: (-r["total_us"], r["name"]))
    return rows


def summarize(payload: Dict[str, Any], *, top: int = 12) -> str:
    lines: List[str] = []
    meta = payload.get("meta", {})
    events = payload.get("traceEvents", [])
    lines.append(
        f"trace: schema v{meta.get('schema_version', '?')}, "
        f"{len(events)} events "
        f"({meta.get('n_dropped_events', 0)} dropped), "
        f"{meta.get('n_timeline_segments', 0)} timeline segments"
    )

    spans = _span_rollup(events)
    if spans:
        lines.append("")
        lines.append(f"{'span':<28}{'count':>8}{'total_ms':>12}{'mean_us':>12}")
        for row in spans[:top]:
            mean_us = row["total_us"] / row["count"]
            lines.append(
                f"{row['name']:<28}{row['count']:>8}"
                f"{row['total_us'] / 1e3:>12.2f}{mean_us:>12.1f}"
            )

    m = payload.get("metrics", {})
    counters = m.get("counters", {})
    if counters:
        lines.append("")
        lines.append(f"{'counter':<44}{'value':>10}")
        for name in sorted(counters):
            lines.append(f"{name:<44}{counters[name]:>10}")
    gauges = m.get("gauges", {})
    if gauges:
        lines.append("")
        lines.append(f"{'gauge':<44}{'value':>12}")
        for name in sorted(gauges):
            lines.append(f"{name:<44}{gauges[name]:>12.4g}")
    histograms = m.get("histograms", {})
    if histograms:
        lines.append("")
        lines.append(
            f"{'histogram':<36}{'count':>8}{'mean':>12}{'min':>10}{'max':>10}"
        )
        for name in sorted(histograms):
            h = histograms[name]
            lines.append(
                f"{name:<36}{h['count']:>8}{h['mean']:>12.3g}"
                f"{h.get('min', 0.0):>10.3g}{h.get('max', 0.0):>10.3g}"
            )

    busy = meta.get("node_busy_s", {})
    if busy:
        lines.append("")
        lines.append(f"{'node':<16}{'busy_s':>12}")
        for node in sorted(busy):
            lines.append(f"{node:<16}{busy[node]:>12.1f}")
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize a recorded flight-recorder trace",
    )
    ap.add_argument("trace", help="trace JSON written by --trace")
    ap.add_argument("--top", type=int, default=12,
                    help="span rows to show (default 12)")
    ap.add_argument("--json", action="store_true",
                    help="emit the metrics/meta rollup as JSON instead")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        payload = json.load(f)
    if args.json:
        rollup = {
            "meta": payload.get("meta", {}),
            "metrics": payload.get("metrics", {}),
            "spans": _span_rollup(payload.get("traceEvents", [])),
        }
        json.dump(rollup, sys.stdout, indent=1, default=float)
        print()
    else:
        print(summarize(payload, top=args.top))
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        # `python -m repro_torch.obs out.json | head` is documented usage: the
        # reader closing early is success, not a traceback
        sys.stderr.close()
        raise SystemExit(0)
