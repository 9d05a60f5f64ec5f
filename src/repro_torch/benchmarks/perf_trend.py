"""Perf-trend gate of the port: compare a ``repro_torch.benchmarks.run
--json`` record against the previous run's and fail on big regressions.

  python -m repro_torch.benchmarks.perf_trend \
      --baseline prev/BENCH.json --current BENCH.json [--threshold 0.30]

Per-section metrics (rows matched by key; unmatched rows are informational
only, so grid changes don't fail the gate):

  * ``kernels`` — ``us`` per (kernel, dtype) row (lower is better); the
    port's bench times each kernel in float32 and bfloat16, so a row's
    ``dtype`` joins its key where the row has one
  * ``serving`` — ``tok_per_s`` (higher is better) and ``ttft_p95_ms``
    (time-to-first-token p95, lower is better) per (config, slots) row

A row regresses when any of its gated metrics is worse than baseline by
more than ``threshold`` (relative).  Keys present in only one of
{baseline, current} are reported but never block: a benchmark's *first*
run (new row, no baseline yet) and a retired benchmark (baseline row
gone from current) both pass — new benchmarks must be able to land
without failing the blocking job they'll feed.  The same one-sided rule
applies per metric: a *new metric* on an old row (e.g. the first run
that records TTFT) is reported but never blocks.  Rows missing every
section metric (or with non-numeric values) are skipped the same way.
Missing/corrupt baseline (e.g. the first run on a branch, or an expired
artifact) exits 0 — the gate only *blocks* when there is something real
to compare, per the ROADMAP note: non-blocking until a baseline exists,
blocking on >30% regressions after.

Stdlib-only on purpose: it runs without the package or a card.
"""

from __future__ import annotations

import argparse
import json
import sys

# section name → (row key fields, ((metric, higher_is_better), ...))
METRICS = {
    "kernels": (("kernel",), (("us", False),)),
    "serving": (("config", "slots"), (("tok_per_s", True),
                                      ("ttft_p95_ms", False))),
}
#: key fields a row joins to its key where it has them
OPTIONAL_KEYS = {"kernels": ("dtype",)}


def _rows(record: dict, section: str):
    """{row key: {metric: value}} — rows with no usable metric drop."""
    data = record.get("sections", {}).get(section, {}).get("data") or {}
    out = {}
    keys, metrics = METRICS[section]
    for row in data.get("rows", []):
        try:
            key = tuple(row[k] for k in keys) + tuple(
                row[k] for k in OPTIONAL_KEYS.get(section, ()) if k in row)
        except KeyError:
            continue
        vals = {}
        for metric, _ in metrics:
            try:
                vals[metric] = float(row[metric])
            except (KeyError, TypeError, ValueError):
                continue
        if vals:
            out[key] = vals
    return out


def compare(baseline: dict, current: dict, threshold: float):
    """Returns (report_lines, regressions)."""
    lines, regressions = [], []
    for section, (_, metrics) in METRICS.items():
        base, cur = _rows(baseline, section), _rows(current, section)
        for key in sorted(cur, key=str):
            if key not in base:
                shown = ", ".join(f"{m}={v:g}" for m, v in cur[key].items())
                lines.append(f"  {section} {key}: {shown} "
                             "(new row, no baseline)")
                continue
            for metric, higher_better in metrics:
                if metric not in cur[key]:
                    continue
                c = cur[key][metric]
                if metric not in base[key]:
                    lines.append(f"  {section} {key}: {metric}={c:g} "
                                 "(new metric, no baseline)")
                    continue
                b = base[key][metric]
                if b <= 0:
                    continue
                change = (c - b) / b
                worse = -change if higher_better else change
                flag = "REGRESSION" if worse > threshold else "ok"
                lines.append(f"  {section} {key}: {metric} {b:g} -> {c:g} "
                             f"({change:+.1%}) {flag}")
                if worse > threshold:
                    regressions.append((section, key, metric, b, c))
        for key in sorted(set(base) - set(cur), key=str):
            shown = ", ".join(f"{m}={v:g}" for m, v in base[key].items())
            lines.append(f"  {section} {key}: {shown} "
                         "(row absent from current run — informational)")
    return lines, regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--current", required=True)
    ap.add_argument("--threshold", type=float, default=0.30)
    args = ap.parse_args(argv)

    try:
        with open(args.baseline) as f:
            baseline = json.load(f)
    except (OSError, ValueError) as e:
        print(f"no usable baseline ({e}) — trend check skipped")
        return 0
    try:
        with open(args.current) as f:
            current = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read current record {args.current}: {e}",
              file=sys.stderr)
        return 2

    lines, regressions = compare(baseline, current, args.threshold)
    print(f"perf trend vs {args.baseline} "
          f"(threshold {args.threshold:.0%}):")
    for ln in lines:
        print(ln)
    if regressions:
        print(f"{len(regressions)} metric(s) regressed by more than "
              f"{args.threshold:.0%} across "
              f"{len({r[:2] for r in regressions})} row(s)")
        return 1
    print("no regression beyond threshold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
