"""Benchmark aggregator of the port: one section per paper table/figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      --sections fig8_ussa,fig9_sssa,table3_resources --json out.json

Sections: ``fig8_ussa``, ``fig9_sssa``, ``fig10_csa_models`` (the whole
grid, ~30 s of host numpy), ``table3_resources`` and ``kernels``.  Figs.
8–10 and Table III are simulated CFU cycles and byte counts on the host;
``kernels`` runs the hand-written kernels on the card (``--device
cuda``, the default) or their plain versions (``--device cpu``).
``--json PATH`` writes each section's wall time, ok flag and its
``run()`` payload.  Exits 1 if a section raised or printed a FAIL line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import re
import sys
import time
import traceback
from typing import List

SECTIONS = {
    "fig8_ussa": "repro_torch.benchmarks.bench_ussa",
    "fig9_sssa": "repro_torch.benchmarks.bench_sssa",
    "fig10_csa_models": "repro_torch.benchmarks.bench_csa_models",
    "table3_resources": "repro_torch.benchmarks.bench_resources",
    "kernels": "repro_torch.benchmarks.bench_kernels",
}


def _jsonable(obj):
    """Section payloads (numpy scalars, tuples) as plain JSON."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):          # numpy scalar
        return obj.item()
    return obj


def print_table(mod, data) -> List[str]:
    """Print ``mod.main(data)``; return its verdict lines (those that
    say PASS, FAIL or CHECK)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(data)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return [ln for ln in text.splitlines()
            if re.search(r"\b(PASS|FAIL|CHECK)\b", ln)]


def run_section(name: str, device: str) -> dict:
    """Run one section's ``run()`` and print its ``main()`` table; the
    entry records wall seconds, the payload and whether every verdict
    line it printed reads PASS."""
    mod = importlib.import_module(SECTIONS[name])
    t0 = time.time()
    data = mod.run(device=device) if name == "kernels" else mod.run()
    verdicts = print_table(mod, data)
    return {"ok": all("PASS" in v for v in verdicts),
            "wall_s": round(time.time() - t0, 3), "data": _jsonable(data)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ", ".join(SECTIONS))
    ap.add_argument("--device", default="cuda",
                    help="device of the kernels section (cuda or cpu)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write per-section wall time + results")
    args = ap.parse_args(argv)
    wanted = args.sections.split(",")
    unknown = sorted(set(wanted) - set(SECTIONS))
    if unknown:
        print(f"unknown sections: {unknown}", file=sys.stderr)
        return 2
    record = {"sections": {}}
    for name in wanted:
        print(f"\n== {name}", flush=True)
        try:
            record["sections"][name] = run_section(name, args.device)
        except Exception:
            traceback.print_exc()
            record["sections"][name] = {"ok": False}
    n_ok = sum(e["ok"] for e in record["sections"].values())
    print(f"\n{n_ok}/{len(wanted)} benchmark sections passed")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
        print(f"wrote {args.json}")
    return 0 if n_ok == len(wanted) else 1


if __name__ == "__main__":
    sys.exit(main())
