"""Benchmark aggregator of the port: one section per paper table/figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      --sections fig8_ussa,fig9_sssa,table3_resources --json out.json

Sections: ``fig8_ussa``, ``fig9_sssa``, ``fig10_csa_models`` (the whole
grid, ~30 s of host numpy), ``table2_int7``, ``table3_resources``,
``kernels``, ``serving`` and ``roofline``.  Figs. 8–10 and Table III are
simulated CFU cycles and byte counts on the host; ``kernels`` runs the
hand-written kernels on the card (``--device cuda``, the default) or
their plain versions (``--device cpu``); ``table2_int7`` trains three
CNNs and ``serving`` serves its request mixes on ``--device``;
``roofline`` tabulates the dry run's records (``launch.dryrun --all``,
host-computed predictions).  ``--json PATH`` writes each section's wall
time, ok flag and its ``run()`` payload.  Exits 1 if a section raised or
printed a FAIL line.

``--warm-autotune`` sweeps the serving keys into the autotune cache
(``benchmarks.warm_autotune``; ``--slots``, ``--prompt-pad``) and exits.
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
    "table2_int7": "repro_torch.benchmarks.bench_int7",
    "table3_resources": "repro_torch.benchmarks.bench_resources",
    "kernels": "repro_torch.benchmarks.bench_kernels",
    "serving": "repro_torch.benchmarks.bench_serving",
    "roofline": "repro_torch.benchmarks.roofline",
}
#: the sections that run on ``--device``; the others are host numpy
ON_DEVICE = ("table2_int7", "kernels", "serving")


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
    data = mod.run(device=device) if name in ON_DEVICE else mod.run()
    verdicts = print_table(mod, data)
    return {"ok": all("PASS" in v for v in verdicts),
            "wall_s": round(time.time() - t0, 3), "data": _jsonable(data)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ", ".join(SECTIONS))
    ap.add_argument("--device", default="cuda",
                    help="device of the table2_int7, kernels and serving "
                         "sections (cuda or cpu)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write per-section wall time + results")
    ap.add_argument("--warm-autotune", action="store_true",
                    help="sweep the serving keys into the autotune cache "
                         "on --device, then exit")
    ap.add_argument("--slots", type=int, default=8,
                    help="--warm-autotune: serving slots (decode M)")
    ap.add_argument("--prompt-pad", type=int, default=128,
                    help="--warm-autotune: prompt pad (per-slot refill M; "
                         "slots * prompt_pad is the wave M, swept on the "
                         "card only)")
    args = ap.parse_args(argv)
    if args.warm_autotune:
        from repro_torch.benchmarks import warm_autotune
        out = warm_autotune.run(slots=args.slots,
                                prompt_pad=args.prompt_pad,
                                device=args.device)
        warm_autotune.main(out)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(_jsonable(out), f, indent=1, sort_keys=True)
            print(f"wrote {args.json}")
        return 0
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
