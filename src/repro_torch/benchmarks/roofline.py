"""Roofline table of the port: aggregates ``launch.dryrun``'s JSONs.

Per (arch × cell) on one H100: the compute and memory times of the
counted step at the card's peaks, the dominant term, model FLOPs over
counted FLOPs (the useful-compute ratio), the roofline fraction (useful
FLOPs over what the bound step could do at peak) and whether the step
fits the card's memory.  Every number is a host-computed prediction
(the dry run runs on ``meta``), not a card reading.  Emits CSV (``main``)
and the markdown table ``PERF.md`` embeds (``markdown``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--out DIR]
      [--matrix]

``--matrix`` prints ``matrix()``: one row per arch, one column per cell.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # dense bf16, the dry run's PEAK_FLOPS
HBM_GB = 80
OUT_DIR = "results/torch_dryrun"


def load(out_dir: str = "") -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir or OUT_DIR, "*",
                                              "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("ok"):
            r["mesh_name"] = os.path.basename(os.path.dirname(path))
            recs.append(r)
    return recs


def row_of(r: dict) -> dict:
    rl = r["roofline"]
    bound = rl["bound_step_s"]
    useful = rl["model_flops"] / r["chips"]
    frac = useful / (bound * PEAK_FLOPS) if bound > 0 else 0.0
    return {
        "arch": r["arch"], "cell": r["cell"], "mesh": r["mesh_name"],
        "chips": r["chips"],
        "t_comp_ms": rl["t_compute_s"] * 1e3,
        "t_mem_ms": rl["t_memory_s"] * 1e3,
        "t_coll_ms": rl["t_collective_s"] * 1e3,
        "dominant": rl["dominant"],
        "useful_ratio": rl["useful_flop_ratio"],
        "roofline_frac": frac,
        "mem_gib": r["memory"]["total_per_device"] / 2**30,
        "fits": r["fits"],
        "trace_s": r["trace_s"],
    }


def one_liner(r: dict) -> str:
    """What would move the dominant term down."""
    d = r["dominant"]
    if d == "collective":
        return ("cut cross-card traffic: reshard activations or trade "
                "model- for data-parallel work")
    if d == "memory":
        return ("cut HBM traffic: more rows per weight read, fewer or "
                "smaller temporaries, a smaller cache or packed weights")
    return "raise tensor-core use: bigger tiles, fewer small ops"


def run(out_dir: str = "") -> dict:
    """The table's rows (``row_of`` of every ok record)."""
    rows = [row_of(r) for r in load(out_dir)]
    for r in rows:
        r["next"] = one_liner(r)
    return {"rows": rows, "out_dir": out_dir or OUT_DIR, "card": CARD}


def main(data: Optional[dict] = None) -> None:
    data = data or run()
    rows = data["rows"]
    if not rows:
        print("no dry-run records found: run "
              "`python -m repro_torch.launch.dryrun --all` first")
        return
    print(f"# roofline table on one {CARD} (per arch x cell; "
          "host-computed predictions)")
    print("arch,cell,mesh,chips,t_comp_ms,t_mem_ms,t_coll_ms,dominant,"
          "useful_flop_ratio,roofline_frac,mem_GiB,fits_80GB")
    for r in rows:
        print(f"{r['arch']},{r['cell']},{r['mesh']},{r['chips']},"
              f"{r['t_comp_ms']:.2f},{r['t_mem_ms']:.2f},"
              f"{r['t_coll_ms']:.2f},{r['dominant']},"
              f"{r['useful_ratio']:.3f},{r['roofline_frac']:.4f},"
              f"{r['mem_gib']:.2f},{int(r['fits'])}")
    by_dom: Dict[str, int] = {}
    for r in rows:
        by_dom[r["dominant"]] = by_dom.get(r["dominant"], 0) + 1
    print(f"cells: {len(rows)}  fit<{HBM_GB}GB: "
          f"{sum(r['fits'] for r in rows)}  bottlenecks: {by_dom}")


def markdown(out_dir: str = "") -> str:
    rows = run(out_dir)["rows"]
    lines = ["| arch | cell | T_comp (ms) | T_mem (ms) | dominant | "
             "useful ratio | roofline frac | GiB | fits |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['t_comp_ms']:.1f} | "
            f"{r['t_mem_ms']:.1f} | {r['dominant']} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_frac']:.4f} | "
            f"{r['mem_gib']:.1f} | {'yes' if r['fits'] else 'no'} |")
    return "\n".join(lines)


CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def matrix(out_dir: str = "") -> str:
    """The arch × cell matrix as markdown: per cell the bound step in ms,
    its dominant term (C compute, M memory), the useful-FLOP ratio and
    the GiB the step holds (``*`` where that exceeds the card's 80 GB)."""
    rows = run(out_dir)["rows"]
    archs = list(dict.fromkeys(r["arch"] for r in rows))
    cell = {(r["arch"], r["cell"]): r for r in rows}
    lines = ["| arch | " + " | ".join(CELLS) + " |",
             "|---" * (len(CELLS) + 1) + "|"]
    for a in archs:
        out = []
        for c in CELLS:
            r = cell.get((a, c))
            if r is None:
                out.append("—")
                continue
            ms = max(r["t_comp_ms"], r["t_mem_ms"])
            out.append(f"{ms:.4g} {r['dominant'][0].upper()}, "
                       f"{r['useful_ratio']:.2f}, {r['mem_gib']:.4g}"
                       f"{'' if r['fits'] else '*'}")
        lines.append(f"| {a} | " + " | ".join(out) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help=f"records (default {OUT_DIR})")
    ap.add_argument("--matrix", action="store_true")
    args = ap.parse_args()
    if args.matrix:
        print(matrix(args.out))
    else:
        main(run(args.out))
