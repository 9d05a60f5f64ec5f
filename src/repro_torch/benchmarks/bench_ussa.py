"""Figure 8 reproduction: USSA analytical vs observed speedup curves.

The cycle-accurate simulator runs real IID-pruned weight streams through
the variable-cycle MAC model; the closed forms are the paper's equations.
Pass criterion (printed): simulator within 5% of the closed form at every
sparsity.  Simulated CFU cycles (host numpy), not a device measurement.
The twin of the JAX package's ``benchmarks/bench_ussa.py``: same seed,
same rows.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import analytical
from repro_torch.core.cycle_model import Design, stream_cycles

SPARSITIES = np.arange(0.0, 1.0, 0.1)
STREAM = 200_000


def run() -> dict:
    rng = np.random.default_rng(0)
    rows = []
    worst_rel = 0.0
    for x in SPARSITIES:
        mask = rng.random(STREAM) >= x
        sim_c = stream_cycles(mask, Design.USSA,
                              include_loop_overhead=False) / (STREAM / 4)
        s_sim = 4.0 / sim_c
        s_a = analytical.ussa_speedup_analytical(x)
        s_o = analytical.ussa_speedup_observed(x)
        rel = abs(4.0 / sim_c - s_o) / s_o
        worst_rel = max(worst_rel, rel)
        rows.append((x, s_a, s_o, s_sim))
    return {"rows": rows, "worst_rel": worst_rel}


def main(out=None) -> None:
    if out is None:
        out = run()
    print("# Fig. 8 — USSA speedup vs unstructured sparsity "
          "(simulated CFU cycles, not measured)")
    print("x,s_analytical,s_observed_closed_form,s_simulated")
    for x, s_a, s_o, s_sim in out["rows"]:
        sa = f"{s_a:.3f}" if np.isfinite(s_a) else "inf"
        print(f"{x:.1f},{sa},{s_o:.3f},{s_sim:.3f}")
    band = [r for r in out["rows"] if 0.5 <= r[0] <= 0.8]
    lo = min(r[3] for r in band)
    hi = max(r[3] for r in band)
    print(f"paper band (2-3x at moderate-high sparsity): "
          f"simulated {lo:.2f}-{hi:.2f}x")
    print(f"simulator vs closed form worst rel err: "
          f"{out['worst_rel']*100:.2f}%  "
          f"({'PASS' if out['worst_rel'] < 0.05 else 'FAIL'})")


if __name__ == "__main__":
    main()
