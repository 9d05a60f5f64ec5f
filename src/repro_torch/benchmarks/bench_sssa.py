"""Figure 9 reproduction: SSSA analytical vs observed speedup.

Block-pruned (4:4) weight streams through the lookahead-walk simulator vs
the SIMD baseline — including the paper's Section IV-E effect where the
*observed* speedup EXCEEDS the analytical 1/(1-x) because skipped blocks
also eliminate loop iterations.  Simulated CFU cycles (host numpy), not a
device measurement.  The twin of the JAX package's
``benchmarks/bench_sssa.py``: same seed, same masks, same rows.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import analytical, pruning
from repro_torch.core.cycle_model import Design, stream_cycles

SPARSITIES = [0.0, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875]
K, N = 4096, 8


def run() -> dict:
    rng = np.random.default_rng(1)
    rows = []
    for x in SPARSITIES:
        w = rng.normal(size=(K, N)).astype(np.float32)
        _, mask = pruning.block_semi_structured_numpy(w, x, block=4)
        m = mask.astype(bool)
        base = sum(stream_cycles(m[:, j], Design.BASELINE_SIMD)
                   for j in range(N))
        sssa = sum(stream_cycles(m[:, j], Design.SSSA) for j in range(N))
        s_obs = base / sssa
        s_a = analytical.sssa_speedup_analytical(min(x, 0.99))
        rows.append((x, s_a, s_obs))
    return {"rows": rows}


def main(out=None) -> None:
    if out is None:
        out = run()
    print("# Fig. 9 — SSSA speedup vs semi-structured (4:4) sparsity "
          "(simulated CFU cycles, not measured)")
    print("x_blocks,s_analytical,s_observed_simulated")
    crossover = False
    for x, s_a, s_obs in out["rows"]:
        print(f"{x:.3f},{s_a:.3f},{s_obs:.3f}")
        if x >= 0.5 and s_obs > s_a:
            crossover = True
    band = [r for r in out["rows"] if 0.5 <= r[0] <= 0.75]
    print(f"paper band (2-4x): observed "
          f"{min(r[2] for r in band):.2f}-{max(r[2] for r in band):.2f}x")
    print(f"observed exceeds analytical at high sparsity "
          f"(Section IV-E): {'PASS' if crossover else 'FAIL'}")


if __name__ == "__main__":
    main()
