"""Figure 10 reproduction: whole-model CSA speedups for the paper's four
TinyML models at three (x_us, x_ss) sparsity configurations.

Every MAC-bearing layer of the full-size VGG16 / ResNet-56 / MobileNetV2 /
DSCNN is combined-pruned (block 4:4 outside, unstructured inside) and its
cycle counts summed under the CSA vs the baselines — the Listing 1 vs
Listing 3 comparison.  Simulated CFU cycles (host numpy), not a device
measurement.  The twin of the JAX package's
``benchmarks/bench_csa_models.py``: same seeds, same masks, same rows.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from repro_torch.configs.tinyml import FIG10_CONFIGS, PAPER_MODELS
from repro_torch.core import pruning
from repro_torch.core.cycle_model import Design, model_cycles
from repro_torch.models import cnn


def masks_for(model: str, x_ss: float, x_us: float, seed: int = 0):
    layers = cnn.layer_shapes(model)
    rng = np.random.default_rng(seed)
    masks = []
    for spec in layers:
        if spec.kind == "conv":
            h, w_, ci, co = spec.shape
            flat = rng.normal(size=(h * w_ * ci, co)).astype(np.float32)
        else:
            flat = rng.normal(size=spec.shape).astype(np.float32)
        _, mask = pruning.combined_numpy(flat, x_ss=x_ss, x_us=x_us)
        masks.append(mask.reshape(spec.shape))
    return layers, masks


def run(models: Optional[Iterable[str]] = None,
        configs=FIG10_CONFIGS) -> dict:
    """The Fig. 10 grid: every model of ``models`` (default: all four)
    at every ``(x_us, x_ss)`` of ``configs``."""
    rows = []
    for model in (PAPER_MODELS if models is None else models):
        for (x_us, x_ss) in configs:
            layers, masks = masks_for(model, x_ss, x_us)
            simd = model_cycles(layers, masks, Design.BASELINE_SIMD)
            seq = model_cycles(layers, masks, Design.BASELINE_SEQ)
            rows.append({
                "model": model, "x_us": x_us, "x_ss": x_ss,
                # paper convention: vcmac designs (USSA/CSA) compare to
                # the sequential baseline, SSSA to the SIMD baseline
                "speedup_csa": seq / model_cycles(layers, masks,
                                                  Design.CSA),
                "speedup_sssa": simd / model_cycles(layers, masks,
                                                    Design.SSSA),
                "speedup_ussa_vs_seq":
                    seq / model_cycles(layers, masks, Design.USSA),
            })
    return {"rows": rows}


def main(out=None) -> None:
    if out is None:
        out = run()
    print("# Fig. 10 — model-level speedups with CSA "
          "(+ Table I USSA/SSSA bands; simulated CFU cycles, not measured)")
    print("model,x_us,x_ss,csa_speedup,sssa_speedup,ussa_speedup")
    for r in out["rows"]:
        print(f"{r['model']},{r['x_us']},{r['x_ss']},"
              f"{r['speedup_csa']:.2f},{r['speedup_sssa']:.2f},"
              f"{r['speedup_ussa_vs_seq']:.2f}")
    top = max(r["speedup_csa"] for r in out["rows"])
    print(f"max CSA speedup: {top:.2f}x "
          f"(paper: up to 5x) {'PASS' if 3.5 < top < 7 else 'CHECK'}")


if __name__ == "__main__":
    main()
