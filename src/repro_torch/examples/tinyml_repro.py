"""TinyML walk-through on the port (the paper's own evaluation setting).

Trains a reduced DS-CNN on synthetic keyword-spotting-shaped data
(``benchmarks.bench_int7._train``: 250 AdamW steps of 64 samples, on the
card by default), then runs the co-design loop on it:

  * INT8 vs INT7 accuracy (Table II's question) on the trained model;
  * combined pruning of a trained pointwise convolution at two Fig. 10
    operating points, and the cycle-model speedups of USSA / SSSA / CSA
    on the trained masks;
  * INT7 lookahead encoding of the pruned layer (Algorithms 1+2).

The JAX package's ``examples/tinyml_repro.py`` is the reference.

Run:  PYTHONPATH=src python -m repro_torch.examples.tinyml_repro [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.bench_int7 import _train
from repro_torch.core import encoding, pruning
from repro_torch.core.cycle_model import Design, LayerShape, model_speedup
from repro_torch.models import cnn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args(argv)
    out = {}

    # --- train a reduced DS-CNN on synthetic GSC-shaped data --------------
    t0 = time.time()
    params, acc_of, _ = _train("dscnn", (49, 10, 1), 12, 0.5, args.steps,
                               device=args.device)
    out["acc"] = acc = acc_of(params)
    print(f"trained DSCNN(w=0.5): acc {acc:.3f} ({time.time() - t0:.0f}s)")

    # --- Table II: INT8 vs INT7 -------------------------------------------
    out["acc_int8"] = acc8 = acc_of(cnn.quantize_dequantize(params, False))
    out["acc_int7"] = acc7 = acc_of(cnn.quantize_dequantize(params, True))
    print(f"INT8 acc {acc8:.3f} | INT7 acc {acc7:.3f} "
          f"(Δ {abs(acc8 - acc7) * 100:.2f} pts — paper: ~0)")

    # --- prune trained weights, count CFU cycles --------------------------
    # the first pointwise conv (the stem has Cin = 1), as HWIO (1, 1, C, C)
    w = cnn.oihw_to_hwio(params["blocks"][0]["pw"]["w"])
    C = w.shape[-1]
    flat = w.reshape(C, C).float().cpu()
    out["speedups"] = {}
    for x_ss, x_us in ((0.5, 0.5), (0.6, 0.6)):
        _, mask = pruning.combined(flat, x_ss=x_ss, x_us=x_us)
        m4 = mask.numpy().astype(bool).reshape(1, 1, C, C)
        layers = [LayerShape("conv", (1, 1, C, C), (25, 5))]
        s = {d.name: model_speedup(layers, [m4], d)
             for d in (Design.CSA, Design.SSSA, Design.USSA)}
        out["speedups"][(x_ss, x_us)] = s
        print(f"(x_ss={x_ss}, x_us={x_us}) speedups: CSA {s['CSA']:.2f}x, "
              f"SSSA {s['SSSA']:.2f}x, USSA {s['USSA']:.2f}x")

    # --- lookahead-encode the pruned layer (zero-byte metadata) -----------
    wp, _ = pruning.block_semi_structured(flat, 0.5, block=4)
    q, _ = encoding.quantize_int7(wp, axis=0)
    enc = encoding.encode_weight_matrix(q)
    vals, _ = encoding.decode_weight_matrix(enc)
    visited = encoding.simulate_walk(enc[:, 0].numpy())
    out["round_trip"] = bool(torch.equal(vals, q))
    print(f"lookahead encode: round-trip exact {out['round_trip']}, "
          f"walk visits {len(visited)}/{C // 4} blocks of column 0")
    print("ok")
    return out


if __name__ == "__main__":
    main()
