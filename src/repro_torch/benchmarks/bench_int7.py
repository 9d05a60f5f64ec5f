"""Table II of the paper on the port: INT8 vs INT7 accuracy on trained
CNNs.

The twin of the JAX package's ``benchmarks/bench_int7.py``: the paper's
point is that giving up one weight bit to the lookahead metadata does not
hurt accuracy.  Reduced-width versions of the three Table II models are
trained with AdamW on deterministic class-conditional data
(``data.class_data``: real CIFAR/VWW/GSC are not available offline, and
the *quantization delta* is what Table II reports), then the same trained
weights are fake-quantized through INT8 and through INT7
(``models.cnn.quantize_dequantize``) and evaluated.  Training runs the
plain PyTorch ops on ``device`` (the card by default): the CNNs use no
kernel of the port.

Expected: |acc(INT8) - acc(INT7)| of about 1 point or less, as the
paper's 93.51/93.53, 91.53/91.42, 95.17/95.10.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import class_data
from repro_torch.models import cnn

RUNS = [
    # (model, input shape, classes, width, steps): Table II's rows
    ("resnet56", (32, 32, 3), 10, 0.25, 250),
    ("mobilenetv2", (48, 48, 3), 2, 0.25, 200),
    ("dscnn", (49, 10, 1), 12, 0.5, 250),
]
BATCH = 64
LR = 1e-3


def _train(model, shape, classes, width, steps, seed=0,
           params: Optional[Any] = None, device="cuda"):
    """Train ``model`` for ``steps`` AdamW steps of ``BATCH`` samples →
    ``(params, acc_of, preds_of)``; ``params`` overrides the seeded init
    (a test starts both frameworks from the same weights)."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.trainer import value_and_grad
    device = resolve_device(device)
    init, apply = cnn.CNN_ZOO[model]
    if params is None:
        params = init(seed=seed, num_classes=classes, width=width,
                      device=device)
    # same seed → same class means; the held-out slice is fresh noise
    x_both, y_both = class_data(seed, 5120, shape, classes)
    x_all, y_all = x_both[:4096], y_both[:4096]
    x_test = torch.from_numpy(x_both[4096:]).to(device)
    y_test = torch.from_numpy(y_both[4096:]).to(device)

    def loss_fn(p, batch):
        xb, yb = batch
        logp = F.log_softmax(apply(p, xb), dim=-1)
        return -torch.take_along_dim(logp, yb[:, None].long(), 1).mean()

    ocfg = AdamWConfig(lr=LR, weight_decay=0.0)
    state = adamw_init(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, len(x_all), BATCH)
        batch = (torch.from_numpy(x_all[idx]).to(device),
                 torch.from_numpy(y_all[idx]).to(device))
        _, grads = value_and_grad(loss_fn, params, batch)
        params, state, _ = adamw_update(ocfg, params, grads, state)

    @torch.no_grad()
    def preds_of(p):
        return torch.argmax(apply(p, x_test), dim=-1)

    def acc_of(p):
        return float((preds_of(p) == y_test).float().mean())

    return params, acc_of, preds_of


def run(device="cuda") -> dict:
    rows = []
    for model, shape, classes, width, steps in RUNS:
        t0 = time.time()
        params, acc_of, preds_of = _train(model, shape, classes, width,
                                          steps, device=device)
        p8 = cnn.quantize_dequantize(params, bits7=False)
        p7 = cnn.quantize_dequantize(params, bits7=True)
        base_preds = preds_of(params)
        # agreement with the fp32 model's predictions: the direct measure
        # of "does the sacrificed bit move decisions"
        agree8 = float((preds_of(p8) == base_preds).float().mean())
        agree7 = float((preds_of(p7) == base_preds).float().mean())
        rows.append({"model": model, "acc_fp32": acc_of(params),
                     "acc_int8": acc_of(p8), "acc_int7": acc_of(p7),
                     "agree_int8": agree8, "agree_int7": agree7,
                     "train_s": time.time() - t0})
    return {"rows": rows}


def main(out=None) -> None:
    if out is None:
        out = run()
    print("# Table II — INT8 vs INT7 (lookahead bit): accuracy + "
          "fp32-prediction agreement")
    print("model,acc_fp32,acc_int8,acc_int7,acc_delta_pts,"
          "agree_int8,agree_int7,agree_delta_pts,train_s")
    ok = True
    for r in out["rows"]:
        d_acc = abs(r["acc_int8"] - r["acc_int7"]) * 100
        d_agr = abs(r["agree_int8"] - r["agree_int7"]) * 100
        ok &= d_acc < 1.5 and d_agr < 3.0 and r["agree_int7"] > 0.9
        print(f"{r['model']},{r['acc_fp32']:.4f},{r['acc_int8']:.4f},"
              f"{r['acc_int7']:.4f},{d_acc:.2f},{r['agree_int8']:.4f},"
              f"{r['agree_int7']:.4f},{d_agr:.2f},{r['train_s']:.0f}")
    print("one-bit sacrifice is decision-neutral "
          "(acc Δ<1.5 pts, agreement Δ<3 pts, agree>90%): "
          f"{'PASS' if ok else 'FAIL'}")


if __name__ == "__main__":
    main()
