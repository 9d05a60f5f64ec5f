"""The paper's co-design loop at LM scale, on the port:

  1. train dense (``dense_trainer``, the ``Trainer``);
  2. prune to 2:4 along K with positions shared over ``group`` columns
     (``nm_masks``: the structure the N:M pack keeps exactly), and
     fine-tune with *masked* AdamW so pruned weights stay zero
     (``finetune``);
  3. report the held-out loss of the dense, the pruned and the
     fine-tuned model, and the sparsity actually held;
  4. pack a pruned weight into the N:M format and check the packed
     forward against the masked dense one.

The functions take the model config, so a caller can run the loop at
any width (``chip_smoke.py`` runs it on qwen3-0.6b at full width).  The
JAX package's ``examples/train_sparse_lm.py`` is the reference; here the
masks may cover any projections (``names``), not only the MLPs.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_sparse_lm \\
          [--small] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import models as MZ
from repro_torch.core import pruning
from repro_torch.data import DataConfig, make_batch
from repro_torch.models.config import ModelConfig
from repro_torch.optim import apply_mask
from repro_torch.train import (TrainConfig, Trainer, build_train_step,
                               init_opt_state)
from repro_torch.tree import leaves, leaves_as

MLP = ("w_in", "w_gate", "w_out")
#: every projection ``sparse()`` packs
PROJECTIONS = ("wq", "wk", "wv", "wo") + MLP
FINETUNE_START = 10_000            # the fine-tune's batches, as in JAX's
HELDOUT_START = 20_000             # batches no stage trains on


def lm_config(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(name="sparse-lm-8m", n_layers=4, d_model=128,
                           vocab_size=4096, n_heads=4, n_kv_heads=2,
                           d_ff=512, remat=False)
    return ModelConfig(name="sparse-lm-100m", n_layers=8, d_model=512,
                       vocab_size=32768, n_heads=8, n_kv_heads=4,
                       d_ff=2048, remat=False)


def nm_masks(params: Any, n: int, m: int, group: int = 128,
             names: Sequence[str] = MLP) -> Any:
    """n:m masks along K (positions shared over ``group`` columns, or
    per column where ``group`` does not divide N) for every matrix under
    a key in ``names``; ``None`` elsewhere."""
    def visit(node, key):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, key) for v in node]
        if key in names and node.dim() == 2:
            g = group if node.shape[-1] % group == 0 else 1
            return pruning.n_m(node.float(), n, m, group=g)[1].to(node.dtype)
        return None

    return visit(params, None)


def masked_leaves(params: Any, masks: Any) -> List[Tuple[Any, Any]]:
    """(leaf, mask) of every masked leaf."""
    return [(p, mk) for p, mk in zip(leaves(params), leaves_as(masks, params))
            if mk is not None]


def zeros_kept(params: Any, masks: Any) -> bool:
    """Every masked position is exactly zero."""
    return all(bool((p[mk == 0] == 0).all())
               for p, mk in masked_leaves(params, masks))


def dense_trainer(cfg: ModelConfig, dcfg: DataConfig, steps: int,
                  lr: float = 3e-3, warmup: int = 20, device="cuda",
                  log_every: int = 40) -> Trainer:
    """The dense stage's ``Trainer`` (seeded init, the cosine schedule
    over ``steps``); ``fit`` runs it."""
    return Trainer(cfg, TrainConfig(steps=steps, lr=lr, warmup=warmup,
                                    log_every=log_every), dcfg,
                   device=device)


def finetune(cfg: ModelConfig, params: Any, masks: Any, dcfg: DataConfig,
             steps: int, lr: float = 1e-3, warmup: int = 10, device="cuda",
             start: int = FINETUNE_START,
             progress: Optional[Callable[[int, dict], None]] = None
             ) -> Tuple[Any, List[dict]]:
    """Masked fine-tune from ``params`` (already pruned) on the batches
    at ``start + s``, fresh optimizer state → (params, metrics per
    step, the loss and step seconds included)."""
    tcfg = TrainConfig(steps=steps, lr=lr, warmup=warmup)
    step_fn = build_train_step(cfg, tcfg, masks=masks)
    opt = init_opt_state(params, tcfg)
    history = []
    for s in range(steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(
            params, opt, make_batch(cfg, dcfg, start + s, device))
        m = {k: float(v) for k, v in metrics.items()}
        m["step_time_s"] = time.perf_counter() - t0
        history.append(m)
        if progress:
            progress(s, m)
    return params, history


def heldout_loss(params: Any, cfg: ModelConfig, dcfg: DataConfig,
                 batches: int = 4, device="cuda",
                 start: int = HELDOUT_START) -> float:
    """Mean loss over ``batches`` batches no stage trains on."""
    with torch.no_grad():
        return float(np.mean([
            float(MZ.model_loss(params, cfg,
                                make_batch(cfg, dcfg, start + i, device)))
            for i in range(batches)]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--dense-steps", type=int, default=120)
    ap.add_argument("--finetune-steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.sparse_linear import (SparsityConfig,
                                                apply_linear,
                                                sparsify_weight)
    cfg = lm_config(args.small)
    dcfg = DataConfig(seed=0, global_batch=args.batch, seq_len=args.seq)
    dev = args.device
    print(f"model: {cfg.name}  params≈{cfg.param_count()/1e6:.1f}M")

    # --- 1. dense training -------------------------------------------------
    t0 = time.time()
    trainer = dense_trainer(cfg, dcfg, args.dense_steps, device=dev)
    params, _ = trainer.fit(
        progress=lambda s, m: print(f"  dense {s:4d} loss {m['loss']:.3f}"))
    dense = heldout_loss(params, cfg, dcfg, device=dev)
    print(f"dense: {trainer.history[0]['loss']:.3f} → "
          f"{trainer.history[-1]['loss']:.3f} ({time.time()-t0:.0f}s), "
          f"held-out {dense:.3f}")

    # --- 2. one-shot 2:4 prune + masked fine-tune --------------------------
    masks = nm_masks(params, 2, 4)
    params = apply_mask(params, masks)
    pruned = heldout_loss(params, cfg, dcfg, device=dev)
    print(f"after one-shot 2:4 prune of MLPs: held-out loss {pruned:.3f}")
    params, hist = finetune(
        cfg, params, masks, dcfg, args.finetune_steps, device=dev,
        progress=lambda s, m: s % 40 == 0 and print(
            f"  finetune {s:4d} loss {m['loss']:.3f}"))
    tuned = heldout_loss(params, cfg, dcfg, device=dev)

    # --- 3. sparsity held + packed forward matches ---------------------------
    kept = zeros_kept(params, masks)
    sparsity = np.mean([float((p == 0).float().mean())
                        for p, _ in masked_leaves(params, masks)])
    print(f"MLP sparsity after fine-tune: {sparsity:.3f} "
          f"(zeros preserved: {kept})")
    scfg = SparsityConfig(format="nm", n=2, m=4, block_n=128)
    w = params["layers"][0]["mlp"]["w_in"].float()
    x = torch.randn((4, w.shape[0]), generator=torch.Generator().manual_seed(0)
                    ).to(w.device)
    err = float((apply_linear(x, sparsify_weight(w, scfg), scfg)
                 - x @ w).abs().max())
    print(f"packed 2:4 forward vs masked dense: max err {err:.2e}")
    print(f"\nsummary: held-out dense {dense:.3f} → pruned {pruned:.3f} → "
          f"fine-tuned {tuned:.3f} at {sparsity:.0%} MLP sparsity "
          f"(last fine-tune loss {hist[-1]['loss']:.3f})")
    if not (kept and err < 1e-4 and tuned < pruned):
        raise SystemExit("the co-design loop failed its checks")
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
