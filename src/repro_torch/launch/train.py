"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the port's ``Trainer`` end to end on one device (``--device``, the
card by default) and prints the JAX launcher's closing JSON.  The JAX
launcher's ``--model-parallel`` comes with tensor parallelism (ROADMAP
queue 1 item 13).

Examples:
  python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
      --steps 30 --device cpu
  python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
      --steps 200 --checkpoint-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-size config (CPU-friendly)")
    ap.add_argument("--sparse", action="store_true",
                    help="apply the paper's sparsity preset")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import configs as C
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainConfig, Trainer

    if args.sparse and args.reduced:
        ap.error("--sparse presets apply to the full config")
    mod = C._module(args.arch)
    cfg = (mod.reduced() if args.reduced
           else (mod.sparse() if args.sparse else mod.config()))
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches, lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        compress_grads=args.compress_grads, seed=args.seed)
    dcfg = DataConfig(seed=args.seed, global_batch=args.batch,
                      seq_len=args.seq)

    trainer = Trainer(cfg, tcfg, dcfg, device=args.device)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"device={trainer.device} steps={tcfg.steps}")
    t0 = time.time()

    def progress(step, m):
        print(f"  step {step:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['step_time_s']*1e3:.0f} ms",
              flush=True)

    trainer.fit(progress=progress)
    dt = time.time() - t0
    first = trainer.history[0]["loss"]
    last = trainer.history[-1]["loss"]
    print(json.dumps({
        "arch": cfg.name, "steps": tcfg.steps, "wall_s": round(dt, 1),
        "loss_first": round(first, 4), "loss_last": round(last, 4),
        "loss_drop": round(first - last, 4),
        "stragglers_flagged": len(trainer.straggler_flags),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
