"""Trainer of the port: the train step and the fault-tolerant fit loop of
the JAX package's ``train/trainer.py``, on one device.

``build_train_step`` assembles the step:

  * loss = ``models.model_loss`` (family-dispatched), differentiated by
    autograd over the cache-less forward — plain PyTorch, no kernel;
  * microbatch gradient accumulation (``microbatches``), summed in fp32;
  * optional int8 gradient quantization with error feedback carried in
    the optimizer state (``compress_grads``);
  * the masked AdamW update (pruned weights stay pruned).

The step is functional: it returns new params and optimizer state and
leaves its inputs as they were, so a step that fails anywhere can be
retried on the same state.

``Trainer.fit`` adds the host-side posture: restart from the latest
checkpoint, periodic async checkpoints, per-step retry on a transient
device failure (``TRANSIENT``; anything else propagates at once), and a
straggler watchdog (steps slower than ``straggler_factor``× the EMA of
step time are flagged).  The mesh, the shardings and the ``profile``
switch come with tensor parallelism (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import models as MZ
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_batch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.compression import compress_tree
from repro_torch.tree import leaves, tree_map, unflatten

#: the error class of a transient device failure, the only one a step is
#: retried on (a CUDA runtime error; ``torch.AcceleratorError`` where
#: torch has it)
TRANSIENT = getattr(torch, "AcceleratorError", torch.cuda.CudaError)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1           # grad-accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    # optimizer
    lr: float = 3e-4
    warmup: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # resilience
    compress_grads: bool = False
    max_retries: int = 2            # per-step transient-failure retries
    straggler_factor: float = 3.0   # step > factor·EMA ⇒ flagged
    seed: int = 0


# ---------------------------------------------------------------------------
# Step construction
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn: Callable, params: Any, batch: Dict,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the grads have
    the params' tree and dtypes (zeros for a leaf the loss does not
    reach); ``params`` are not modified.  ``mark`` (see
    :func:`build_train_step`) is called with ``"forward"`` and
    ``"backward"`` as each is issued."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        if mark is not None:
            mark("forward")
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    if mark is not None:
        mark("backward")
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])


def _accumulate_grads(loss_fn: Callable, params: Any, batch: Dict,
                      n_micro: int,
                      mark: Optional[Callable[[str], None]] = None
                      ) -> Tuple[torch.Tensor, Any]:
    """Mean loss and grads over ``n_micro`` microbatches (the batch split
    along its leading axis), summed in fp32 in order."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch, mark)
    loss_acc, acc = 0.0, None
    for i in range(n_micro):
        mb = {k: v.reshape(n_micro, v.shape[0] // n_micro,
                           *v.shape[1:])[i] for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, params, mb, mark)
        loss_acc = loss_acc + loss
        acc = tree_map(lambda g: g.float(), grads) if acc is None \
            else tree_map(torch.add, acc, grads)
    inv = 1.0 / n_micro
    return loss_acc * inv, tree_map(lambda g: g * inv, acc)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     masks: Optional[Any] = None,
                     mark: Optional[Callable[[str], None]] = None
                     ) -> Callable:
    """``step(params, opt_state, batch) → (params, opt_state, metrics)``,
    new state each call (the inputs are left as they were); ``metrics``
    holds ``loss``, ``grad_norm`` (0-dim device tensors) and ``lr``.

    ``mark(part)``, if given, is called on the host as each part of the
    step has been issued: ``"forward"`` and ``"backward"`` (once per
    microbatch), then ``"optimizer"`` (gradient compression included) —
    a hook for timing the step's parts, e.g. with CUDA events."""
    opt_cfg = AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay,
                          grad_clip=tcfg.grad_clip,
                          schedule=cosine_warmup(tcfg.warmup, tcfg.steps))

    def loss_fn(params, batch):
        return MZ.model_loss(params, cfg, batch)

    def step(params, opt_state, batch):
        loss, grads = _accumulate_grads(loss_fn, params, batch,
                                        tcfg.microbatches, mark)
        if tcfg.compress_grads:
            # int8 quantize/dequantize with error feedback carried in the
            # optimizer state: what a cross-host reduce would move
            _, new_err, grads = compress_tree(grads, opt_state.get("ef"))
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, grads,
            {k: opt_state[k] for k in ("mu", "nu", "step")}, masks=masks)
        if tcfg.compress_grads:
            new_opt["ef"] = new_err
        if mark is not None:
            mark("optimizer")
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return step


def init_opt_state(params: Any, tcfg: TrainConfig) -> dict:
    state = adamw_init(params)
    if tcfg.compress_grads:
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


# ---------------------------------------------------------------------------
# Fit loop (host-side resilience)
# ---------------------------------------------------------------------------

class Trainer:
    """Runs ``tcfg.steps`` steps of ``build_train_step`` on ``device``
    over the ``dcfg`` stream.  ``params`` and ``opt_state`` hold the
    state after the last finished step (what ``progress`` may read)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 masks: Optional[Any] = None, device="cuda"):
        self.cfg, self.tcfg, self.dcfg = cfg, tcfg, dcfg
        self.masks = masks
        self.device = resolve_device(device)
        self.manager = (CheckpointManager(tcfg.checkpoint_dir,
                                          keep=tcfg.keep_checkpoints)
                        if tcfg.checkpoint_dir else None)
        self.history: list = []
        self.straggler_flags: list = []
        self.params: Any = None
        self.opt_state: Optional[dict] = None

    # -- initialization / restore ---------------------------------------

    def init_state(self) -> Tuple[Any, dict, int]:
        """Fresh (seeded) or restored ``(params, opt_state, start_step)``."""
        params = MZ.init_model(self.cfg, seed=self.tcfg.seed,
                               device=self.device)
        opt_state = init_opt_state(params, self.tcfg)
        if self.manager is not None:
            restored = self.manager.restore_latest(
                {"params": params, "opt": opt_state})
            if restored is not None:
                tree, step = restored
                opt = tree["opt"]
                on_dev = {k: tree_map(lambda t: t.to(self.device), v)
                          for k, v in opt.items() if k != "step"}
                return (tree_map(lambda t: t.to(self.device), tree["params"]),
                        {**on_dev, "step": opt["step"]}, step)
        return params, opt_state, 0

    # -- main loop --------------------------------------------------------

    def fit(self, progress: Optional[Callable[[int, dict], None]] = None
            ) -> Tuple[Any, dict]:
        params, opt_state, start = self.init_state()
        self.params, self.opt_state = params, opt_state
        step_fn = build_train_step(self.cfg, self.tcfg, masks=self.masks)

        ema = None
        for step in range(start, self.tcfg.steps):
            batch = make_batch(self.cfg, self.dcfg, step, self.device)
            for attempt in range(self.tcfg.max_retries + 1):
                t0 = time.perf_counter()
                try:
                    new = step_fn(params, opt_state, batch)
                    float(new[2]["loss"])         # wait for the device
                    break
                except TRANSIENT:
                    # a transient device failure: the step is functional,
                    # so it is retried on the state it started from
                    if attempt == self.tcfg.max_retries:
                        raise
            dt = time.perf_counter() - t0
            params, opt_state, metrics = new
            self.params, self.opt_state = params, opt_state

            # straggler watchdog
            if ema is None:
                ema = dt
            if dt > self.tcfg.straggler_factor * ema and step > start + 2:
                self.straggler_flags.append(
                    {"step": step, "dt": dt, "ema": ema})
            ema = 0.9 * ema + 0.1 * dt

            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = dt
            self.history.append(m)
            if progress and step % self.tcfg.log_every == 0:
                progress(step, m)

            if (self.manager is not None
                    and (step + 1) % self.tcfg.checkpoint_every == 0):
                self.manager.save(step + 1,
                                  {"params": params, "opt": opt_state})

        if self.manager is not None:
            last = self.manager.timings[-1]["step"] \
                if self.manager.timings else None
            if last == self.tcfg.steps:
                self.manager.wait()       # the periodic save was the last
            else:
                self.manager.save(self.tcfg.steps,
                                  {"params": params, "opt": opt_state},
                                  blocking=True)
        return params, opt_state
