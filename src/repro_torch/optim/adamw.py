"""AdamW with mask-aware updates (pruned weights stay pruned) — the JAX
package's ``optim/adamw.py`` on the port's trees.

State is ``{"mu", "nu", "step"}``: fp32 moments with the params' tree,
and the step counter as an int32 tensor on the host, so bias correction
and the schedule are host scalars and the update reads nothing back from
the device.

Mask semantics (the paper's co-design loop): after pruning, the trainer
passes a mask tree of 0/1 tensors (``None`` where a leaf is dense);
gradients are masked before the global norm and the new params after the
update, so zeros never regrow and the packed formats stay valid.
``masks=None`` means dense.

The arithmetic is the JAX function's, in its order, on whole leaf lists
with the multi-tensor ``torch._foreach_*`` ops (a few launches per op for
all ~300 leaves of a model instead of one per leaf).  The update returns
new tensors and leaves its inputs untouched, so a step that fails after
it can be retried on the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import (leaves, leaves_as, stack_names, tree_map,
                              unflatten)

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                       # peak LR if a schedule is used
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0                 # global-norm clip; 0 disables
    schedule: Optional[Callable[[int], float]] = None   # step → lr scale


def adamw_init(params: Any) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def apply_mask(tree: Any, masks: Optional[Any]) -> Any:
    """Elementwise-multiply leaves by their mask where one exists."""
    if masks is None:
        return tree
    return tree_map(lambda t, m: t if m is None else t * m.to(t.dtype),
                    tree, masks)


def global_norm(tree: Any) -> torch.Tensor:
    """The fp32 L2 norm of every leaf together."""
    xs = leaves(tree)
    return _norm(_to(xs, [torch.float32] * len(xs)))


def _norm(xs: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(xs)))


def _to(xs: List[torch.Tensor], dtypes: List[torch.dtype]
        ) -> List[torch.Tensor]:
    """Each ``xs[i]`` in ``dtypes[i]``: a tensor already in it as itself,
    the others converted by one multi-tensor copy."""
    todo = [i for i, (x, d) in enumerate(zip(xs, dtypes)) if x.dtype != d]
    out = list(xs)
    if todo:
        dst = [torch.empty_like(xs[i], dtype=dtypes[i]) for i in todo]
        torch._foreach_copy_(dst, [xs[i] for i in todo])
        for i, d in zip(todo, dst):
            out[i] = d
    return out


def _masked(xs: List[torch.Tensor], ms: List[Optional[torch.Tensor]]
            ) -> List[torch.Tensor]:
    """``x * m`` (the mask in ``x``'s dtype) where a mask exists."""
    at = [i for i, m in enumerate(ms) if m is not None]
    if not at:
        return list(xs)
    out = list(xs)
    prod = torch._foreach_mul([xs[i] for i in at],
                              [ms[i].to(xs[i].dtype) for i in at])
    for i, p in zip(at, prod):
        out[i] = p
    return out


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                 masks: Optional[Any] = None) -> Tuple[Any, dict, dict]:
    """One optimizer step → ``(new_params, new_state, metrics)``; the
    metrics are ``grad_norm`` (a 0-dim device tensor) and ``lr``."""
    step = int(state["step"]) + 1
    p = leaves(params)
    m = leaves_as(masks, params)
    g = _masked(leaves_as(grads, params), m)

    f32 = [torch.float32] * len(p)
    g32 = _to(g, f32)
    gnorm = _norm(g32)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        g32 = torch._foreach_mul(g32, scale)

    lr = F32(cfg.lr)
    if cfg.schedule is not None:
        lr = F32(lr * F32(cfg.schedule(step)))
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(F32(1.0) - F32(b1) ** F32(step))
    c2 = float(F32(1.0) - F32(b2) ** F32(step))

    mu = torch._foreach_mul(leaves_as(state["mu"], params), b1)
    torch._foreach_add_(mu, torch._foreach_mul(g32, 1 - b1))
    nu = torch._foreach_mul(leaves_as(state["nu"], params), b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(g32, g32), 1 - b2))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(torch._foreach_div(mu, c1), denom)

    p32 = _to(p, f32)
    # decay matrices only: a leaf's rank in the JAX package's stacked
    # tree, where a layer stack's 1-d norm scales are (L, d) matrices
    mats = [i for i, (x, name) in enumerate(zip(p, stack_names(params)))
            if x.dim() + name.count("*") >= 2]
    if mats and cfg.weight_decay:
        decay = torch._foreach_mul([p32[i] for i in mats], cfg.weight_decay)
        torch._foreach_add_([delta[i] for i in mats], decay)
    new32 = torch._foreach_sub(p32, torch._foreach_mul(delta, float(lr)))
    new = _masked(_to(new32, [x.dtype for x in p]), m)

    new_state = {"mu": unflatten(params, mu), "nu": unflatten(params, nu),
                 "step": torch.tensor(step, dtype=torch.int32)}
    return unflatten(params, new), new_state, {"grad_norm": gnorm, "lr": lr}

