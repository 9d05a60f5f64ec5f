"""Shared building blocks: rmsnorm, layernorm, rotary embeddings,
embed/unembed and the MLP, gated or plain.

Cast points follow the JAX package: rmsnorm and rope compute in fp32 and
cast back to the input dtype; silu and gelu run in fp32.  Every projection goes
through ``core.sparse_linear.apply_linear``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparse_linear import (DENSE, SparsityConfig,
                                            apply_linear, init_linear)

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``remat`` (the JAX
    package's ``jax.checkpoint`` of a layer body)."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm with the ``(1 + scale)`` convention."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def init_layernorm(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """Layer norm in fp32 (biased variance), cast back to ``x``'s
    dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


def init_embedding(vocab_padded: int, d: int, dtype: torch.dtype,
                   generator: torch.Generator, device) -> torch.Tensor:
    e = torch.randn((vocab_padded, d), generator=generator, device=device,
                    dtype=torch.float32)
    return (e / math.sqrt(d)).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    """Rows of ``table``; with ``scale`` (gemma) times ``sqrt(d)``
    rounded to the table's dtype first, as the JAX package casts it (68.0
    at d = 4608 and 34.0 at d = 1152 in bfloat16)."""
    x = table[tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=x.dtype).item()
    return x


def unembed(table: torch.Tensor, x: torch.Tensor,
            softcap: Optional[float] = None) -> torch.Tensor:
    """``x (..., d) @ table.T`` → fp32 logits ``(..., vocab_padded)``."""
    logits = (x @ table.T).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Rotate ``x (B, L, H, D)`` by ``positions`` (split-half layout).

    ``positions`` is ``(B, L)`` for standard RoPE, or ``(B, L, 3)``
    (temporal, height, width) for M-RoPE: the ``D/2`` frequency slots
    fall into ``mrope_sections`` groups, each rotated by its own position
    component.  Identical triples give standard RoPE."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    if mrope_sections is None:
        if positions.dim() != x.dim() - 2:
            raise ValueError("standard RoPE expects (..., L) positions")
        ang = positions[..., None].float() * inv            # (B, L, D/2)
    else:
        if positions.shape[-1] != 3:
            raise ValueError("M-RoPE expects (..., L, 3) positions")
        if sum(mrope_sections) != D // 2:
            raise ValueError(f"mrope sections {mrope_sections} != "
                             f"D/2={D // 2}")
        # the position component of each frequency slot, built on the
        # device (a captured decode chunk may copy nothing from the host)
        s0, s1, _ = mrope_sections
        slot = torch.arange(D // 2, device=x.device)
        sect = (slot >= s0).long() + (slot >= s0 + s1).long()
        ang = positions.float().index_select(-1, sect) * inv  # (B, L, D/2)
    sin = torch.sin(ang)[..., None, :]                       # (B, L, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(d: int, ff: int, dtype: torch.dtype,
             generator: torch.Generator, device, gated: bool = True
             ) -> Params:
    p = {"w_in": init_linear(d, ff, dtype, generator, device),
         "w_out": init_linear(ff, d, dtype, generator, device)}
    if gated:
        p["w_gate"] = init_linear(d, ff, dtype, generator, device)
    return p


def mlp(params: Params, x: torch.Tensor,
        sparsity: SparsityConfig = DENSE, gated: bool = True
        ) -> torch.Tensor:
    """Gated MLP ``w_out(silu(w_gate x) * w_in x)``, or with ``gated=False``
    the plain ``w_out(gelu(w_in x))`` (the tanh form, ``jax.nn.gelu``'s
    default)."""
    h = apply_linear(x, params["w_in"], sparsity)
    if gated:
        g = apply_linear(x, params["w_gate"], sparsity)
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return apply_linear(h, params["w_out"], sparsity)
