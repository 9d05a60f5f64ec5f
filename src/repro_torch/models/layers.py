"""Shared building blocks: rmsnorm, rotary embeddings, embed/unembed and
the gated MLP.

Cast points follow the JAX package: rmsnorm and rope compute in fp32 and
cast back to the input dtype; silu runs in fp32.  Every projection goes
through ``core.sparse_linear.apply_linear``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import (DENSE, SparsityConfig,
                                            apply_linear, init_linear)

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm with the ``(1 + scale)`` convention."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def init_embedding(vocab_padded: int, d: int, dtype: torch.dtype,
                   generator: torch.Generator, device) -> torch.Tensor:
    e = torch.randn((vocab_padded, d), generator=generator, device=device,
                    dtype=torch.float32)
    return (e / math.sqrt(d)).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor,
            softcap: Optional[float] = None) -> torch.Tensor:
    """``x (..., d) @ table.T`` → fp32 logits ``(..., vocab_padded)``."""
    logits = (x @ table.T).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotate ``x (B, L, H, D)`` by ``positions (B, L)`` (standard RoPE,
    split-half layout)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = positions[..., None].float() * inv                # (B, L, D/2)
    sin = torch.sin(ang)[..., None, :]                       # (B, L, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(d: int, ff: int, dtype: torch.dtype,
             generator: torch.Generator, device) -> Params:
    return {"w_in": init_linear(d, ff, dtype, generator, device),
            "w_out": init_linear(ff, d, dtype, generator, device),
            "w_gate": init_linear(d, ff, dtype, generator, device)}


def mlp(params: Params, x: torch.Tensor,
        sparsity: SparsityConfig = DENSE) -> torch.Tensor:
    """Gated MLP: ``w_out(silu(w_gate x) * w_in x)``."""
    h = apply_linear(x, params["w_in"], sparsity)
    g = apply_linear(x, params["w_gate"], sparsity)
    h = F.silu(g.float()).to(h.dtype) * h
    return apply_linear(h, params["w_out"], sparsity)
