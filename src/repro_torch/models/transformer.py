"""Decoder-only LM of the port: pre-norm blocks in a Python loop over
per-layer params.

Params are ``{"embed": (V_pad, d), "layers": [per-layer dict, ...],
"ln_final": {"scale"}}``; a per-layer dict holds ``ln_attn``, ``ln_mlp``,
``attn`` (``wq/wk/wv/wo`` + qk-norm scales) and ``mlp``
(``w_in/w_gate/w_out``).  Projections may be dense tensors or packs —
``apply_linear`` dispatches on the type.  The cache keeps the JAX
package's stacked ``(n_layers, ...)`` leaves; layer ``l`` works on views
of slice ``l``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.config import LayerKind, ModelConfig

Params = Dict[str, Any]


def init_layer(cfg: ModelConfig, dtype: torch.dtype,
               generator: torch.Generator, device) -> Params:
    return {"ln_attn": L.init_rmsnorm(cfg.d_model, device),
            "ln_mlp": L.init_rmsnorm(cfg.d_model, device),
            "attn": init_attention(cfg, dtype, generator, device),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device)}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Random LM params (normal, fan-in scaled, as the JAX init)."""
    dtype = L.DTYPES[cfg.dtype]
    return {"embed": L.init_embedding(cfg.vocab_padded, cfg.d_model, dtype,
                                      generator, device),
            "layers": [init_layer(cfg, dtype, generator, device)
                       for _ in range(cfg.n_layers)],
            "ln_final": L.init_rmsnorm(cfg.d_model, device)}


def _layer_cache(cache: Params, l: int) -> Params:
    return {k: v[l] for k, v in cache.items()}


def block(p: Params, cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor, kind: int, cache: Params, cache_pos
          ) -> torch.Tensor:
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``."""
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    attn_out, _ = attention(p["attn"], cfg, h, positions, cache, cache_pos,
                            is_local=kind == int(LayerKind.ATTN_LOCAL),
                            sparsity=cfg.attn_sparsity)
    x = x + attn_out
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity)


def _forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             positions: torch.Tensor, cache: Params, cache_pos
             ) -> torch.Tensor:
    x = L.embed(params["embed"], tokens)
    for l, p in enumerate(params["layers"]):
        x = block(p, cfg, x, positions, cfg.layer_kinds[l],
                  _layer_cache(cache, l), cache_pos)
    return L.rmsnorm(params["ln_final"], x, cfg.norm_eps)


def lm_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: Params) -> Tuple[torch.Tensor, Params]:
    """Fill rows ``[0, L)`` of the cache with the prompt ``tokens (B, L)``;
    return the last position's fp32 logits ``(B, vocab_padded)``."""
    B, Lq = tokens.shape
    positions = torch.arange(Lq, device=tokens.device)[None].expand(B, Lq)
    x = _forward(params, cfg, tokens, positions, cache, 0)
    return L.unembed(params["embed"], x[:, -1], cfg.final_softcap), cache


def lm_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                   cache: Params, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``token (B,)`` written at per-slot ``pos (B,)`` →
    next-token fp32 logits ``(B, vocab_padded)``."""
    x = _forward(params, cfg, token[:, None], pos[:, None], cache, pos)
    return L.unembed(params["embed"], x[:, 0], cfg.final_softcap), cache
