"""Decoder-only LM of the port: pre-norm blocks in a Python loop over
per-layer params.

Params are ``{"embed": (V_pad, d), "layers": [per-layer dict, ...],
"ln_final": {"scale"}}``, plus ``"unembed": (V_pad, d)`` for an untied
head (``tie_embeddings=False``, stablelm); a per-layer dict holds
``ln_attn``, ``ln_mlp``, ``attn`` (``wq/wk/wv/wo`` + qk-norm scales),
under ``post_norm`` (gemma) ``ln_attn_post`` and ``ln_mlp_post``, and
``mlp`` (``w_in/w_gate/w_out``), or for an MoE config (``n_experts``)
``moe`` (``router``, the expert stacks, optional ``shared``; see
``models/moe.py``).  gemma's local layers (``ATTN_LOCAL``) attend over
a sliding window, and its token embeddings are scaled by ``sqrt(d)``
(``embed_scale``).  Projections may be dense tensors or packs —
``apply_linear`` dispatches on the type.  The cache keeps the JAX
package's stacked ``(n_layers, ...)`` leaves; layer ``l`` works on views
of slice ``l``.  Under M-RoPE (qwen2-vl) the positions are broadcast to
identical (t, h, w) triples, as the JAX model does for text.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.sparse_linear import pack_params
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.config import LayerKind, ModelConfig

Params = Dict[str, Any]


def init_layer(cfg: ModelConfig, dtype: torch.dtype,
               generator: torch.Generator, device) -> Params:
    p = {"ln_attn": L.init_rmsnorm(cfg.d_model, device),
         "ln_mlp": L.init_rmsnorm(cfg.d_model, device),
         "attn": init_attention(cfg, dtype, generator, device)}
    if cfg.post_norm:
        p["ln_attn_post"] = L.init_rmsnorm(cfg.d_model, device)
        p["ln_mlp_post"] = L.init_rmsnorm(cfg.d_model, device)
    if cfg.n_experts:
        p["moe"] = M.init_moe(cfg, dtype, generator, device)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device)
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator, device,
            packed: bool = False) -> Params:
    """Random LM params (normal, fan-in scaled, as the JAX init).  With
    ``packed``, each layer is pruned and packed per ``cfg`` right after
    its init (``pack_params``), so one dense layer is the only transient:
    the draws, and so the packs, equal ``pack_params`` of the dense init."""
    dtype = L.DTYPES[cfg.dtype]

    def layer():
        p = init_layer(cfg, dtype, generator, device)
        return pack_params(p, cfg) if packed else p

    p = {"embed": L.init_embedding(cfg.vocab_padded, cfg.d_model, dtype,
                                   generator, device),
         "layers": [layer() for _ in range(cfg.n_layers)],
         "ln_final": L.init_rmsnorm(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(cfg.vocab_padded, cfg.d_model, dtype,
                                        generator, device)
    return p


def head(params: Params) -> torch.Tensor:
    """The output head's table: the untied ``unembed``, else ``embed``."""
    return params.get("unembed", params["embed"])


def _layer_cache(cache: Params, l: int) -> Params:
    return {k: v[l] for k, v in cache.items()}


def block(p: Params, cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor, kind: int, cache: Params, cache_pos
          ) -> torch.Tensor:
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``,
    the MoE block in place of the MLP under ``cfg.n_experts`` (its aux
    loss dropped: nothing here trains); under ``cfg.post_norm`` each
    sub-block's output is normed again before its residual add."""
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    attn_out, _ = attention(p["attn"], cfg, h, positions, cache, cache_pos,
                            is_local=kind == int(LayerKind.ATTN_LOCAL),
                            sparsity=cfg.attn_sparsity)
    if cfg.post_norm:
        attn_out = L.rmsnorm(p["ln_attn_post"], attn_out, cfg.norm_eps)
    x = x + attn_out
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    if cfg.n_experts:
        mlp_out = M.moe_block(p["moe"], cfg, h)[0]
    else:
        mlp_out = L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity)
    if cfg.post_norm:
        mlp_out = L.rmsnorm(p["ln_mlp_post"], mlp_out, cfg.norm_eps)
    return x + mlp_out


def _forward(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
             positions: torch.Tensor, cache: Params, cache_pos
             ) -> torch.Tensor:
    """``inputs``: tokens ``(B, L)``, or embeds ``(B, L, d)`` when
    ``cfg.input_mode == "embeds"`` (cast to the model dtype);
    ``positions (B, L)``, broadcast to triples under M-RoPE."""
    if cfg.input_mode == "embeds" and inputs.dim() == 3:
        x = inputs.to(L.DTYPES[cfg.dtype])
    else:
        x = L.embed(params["embed"], inputs, cfg.embed_scale)
    if cfg.mrope_sections is not None:
        positions = positions[..., None].expand(*positions.shape, 3)
    for l, p in enumerate(params["layers"]):
        x = block(p, cfg, x, positions, cfg.layer_kinds[l],
                  _layer_cache(cache, l), cache_pos)
    return L.rmsnorm(params["ln_final"], x, cfg.norm_eps)


def lm_prefill(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
               cache: Params) -> Tuple[torch.Tensor, Params]:
    """Fill rows ``[0, L)`` of the cache with the prompt — tokens ``(B,
    L)`` or embeds ``(B, L, d)`` (:func:`_forward`); return the last
    position's fp32 logits ``(B, vocab_padded)``."""
    B, Lq = inputs.shape[:2]
    positions = torch.arange(Lq, device=inputs.device)[None].expand(B, Lq)
    x = _forward(params, cfg, inputs, positions, cache, 0)
    return L.unembed(head(params), x[:, -1], cfg.final_softcap), cache


def lm_decode_block(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    cache: Params, pos) -> Tuple[torch.Tensor, Params]:
    """``tokens (B, T)`` written at rows ``[pos, pos + T)`` of every slot,
    causal within the block over the rows already cached; fp32 logits for
    every block position ``(B, T, vocab_padded)``.  ``pos`` is a ``(B,)``
    tensor of per-slot offsets (the speculative verify block, either
    cache layout) or a host int, one offset for every slot (the prefix
    suffix prefill, paged cache)."""
    B, T = tokens.shape
    block = torch.arange(T, device=tokens.device)
    positions = (pos + block)[None].expand(B, T) if isinstance(pos, int) \
        else pos[:, None] + block
    x = _forward(params, cfg, tokens, positions, cache, pos)
    return L.unembed(head(params), x, cfg.final_softcap), cache


def lm_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                   cache: Params, pos: torch.Tensor
                   ) -> Tuple[torch.Tensor, Params]:
    """One decode step: ``token (B,)`` written at per-slot ``pos (B,)`` →
    next-token fp32 logits ``(B, vocab_padded)``."""
    x = _forward(params, cfg, token[:, None], pos[:, None], cache, pos)
    return L.unembed(head(params), x[:, 0], cfg.final_softcap), cache
