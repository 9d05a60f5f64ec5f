"""Encoder-decoder backbone of the port (seamless-m4t-large-v2) — the
serving half of the JAX package's ``models/encdec.py``.

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings ``(B, L_src, d_model)``.  Pre-norm blocks:

  * encoder: ``n_encoder_layers`` × [bidirectional self-attention + MLP],
    then ``ln_enc_final``;
  * decoder: ``n_layers`` × [causal self-attention + cross-attention over
    the encoder output + MLP], then ``ln_dec_final`` and the tied head.

Params: ``{"embed", "encoder": [per-layer dict, ...], "decoder": [...],
"ln_enc_final", "ln_dec_final"}``; an encoder layer holds ``ln_attn``,
``attn``, ``ln_mlp`` and ``mlp``, a decoder layer ``ln_self``,
``self_attn``, ``ln_cross``, ``cross_attn``, ``ln_mlp`` and ``mlp``.

The cache is ``{"self": ..., "cross": {"k", "v"}}``: the decoder's self
KV, monolithic ``(n_layers, B, max_len, Hk, D)`` or paged, and the
decode-invariant cross K/V ``(n_layers, B, src_len, Hk, D)``, monolithic
(written once per request at a fixed ``src_len``, so paging it buys
nothing).  :func:`encdec_prefill` writes the cross K/V in place, so a
captured decode chunk that reads them keeps their addresses.

Kernels: the encoder's attention and the prompt's cross-attention run on
the flash kernel, non-causal; the prompt's self-attention on it causal;
decode self-attention on the paged kernel (paged layout); decode
cross-attention is plain fp32 attention over the cross cache, as the JAX
``_sdpa`` computes it (a kernel route for it is ROADMAP queue 2).

Training is the teacher-forced forward without a cache
(:func:`encdec_apply`, :func:`encdec_loss`): ``encode(kernel=False)``
and :func:`decode_hidden` run every attention on the plain route
(self-attention causal, cross-attention over the encoder output, the
encoder bidirectional) and, under ``cfg.remat``, recompute each layer in
the backward, as the JAX package checkpoints its scanned bodies.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.sparse_linear import apply_linear, pack_params
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention,
                                          bidirectional_attention,
                                          cross_attention, init_attention,
                                          init_kv_cache, init_paged_kv_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import chunked_ce

Params = Dict[str, Any]


def _init_enc_layer(cfg: ModelConfig, dtype, generator, device) -> Params:
    return {"ln_attn": L.init_rmsnorm(cfg.d_model, device),
            "attn": init_attention(cfg, dtype, generator, device),
            "ln_mlp": L.init_rmsnorm(cfg.d_model, device),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device, gated=cfg.mlp_gated)}


def _init_dec_layer(cfg: ModelConfig, dtype, generator, device) -> Params:
    return {"ln_self": L.init_rmsnorm(cfg.d_model, device),
            "self_attn": init_attention(cfg, dtype, generator, device),
            "ln_cross": L.init_rmsnorm(cfg.d_model, device),
            "cross_attn": init_attention(cfg, dtype, generator, device),
            "ln_mlp": L.init_rmsnorm(cfg.d_model, device),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device, gated=cfg.mlp_gated)}


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device,
                packed: bool = False) -> Params:
    """Random params (normal, fan-in scaled, as the JAX init).  With
    ``packed``, each layer is pruned and packed per ``cfg`` right after
    its init, as ``init_lm`` does."""
    dtype = L.DTYPES[cfg.dtype]

    def layer(init):
        p = init(cfg, dtype, generator, device)
        return pack_params(p, cfg) if packed else p

    return {"embed": L.init_embedding(cfg.vocab_padded, cfg.d_model, dtype,
                                      generator, device),
            "encoder": [layer(_init_enc_layer)
                        for _ in range(cfg.n_encoder_layers)],
            "decoder": [layer(_init_dec_layer) for _ in range(cfg.n_layers)],
            "ln_enc_final": L.init_rmsnorm(cfg.d_model, device),
            "ln_dec_final": L.init_rmsnorm(cfg.d_model, device)}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, *, dtype: torch.dtype = torch.bfloat16,
                      page_size: int = 0, num_pages: int = 0,
                      device) -> Params:
    """Self KV (paged when ``page_size > 0``) and the cross K/V
    ``(n_layers, batch, src_len, Hk, D)``, zeros until a prefill."""
    if page_size:
        self_cache = init_paged_kv_cache(cfg, batch, max_len, page_size,
                                         num_pages, dtype=dtype,
                                         device=device)
    else:
        self_cache = init_kv_cache(cfg, batch, max_len, dtype=dtype,
                                   device=device)
    return {"self": self_cache,
            "cross": init_kv_cache(cfg, batch, src_len, dtype=dtype,
                                   device=device)}


def _enc_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, kernel: bool) -> torch.Tensor:
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    if kernel:
        x = x + bidirectional_attention(p["attn"], cfg, h, positions,
                                        sparsity=cfg.attn_sparsity)
    else:
        x = x + attention(p["attn"], cfg, h, positions, causal=False,
                          sparsity=cfg.attn_sparsity)[0]
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity,
                     gated=cfg.mlp_gated)


def encode(params: Params, cfg: ModelConfig, src: torch.Tensor,
           kernel: bool = True) -> torch.Tensor:
    """``src (B, L_src, d_model)`` frame embeddings → the encoder output
    (rope at positions ``0..L_src-1``, bidirectional attention): on the
    flash kernel (``kernel``, serving), or on the plain route with
    ``cfg.remat`` recomputing each layer (training)."""
    B, Ls = src.shape[:2]
    positions = torch.arange(Ls, device=src.device)[None].expand(B, Ls)
    x = src.to(L.DTYPES[cfg.dtype])
    for p in params["encoder"]:
        x = L.maybe_remat(cfg.remat and not kernel, _enc_layer, p, cfg, x,
                          positions, kernel)
    return L.rmsnorm(params["ln_enc_final"], x, cfg.norm_eps)


def _dec_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    h = L.rmsnorm(p["ln_self"], x, cfg.norm_eps)
    x = x + attention(p["self_attn"], cfg, h, positions,
                      sparsity=cfg.attn_sparsity)[0]
    h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
    x = x + attention(p["cross_attn"], cfg, h, positions, cross_src=enc_out,
                      sparsity=cfg.attn_sparsity)[0]
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity,
                     gated=cfg.mlp_gated)


def decode_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder trunk (no cache; cross K/V computed in
    each layer) → final normed hidden states ``(B, T, d)``."""
    B, T = tokens.shape
    x = L.embed(params["embed"], tokens, cfg.embed_scale)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    for p in params["decoder"]:
        x = L.maybe_remat(cfg.remat, _dec_layer, p, cfg, x, positions,
                          enc_out)
    return L.rmsnorm(params["ln_dec_final"], x, cfg.norm_eps)


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    return L.unembed(params["embed"], decode_hidden(params, cfg, tokens,
                                                    enc_out),
                     cfg.final_softcap)


def encdec_apply(params: Params, cfg: ModelConfig, src: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward: (frames, target tokens) → fp32 logits."""
    return decode_train(params, cfg, tokens,
                        encode(params, cfg, src, kernel=False))


def encdec_loss(params: Params, cfg: ModelConfig, src: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    x = decode_hidden(params, cfg, tokens,
                      encode(params, cfg, src, kernel=False))
    return chunked_ce(x, params["embed"], labels, cfg)


def _cross_kv(p_layer: Params, cfg: ModelConfig, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V ``(B, L_src, Hk, D)`` from the encoder
    output: no rope, the k-norm under ``qk_norm``."""
    B, Ls = enc_out.shape[:2]
    ca = p_layer["cross_attn"]
    k = apply_linear(enc_out, ca["wk"], cfg.attn_sparsity)
    v = apply_linear(enc_out, ca["wv"], cfg.attn_sparsity)
    k = k.reshape(B, Ls, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Ls, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = L.rmsnorm(ca["k_norm"], k, cfg.norm_eps)
    return k, v


def _dec_cached(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, cache_pos) -> torch.Tensor:
    """The decoder over the cache: ``tokens (B, T)`` written at rows
    ``[cache_pos, cache_pos + T)`` of the self KV (a host int at prefill,
    per-slot ``(B,)`` at decode), attending over the cross K/V as cached
    → final normed hidden states ``(B, T, d)``.  Cross-attention takes
    the flash kernel at prefill and plain fp32 attention at decode."""
    B, T = tokens.shape
    block = torch.arange(T, device=tokens.device)
    prefill = isinstance(cache_pos, int)
    positions = ((cache_pos + block)[None].expand(B, T) if prefill
                 else cache_pos[:, None] + block)
    x = L.embed(params["embed"], tokens, cfg.embed_scale)
    self_c, cross = cache["self"], cache["cross"]
    for l, p in enumerate(params["decoder"]):
        h = L.rmsnorm(p["ln_self"], x, cfg.norm_eps)
        out, _ = attention(p["self_attn"], cfg, h, positions,
                           {k: v[l] for k, v in self_c.items()}, cache_pos,
                           sparsity=cfg.attn_sparsity)
        x = x + out
        h = L.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + cross_attention(p["cross_attn"], cfg, h, cross["k"][l],
                                cross["v"][l], kernel=prefill,
                                sparsity=cfg.attn_sparsity)
        h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity,
                      gated=cfg.mlp_gated)
    return L.rmsnorm(params["ln_dec_final"], x, cfg.norm_eps)


def encdec_prefill(params: Params, cfg: ModelConfig, src: torch.Tensor,
                   prompt: torch.Tensor, cache: Params
                   ) -> Tuple[torch.Tensor, Params]:
    """Encode ``src (B, L_src, d)`` (``L_src`` the cache's ``src_len``),
    write every decoder layer's cross K/V into the cache in place, then
    prefill the decoder self KV with ``prompt (B, L)``; returns the last
    position's fp32 logits ``(B, vocab_padded)`` and the cache."""
    enc = encode(params, cfg, src)
    cross = cache["cross"]
    for l, p in enumerate(params["decoder"]):
        k, v = _cross_kv(p, cfg, enc)
        cross["k"][l].copy_(k)
        cross["v"][l].copy_(v)
    x = _dec_cached(params, cfg, prompt, cache, 0)
    return L.unembed(params["embed"], x[:, -1], cfg.final_softcap), cache


def encdec_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                       cache: Params, pos: torch.Tensor
                       ) -> Tuple[torch.Tensor, Params]:
    """``token (B,)`` at per-slot ``pos (B,)`` → next-token fp32 logits
    ``(B, vocab_padded)``."""
    x = _dec_cached(params, cfg, token[:, None], cache, pos)
    return L.unembed(params["embed"], x[:, 0], cfg.final_softcap), cache


def encdec_decode_block(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, cache: Params,
                        pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """The speculative verify step: ``tokens (B, T)`` at per-slot
    positions ``pos (B,)``, causal within the block, over the cached self
    and cross K/V → fp32 logits ``(B, T, vocab_padded)``."""
    x = _dec_cached(params, cfg, tokens, cache, pos)
    return L.unembed(params["embed"], x, cfg.final_softcap), cache
