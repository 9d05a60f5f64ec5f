"""Hybrid / SSM LM assemblies of the port: zamba2 (a Mamba-2 trunk plus
one *shared* attention block) and pure mamba2 — the JAX package's
``models/hybrid.py``.

The layer pattern comes from ``cfg.layer_kinds``: ``MAMBA`` layers form
the trunk; a ``SHARED_ATTN`` entry means "apply the shared attention
block (attention + gated MLP, one set of weights), then this layer's
mamba mixer".  Pure mamba2 has no ``SHARED_ATTN`` entry.

Params: ``{"embed", "mamba": [per-layer dict, ...], "ln_final"}``, plus
``"shared"`` (``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``) when the
pattern has a shared slot and ``"unembed"`` for an untied head.  A
mamba layer's dict is ``init_mamba``'s plus its pre-norm ``ln``.

The cache is ``{"ssm": {"conv", "ssm"}, "kv": ...}``: the recurrent
state stacked over all layers (fp32), and the shared block's KV stacked
over the shared slots only, monolithic ``(n_shared, B, S, Hk, D)`` or
paged; mamba2 has no ``"kv"``.  Everything is written in place.

Training runs without a cache (:func:`hybrid_apply`, :func:`hybrid_loss`):
the chunked SSD scan from a zero state in every mamba layer, the shared
block's attention on the plain route, and under ``cfg.remat`` each mamba
layer recomputed in the backward, as the JAX ``_scan_run`` checkpoints
its body.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.sparse_linear import pack_params
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention, init_attention,
                                          init_paged_kv_cache)
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.ssm import init_mamba, init_ssm_cache, mamba_block
from repro_torch.models.transformer import chunked_ce

Params = Dict[str, Any]


def shared_slots(cfg: ModelConfig) -> List[int]:
    """Layer indices where the shared attention block fires (before the
    mamba layer at that index)."""
    return [i for i, k in enumerate(cfg.layer_kinds)
            if LayerKind(k) == LayerKind.SHARED_ATTN]


def _runs(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """The (lo, hi) mamba-layer runs between shared-block applications."""
    slots = shared_slots(cfg)
    bounds = [0] + slots + [cfg.n_layers]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
            if bounds[i] < bounds[i + 1]]


def init_hybrid_lm(cfg: ModelConfig, generator: torch.Generator, device,
                   packed: bool = False) -> Params:
    """Random params (normal, fan-in scaled, as the JAX init).  With
    ``packed``, each mamba layer and the shared block are pruned and
    packed per ``cfg`` right after their init, as ``init_lm`` does."""
    dtype = L.DTYPES[cfg.dtype]

    def pack(p):
        return pack_params(p, cfg) if packed else p

    def layer():
        p = init_mamba(cfg, dtype, generator, device)
        p["ln"] = L.init_rmsnorm(cfg.d_model, device)
        return pack(p)

    p: Params = {"embed": L.init_embedding(cfg.vocab_padded, cfg.d_model,
                                           dtype, generator, device),
                 "mamba": [layer() for _ in range(cfg.n_layers)],
                 "ln_final": L.init_rmsnorm(cfg.d_model, device)}
    if shared_slots(cfg):
        p["shared"] = pack({
            "ln_attn": L.init_rmsnorm(cfg.d_model, device),
            "attn": init_attention(cfg, dtype, generator, device),
            "ln_mlp": L.init_rmsnorm(cfg.d_model, device),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device)})
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_embedding(cfg.vocab_padded, cfg.d_model, dtype,
                                        generator, device)
    return p


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      dtype: torch.dtype = torch.bfloat16,
                      page_size: int = 0, num_pages: int = 0,
                      device) -> Params:
    """``{"ssm": stacked conv + state (fp32), "kv": the shared slots'
    KV}``; ``page_size > 0`` pages the KV (the recurrent state is O(1) in
    sequence length and has nothing to page)."""
    cache: Params = {"ssm": init_ssm_cache(cfg, batch, device=device)}
    n_shared = len(shared_slots(cfg))
    if n_shared:
        if page_size:
            cache["kv"] = init_paged_kv_cache(
                cfg, batch, max_len, page_size, num_pages, n_layers=n_shared,
                dtype=dtype, device=device)
        else:
            shape = (n_shared, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache["kv"] = {"k": torch.zeros(shape, dtype=dtype,
                                            device=device),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=device)}
    return cache


def _mamba_layer(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    out, _ = mamba_block(p, cfg, h, sparsity=cfg.mlp_sparsity)
    return x + out


def _scan_run(params_run: List[Params], cfg: ModelConfig, x: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """One contiguous run of mamba layers without a cache; ``remat``
    recomputes each layer in the backward."""
    for p in params_run:
        x = L.maybe_remat(remat, _mamba_layer, p, cfg, x)
    return x


def hybrid_hidden(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[Params] = None, cache_pos=None,
                  collect_states: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The trunk: tokens ``(B, L)`` at ``positions (B, L)`` (default
    ``arange(L)`` per row) → the final normed hidden states, and with
    ``collect_states`` the per-position recurrent snapshots stacked over
    layers, ``{"conv": (nl, B, L, K-1, c), "ssm": (nl, B, L, h, p, n)}``
    (else ``None``).  ``cache_pos`` is the attention's: a host int at
    prefill, ``(B,)`` at decode.  ``cache=None`` is the training route
    (:func:`_scan_run`, plain attention)."""
    x = L.embed(params["embed"], inputs, cfg.embed_scale)
    if positions is None:
        B, Lq = inputs.shape
        positions = torch.arange(Lq, device=x.device)[None].expand(B, Lq)
    slots = shared_slots(cfg)
    ssm = kv = None
    if cache is not None:
        ssm, kv = cache["ssm"], cache.get("kv")
    conv_seq: list = []
    ssm_seq: list = []
    for lo, hi in _runs(cfg):
        if lo in slots:
            s = slots.index(lo)
            sp = params["shared"]
            h = L.rmsnorm(sp["ln_attn"], x, cfg.norm_eps)
            # every leaf of the KV is stacked over the shared slots
            layer_kv = (None if kv is None else
                        {name: leaf[s] for name, leaf in kv.items()})
            attn_out, _ = attention(sp["attn"], cfg, h, positions, layer_kv,
                                    cache_pos, sparsity=cfg.attn_sparsity)
            x = x + attn_out
            h = L.rmsnorm(sp["ln_mlp"], x, cfg.norm_eps)
            x = x + L.mlp(sp["mlp"], h, sparsity=cfg.mlp_sparsity)
        if cache is None:
            x = _scan_run(params["mamba"][lo:hi], cfg, x, cfg.remat)
            continue
        for l in range(lo, hi):
            p = params["mamba"][l]
            h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
            out, new = mamba_block(p, cfg, h, cache={"conv": ssm["conv"][l],
                                                     "ssm": ssm["ssm"][l]},
                                   sparsity=cfg.mlp_sparsity,
                                   collect_states=collect_states)
            x = x + out
            if collect_states:
                conv_seq.append(new["conv_seq"])
                ssm_seq.append(new["ssm_seq"])
    snaps = ({"conv": torch.stack(conv_seq), "ssm": torch.stack(ssm_seq)}
             if collect_states else None)
    return L.rmsnorm(params["ln_final"], x, cfg.norm_eps), snaps


def hybrid_apply(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 last_only: bool = False
                 ) -> Tuple[torch.Tensor, None, torch.Tensor]:
    """Cache-less forward → (fp32 logits ``(B, L|1, vocab_padded)``,
    ``None`` (no cache), a zero aux), the contract of ``lm_apply``."""
    x, _ = hybrid_hidden(params, cfg, inputs, positions)
    if last_only:
        x = x[:, -1:]
    return (L.unembed(_head(params), x, cfg.final_softcap), None,
            torch.zeros((), dtype=torch.float32, device=x.device))


def hybrid_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE through the vocab-chunked logsumexp
    (``transformer.chunked_ce``)."""
    x, _ = hybrid_hidden(params, cfg, tokens)
    return chunked_ce(x, _head(params), labels, cfg)


def _head(params: Params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def hybrid_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: Params) -> Tuple[torch.Tensor, Params]:
    """Fill the cache from the prompt ``(B, L)`` — the recurrent state is
    seeded from the cache's (a blank cache: zero) — and return the last
    position's fp32 logits ``(B, vocab_padded)``."""
    B, Lq = tokens.shape
    positions = torch.arange(Lq, device=tokens.device)[None].expand(B, Lq)
    x, _ = hybrid_hidden(params, cfg, tokens, positions, cache, 0)
    return L.unembed(_head(params), x[:, -1], cfg.final_softcap), cache


def hybrid_decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                       cache: Params, pos: torch.Tensor
                       ) -> Tuple[torch.Tensor, Params]:
    """``token (B,)`` at per-slot ``pos (B,)`` → next-token fp32 logits
    ``(B, vocab_padded)``; the O(1) recurrent update in every layer."""
    x, _ = hybrid_hidden(params, cfg, token[:, None], pos[:, None], cache,
                         pos)
    return L.unembed(_head(params), x[:, 0], cfg.final_softcap), cache


def hybrid_decode_block(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, cache: Params,
                        pos: torch.Tensor, collect: bool = False
                        ) -> Tuple[torch.Tensor, Params, Optional[Params]]:
    """The speculative verify step: ``tokens (B, T)`` at per-slot
    positions ``pos (B,)`` → fp32 logits ``(B, T, vocab_padded)``, the
    cache and, with ``collect``, the state after each block position
    ``{"conv": (nl, B, T, K-1, c), "ssm": (nl, B, T, h, p, n)}`` (else
    ``None``): KV rolls back by position masking, the recurrent state by
    selecting a snapshot."""
    T = tokens.shape[1]
    positions = pos[:, None] + torch.arange(T, device=tokens.device)
    x, snaps = hybrid_hidden(params, cfg, tokens, positions, cache, pos,
                             collect_states=collect)
    return L.unembed(_head(params), x, cfg.final_softcap), cache, snaps
