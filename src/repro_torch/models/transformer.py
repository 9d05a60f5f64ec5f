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

Training runs without a cache: :func:`lm_hidden` → :func:`chunked_ce`
(:func:`lm_loss`), or :func:`lm_apply` for logits.  Its attention is the
plain fp32 route (``attention(cache=None)``), its MoE blocks return
their load-balancing aux term, and under ``cfg.remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``), as the JAX
package checkpoints its scanned layer body.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparse_linear import pack_params
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.attention import NEG_INF, attention, init_attention
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
          positions: torch.Tensor, kind: int, cache: Optional[Params],
          cache_pos) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``,
    the MoE block in place of the MLP under ``cfg.n_experts``; under
    ``cfg.post_norm`` each sub-block's output is normed again before its
    residual add.  Returns ``(x, aux)``: the MoE block's load-balancing
    term, ``None`` for a dense MLP.  ``cache=None`` is the training
    route (plain attention)."""
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    attn_out, _ = attention(p["attn"], cfg, h, positions, cache, cache_pos,
                            is_local=kind == int(LayerKind.ATTN_LOCAL),
                            sparsity=cfg.attn_sparsity)
    if cfg.post_norm:
        attn_out = L.rmsnorm(p["ln_attn_post"], attn_out, cfg.norm_eps)
    x = x + attn_out
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    aux = None
    if cfg.n_experts:
        mlp_out, aux = M.moe_block(p["moe"], cfg, h)
    else:
        mlp_out = L.mlp(p["mlp"], h, sparsity=cfg.mlp_sparsity)
    if cfg.post_norm:
        mlp_out = L.rmsnorm(p["ln_mlp_post"], mlp_out, cfg.norm_eps)
    return x + mlp_out, aux


def _embed(params: Params, cfg: ModelConfig, inputs: torch.Tensor
           ) -> torch.Tensor:
    """Tokens ``(B, L)``, or embeds ``(B, L, d)`` when ``cfg.input_mode
    == "embeds"`` (cast to the model dtype)."""
    if cfg.input_mode == "embeds" and inputs.dim() == 3:
        return inputs.to(L.DTYPES[cfg.dtype])
    return L.embed(params["embed"], inputs, cfg.embed_scale)


def _forward(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
             positions: torch.Tensor, cache: Params, cache_pos
             ) -> torch.Tensor:
    """The trunk over a serving cache: ``inputs`` as :func:`_embed`
    takes them, ``positions (B, L)``, broadcast to triples under
    M-RoPE."""
    x = _embed(params, cfg, inputs)
    if cfg.mrope_sections is not None:
        positions = positions[..., None].expand(*positions.shape, 3)
    for l, p in enumerate(params["layers"]):
        x, _ = block(p, cfg, x, positions, cfg.layer_kinds[l],
                     _layer_cache(cache, l), cache_pos)
    return L.rmsnorm(params["ln_final"], x, cfg.norm_eps)


def lm_hidden(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
              positions: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-less trunk (training): ``inputs`` → (final normed
    hidden states, the layers' summed MoE aux, fp32, 0 without experts).
    ``positions`` default to ``arange(L)`` per row, as triples under
    M-RoPE."""
    x = _embed(params, cfg, inputs)
    B, Lq = x.shape[:2]
    if positions is None:
        positions = torch.arange(Lq, device=x.device)[None].expand(B, Lq)
    if cfg.mrope_sections is not None and positions.dim() == 2:
        positions = positions[..., None].expand(B, Lq, 3)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, p in enumerate(params["layers"]):
        x, a = L.maybe_remat(cfg.remat, block, p, cfg, x, positions,
                             cfg.layer_kinds[l], None, None)
        if a is not None:
            aux = aux + a
    return L.rmsnorm(params["ln_final"], x, cfg.norm_eps), aux


def lm_apply(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
             positions: Optional[torch.Tensor] = None,
             last_only: bool = False
             ) -> Tuple[torch.Tensor, None, torch.Tensor]:
    """Cache-less forward → (fp32 logits ``(B, L|1, vocab_padded)``,
    ``None`` (no cache), aux); ``last_only`` unembeds the last position
    only."""
    x, aux = lm_hidden(params, cfg, inputs, positions)
    if last_only:
        x = x[:, -1:]
    return L.unembed(head(params), x, cfg.final_softcap), None, aux


def lm_logits(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training-mode forward (no cache)."""
    return lm_apply(params, cfg, inputs, positions)[0]


def _ce_chunk(x32: torch.Tensor, tb: torch.Tensor, labels: torch.Tensor,
              m_run: torch.Tensor, l_run: torch.Tensor,
              lab_logit: torch.Tensor, lo: int, vocab: int,
              softcap: Optional[float]):
    """One vocab chunk of :func:`chunked_ce`: the chunk's logits, the
    padding masked, folded into the running logsumexp and the label's
    logit."""
    chunk = tb.shape[0]
    s = torch.einsum("bld,vd->blv", x32, tb.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    valid = (lo + torch.arange(chunk, device=s.device)) < vocab
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m_run, s.amax(-1))
    l_new = l_run * torch.exp(m_run - m_new) + torch.exp(
        s - m_new[..., None]).sum(-1)
    in_chunk = (labels >= lo) & (labels < lo + chunk)
    idx = (labels.long() - lo).clamp(0, chunk - 1)
    got = s.gather(-1, idx[..., None])[..., 0]
    return m_new, l_new, torch.where(in_chunk, got, lab_logit)


def chunked_ce(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               cfg: ModelConfig, chunk: int = 16384) -> torch.Tensor:
    """Mean next-token CE from hidden states ``x (B, L, d)`` without a
    ``(B, L, V)`` logits tensor: the unembedding streams in vocab chunks
    with an online logsumexp, the vocab padding masked, each chunk
    recomputed in the backward (so only ``(B, L, chunk)`` logits are ever
    alive), as the JAX ``chunked_ce`` checkpoints its step.  A ``chunk``
    that does not divide ``V`` becomes the largest divisor of ``V`` below
    it."""
    B, Lq, d = x.shape
    V = table.shape[0]
    if V % chunk:
        nc_min = max(1, -(-V // chunk))
        chunk = next((V // nc for nc in range(nc_min, V + 1) if V % nc == 0),
                     V)
    x32 = x.float()
    dev = x.device
    m = torch.full((B, Lq), NEG_INF, device=dev)
    lsum = torch.zeros((B, Lq), device=dev)
    lab = torch.full((B, Lq), NEG_INF, device=dev)
    for lo in range(0, V, chunk):
        m, lsum, lab = checkpoint(
            _ce_chunk, x32, table[lo:lo + chunk], labels, m, lsum, lab, lo,
            cfg.vocab_size, cfg.final_softcap, use_reentrant=False)
    return ((m + torch.log(lsum)) - lab).mean()


def lm_loss(params: Params, cfg: ModelConfig, inputs: torch.Tensor,
            labels: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy (+ ``aux_weight`` × the MoE aux),
    padding masked; ``inputs`` as :func:`lm_hidden` takes them."""
    x, aux = lm_hidden(params, cfg, inputs)
    return chunked_ce(x, head(params), labels, cfg) + aux_weight * aux


def mask_vocab_padding(logits: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        >= cfg.vocab_size
    return torch.where(pad, NEG_INF, logits)


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
