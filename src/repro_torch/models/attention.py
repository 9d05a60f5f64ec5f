"""GQA attention with a KV cache — qk-norm, rope, and the two cache
layouts of the JAX package:

  * monolithic — ``{"k": (B, S, Hk, D), "v": ...}`` per layer;
  * paged — ``{"kp": (P, ps, Hk, D), "vp": ..., "ptab": (B, max_pages)}``:
    a shared page pool plus a per-slot page table.  Page 0 is the null
    page: unallocated table entries point at it, writes from dead slots
    land in it, and the length mask keeps reads from attending to it.

Caches are updated in place (the JAX version returns new arrays; the
port writes the new rows into the same storage and returns it).

Which kernel runs where:

  * prefill (``cache_pos = 0``, Lq == Lk == prompt rows) calls the flash
    kernel on the freshly projected k/v, rounded to the cache dtype as
    the cache read would round them — equal to the JAX masked view of
    the cache because every row past the prompt is masked;
  * paged decode calls the paged-attention kernel with
    ``lens = pos + 1`` over the page-table view, instead of JAX's
    gathered view;
  * monolithic decode is plain masked attention over the cache (as the
    JAX ``_sdpa`` does).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_linear import (DENSE, SparsityConfig,
                                            apply_linear, init_linear)
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, dtype: torch.dtype,
                   generator: torch.Generator, device) -> Params:
    d = cfg.d_model
    p = {"wq": init_linear(d, cfg.q_dim, dtype, generator, device),
         "wk": init_linear(d, cfg.kv_dim, dtype, generator, device),
         "wv": init_linear(d, cfg.kv_dim, dtype, generator, device),
         "wo": init_linear(cfg.q_dim, d, dtype, generator, device)}
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(cfg.head_dim, device)
        p["k_norm"] = L.init_rmsnorm(cfg.head_dim, device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype: torch.dtype = torch.bfloat16, device) -> Params:
    """Stacked-over-layers monolithic cache ``(nl, B, S, Hk, D)``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_max_pages(max_len: int, page_size: int) -> int:
    """Logical pages per slot covering a ``max_len`` sequence."""
    return -(-max_len // page_size)


def init_paged_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                        page_size: int, num_pages: int = 0, *,
                        dtype: torch.dtype = torch.bfloat16,
                        device) -> Params:
    """Paged cache: pool ``(nl, num_pages + 1, ps, Hk, D)`` (page 0 is
    the null page) and an all-null table ``(nl, B, max_pages)``.
    ``num_pages=0`` sizes the pool at full capacity."""
    mp = paged_max_pages(max_len, page_size)
    if num_pages <= 0:
        num_pages = batch * mp
    pool = (cfg.n_layers, num_pages + 1, page_size, cfg.n_kv_heads,
            cfg.head_dim)
    return {"kp": torch.zeros(pool, dtype=dtype, device=device),
            "vp": torch.zeros(pool, dtype=dtype, device=device),
            "ptab": torch.zeros((cfg.n_layers, batch, mp), dtype=torch.int32,
                                device=device)}


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 sparsity: SparsityConfig):
    """x (B, L, d) → q (B, L, H, D), k/v (B, L, Hk, D)."""
    B, Lq, _ = x.shape
    q = apply_linear(x, params["wq"], sparsity)
    k = apply_linear(x, params["wk"], sparsity)
    v = apply_linear(x, params["wv"], sparsity)
    q = q.reshape(B, Lq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, Lq, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Lq, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _sdpa_cache(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, kv_len: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """Plain masked attention of ``q (B, Lq, H, D)`` over a whole cache
    ``(B, S, Hk, D)`` with per-slot valid lengths ``kv_len (B,)`` — the
    JAX ``_sdpa`` in fp32, for monolithic decode."""
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qh = q.transpose(1, 2).reshape(B, Hk, g, Lq, D).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh) * D ** -0.5
    if cfg.attn_softcap is not None:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    kvl = kv_len.long()
    qpos = kvl[:, None] - Lq + torch.arange(Lq, device=q.device)  # (B, Lq)
    kpos = torch.arange(Lk, device=q.device)
    mask = (kpos <= qpos[..., None]) & (kpos < kvl[:, None, None])
    if window is not None:
        mask &= kpos > qpos[..., None] - window
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(logits, -1), vh)
    return out.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)


def _flash_prefill(cfg: ModelConfig, q, k, v, cache_dtype, window):
    """Causal attention over the fresh prompt rows; k/v are rounded to
    the cache dtype first, as reading them back from the cache would."""
    kh = k.to(cache_dtype).to(q.dtype).transpose(1, 2).contiguous()
    vh = v.to(cache_dtype).to(q.dtype).transpose(1, 2).contiguous()
    out = dispatch.attention(q.transpose(1, 2).contiguous(), kh, vh,
                             causal=True, window=window,
                             softcap=cfg.attn_softcap)
    return out.transpose(1, 2)


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: Params, cache_pos, *,
              is_local: bool = False,
              sparsity: SparsityConfig = DENSE
              ) -> Tuple[torch.Tensor, Params]:
    """Project → rope → cache write → attention → out projection.

    ``cache_pos`` is the int ``0`` for prefill (the prompt fills rows
    ``[0, L)``) or a ``(B,)`` tensor of per-slot positions for one-token
    decode.  ``cache`` is this layer's monolithic or paged cache (the
    paged one detected by its ``ptab``); it is written in place and
    returned.
    """
    window = cfg.window_size if is_local else None
    q, k, v = _project_qkv(params, cfg, x, sparsity)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    B, Lq = x.shape[0], x.shape[1]
    prefill = isinstance(cache_pos, int)
    if prefill and cache_pos != 0:
        raise NotImplementedError(
            "prefill at a nonzero offset (prefix sharing, speculation) is "
            "not ported yet (ROADMAP queue 1 items 8-9)")
    if not prefill and Lq != 1:
        raise NotImplementedError(
            "multi-token decode blocks are not ported yet (ROADMAP queue 1 "
            "item 9)")

    if "ptab" in cache:
        kp, vp, pt = cache["kp"], cache["vp"], cache["ptab"]
        ps, n_view = kp.shape[1], pt.shape[1]
        posn = (torch.arange(Lq, device=x.device)[None].expand(B, Lq)
                if prefill else cache_pos[:, None].long())
        pages = pt.gather(1, (posn // ps).clamp(0, n_view - 1)).long()
        offs = posn % ps
        kp[pages, offs] = k.to(kp.dtype)
        vp[pages, offs] = v.to(vp.dtype)
        if prefill:
            out = _flash_prefill(cfg, q, k, v, kp.dtype, window)
        else:
            if cfg.attn_softcap is not None or window is not None:
                raise NotImplementedError(
                    "paged decode with softcap or a sliding window is not "
                    "ported yet (ROADMAP queue 2 item 2)")
            lens = (cache_pos + 1).clamp(max=n_view * ps).to(torch.int32)
            out = dispatch.paged_attention(
                q[:, 0].contiguous(), PagedKV(kp, vp, pt, lens))[:, None]
    else:
        ck, cv = cache["k"], cache["v"]
        if prefill:
            ck[:, :Lq] = k.to(ck.dtype)
            cv[:, :Lq] = v.to(cv.dtype)
            out = _flash_prefill(cfg, q, k, v, ck.dtype, window)
        else:
            rows = torch.arange(B, device=x.device)
            ck[rows, cache_pos.long()] = k[:, 0].to(ck.dtype)
            cv[rows, cache_pos.long()] = v[:, 0].to(cv.dtype)
            out = _sdpa_cache(cfg, q, ck, cv, cache_pos + 1, window)

    out = apply_linear(out.reshape(B, Lq, cfg.q_dim), params["wo"], sparsity)
    return out, cache
