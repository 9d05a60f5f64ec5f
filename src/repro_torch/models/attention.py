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
  * a suffix prefill at a host offset ``cache_pos = start > 0`` (prefix
    sharing, paged cache only) calls the flash kernel with the ``L``
    new queries over the ``start + L`` keys gathered back from the
    slot's pages in the cache dtype — the rows the JAX ``_sdpa`` reads
    at ``kv_len = start + L``;
  * paged decode of ``Lq`` tokens per slot at per-slot positions ``pos``
    (one token, or the speculative verify block) writes rows ``pos +
    [0, Lq)`` through the page table and calls the paged-attention
    kernel with ``lens = pos + Lq`` over the page-table view, instead of
    JAX's gathered view (the kernel's query ``i`` sees the keys before
    ``lens - (Lq - 1 - i)`` and before the view's end, as that view
    does, and on a local layer only the last ``window_size`` of them);
  * every route takes the layer's sliding window (a local layer) and
    the config's ``attn_softcap`` (gemma);
  * monolithic decode writes the ``Lq`` rows at each slot's own ``pos``
    (the start clamped so the block fits, as ``dynamic_update_slice``
    clamps it) and is plain masked attention over the cache with
    ``kv_len = pos + Lq`` (as the JAX ``_sdpa`` does);
  * :func:`bidirectional_attention` (no cache: an encoder's attention)
    calls the flash kernel with ``causal=False``;
  * :func:`cross_attention` over a source's cached keys and values calls
    the flash kernel non-causal for a prompt's rows, and is plain
    unmasked fp32 attention at decode (as the JAX ``_sdpa`` over the
    cross cache);
  * without a cache (``cache=None``: training and the teacher-forced
    forward) :func:`attention` is the JAX ``_sdpa`` in plain fp32 on any
    device, causal or not, over ``x`` or over a ``cross_src``: no kernel
    runs, since the kernels have no backward.
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
                        n_layers: Optional[int] = None,
                        dtype: torch.dtype = torch.bfloat16,
                        device) -> Params:
    """Paged cache: pool ``(nl, num_pages + 1, ps, Hk, D)`` (page 0 is
    the null page) and an all-null table ``(nl, B, max_pages)``, ``nl``
    = ``n_layers`` (default ``cfg.n_layers``).  ``num_pages=0`` sizes the
    pool at full capacity."""
    nl = n_layers if n_layers is not None else cfg.n_layers
    mp = paged_max_pages(max_len, page_size)
    if num_pages <= 0:
        num_pages = batch * mp
    pool = (nl, num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(pool, dtype=dtype, device=device),
            "vp": torch.zeros(pool, dtype=dtype, device=device),
            "ptab": torch.zeros((nl, batch, mp), dtype=torch.int32,
                                device=device)}


def _project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 sparsity: SparsityConfig,
                 kv_src: Optional[torch.Tensor] = None):
    """x (B, L, d) → q (B, L, H, D), k/v (B, Lk, Hk, D) from ``kv_src``
    (default ``x``)."""
    B, Lq, _ = x.shape
    src = x if kv_src is None else kv_src
    Lk = src.shape[1]
    q = apply_linear(x, params["wq"], sparsity)
    k = apply_linear(src, params["wk"], sparsity)
    v = apply_linear(src, params["wv"], sparsity)
    q = q.reshape(B, Lq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, Lk, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, Lk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _sdpa_cache(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, kv_len: Optional[torch.Tensor],
                window: Optional[int]) -> torch.Tensor:
    """Plain masked attention of ``q (B, Lq, H, D)`` over a whole cache
    ``(B, S, Hk, D)`` with per-slot valid lengths ``kv_len (B,)`` — the
    JAX ``_sdpa`` in fp32, for monolithic decode.  ``kv_len=None`` masks
    nothing: every row is valid and every query sees it (cross-attention
    over a source)."""
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qh = q.transpose(1, 2).reshape(B, Hk, g, Lq, D).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh) * D ** -0.5
    if cfg.attn_softcap is not None:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    if kv_len is not None:
        kvl = kv_len.long()
        qpos = kvl[:, None] - Lq + torch.arange(Lq, device=q.device)
        kpos = torch.arange(Lk, device=q.device)
        mask = (kpos <= qpos[..., None]) & (kpos < kvl[:, None, None])
        if window is not None:
            mask &= kpos > qpos[..., None] - window
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(logits, -1), vh)
    return out.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)


#: chunk sizes of :func:`_sdpa`'s online-softmax route (the JAX
#: ``_KV_CHUNK``/``_Q_CHUNK``): keys longer than ``KV_CHUNK`` that it
#: divides are walked in chunks, so the logits are never whole
KV_CHUNK = 2048
Q_CHUNK = 2048


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """``(Lq, Lk)`` reachability of keys at ``kpos`` from queries at
    ``qpos``."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos[:, None]
    if window is not None:
        mask &= kpos > qpos[:, None] - window
    return mask


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor, *, causal: bool, window: Optional[int]
          ) -> torch.Tensor:
    """The cache-less attention of the JAX ``_sdpa`` in plain fp32:
    ``q (B, Lq, H, D)`` over ``k/v (B, Lk, Hk, D)`` → ``(B, Lq, H, D)`` in
    ``q``'s dtype, queries at positions ``Lk - Lq + [0, Lq)``.  Whole
    logits (:func:`_sdpa_cache` over all ``Lk`` keys) unless ``Lk >
    KV_CHUNK`` divides by it: then the keys are walked in chunks with an
    online softmax (queries in ``Q_CHUNK`` blocks where that divides), as
    JAX walks them."""
    if window is not None and not causal:
        raise ValueError("a sliding window is causal here: no layer of the "
                         "port attends bidirectionally within a window")
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    if Lk <= KV_CHUNK or Lk % KV_CHUNK:
        kv_len = torch.full((B,), Lk, device=q.device) if causal else None
        return _sdpa_cache(cfg, q, k, v, kv_len, window)
    g = H // Hk
    dev = q.device
    qh = q.transpose(1, 2).reshape(B, Hk, g, Lq, D).float()
    kh = k.transpose(1, 2).float()                       # (B, Hk, Lk, D)
    vh = v.transpose(1, 2).float()
    qpos = torch.arange(Lq, device=dev) + (Lk - Lq)
    qc = Lq if (Lq <= Q_CHUNK or Lq % Q_CHUNK) else Q_CHUNK
    blocks = []
    for q0 in range(0, Lq, qc):
        qb = qh[..., q0:q0 + qc, :]
        m_run = torch.full((B, Hk, g, qc, 1), NEG_INF, device=dev)
        l_run = torch.zeros((B, Hk, g, qc, 1), device=dev)
        acc = torch.zeros((B, Hk, g, qc, D), device=dev)
        for k0 in range(0, Lk, KV_CHUNK):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                             kh[:, :, k0:k0 + KV_CHUNK]) * D ** -0.5
            if cfg.attn_softcap is not None:
                s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
            mask = _mask(qpos[q0:q0 + qc],
                         torch.arange(k0, k0 + KV_CHUNK, device=dev),
                         causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vh[:, :, k0:k0 + KV_CHUNK])
            m_run = m_new
        blocks.append(acc / torch.where(l_run == 0.0, 1.0, l_run))
    out = torch.cat(blocks, dim=3)
    return out.reshape(B, H, Lq, D).transpose(1, 2).to(q.dtype)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """``(B, L, H, D)`` → the kernels' contiguous ``(B, H, L, D)``."""
    return t.transpose(1, 2).contiguous()


def bidirectional_attention(params: Params, cfg: ModelConfig,
                            x: torch.Tensor, positions: torch.Tensor, *,
                            sparsity: SparsityConfig = DENSE
                            ) -> torch.Tensor:
    """Cache-less attention of ``x (B, L, d)`` over itself, every query
    over every key, on the flash kernel (``causal=False``): project →
    rope → attention → out projection.  The encoder's attention, the JAX
    ``attention(..., causal=False)`` without a cache (no window: encoder
    layers are not local)."""
    B, Lq = x.shape[:2]
    q, k, v = _project_qkv(params, cfg, x, sparsity)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    out = dispatch.attention(_heads(q), _heads(k), _heads(v), causal=False,
                             softcap=cfg.attn_softcap)
    return apply_linear(out.transpose(1, 2).reshape(B, Lq, cfg.q_dim),
                        params["wo"], sparsity)


def cross_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, *, kernel: bool,
                    sparsity: SparsityConfig = DENSE) -> torch.Tensor:
    """Attention of ``x (B, Lq, d)`` over a source's cached keys and
    values ``k/v (B, Ls, Hk, D)``: no rope, no mask (every source row is
    valid to every query).  ``kernel`` runs the flash kernel, non-causal,
    on k/v read back in ``x``'s dtype (a prompt's rows at prefill); else
    plain fp32 attention over the cache, the JAX ``_sdpa`` (decode and
    the verify block)."""
    B, Lq = x.shape[:2]
    q = apply_linear(x, params["wq"], sparsity)
    q = q.reshape(B, Lq, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    if kernel:
        out = dispatch.attention(_heads(q), _heads(k.to(q.dtype)),
                                 _heads(v.to(q.dtype)), causal=False,
                                 softcap=cfg.attn_softcap).transpose(1, 2)
    else:
        out = _sdpa_cache(cfg, q, k, v, None, None)
    return apply_linear(out.reshape(B, Lq, cfg.q_dim), params["wo"], sparsity)


def _flash_prefill(cfg: ModelConfig, q, k, v, cache_dtype, window):
    """Causal attention over the fresh prompt rows; k/v are rounded to
    the cache dtype first, as reading them back from the cache would."""
    out = dispatch.attention(_heads(q), _heads(k.to(cache_dtype).to(q.dtype)),
                             _heads(v.to(cache_dtype).to(q.dtype)),
                             causal=True, window=window,
                             softcap=cfg.attn_softcap)
    return out.transpose(1, 2)


def _flash_suffix(cfg: ModelConfig, q, kp, vp, pt, kv_len: int, window):
    """Causal attention of the last ``Lq`` positions over the first
    ``kv_len`` rows of each slot's pages, read back in the cache dtype
    (the shared head and the suffix just written), as the JAX ``_sdpa``
    reads its gathered view."""
    B, ps = q.shape[0], kp.shape[1]
    table = pt[:, :-(-kv_len // ps)].long()

    def view(pool):
        rows = pool[table].reshape(B, -1, *pool.shape[2:])[:, :kv_len]
        return _heads(rows.to(q.dtype))

    out = dispatch.attention(_heads(q), view(kp), view(vp), causal=True,
                             window=window, softcap=cfg.attn_softcap)
    return out.transpose(1, 2)


def _last_writers(rows: torch.Tensor, *vals: torch.Tensor):
    """``vals (B, Lq, ...)`` with each entry replaced by the value of the
    last entry (in ``(B, Lq)`` order) whose pool row ``rows (B, Lq)`` is
    the same.  Frozen slots write their rows to the null page, where they
    may collide; a CUDA scatter keeps any one of the colliding values,
    the CPU's and the JAX scatter the last.  Slots interact only through
    an MoE capacity dispatch, where a frozen slot's route can take a live
    token's place; so the MoE decode writes the last value from every
    colliding entry, and the card keeps what the CPU keeps."""
    flat = rows.reshape(-1)
    n = flat.numel()
    order = torch.arange(n, device=flat.device)
    last = torch.where(flat[:, None] == flat[None, :], order, -1).amax(1)
    return tuple(t.reshape(n, *t.shape[2:])[last].reshape(t.shape)
                 for t in vals)


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[Params] = None,
              cache_pos=None, *, is_local: bool = False,
              cross_src: Optional[torch.Tensor] = None,
              causal: Optional[bool] = None,
              sparsity: SparsityConfig = DENSE
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Project → rope → cache write → attention → out projection.

    ``cache_pos`` is a host int for prefill (the prompt fills rows
    ``[cache_pos, cache_pos + L)``; a nonzero offset needs the paged
    cache) or a ``(B,)`` tensor of per-slot positions for decode: the
    ``L`` tokens of each slot (one, or a verify block) fill rows
    ``[pos, pos + L)``, causal within the block.  ``cache`` is this
    layer's monolithic or paged cache (the paged one detected by its
    ``ptab``); it is written in place and returned.

    ``cache=None`` is the training route, the JAX ``attention`` without
    a cache: plain fp32 :func:`_sdpa` over ``x``'s own keys (``causal``,
    default true) or, with ``cross_src``, over the encoder output's (no
    rope, no mask); returns ``(out, None)``.
    """
    window = cfg.window_size if is_local else None
    if cache is None:
        return _attention_plain(params, cfg, x, positions, window,
                                cross_src, causal, sparsity), None
    q, k, v = _project_qkv(params, cfg, x, sparsity)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    B, Lq = x.shape[0], x.shape[1]
    prefill = isinstance(cache_pos, int)
    if prefill and cache_pos and "ptab" not in cache:
        raise NotImplementedError(
            "prefill at a nonzero host offset needs the paged cache (prefix "
            "sharing shares pages); decode at per-slot offsets takes a "
            "(B,) tensor")

    def rows_from(start: torch.Tensor) -> torch.Tensor:
        """(B, Lq) cache rows of each slot's block from ``start (B,)``."""
        start = start.long()[:, None]
        return start if Lq == 1 else \
            start + torch.arange(Lq, device=x.device)

    if "ptab" in cache:
        kp, vp, pt = cache["kp"], cache["vp"], cache["ptab"]
        ps, n_view = kp.shape[1], pt.shape[1]
        posn = (cache_pos + torch.arange(Lq, device=x.device)[None]
                .expand(B, Lq) if prefill else rows_from(cache_pos))
        pages = pt.gather(1, (posn // ps).clamp(0, n_view - 1)).long()
        offs = posn % ps
        k, v = k.to(kp.dtype), v.to(vp.dtype)
        if cfg.n_experts and not prefill:
            k, v = _last_writers(pages * ps + offs, k, v)
        kp[pages, offs] = k
        vp[pages, offs] = v
        if prefill and cache_pos:
            out = _flash_suffix(cfg, q, kp, vp, pt, cache_pos + Lq, window)
        elif prefill:
            out = _flash_prefill(cfg, q, k, v, kp.dtype, window)
        else:
            kv = PagedKV(kp, vp, pt, (cache_pos + Lq).to(torch.int32))
            kw = dict(window=window, softcap=cfg.attn_softcap)
            if Lq == 1:
                out = dispatch.paged_attention(q[:, 0].contiguous(), kv,
                                               **kw)[:, None]
            else:
                out = dispatch.paged_attention(q.contiguous(), kv, **kw)
    else:
        ck, cv = cache["k"], cache["v"]
        if prefill:
            ck[:, :Lq] = k.to(ck.dtype)
            cv[:, :Lq] = v.to(cv.dtype)
            out = _flash_prefill(cfg, q, k, v, ck.dtype, window)
        else:
            # each slot's Lq rows at its own position, the start clamped
            # so the block fits (a frozen slot near max_len), as the JAX
            # vmap(dynamic_update_slice) clamps it
            rows = rows_from(cache_pos.clamp(max=ck.shape[1] - Lq))
            slots = torch.arange(B, device=x.device)[:, None]
            ck[slots, rows] = k.to(ck.dtype)
            cv[slots, rows] = v.to(cv.dtype)
            out = _sdpa_cache(cfg, q, ck, cv, cache_pos + Lq, window)

    out = apply_linear(out.reshape(B, Lq, cfg.q_dim), params["wo"], sparsity)
    return out, cache


def _attention_plain(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, window: Optional[int],
                     cross_src: Optional[torch.Tensor],
                     causal: Optional[bool], sparsity: SparsityConfig
                     ) -> torch.Tensor:
    """:func:`attention` without a cache (see there)."""
    if causal is None:
        causal = cross_src is None
    q, k, v = _project_qkv(params, cfg, x, sparsity, kv_src=cross_src)
    if cross_src is None:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    out = _sdpa(cfg, q, k, v, causal=causal, window=window)
    B, Lq = x.shape[:2]
    return apply_linear(out.reshape(B, Lq, cfg.q_dim), params["wo"], sparsity)
