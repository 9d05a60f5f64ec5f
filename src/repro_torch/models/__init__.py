"""Model API of the port — the JAX package's serving surface for the
decoder-only ("lm") family: gated LMs with a tied or untied head (qwen3,
stablelm), M-RoPE and precomputed-embedding prompts (qwen2-vl), and
routed experts in place of the MLP (qwen2-moe, dbrx; ``models/moe.py``).

``init_model`` → ``init_cache`` → ``prefill`` / ``decode_step`` /
``decode_block``, plus the cache helpers the serving loops use
(``blank_slot_cache``, ``merge_cache_slot``, ``copy_page``,
``set_page_table``, ``page_view``, ``unpage_view``).  Caches are updated
in place; the helpers return the cache for call-site parity with the JAX
API.  The hybrid (mamba) and encoder-decoder families and the gemma
features are ROADMAP queue 1 items 11c-11e.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as TR
from repro_torch.models.attention import (init_kv_cache, init_paged_kv_cache,
                                          paged_max_pages)
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models import moe as MOE

Params = Dict[str, Any]

__all__ = ["LayerKind", "ModelConfig", "family", "expert_rows", "init_model",
           "init_cache", "prefill", "decode_step", "decode_block",
           "blank_slot_cache", "merge_cache_slot", "copy_page",
           "set_page_table", "page_view", "unpage_view", "paged_max_pages"]


def family(cfg: ModelConfig) -> str:
    if cfg.is_encoder_decoder:
        return "encdec"
    if cfg.uses_mamba:
        return "hybrid"
    return "lm"


def expert_rows(cfg: ModelConfig, tokens: int) -> Optional[int]:
    """Rows each routed expert's projections take in a forward of
    ``tokens`` tokens (``None`` without experts)."""
    return MOE.expert_rows(cfg, tokens) if cfg.n_experts else None


def _check_ported(cfg: ModelConfig) -> None:
    f = family(cfg)
    if f != "lm" or not cfg.mlp_gated or cfg.embed_scale \
            or cfg.post_norm or cfg.input_mode not in ("tokens", "embeds"):
        raise NotImplementedError(
            f"{cfg.name}: only gated decoder-only LMs are ported (tied or "
            "untied head, M-RoPE, embeds input, routed experts); SSM/hybrid "
            "is ROADMAP queue 1 item 11c, enc-dec 11d and the gemma features "
            "(post-norms, scaled embeds, ungated MLPs) 11e")


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda",
               packed: bool = False) -> Params:
    """Random params from ``seed`` on ``device`` (a ``torch.Generator``
    on that device draws them); ``packed`` prunes and packs them per
    ``cfg`` layer by layer as they are drawn, for a model whose dense
    weights do not fit the device."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TR.init_lm(cfg, gen, device, packed=packed)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16, page_size: int = 0,
               num_pages: int = 0, device="cuda") -> Params:
    """Serving cache: paged when ``page_size > 0`` (``num_pages``
    allocatable pages plus the null page; 0 → full capacity), else
    monolithic ``(n_layers, batch, max_len, Hk, D)``."""
    _check_ported(cfg)
    device = resolve_device(device)
    if page_size:
        return init_paged_kv_cache(cfg, batch, max_len, page_size, num_pages,
                                   dtype=dtype, device=device)
    return init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prompt ``batch["embeds"] (B, L, d)`` (an ``input_mode="embeds"``
    config) or ``batch["tokens"] (B, L)`` → (last-position logits,
    cache)."""
    return TR.lm_prefill(params, cfg, batch.get("embeds", batch.get("tokens")),
                         cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One token per slot in at per-slot ``pos (B,)``, next-token logits
    out."""
    return TR.lm_decode_step(params, cfg, token, cache, pos)


def decode_block(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: Params, pos) -> Tuple[torch.Tensor, Params]:
    """Multi-token decode-shaped forward of the ``lm`` family — the
    speculative *verify* step: ``tokens (B, T)`` written at per-slot
    positions ``pos (B,)`` (ragged offsets; causal attention within the
    block) on either cache layout and scored in one forward, logits for
    every block position ``(B, T, vocab_padded)``.  A host int ``pos``
    is one offset for every slot (the prefix-sharing suffix prefill, on
    the paged cache)."""
    return TR.lm_decode_block(params, cfg, tokens, cache, pos)


def _is_paged(cache: Params) -> bool:
    return "ptab" in cache


def blank_slot_cache(cache: Params, batch: int = 1) -> Params:
    """The scratch cache a per-slot prefill fills before
    :func:`merge_cache_slot`: a zeroed batch-``batch`` copy (monolithic),
    or the shared pools with an all-null batch-``batch`` table (paged)."""
    if _is_paged(cache):
        nl, _, mp = cache["ptab"].shape
        return {"kp": cache["kp"], "vp": cache["vp"],
                "ptab": torch.zeros((nl, batch, mp), dtype=torch.int32,
                                    device=cache["ptab"].device)}
    return {k: torch.zeros(v.shape[:1] + (batch,) + v.shape[2:],
                           dtype=v.dtype, device=v.device)
            for k, v in cache.items()}


def merge_cache_slot(cache: Params, slot_cache: Params, slot: int) -> Params:
    """Write a batch-1 scratch cache into slot ``slot``: the page-table row
    (paged — the pool writes already landed), or every row (monolithic)."""
    if _is_paged(cache):
        cache["ptab"][:, slot] = slot_cache["ptab"][:, 0]
    else:
        for k in cache:
            cache[k][:, slot] = slot_cache[k][:, 0]
    return cache


def copy_page(cache: Params, src: int, dst: int) -> Params:
    """Copy physical page ``src`` onto ``dst`` in every layer's pools, in
    place: the copy-on-write half of prefix sharing.  Rows past the
    divergence are overwritten by the suffix prefill or masked by the
    slot's length."""
    if _is_paged(cache):
        cache["kp"][:, dst] = cache["kp"][:, src]
        cache["vp"][:, dst] = cache["vp"][:, src]
    return cache


def set_page_table(cache: Params, table) -> Params:
    """Broadcast ``table (B, max_pages)`` into the page table of every
    layer.

    A tensor on the cache's device is copied device to device — what a
    captured decode chunk does with the table the engine staged into a
    device buffer before it.  A host array (the allocator's view) is
    copied to the device first."""
    if _is_paged(cache):
        pt = cache["ptab"]
        if not (isinstance(table, torch.Tensor) and table.device == pt.device):
            table = torch.as_tensor(table, dtype=torch.int32).to(pt.device)
        pt.copy_(table.reshape(1, *pt.shape[1:]).expand_as(pt))
    return cache


def page_view(cache: Params, view_pages: Optional[int]) -> Params:
    """Narrow every page table to its first ``view_pages`` logical pages
    (a view: writes land in the shared pools)."""
    if view_pages is None or not _is_paged(cache):
        return cache
    return {"kp": cache["kp"], "vp": cache["vp"],
            "ptab": cache["ptab"][..., :view_pages]}


def unpage_view(new_cache: Params, full_cache: Params) -> Params:
    """Undo :func:`page_view`: the pools were updated in place, so the
    full cache is already current."""
    return full_cache
