"""Model API of the port — the JAX package's serving surface for the
decoder-only ("lm") family.

``init_model`` → ``init_cache`` → ``prefill`` / ``decode_step``, plus the
cache helpers the serving loops use (``blank_slot_cache``,
``merge_cache_slot``, ``set_page_table``, ``page_view``,
``unpage_view``).  Caches are updated in place; the helpers return the
cache for call-site parity with the JAX API.  The hybrid (mamba) and
encoder-decoder families are ROADMAP queue 1 item 11.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import transformer as TR
from repro_torch.models.attention import (init_kv_cache, init_paged_kv_cache,
                                          paged_max_pages)
from repro_torch.models.config import LayerKind, ModelConfig

Params = Dict[str, Any]

__all__ = ["LayerKind", "ModelConfig", "family", "init_model", "init_cache",
           "prefill", "decode_step", "blank_slot_cache", "merge_cache_slot",
           "set_page_table", "page_view", "unpage_view", "paged_max_pages"]


def family(cfg: ModelConfig) -> str:
    if cfg.is_encoder_decoder:
        return "encdec"
    if cfg.uses_mamba:
        return "hybrid"
    return "lm"


def _check_ported(cfg: ModelConfig) -> None:
    f = family(cfg)
    if f != "lm" or cfg.n_experts or not cfg.mlp_gated \
            or not cfg.tie_embeddings or cfg.embed_scale or cfg.post_norm \
            or cfg.mrope_sections is not None or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: only dense gated decoder-only LMs with tied "
            "embeddings are ported (MoE/SSM/enc-dec and the other model "
            "features are ROADMAP queue 1 item 11)")


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> Params:
    """Random params from ``seed`` on ``device`` (a ``torch.Generator``
    on that device draws them)."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TR.init_lm(cfg, gen, device)


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
    """Prompt ``batch["tokens"] (B, L)`` → (last-position logits, cache)."""
    return TR.lm_prefill(params, cfg, batch["tokens"], cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One token per slot in at per-slot ``pos (B,)``, next-token logits
    out."""
    return TR.lm_decode_step(params, cfg, token, cache, pos)


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


def set_page_table(cache: Params, table) -> Params:
    """Copy ``table (B, max_pages)`` (the host allocator's view) into the
    page table of every layer."""
    if _is_paged(cache):
        pt = cache["ptab"]
        pt.copy_(torch.as_tensor(table, dtype=torch.int32)
                 .to(pt.device, non_blocking=True)
                 .reshape(1, *pt.shape[1:]).expand_as(pt))
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
