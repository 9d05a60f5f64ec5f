"""Model API of the port — the JAX package's serving surface for three
families:

  * ``"lm"``: gated decoder-only LMs with a tied or untied head (qwen3,
    stablelm), M-RoPE and precomputed-embedding prompts (qwen2-vl),
    routed experts in place of the MLP (qwen2-moe, dbrx;
    ``models/moe.py``), and gemma's local/global layers with sliding
    windows, softcaps, post-norms and scaled embeds (gemma2, gemma3);
  * ``"hybrid"``: the Mamba-2 trunk with or without zamba2's shared
    attention block (mamba2, zamba2; ``models/hybrid.py``,
    ``models/ssm.py``), whose cache is ``{"ssm": {"conv", "ssm"}, "kv":
    ...}`` (no ``"kv"`` for mamba2);
  * ``"encdec"``: the encoder-decoder backbone of seamless-m4t
    (``models/encdec.py``), whose cache is ``{"self": ..., "cross":
    {"k", "v"}}`` and whose ``prefill`` takes the source frames as
    ``batch["src"]``, or a null (all-zero) source sized to the cross
    cache when the batch holds tokens only (what the ``Engine`` feeds).

``abstract_model`` and ``abstract_cache`` build the same trees on
``meta`` without drawing a number (the counterpart of
``jax.eval_shape(init_model)``, what the dry run lowers).

``init_model`` → ``init_cache`` → ``prefill`` / ``decode_step`` /
``decode_block``, plus the cache helpers the serving loops use
(``blank_slot_cache``, ``merge_cache_slot``, ``copy_page``,
``set_page_table``, ``page_view``, ``unpage_view``), which recurse over
nested caches as the JAX ones do, and the recurrent-state helpers of
speculative rollback (``recurrent_state``, ``set_recurrent_state``,
``select_recurrent``, ``where_slot``).  Caches are updated in place; the
helpers return the cache for call-site parity with the JAX API.

Training speaks :func:`model_loss` and :func:`model_logits` over the
batches of ``data.pipeline`` (``{"tokens", "labels"}``, ``{"embeds",
"labels"}`` or ``{"src", "tokens", "labels"}``): the cache-less forward
of each family, whose attention is plain PyTorch on every device, so
autograd differentiates it and no kernel runs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.sparse_linear import sparsify_abstract
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as TR
from repro_torch.models.attention import (init_kv_cache, init_paged_kv_cache,
                                          paged_max_pages)
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models import moe as MOE

Params = Dict[str, Any]

__all__ = ["LayerKind", "ModelConfig", "family", "expert_rows", "init_model",
           "abstract_model", "abstract_cache",
           "model_loss", "model_logits", "init_cache", "prefill", "decode_step", "decode_block",
           "blank_slot_cache", "merge_cache_slot", "copy_page",
           "set_page_table", "page_view", "unpage_view", "paged_max_pages",
           "recurrent_state", "set_recurrent_state", "select_recurrent",
           "where_slot", "cache_leaves"]


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
    if f == "encdec":
        # seamless: an ungated MLP, frames into the encoder
        ok = not cfg.mlp_gated and cfg.input_mode == "embeds"
    else:
        ok = cfg.mlp_gated and cfg.input_mode in ("tokens", "embeds") \
            and (f != "hybrid" or cfg.input_mode == "tokens")
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: only gated decoder-only LMs (tied or untied head, "
            "M-RoPE, embeds input, routed experts, gemma's features), the "
            "SSM/hybrid family and the ungated enc-dec family are ported")


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
    return _init_model(cfg, gen, device, packed)


def _init_model(cfg: ModelConfig, gen: torch.Generator, device,
                packed: bool) -> Params:
    if family(cfg) == "encdec":
        return ED.init_encdec(cfg, gen, device, packed=packed)
    if family(cfg) == "hybrid":
        return HY.init_hybrid_lm(cfg, gen, device, packed=packed)
    return TR.init_lm(cfg, gen, device, packed=packed)


def abstract_model(cfg: ModelConfig, *, packed: bool = False) -> Params:
    """:func:`init_model`'s tree on ``meta``: every tensor's shape and
    dtype, no storage, no number drawn (a ``meta`` tensor takes a CPU
    generator and reads nothing from it).  ``packed`` replaces the
    governed weights by ``core.sparse_linear.sparsify_abstract``'s packs
    at the nominal density: the layout ``init_model(packed=True)``
    gives."""
    _check_ported(cfg)
    device = resolve_device("meta", allow_meta=True)
    params = _init_model(cfg, torch.Generator(), device, packed=False)
    return sparsify_abstract(params, cfg) if packed else params


def model_loss(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor],
               aux_weight: float = 0.01) -> torch.Tensor:
    """The family's mean next-token cross-entropy on ``batch`` (the lm
    family's plus ``aux_weight`` times its MoE load-balancing term)."""
    f = family(cfg)
    if f == "encdec":
        return ED.encdec_loss(params, cfg, batch["src"], batch["tokens"],
                              batch["labels"])
    if f == "hybrid":
        return HY.hybrid_loss(params, cfg, batch["tokens"], batch["labels"])
    return TR.lm_loss(params, cfg, batch.get("embeds", batch.get("tokens")),
                      batch["labels"], aux_weight)


def model_logits(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The family's cache-less fp32 logits ``(B, L, vocab_padded)``."""
    f = family(cfg)
    if f == "encdec":
        return ED.encdec_apply(params, cfg, batch["src"], batch["tokens"])
    if f == "hybrid":
        return HY.hybrid_apply(params, cfg, batch["tokens"])[0]
    return TR.lm_apply(params, cfg, batch.get("embeds",
                                              batch.get("tokens")))[0]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               src_len: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16, page_size: int = 0,
               num_pages: int = 0, device="cuda") -> Params:
    """Serving cache: paged when ``page_size > 0`` (``num_pages``
    allocatable pages plus the null page; 0 → full capacity), else
    monolithic ``(n_layers, batch, max_len, Hk, D)``.  The hybrid
    family's is ``{"ssm": ..., "kv": ...}``: the fp32 recurrent state of
    every layer and the KV of the shared slots only
    (``hybrid.init_hybrid_cache``).  The enc-dec family's is ``{"self":
    ..., "cross": ...}``: the decoder's self KV (paged or not) and the
    monolithic cross K/V of ``src_len`` source rows (default
    ``max_len``, what the ``Engine`` serves)."""
    _check_ported(cfg)
    return _init_cache(cfg, batch, max_len, src_len, dtype, page_size,
                       num_pages, resolve_device(device))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   src_len: Optional[int] = None,
                   dtype: torch.dtype = torch.bfloat16, page_size: int = 0,
                   num_pages: int = 0) -> Params:
    """:func:`init_cache`'s tree on ``meta`` (shapes and dtypes only)."""
    _check_ported(cfg)
    return _init_cache(cfg, batch, max_len, src_len, dtype, page_size,
                       num_pages, resolve_device("meta", allow_meta=True))


def _init_cache(cfg, batch, max_len, src_len, dtype, page_size, num_pages,
                device) -> Params:
    if family(cfg) == "encdec":
        return ED.init_encdec_cache(cfg, batch, max_len, src_len or max_len,
                                    dtype=dtype, page_size=page_size,
                                    num_pages=num_pages, device=device)
    if family(cfg) == "hybrid":
        return HY.init_hybrid_cache(cfg, batch, max_len, dtype=dtype,
                                    page_size=page_size, num_pages=num_pages,
                                    device=device)
    if page_size:
        return init_paged_kv_cache(cfg, batch, max_len, page_size, num_pages,
                                   dtype=dtype, device=device)
    return init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Prompt ``batch["embeds"] (B, L, d)`` (an ``input_mode="embeds"``
    config) or ``batch["tokens"] (B, L)`` → (last-position logits,
    cache).  The enc-dec family encodes ``batch["src"] (B, src_len, d)``
    and prefills the decoder with ``batch["tokens"]``; without a
    ``"src"`` (the ``Engine``'s token prompts) it encodes the JAX
    package's null source, zeros sized to the cross cache."""
    if family(cfg) == "encdec":
        src = batch.get("src")
        if src is None:
            ck = cache["cross"]["k"]
            src = torch.zeros((batch["tokens"].shape[0], ck.shape[2],
                               cfg.d_model), dtype=ck.dtype, device=ck.device)
        return ED.encdec_prefill(params, cfg, src, batch["tokens"], cache)
    if family(cfg) == "hybrid":
        return HY.hybrid_prefill(params, cfg, batch["tokens"], cache)
    return TR.lm_prefill(params, cfg, batch.get("embeds", batch.get("tokens")),
                         cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One token per slot in at per-slot ``pos (B,)``, next-token logits
    out."""
    if family(cfg) == "encdec":
        return ED.encdec_decode_step(params, cfg, token, cache, pos)
    if family(cfg) == "hybrid":
        return HY.hybrid_decode_step(params, cfg, token, cache, pos)
    return TR.lm_decode_step(params, cfg, token, cache, pos)


def decode_block(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: Params, pos, collect_states: bool = False):
    """Multi-token decode-shaped forward — the speculative *verify* step:
    ``tokens (B, T)`` written at per-slot positions ``pos (B,)`` (ragged
    offsets; causal attention within the block) on either cache layout
    and scored in one forward, logits for every block position ``(B, T,
    vocab_padded)``.  A host int ``pos`` is one offset for every slot
    (the prefix-sharing suffix prefill of the ``lm`` family, on the paged
    cache).

    Returns ``(logits, cache)``; with ``collect_states``, ``(logits,
    cache, snapshots)``: ``None`` for the ``lm`` and ``encdec`` families
    (their rollback is position masking), and for the hybrid family the
    recurrent state after each block position (:func:`select_recurrent`).
    """
    snaps = None
    if family(cfg) == "encdec":
        logits, cache = ED.encdec_decode_block(params, cfg, tokens, cache,
                                               pos)
    elif family(cfg) == "hybrid":
        logits, cache, snaps = HY.hybrid_decode_block(
            params, cfg, tokens, cache, pos, collect=collect_states)
    else:
        logits, cache = TR.lm_decode_block(params, cfg, tokens, cache, pos)
    return (logits, cache, snaps) if collect_states else (logits, cache)


# --- recurrent (non-positional) cache state -------------------------------
#
# KV caches roll back by position: rows past a slot's position are dead
# by masking.  The hybrid family's conv/SSM state is order-dependent:
# these helpers snapshot it before a drafted block, restore it for the
# verify forward and select the snapshot of the accepted prefix after.

def recurrent_state(cache: Params) -> Optional[Params]:
    """The order-dependent part of a serving cache, ``{"conv", "ssm"}``
    (the cache's own tensors), or ``None`` for a purely positional
    family."""
    if isinstance(cache, dict) and "ssm" in cache:
        return cache["ssm"]
    return None


def set_recurrent_state(cache: Params, state: Optional[Params]) -> Params:
    """Copy ``state`` into the cache's recurrent tensors, in place."""
    if state is not None:
        for k, t in cache["ssm"].items():
            t.copy_(state[k])
    return cache


def select_recurrent(snapshots: Params, idx: torch.Tensor) -> Params:
    """Per-slot snapshots: leaves ``(nl, B, T, ...)`` × ``idx (B,)`` →
    ``(nl, B, ...)``, the state after block position ``idx[b]``."""
    def pick(leaf):
        slots = torch.arange(leaf.shape[1], device=leaf.device)
        return leaf[:, slots, idx.long()]

    return {k: pick(v) for k, v in snapshots.items()}


def where_slot(mask: torch.Tensor, a: Params, b: Params) -> Params:
    """Per-slot select between two state trees whose leaves carry the
    batch on axis 1: slot ``i`` takes ``a`` where ``mask[i]``, else
    ``b``."""
    def sel(la, lb):
        return torch.where(mask.reshape((1, -1) + (1,) * (la.dim() - 2)),
                           la, lb)

    return {k: sel(a[k], b[k]) for k in a}


# --- cache helpers (recursing over nested caches) ---------------------------

def _is_paged(tree: Any) -> bool:
    return isinstance(tree, dict) and "ptab" in tree


def cache_leaves(cache: Any) -> list:
    """Every tensor of a (nested) cache, in key order."""
    if isinstance(cache, dict):
        return [t for v in cache.values() for t in cache_leaves(v)]
    return [cache]


def blank_slot_cache(cache: Params, batch: int = 1) -> Params:
    """The scratch cache a per-slot prefill fills before
    :func:`merge_cache_slot`: a zeroed batch-``batch`` copy of every
    monolithic subtree (batch on axis 1 of every leaf; the recurrent
    state too), and for a paged subtree the shared pools with an
    all-null batch-``batch`` table."""
    if _is_paged(cache):
        nl, _, mp = cache["ptab"].shape
        return {"kp": cache["kp"], "vp": cache["vp"],
                "ptab": torch.zeros((nl, batch, mp), dtype=torch.int32,
                                    device=cache["ptab"].device)}
    if isinstance(cache, dict):
        return {k: blank_slot_cache(v, batch) for k, v in cache.items()}
    return torch.zeros(cache.shape[:1] + (batch,) + cache.shape[2:],
                       dtype=cache.dtype, device=cache.device)


def merge_cache_slot(cache: Params, slot_cache: Params, slot: int) -> Params:
    """Write a batch-1 scratch cache into slot ``slot``: a paged subtree's
    page-table row (the pool writes already landed), every row of a
    monolithic one."""
    if _is_paged(cache):
        cache["ptab"][:, slot] = slot_cache["ptab"][:, 0]
    elif isinstance(cache, dict):
        for k in cache:
            merge_cache_slot(cache[k], slot_cache[k], slot)
    else:
        cache[:, slot] = slot_cache[:, 0]
    return cache


def copy_page(cache: Params, src: int, dst: int) -> Params:
    """Copy physical page ``src`` onto ``dst`` in every paged subtree's
    pools, in place: the copy-on-write half of prefix sharing.  Rows past
    the divergence are overwritten by the suffix prefill or masked by the
    slot's length."""
    if _is_paged(cache):
        cache["kp"][:, dst] = cache["kp"][:, src]
        cache["vp"][:, dst] = cache["vp"][:, src]
    elif isinstance(cache, dict):
        for v in cache.values():
            copy_page(v, src, dst)
    return cache


def set_page_table(cache: Params, table) -> Params:
    """Broadcast ``table (B, max_pages)`` into the page table of every
    layer of every paged subtree (a no-op without one).

    A tensor on the cache's device is copied device to device — what a
    captured decode chunk does with the table the engine staged into a
    device buffer before it.  A host array (the allocator's view) is
    copied to the device first."""
    if _is_paged(cache):
        pt = cache["ptab"]
        if not (isinstance(table, torch.Tensor) and table.device == pt.device):
            table = torch.as_tensor(table, dtype=torch.int32).to(pt.device)
        pt.copy_(table.reshape(1, *pt.shape[1:]).expand_as(pt))
    elif isinstance(cache, dict):
        for v in cache.values():
            set_page_table(v, table)
    return cache


def page_view(cache: Params, view_pages: Optional[int]) -> Params:
    """Narrow every page table to its first ``view_pages`` logical pages
    (a view: writes land in the shared pools; other leaves are the
    cache's own)."""
    if view_pages is None:
        return cache
    if _is_paged(cache):
        return {"kp": cache["kp"], "vp": cache["vp"],
                "ptab": cache["ptab"][..., :view_pages]}
    if isinstance(cache, dict):
        return {k: page_view(v, view_pages) for k, v in cache.items()}
    return cache


def unpage_view(new_cache: Params, full_cache: Params) -> Params:
    """Undo :func:`page_view`: the pools were updated in place, so the
    full cache is already current."""
    return full_cache
