"""The serving programs: prefill steps and the chunked decode loop.

  * :func:`build_prefill_slot_step` — prefill ONE request into slot ``i``
    of the shared cache and stamp the slot's decode state (first token,
    position, budget) on the card: the first token is sampled there and
    emitted by the next decode chunk, so refill costs zero host syncs.
    With ``paged=True`` the scratch cache shares the page pool and the
    slot's host-assigned pages ride in as an argument.
  * :func:`build_prefix_prefill_slot_step` — its prefix-sharing twin:
    the prompt's head already lies in shared pages mapped into the
    slot's table, so only the suffix is computed (after a copy-on-write
    page copy when the divergence falls inside a page).
  * :func:`build_prefix_fill_step` — prefill a registered prefix into
    the pages the index gave it, touching no slot.
  * :func:`build_prefill_wave_step` — the whole batch in one prefill when
    every slot is free (monolithic layout).
  * :func:`build_decode_loop` — ``decode_chunk`` decode+sample steps in a
    Python loop of device operations, with no ``.item()`` or ``.cpu()``
    inside; EOS, budget exhaustion and cache capacity are detected on the
    card.  The loop returns ``(decode_chunk, slots)`` token and emit
    blocks that the engine fetches once per chunk.

The JAX package compiles these with ``jax.jit``; here they are plain
functions run eagerly (the builders return closures so call sites read
the same).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import models as MZ
from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.state import sample_token_slots

State = Dict[str, torch.Tensor]


def build_prefill_slot_step(cfg: ModelConfig, scfg: ServeConfig,
                            prompt_rows: Optional[int] = None,
                            paged: bool = False) -> Callable:
    """(params, tokens (1, rows), cache, state, slot, budget, temp,
    generator[, page_row (max_pages,)]) → (cache, state).

    ``generator`` is ``None`` for a greedy request."""
    rows = prompt_rows or scfg.prompt_pad
    V = cfg.vocab_size

    def step(params, tokens, cache, state: State, slot: int, budget: int,
             temp: float, generator: Optional[torch.Generator],
             page_row: Optional[torch.Tensor] = None):
        scratch = MZ.blank_slot_cache(cache)
        if paged:
            scratch = MZ.set_page_table(scratch, page_row[None])
        logits, scratch = MZ.prefill(params, cfg, {"tokens": tokens}, scratch)
        cache = MZ.merge_cache_slot(cache, scratch, slot)
        _start_slot(state, slot, logits[:, :V], temp, generator, rows, budget)
        return cache, state

    return step


def _start_slot(state: State, slot: int, logits: torch.Tensor, temp: float,
                generator: Optional[torch.Generator], rows: int,
                budget: int) -> None:
    """Stamp a freshly prefilled slot's decode state on the card: the
    first token sampled from ``logits (1, V)``, its position and budget."""
    temps = torch.full((1,), temp, device=logits.device)
    state["tok"][slot] = sample_token_slots(logits, temps, generator)[0]
    state["pos"][slot] = rows
    state["done"][slot] = False
    state["left"][slot] = budget


def build_prefix_prefill_slot_step(cfg: ModelConfig, scfg: ServeConfig,
                                   prompt_rows: int, start: int,
                                   cow: bool = False) -> Callable:
    """(params, tokens (1, rows - start), cache, state, slot, budget,
    temp, generator, page_row[, copy_src, copy_dst]) → (cache, state).

    Rows ``[0, start)`` of the prompt already lie in shared pages mapped
    read-only into ``page_row``, so only the suffix is computed: a
    :func:`models.decode_block` forward at the host offset ``start``
    whose scatter lands in the slot's private pages (positions ≥
    ``start``).  ``cow=True`` first copies page ``copy_src`` onto
    ``copy_dst``: the divergent page's common rows ride in with the copy,
    the rows past them are overwritten by the suffix or masked."""
    rows = prompt_rows
    V = cfg.vocab_size

    def step(params, tokens, cache, state: State, slot: int, budget: int,
             temp: float, generator: Optional[torch.Generator],
             page_row: torch.Tensor, copy_src: Optional[int] = None,
             copy_dst: Optional[int] = None):
        if cow:
            cache = MZ.copy_page(cache, copy_src, copy_dst)
        scratch = MZ.set_page_table(MZ.blank_slot_cache(cache),
                                    page_row[None])
        logits, scratch = MZ.decode_block(params, cfg, tokens, scratch, start)
        cache = MZ.merge_cache_slot(cache, scratch, slot)
        _start_slot(state, slot, logits[:, -1, :V], temp, generator, rows,
                    budget)
        return cache, state

    return step


def build_prefix_fill_step(cfg: ModelConfig, scfg: ServeConfig,
                           prompt_rows: int) -> Callable:
    """(params, tokens (1, rows), cache, page_row) → cache.

    ``Engine.register_prefix``'s fill: prefill the registered head into
    the pages ``page_row`` names, touching no slot's page table or decode
    state (the scratch shares the pools; the logits are dropped).  Pages
    the head already had resident are rewritten with the same values."""

    def step(params, tokens, cache, page_row: torch.Tensor):
        scratch = MZ.set_page_table(MZ.blank_slot_cache(cache),
                                    page_row[None])
        MZ.prefill(params, cfg, {"tokens": tokens}, scratch)
        return MZ.unpage_view(scratch, cache)

    return step


def build_prefill_wave_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """(params, tokens (slots, prompt_pad), cache, valid (slots,) bool,
    budgets (slots,), temps (slots,), generator) → (cache, state).

    Rebuilds the whole decode state; ``valid`` marks the slots that got a
    request.  Only used while no slot is live (it rewrites every slot's
    cache rows)."""
    V = cfg.vocab_size

    def step(params, tokens, cache, valid: np.ndarray, budgets: np.ndarray,
             temps: torch.Tensor, generator: Optional[torch.Generator]):
        logits, cache = MZ.prefill(params, cfg, {"tokens": tokens}, cache)
        dev = logits.device
        first = sample_token_slots(logits[:, :V], temps, generator)
        ok = torch.from_numpy(valid).to(dev)
        state = {
            "tok": torch.where(ok, first, 0).to(torch.int32),
            "pos": torch.where(ok, scfg.prompt_pad, 0).to(torch.int32),
            "done": ~ok,
            "left": torch.from_numpy(
                np.where(valid, budgets, 0).astype(np.int32)).to(dev),
        }
        return cache, state

    return step


def build_decode_loop(cfg: ModelConfig, scfg: ServeConfig,
                      paged: bool = False,
                      view_pages: Optional[int] = None) -> Callable:
    """(params, cache, state, temps, generator[, ptab]) → (cache, state,
    tokens, emitted).

    Each step first *emits* the carry token (sampled by the previous step
    or by the slot's prefill), then decides whether the slot is finished
    (EOS, budget, or cache capacity) and, if not, decodes and samples the
    next token at the slot's own position and temperature.  Finished and
    free slots ride along frozen; their cache writes land on rows nothing
    attends to.  ``paged=True`` stamps the host page table into the cache
    first and narrows attention to the first ``view_pages`` pages.
    ``tokens``/``emitted`` are ``(decode_chunk, slots)`` device tensors —
    the engine's one fetch per chunk.
    """
    V = cfg.vocab_size

    def loop(params, cache, state: State, temps: torch.Tensor,
             generator: Optional[torch.Generator], ptab: Any = None):
        if paged:
            cache = MZ.set_page_table(cache, ptab)
        vcache = MZ.page_view(cache, view_pages) if paged else cache
        tok, pos = state["tok"], state["pos"]
        done, left = state["done"], state["left"]
        toks, emits = [], []
        for _ in range(scfg.decode_chunk):
            emit = ~done & (left > 0)
            left = left - emit.to(left.dtype)
            done = done | (emit & ((tok == scfg.eos_token) | (left == 0)
                                   | (pos + 1 >= scfg.max_len)))
            logits, vcache = MZ.decode_step(params, cfg, tok, vcache, pos)
            nxt = sample_token_slots(logits[:, :V], temps, generator)
            toks.append(tok)
            emits.append(emit)
            alive = ~done
            tok = torch.where(alive, nxt, tok)
            pos = torch.where(alive, pos + 1, pos)
        state = {"tok": tok, "pos": pos, "done": done, "left": left}
        return cache, state, torch.stack(toks), torch.stack(emits)

    return loop
