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
    blocks that the engine fetches once per chunk.  This functional form
    is the reference the tests hold the served chunk against.
  * :func:`build_decode_chunk` — the same steps as a body over the fixed
    :class:`~repro_torch.serving.state.ChunkBuffers`, writing its tokens,
    emits and final state in place: what the engine serves.
  * :func:`build_spec_decode_loop` / :func:`build_spec_decode_chunk` —
    the speculative twins (``ServeConfig.spec_k > 0``): each step drafts
    ``spec_k`` tokens per slot with the draft params, verifies the
    ``(slots, spec_k + 1)`` block in one forward of the verify params and
    commits the accepted prefix plus one verify token; the token blocks
    grow to ``decode_chunk * (spec_k + 1)`` rows.
  * :class:`DecodeChunk` — runs one key's body: eagerly on the CPU, and
    on the card as the replay of one captured ``torch.cuda.CUDAGraph``
    (the counterpart of the JAX package's one compiled program per
    ``view_pages`` bucket).

:func:`build_prefill_step` / :func:`build_decode_step` are the wave-style
whole-batch steps: the one-token-per-sync reference loop the serving
benchmark compares the chunked engine against.

The JAX package compiles these with ``jax.jit``; here the prefill steps
are plain functions run eagerly (the ``build_*`` functions return
closures so call sites read the same).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import models as MZ
from repro_torch.kernels import (bsr_matmul, csa_matmul, dispatch,
                                 flash_attention, lookahead_decode, nm_spmm,
                                 paged_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.state import ChunkBuffers, sample_token_slots

State = Dict[str, torch.Tensor]


def build_prefill_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """(params, batch, cache) → (last_logits, cache): a whole-batch wave
    prefill of ``batch["tokens"] (B, L)`` into rows ``[0, L)`` of every
    slot.  The engine itself prefills per slot
    (:func:`build_prefill_slot_step`)."""

    def step(params, batch, cache):
        return MZ.prefill(params, cfg, batch, cache)

    return step


def build_decode_step(cfg: ModelConfig, scfg: ServeConfig) -> Callable:
    """(params, token (B,), cache, pos) → (logits, cache): one decode step
    of every slot; ``pos`` is one host int for all slots or a ``(B,)``
    tensor of per-slot positions."""

    def step(params, token, cache, pos):
        if not torch.is_tensor(pos) or pos.dim() == 0:
            pos = torch.full(token.shape, int(pos), dtype=torch.int32,
                             device=token.device)
        return MZ.decode_step(params, cfg, token, cache, pos)

    return step


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
    """(params, tokens (slots, prompt_pad), cache, state, valid (slots,)
    bool, budgets (slots,), temps (slots,), generator) → (cache, state).

    Rewrites the whole decode state in place; ``valid`` marks the slots
    that got a request.  Only used while no slot is live (it rewrites
    every slot's cache rows).  A recurrent state (the hybrid family) is
    zeroed first, in place, so every slot's prompt starts from zero state
    as a per-slot prefill's blank scratch does — not from what the
    retired requests left (the JAX wave step seeds its prefill from the
    live cache there; ROADMAP queue 3)."""
    V = cfg.vocab_size

    def step(params, tokens, cache, state: State, valid: np.ndarray,
             budgets: np.ndarray, temps: torch.Tensor,
             generator: Optional[torch.Generator]):
        for t in (MZ.recurrent_state(cache) or {}).values():
            t.zero_()
        logits, cache = MZ.prefill(params, cfg, {"tokens": tokens}, cache)
        dev = logits.device
        first = sample_token_slots(logits[:, :V], temps, generator)
        ok = torch.from_numpy(valid).to(dev)
        state["tok"].copy_(torch.where(ok, first, 0))
        state["pos"].copy_(torch.where(ok, scfg.prompt_pad, 0))
        state["done"].copy_(~ok)
        state["left"].copy_(torch.from_numpy(
            np.where(valid, budgets, 0).astype(np.int32)))
        return cache, state

    return step


def _decode_step(params, cfg: ModelConfig, scfg: ServeConfig, vcache,
                 tok, pos, done, left, temps: torch.Tensor,
                 generator: Optional[torch.Generator]):
    """One step of a chunk: *emit* the carry token, decide whether the
    slot is finished (EOS, budget, or cache capacity) and, if not, decode
    and sample the next token at the slot's own position and temperature.
    Returns the next ``(tok, pos, done, left)`` and this step's emit
    mask."""
    emit = ~done & (left > 0)
    left = left - emit.to(left.dtype)
    done = done | (emit & ((tok == scfg.eos_token) | (left == 0)
                           | (pos + 1 >= scfg.max_len)))
    logits, _ = MZ.decode_step(params, cfg, tok, vcache, pos)
    nxt = sample_token_slots(logits[:, :cfg.vocab_size], temps, generator)
    alive = ~done
    return (torch.where(alive, nxt, tok), torch.where(alive, pos + 1, pos),
            done, left, emit)


def build_decode_loop(cfg: ModelConfig, scfg: ServeConfig,
                      paged: bool = False,
                      view_pages: Optional[int] = None) -> Callable:
    """(params, cache, state, temps, generator[, ptab]) → (cache, state,
    tokens, emitted).

    ``decode_chunk`` steps of :func:`_decode_step`.  Finished and free
    slots ride along frozen; their cache writes land on rows nothing
    attends to.  ``paged=True`` stamps the host page table into the cache
    first and narrows attention to the first ``view_pages`` pages.
    ``tokens``/``emitted`` are ``(decode_chunk, slots)`` device tensors —
    the engine's one fetch per chunk.  This functional form returns new
    tensors; the engine serves :func:`build_decode_chunk`, and the tests
    hold the two equal.
    """

    def loop(params, cache, state: State, temps: torch.Tensor,
             generator: Optional[torch.Generator], ptab: Any = None):
        if paged:
            cache = MZ.set_page_table(cache, ptab)
        vcache = MZ.page_view(cache, view_pages) if paged else cache
        tok, pos = state["tok"], state["pos"]
        done, left = state["done"], state["left"]
        toks, emits = [], []
        for _ in range(scfg.decode_chunk):
            toks.append(tok)
            tok, pos, done, left, emit = _decode_step(
                params, cfg, scfg, vcache, tok, pos, done, left, temps,
                generator)
            emits.append(emit)
        state = {"tok": tok, "pos": pos, "done": done, "left": left}
        return cache, state, torch.stack(toks), torch.stack(emits)

    return loop


def build_decode_chunk(cfg: ModelConfig, scfg: ServeConfig,
                       paged: bool = False,
                       view_pages: Optional[int] = None) -> Callable:
    """(params, cache, bufs: ChunkBuffers, generator) → None.

    :func:`build_decode_loop`'s steps over fixed buffers: the page table
    is broadcast from ``bufs.ptab`` (already on the device), each step's
    carry token and emit mask land in row ``t`` of ``bufs.tokens`` /
    ``bufs.emitted``, and the final state is copied back into
    ``bufs.state``.  Nothing in it moves data between host and device,
    so a CUDA graph can hold it."""

    def body(params, cache, bufs: ChunkBuffers,
             generator: Optional[torch.Generator]) -> None:
        if paged:
            MZ.set_page_table(cache, bufs.ptab)
        vcache = MZ.page_view(cache, view_pages) if paged else cache
        st = bufs.state
        tok, pos, done, left = st["tok"], st["pos"], st["done"], st["left"]
        for t in range(scfg.decode_chunk):
            bufs.tokens[t].copy_(tok)
            tok, pos, done, left, emit = _decode_step(
                params, cfg, scfg, vcache, tok, pos, done, left, bufs.temps,
                generator)
            bufs.emitted[t].copy_(emit)
        for name, t in (("tok", tok), ("pos", pos), ("done", done),
                        ("left", left)):
            st[name].copy_(t)

    return body


def _sample_at(logits: torch.Tensor, temperature: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """``(B, V) → (B,)`` int32 at one temperature for every slot: the
    argmax at ``temperature <= 0``, else :func:`sample_token_slots`'s
    draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    temps = torch.full(logits.shape[:1], temperature, device=logits.device)
    return sample_token_slots(logits, temps, generator)


def accept_drafts(vlg: torch.Tensor, drafts: torch.Tensor, dlogits,
                  temperature: float, generator: Optional[torch.Generator]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The acceptance rule of a verify block: ``vlg (B, K + 1, V)`` the
    verify logits of the carry token and the ``K`` drafts, ``drafts (B,
    K)`` the drafted tokens, ``dlogits`` the ``K`` draft logits ``(B,
    V)`` they were drawn from.  Returns ``acc (B, K)`` (1 while every
    draft so far is accepted), the accepted count ``j (B,)`` and the
    next carry token ``(B,)``.

    At temperature 0 a draft is accepted while it equals the verify
    argmax, and the carry is the verify argmax at position ``j`` (the
    correction, or the bonus token after full acceptance).  Above it,
    residual (rejection) sampling, the lossless rule: accept ``d_i`` with
    probability ``min(1, p_verify / p_draft)``; at the first rejection
    draw the carry from ``max(p_verify - p_draft, 0)``, renormalised, and
    after full acceptance from ``p_verify`` at the bonus position — so
    each committed token is distributed as the verify model's."""
    K, V = drafts.shape[1], vlg.shape[-1]
    if temperature <= 0.0:
        g = torch.argmax(vlg, dim=-1).to(torch.int32)        # (B, K + 1)
        acc = torch.cumprod((drafts == g[:, :K]).to(torch.int32), dim=1)
        j = acc.sum(1)
        return acc, j, g.gather(1, j[:, None].long())[:, 0]
    pv = torch.softmax(vlg.float() / temperature, dim=-1)    # (B, K+1, V)
    pd = torch.softmax(torch.stack(dlogits, 1).float() / temperature,
                       dim=-1)                               # (B, K, V)
    idx = drafts.long()[..., None]
    pv_t = pv[:, :K].gather(-1, idx)[..., 0]                 # (B, K)
    pd_t = pd.gather(-1, idx)[..., 0]
    u = torch.rand(pd_t.shape, generator=generator, device=pd_t.device)
    acc = torch.cumprod((u * pd_t <= pv_t).to(torch.int32), dim=1)
    j = acc.sum(1)
    at = j.long()[:, None, None].expand(-1, 1, V)
    pv_j = pv.gather(1, at)[:, 0]                            # (B, V)
    pd_j = torch.cat([pd, torch.zeros_like(pd[:, :1])], 1).gather(1, at)[:, 0]
    res = (pv_j - pd_j).clamp_min(0.0)
    total = res.sum(-1, keepdim=True)
    res = torch.where(total > 0, res / total, pv_j)
    carry = _sample_at(torch.where(res > 0, torch.log(res), -1e30), 1.0,
                       generator)
    return acc, j, carry


def _spec_step(params, dparams, cfg: ModelConfig, scfg: ServeConfig, vcache,
               tok, pos, done, left, generator: Optional[torch.Generator]):
    """One draft + verify + commit step of the speculative loop (the
    JAX ``spec_step``); ``vcache`` is the (view-narrowed) cache both
    models run against.

      1. emit the carry token; a slot freezes once the drafted block
         would no longer fit below ``max_len`` (``pos + 1 + K``);
      2. draft ``K`` tokens per slot with ``dparams``, one decode step
         each at the slot's own position (``M = slots``);
      3. verify the ``(slots, K + 1)`` block of the carry token and the
         drafts in ONE ``decode_block`` of ``params`` (``M = slots * (K +
         1)``), which re-writes the block's KV rows with verify values;
      4. accept the longest draft prefix the verify agrees with
         (:func:`accept_drafts`) and commit it under the budget and EOS
         as the plain loop would; the next carry is the verify's token
         at the first rejection (or the bonus token).

    Rejected KV rows need no undo: ``pos`` advances by the committed
    count only, so they are dead by masking.  A recurrent state (the
    hybrid family) is order-dependent, so it rolls back by copies into
    its own storage (what a captured chunk holds): a snapshot before the
    drafts, copied back after them for the verify block, which collects
    the state after each block position; then each live slot takes the
    state after its last committed position and each frozen slot its
    pre-block state.  Returns the next ``(tok, pos, done, left)``, the
    step's ``(B, K + 1)`` tokens and emit mask (column 0 the carry token,
    then the drafts) and the step's drafted and accepted counts (0-d
    tensors)."""
    K, V, T = scfg.spec_k, cfg.vocab_size, scfg.temperature
    emit0 = ~done & (left > 0)
    left = left - emit0.to(left.dtype)
    done = done | (emit0 & ((tok == scfg.eos_token) | (left == 0)
                            | (pos + 1 + K >= scfg.max_len)))
    alive = ~done
    rec = MZ.recurrent_state(vcache)
    rec0 = None if rec is None else {k: t.clone() for k, t in rec.items()}
    drafts, dlogits = [], []
    dtok = tok
    for i in range(K):
        lg, _ = MZ.decode_step(dparams, cfg, dtok, vcache, pos + i)
        lg = lg[:, :V]
        dtok = _sample_at(lg, T, generator)
        drafts.append(dtok)
        dlogits.append(lg)
    dT = torch.stack(drafts, 1)                              # (B, K)
    block = torch.cat([tok[:, None], dT], 1)                 # (B, K + 1)
    if rec0 is None:
        vlg, _ = MZ.decode_block(params, cfg, block, vcache, pos)
    else:
        # the drafts advanced the recurrent state: restore it, the
        # verify block consumes the carry token and the drafts itself
        MZ.set_recurrent_state(vcache, rec0)
        vlg, _, snaps = MZ.decode_block(params, cfg, block, vcache, pos,
                                        collect_states=True)
    vlg = vlg[:, :, :V]
    acc, j, carry = accept_drafts(vlg, dT, dlogits, T, generator)
    # commit the accepted drafts: the budget and EOS cut them short
    # exactly where the plain loop would stop
    accb = acc.bool()
    eos_hit = accb & (dT == scfg.eos_token)
    eos_before = (torch.cumsum(eos_hit.to(torch.int32), 1)
                  - eos_hit.to(torch.int32)) > 0
    in_budget = torch.arange(K, device=tok.device)[None] < left[:, None]
    emit_d = alive[:, None] & accb & in_budget & ~eos_before
    n_emit = emit_d.sum(1).to(left.dtype)
    left = left - n_emit
    done = done | (alive & ((emit_d & eos_hit).any(1) | (left == 0)))
    pos = torch.where(alive, pos + 1 + n_emit, pos)
    nxt = torch.where(~done, carry, tok)
    if rec0 is not None:
        # the state after the carry token and the n_emit committed drafts
        MZ.set_recurrent_state(vcache, MZ.where_slot(
            alive, MZ.select_recurrent(snaps, n_emit), rec0))
    drafted = torch.where(alive, K, 0).sum()
    accepted = torch.where(alive, j, 0).sum()
    return (nxt, pos, done, left, block,
            torch.cat([emit0[:, None], emit_d], 1), drafted, accepted)


def build_spec_decode_loop(cfg: ModelConfig, scfg: ServeConfig,
                           paged: bool = False,
                           view_pages: Optional[int] = None) -> Callable:
    """(params, draft_params, cache, state, generator[, ptab]) → (cache,
    state, tokens, emitted, drafted, accepted).

    The speculative twin of :func:`build_decode_loop`: ``decode_chunk``
    steps of :func:`_spec_step`.  ``tokens``/``emitted`` are
    ``(decode_chunk * (spec_k + 1), slots)``: each step's ``spec_k + 1``
    rows (the carry token, then the drafts) in order, the same block
    layout the plain loop hands the host, taller; ``drafted`` and
    ``accepted`` are the chunk's totals.  A slot freezes when fewer than
    ``spec_k + 1`` cache rows remain, so parity with the plain loop
    needs ``max_len >= prompt_rows + max_new + spec_k``.  Sampling runs
    at the uniform ``scfg.temperature`` (residual acceptance needs the
    draft and verify distributions at one temperature); ``generator`` is
    ``None`` at temperature 0.  This functional form is the reference
    the tests hold :func:`build_spec_decode_chunk` against."""

    def loop(params, dparams, cache, state: State,
             generator: Optional[torch.Generator], ptab: Any = None):
        if paged:
            cache = MZ.set_page_table(cache, ptab)
        vcache = MZ.page_view(cache, view_pages) if paged else cache
        tok, pos = state["tok"], state["pos"]
        done, left = state["done"], state["left"]
        toks, emits, drafted, accepted = [], [], 0, 0
        for _ in range(scfg.decode_chunk):
            tok, pos, done, left, blk, emit, dr, ac = _spec_step(
                params, dparams, cfg, scfg, vcache, tok, pos, done, left,
                generator)
            toks.append(blk.T)
            emits.append(emit.T)
            drafted, accepted = drafted + dr, accepted + ac
        state = {"tok": tok, "pos": pos, "done": done, "left": left}
        return (cache, state, torch.cat(toks), torch.cat(emits), drafted,
                accepted)

    return loop


def build_spec_decode_chunk(cfg: ModelConfig, scfg: ServeConfig,
                            draft_params: Any, paged: bool = False,
                            view_pages: Optional[int] = None) -> Callable:
    """(params, cache, bufs: ChunkBuffers, generator) → None.

    :func:`build_spec_decode_loop`'s steps over fixed buffers, as
    :func:`build_decode_chunk` is the plain loop's: step ``t`` writes rows
    ``[t (K + 1), (t + 1) (K + 1))`` of ``bufs.tokens`` / ``bufs.emitted``,
    the chunk's drafted and accepted totals land in ``bufs.tally`` and
    the final state in ``bufs.state``.  ``draft_params`` are bound here:
    the engine's draft weights, at fixed addresses like its verify
    weights."""
    W = scfg.spec_k + 1

    def body(params, cache, bufs: ChunkBuffers,
             generator: Optional[torch.Generator]) -> None:
        if paged:
            MZ.set_page_table(cache, bufs.ptab)
        vcache = MZ.page_view(cache, view_pages) if paged else cache
        st = bufs.state
        tok, pos, done, left = st["tok"], st["pos"], st["done"], st["left"]
        drafted = accepted = 0
        for t in range(scfg.decode_chunk):
            tok, pos, done, left, blk, emit, dr, ac = _spec_step(
                params, draft_params, cfg, scfg, vcache, tok, pos, done,
                left, generator)
            bufs.tokens[t * W:(t + 1) * W].copy_(blk.T)
            bufs.emitted[t * W:(t + 1) * W].copy_(emit.T)
            drafted, accepted = drafted + dr, accepted + ac
        bufs.tally.copy_(torch.stack([drafted, accepted]))
        for name, t in (("tok", tok), ("pos", pos), ("done", done),
                        ("left", left)):
            st[name].copy_(t)

    return body


#: The kernel wrappers' launch counters, ``(module, attribute)``, that a
#: replay advances by what its capture recorded (a replay makes no Python
#: call): every wrapper's ``launches``, ``paged_attention``'s count of
#: verify-block (Q > 1) launches, the attention wrappers' counts of
#: tensor-core-route and sliding-window launches and the matmul
#: wrappers' counts of half-stage launches.
COUNTED = tuple((mod, "launches") for mod in (
    bsr_matmul, csa_matmul, flash_attention, lookahead_decode, nm_spmm,
    paged_attention)) + tuple((mod, attr) for mod in (
        paged_attention, flash_attention) for attr in (
        "mma_launches", "window_launches")) + (
    (paged_attention, "block_launches"),) + tuple(
        (mod, "half_launches") for mod in (bsr_matmul, csa_matmul, nm_spmm))


class ChunkGraphError(RuntimeError):
    """A decode chunk's graph failed to capture, or its replay found the
    cache moved: a fault of the program, which the engine's fault layer
    never contains (a retry would meet the same fault, or a capture
    stream the failure invalidated)."""


def _cache_ptrs(cache) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in MZ.cache_leaves(cache))


class DecodeChunk:
    """One key's decode chunk program: the :func:`build_decode_chunk`
    body, keyed by ``(view_pages, sampled)``.

    Called with ``graphs=False`` (the CPU, or the card with graphs off)
    it runs the body eagerly.  On the card with graphs on:

      * the key's first chunk runs the body eagerly, on the capture
        stream: it is the real chunk and the warm-up (kernel libraries
        loaded, shared-memory attributes set, the stream's cuBLAS
        workspace made), so no capture sees a first call;
      * its next chunk captures the body into a ``torch.cuda.CUDAGraph``
        on that stream, in the backend's shared memory pool, with the
        sampling generator registered (each replay then advances it),
        and replays it;
      * every later chunk only replays.

    A failed capture raises :class:`ChunkGraphError`; nothing falls back
    to the eager body, and the engine's fault layer lets it through.  The
    graph holds the addresses of ``params``, ``cache`` and the
    :class:`ChunkBuffers`, which the engine never rebinds.

    Inside ``dispatch.plain_versions`` (a degraded engine) it runs the
    body eagerly on the current stream, recorded as ``"plain"``:
    it is never captured and does not count as the key's warm-up, so the
    key's graph, if it has one, replays again once the engine recovers.
    """

    def __init__(self, body: Callable, key: Tuple[Optional[int], bool],
                 stats: Dict[str, Any], pool=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.body, self.key, self.stats = body, key, stats
        self.pool, self.stream = pool, stream
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.runs = 0
        self._launches: Dict[Any, int] = {}
        self._bound: Tuple[int, ...] = ()

    def __call__(self, params, cache, bufs: ChunkBuffers, temps: np.ndarray,
                 generator: Optional[torch.Generator],
                 ptab: Optional[np.ndarray] = None, *,
                 graphs: bool = False) -> None:
        bufs.stage(temps, ptab)
        plain = dispatch.plain_active()
        if plain or not graphs:
            how = "plain" if plain else "eager"
            self.body(params, cache, bufs, generator)
        elif self.graph is not None:
            how = "replay"
            self._replay(cache)
        elif self.runs == 0:
            how = "eager"
            self._warm_up(params, cache, bufs, generator)
        else:
            how = "capture"
            self._capture(params, cache, bufs, generator)
            self._replay(cache)
        self.runs += not plain      # a plain chunk is no warm-up
        self.stats["chunk_runs"].append((self.key, how))

    def _warm_up(self, params, cache, bufs, generator) -> None:
        here = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            self.body(params, cache, bufs, generator)
        here.wait_stream(self.stream)

    def _capture(self, params, cache, bufs, generator) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        before = [getattr(mod, attr) for mod, attr in COUNTED]
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    self.body(params, cache, bufs, generator)
                finally:
                    graph.capture_end()
        except Exception as e:
            raise ChunkGraphError(f"decode chunk {self.key}: the capture "
                                  f"failed: {e}") from e
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        # the capture's wrapper calls launched nothing: count per replay
        for (mod, attr), n in zip(COUNTED, before):
            if getattr(mod, attr) != n:
                self._launches[mod, attr] = getattr(mod, attr) - n
            setattr(mod, attr, n)
        self.graph, self._bound = graph, _cache_ptrs(cache)
        self.stats["graph_captures"].append(
            {"key": list(self.key), "capture_s": t1 - t0,
             "instantiate_s": t2 - t1})

    def _replay(self, cache) -> None:
        if _cache_ptrs(cache) != self._bound:
            raise ChunkGraphError(
                f"decode chunk {self.key}: the cache's storage moved since "
                "its graph was captured")
        self.graph.replay()
        for (mod, attr), n in self._launches.items():
            setattr(mod, attr, getattr(mod, attr) + n)
