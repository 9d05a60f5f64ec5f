"""The streaming :class:`Engine` of the port.

  * ``submit(prompt, *, max_new=None, temperature=None, stream=False)``
    → :class:`RequestHandle`; admission happens at the next ``step()``.
  * ``step()`` → ``list[TokenEvent]`` — one scheduler tick: apply pending
    cancellations, admit queued requests into free slots (per-slot
    prefill, zero host syncs; a whole-batch wave prefill when every slot
    is free and the layout allows it), then run ONE decode chunk on the
    card and make the single device→host fetch.  On the card every chunk
    after its key's first is the replay of one captured CUDA graph
    (``serving.loops.DecodeChunk``).
  * ``cancel(handle)`` — takes effect at the next chunk boundary.
  * ``run()`` / ``generate()`` — drain-the-queue wrappers over ``step()``.
  * ``register_prefix(tokens)`` → :class:`PrefixHandle` — pin a shared
    prompt head in the paged backend's prefix index;
    ``submit(..., prefix=handle)`` prepends it.  Sharing itself is
    automatic (by content, at admission) whenever
    ``ServeConfig.prefix_cache`` is on.
  * speculative decoding with ``ServeConfig.spec_k > 0``: each decode
    step drafts ``spec_k`` tokens per slot with the draft params (the
    model itself, ``spec_draft="self"``, or its sparse packs,
    ``"pack"``) and verifies them in one block forward of the verify
    params; greedy output equals the plain loop's for any draft.

Sync contract (as in the JAX engine): ``step()`` performs exactly one
device→host transfer when any slot is live and zero otherwise — the
speculative drafted/accepted counts ride in it; ``sync_count`` counts
them.  Priorities, deadlines, preemption, fault containment, the
journal and sharding are ROADMAP queue 1 items 12 and 13.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import models as MZ
from repro_torch.core.sparse_linear import make_draft_params
from repro_torch.kernels import dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.serving.backends import make_backend
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.prefix import PrefixHandle
from repro_torch.serving.state import (TERMINAL_STATUSES, ChunkBuffers,
                                       EngineStats, Request, RequestHandle,
                                       RequestStatus, TokenEvent,
                                       _device_fetch, fresh_stats)

__all__ = ["Engine", "RequestHandle"]


def _fetch(t: torch.Tensor) -> np.ndarray:
    """The single device→host transfer.  While the deprecated
    ``repro_torch.serving.engine`` module is imported, resolve through its
    ``_device_fetch`` attribute, so a test that patches it intercepts
    every sync; a process that never imports the shim never warns."""
    compat = sys.modules.get("repro_torch.serving.engine")
    if compat is not None:
        return compat._device_fetch(t)
    return _device_fetch(t)

_NOT_PORTED = {
    "max_queue": "ROADMAP queue 1 item 12",
    "journal_path": "ROADMAP queue 1 item 12",
}


class Engine:
    """Slot-based continuous batching on one device, request-level API.

    Every slot carries its own position, done flag, token budget and
    temperature, all on the device between host fetches.  Finished or
    cancelled slots are refilled at the next chunk boundary by a
    per-slot prefill; in-flight slots never stall.  ``params`` must lie
    on ``device``; the engine keeps its cache and decode buffers at fixed
    addresses for its whole life (its chunk graphs hold them).

    Under speculation (``scfg.spec_k > 0``) ``params`` verify and
    ``draft_params`` draft; without them the draft is ``params`` itself
    (``spec_draft="self"``) or ``core.sparse_linear.make_draft_params``
    of them (``"pack"``: the config's sparse packs of the same weights,
    sharing every unpacked tensor).
    """

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Any, *,
                 draft_params: Any = None, device="cuda"):
        scfg.validate()
        defaults = ServeConfig()
        for field, item in _NOT_PORTED.items():
            if getattr(scfg, field) != getattr(defaults, field):
                raise NotImplementedError(
                    f"ServeConfig.{field} is not served by the port yet "
                    f"({item})")
        if cfg.n_experts and (scfg.spec or scfg.prefix_cache):
            raise NotImplementedError(
                f"{cfg.name}: speculative decoding and prefix sharing are not "
                "served for MoE configs yet (ROADMAP queue 1 item 16): a "
                "verify block or a suffix prefill routes another token set "
                "than the plain loop, so its capacity drops differ")
        if scfg.prefix_cache and MZ.family(cfg) != "lm":
            raise ValueError(
                "prefix_cache shares KV pages by position; the "
                f"'{MZ.family(cfg)}' family carries per-request state "
                "outside the page pool — only decoder-only ('lm') models "
                "can share prefixes")
        self.device = dispatch.resolve_device(device)
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._uid_next = 0
        self.sync_count = 0
        self._stats: Dict[str, Any] = fresh_stats()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        if scfg.spec and draft_params is None:
            draft_params = (make_draft_params(params, cfg)
                            if scfg.spec_draft == "pack" else params)
        self.draft_params = draft_params
        self.prefill_plan = dispatch.plan_params(
            params, scfg.prompt_pad, self.device,
            MZ.expert_rows(cfg, scfg.prompt_pad))
        self.decode_plan = dispatch.plan_params(
            params, scfg.slots, self.device, MZ.expert_rows(cfg, scfg.slots))
        self.draft_plan: List[dict] = []
        self.verify_plan: List[dict] = []
        if scfg.spec:
            # a speculative chunk runs both phases: the draft at the
            # decode geometry, the verify at slots * (spec_k + 1) rows
            self.draft_plan = dispatch.plan_params(draft_params, scfg.slots,
                                                   self.device)
            self.verify_plan = dispatch.plan_params(
                params, scfg.slots * (scfg.spec_k + 1), self.device)
            self.decode_plan = self.decode_plan + self.draft_plan \
                + self.verify_plan
        self._backend = make_backend(cfg, scfg, self._stats, self.device,
                                     draft_params)
        self._slot_req: List[Optional[Request]] = [None] * scfg.slots
        self._temps = np.full((scfg.slots,), scfg.temperature, np.float32)
        self._cache = None
        self._bufs: Optional[ChunkBuffers] = None

    # --- introspection ------------------------------------------------

    @property
    def num_live(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    def reset_stats(self) -> None:
        """Zero the serving counters, the speculative drafted/accepted
        tallies and the prefix-sharing tallies included."""
        self.sync_count = 0
        self._stats.clear()
        self._stats.update(fresh_stats())

    def acceptance_rate(self) -> float:
        """Accepted over drafted tokens since the last reset (0 without
        speculation); also ``stats().acceptance_rate``."""
        return self._stats["accepted"] / max(self._stats["drafted"], 1)

    def _cache_nbytes(self) -> int:
        if self._cache is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in MZ.cache_leaves(self._cache))

    def stats(self) -> EngineStats:
        d = self._stats
        return EngineStats(chunk_s=list(d["chunk_s"]),
                           chunk_tokens=list(d["chunk_tokens"]),
                           prefills=d["prefills"], peak_pages=d["peak_pages"],
                           admission_waits=d["admission_waits"],
                           drafted=d["drafted"], accepted=d["accepted"],
                           prefix_hits=d["prefix_hits"],
                           shared_pages=d["shared_pages"],
                           cow_copies=d["cow_copies"],
                           sync_count=self.sync_count,
                           cache_bytes=self._cache_nbytes(),
                           acceptance_rate=self.acceptance_rate(),
                           chunk_runs=list(d["chunk_runs"]),
                           graph_captures=list(d["graph_captures"]))

    def ttfts_s(self) -> List[float]:
        return [r.ttft_s for r in self.finished if r.ttft_s is not None]

    # --- request intake -------------------------------------------------

    def _coerce_prompt(self, prompt) -> np.ndarray:
        arr = np.asarray(prompt)
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D (one request), got shape {arr.shape}")
        if arr.size == 0:
            raise ValueError("prompt is empty — nothing to prefill")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"prompt must hold integer token ids, got dtype {arr.dtype}")
        if arr.size > self.scfg.max_len - 1:
            raise ValueError(
                f"prompt of {arr.size} tokens cannot fit max_len="
                f"{self.scfg.max_len} with room to decode")
        if arr.min() < 0 or arr.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must lie in "
                             f"[0, {self.cfg.vocab_size})")
        return arr.astype(np.int32)

    def register_prefix(self, tokens: Union[Sequence[int], np.ndarray]
                        ) -> PrefixHandle:
        """Pin a shared prompt head; returns its :class:`PrefixHandle`.

        ``tokens`` must be a whole number of pages: they are computed once
        into index-owned pages (reusing pages already resident) and every
        page takes a refcount the handle holds, so the head stays warm
        until :meth:`PrefixHandle.release`.

        Contract: the registered tokens occupy prompt rows ``[0, len)``.
        Prompts are left-padded to their bucket, so a submission shares
        these pages exactly when its *padded* head equals them — the full
        prompt (prefix + suffix) fills its bucket, or the caller
        registers the padded head it will submit.
        """
        scfg = self.scfg
        if not scfg.prefix_cache:
            raise ValueError(
                "register_prefix needs ServeConfig.prefix_cache=True "
                "(and the paged layout, page_size > 0)")
        arr = self._coerce_prompt(tokens)
        if len(arr) % scfg.page_size:
            raise ValueError(
                f"a registered prefix must be a whole number of pages: "
                f"got {len(arr)} tokens with page_size={scfg.page_size}")
        self._ensure_device_state()
        nodes, page_row = self._backend.register_prefix(arr)
        if page_row is not None:
            fill = self._backend.prefix_fill_step(len(arr))
            self._cache = fill(
                self.params, torch.from_numpy(arr[None]).to(self.device),
                self._cache, torch.from_numpy(page_row).to(self.device))
        return PrefixHandle(self, arr.copy(), nodes)

    def _release_prefix(self, handle: PrefixHandle) -> None:
        self._backend.release_prefix(handle._nodes)

    def submit(self, prompt: Union[Sequence[int], np.ndarray], *,
               max_new: Optional[int] = None,
               temperature: Optional[float] = None,
               stream: bool = False,
               prefix: Optional[PrefixHandle] = None) -> RequestHandle:
        """Queue one request.  Prompts longer than the prefill window are
        left-truncated to their last ``prompt_rows`` tokens; shorter ones
        are left-padded with token 0 (the pads are attended, as in the
        JAX engine).  ``prefix`` prepends a :meth:`register_prefix`
        handle's tokens to ``prompt``.  Under speculation every request
        samples at ``ServeConfig.temperature`` (residual acceptance
        needs the draft and verify distributions at one temperature), so
        another ``temperature`` raises."""
        scfg = self.scfg
        if prefix is not None:
            if prefix._engine is not self:
                raise ValueError("prefix handle belongs to a different "
                                 "engine")
            if prefix.released:
                raise ValueError("prefix handle was released")
            prompt = np.concatenate(
                [prefix.tokens, np.asarray(prompt, np.int32).ravel()])
        arr = self._coerce_prompt(prompt)
        if max_new is None:
            max_new = scfg.max_new_tokens
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        if temperature is not None and scfg.spec \
                and float(temperature) != scfg.temperature:
            raise ValueError(
                "per-request temperature is not supported with speculative "
                "decoding (residual acceptance needs draft and verify at one "
                "temperature): set ServeConfig.temperature instead")
        if scfg.paged and scfg.request_pages(len(arr), max_new) \
                > scfg.pool_pages:
            raise ValueError(
                f"request needs {scfg.request_pages(len(arr), max_new)} "
                f"pages but the pool only has {scfg.pool_pages}")
        req = Request(uid=self._uid_next, prompt=arr, max_new=max_new,
                      temperature=temperature, stream=stream)
        self._uid_next += 1
        self.queue.append(req)
        return RequestHandle(self, req)

    def cancel(self, handle: Union[RequestHandle, Request, int]) -> None:
        """Request cancellation (effective at the next chunk boundary);
        a no-op on a terminal request."""
        if isinstance(handle, RequestHandle):
            req = handle._req
        elif isinstance(handle, Request):
            req = handle
        else:
            req = next((r for r in self.queue + self._slot_req
                        if r is not None and r.uid == handle), None)
            if req is None:
                return
        if req.status not in TERMINAL_STATUSES:
            req.cancel_requested = True

    # --- the scheduler tick ---------------------------------------------

    def _pad_prompt(self, r: Request, rows: int) -> np.ndarray:
        tokens = np.zeros((1, rows), np.int32)
        L = min(len(r.prompt), rows)
        tokens[0, rows - L:] = r.prompt[-L:]                  # left-pad
        return tokens

    def _ensure_device_state(self) -> None:
        if self._cache is None:
            scfg = self.scfg
            self._cache = MZ.init_cache(
                self.cfg, scfg.slots, scfg.max_len, page_size=scfg.page_size,
                num_pages=scfg.pool_pages, device=self.device)
            self._bufs = ChunkBuffers(scfg.slots, scfg.chunk_tokens,
                                      scfg.max_pages if scfg.paged else 0,
                                      self.device)

    def _finish(self, req: Request, slot: Optional[int],
                status: RequestStatus, now: float) -> None:
        req.done = True
        req.status = status
        req.finish_s = now
        self.finished.append(req)
        if slot is not None:
            self._slot_req[slot] = None
            self._backend.retire(slot)

    def _apply_cancels(self) -> None:
        now = time.perf_counter()
        for i, r in enumerate(self._slot_req):
            if r is not None and r.cancel_requested:
                self._bufs.state["done"][i] = True
                self._bufs.state["left"][i] = 0
                self._finish(r, i, RequestStatus.CANCELLED, now)
        for r in [r for r in self.queue if r.cancel_requested]:
            self.queue.remove(r)
            self._finish(r, None, RequestStatus.CANCELLED, now)

    def _temp(self, r: Request) -> float:
        return self.scfg.temperature if r.temperature is None \
            else float(r.temperature)

    def _generator(self, temps) -> Optional[torch.Generator]:
        return self._gen if np.any(np.asarray(temps) > 0) else None

    def _admit(self) -> None:
        """Fill free slots from the queue in FIFO order: one wave prefill
        when every slot is free and the backend has one, else per-slot
        refill gated by the backend's admission check."""
        scfg = self.scfg
        head = self.queue[:scfg.slots]
        wave = self._backend.wave_step() if head and self.num_live == 0 \
            else None
        if wave is not None:
            del self.queue[:len(head)]
            prompts = np.zeros((scfg.slots, scfg.prompt_pad), np.int32)
            budgets = np.zeros(scfg.slots, np.int32)
            valid = np.zeros(scfg.slots, bool)
            for i, r in enumerate(head):
                prompts[i] = self._pad_prompt(r, scfg.prompt_pad)[0]
                budgets[i] = r.max_new
                valid[i] = True
                self._temps[i] = self._temp(r)
                r.rows0 = self._backend.admit(i, len(r.prompt), r.max_new)
                self._start(r, i)
            self._bufs.stage(self._temps)
            self._cache, _ = wave(
                self.params, torch.from_numpy(prompts).to(self.device),
                self._cache, self._bufs.state, valid, budgets,
                self._bufs.temps, self._generator(self._temps[valid]))
            self._stats["prefills"] += len(head)
            return
        while self.queue:
            free = [i for i in range(scfg.slots) if self._slot_req[i] is None]
            if not free:
                break
            r = self.queue[0]
            # the padded rows are what the prefix index keys on: matching
            # and the copy-on-write plan happen in the backend
            rows = self._backend.prompt_rows(len(r.prompt))
            padded = self._pad_prompt(r, rows)
            if not self._backend.can_admit(len(r.prompt), r.max_new,
                                           tokens=padded[0], rows=rows):
                self._stats["admission_waits"] += 1
                break
            self.queue.pop(0)
            i = free[0]
            r.rows0 = self._backend.admit(i, len(r.prompt), r.max_new,
                                          tokens=padded[0], rows=rows)
            start, cow = self._backend.prefill_plan(i)
            temp = self._temp(r)
            tokens = torch.from_numpy(padded[:, start:]).to(self.device)
            self._cache, _ = self._backend.prefill_step(rows, start, cow)(
                self.params, tokens, self._cache, self._bufs.state, i,
                r.max_new, temp, self._generator([temp]),
                *self._backend.prefill_args(i))
            self._temps[i] = temp
            self._start(r, i)
            self._stats["prefills"] += 1

    def _start(self, r: Request, slot: int) -> None:
        r.slot = slot
        r.status = RequestStatus.RUNNING
        self._slot_req[slot] = r

    def _collect(self, blk: np.ndarray, emit: np.ndarray, done: np.ndarray,
                 dt: float) -> List[TokenEvent]:
        """Distribute one fetched token block in emission order, stamp
        TTFTs, record the chunk stats and retire finished slots."""
        now = time.perf_counter()
        emitted = []
        for t in range(blk.shape[0]):       # chunk_tokens rows under spec
            for i, r in enumerate(self._slot_req):
                if emit[t, i] and r is not None:
                    r.out.append(int(blk[t, i]))
                    if r.first_token_s is None:
                        r.first_token_s = now
                    self._backend.note_commit(i)
                    emitted.append((r, len(r.out) - 1))
        self._stats["chunk_s"].append(dt)
        self._stats["chunk_tokens"].append(len(emitted))
        for i, r in enumerate(self._slot_req):
            if r is not None and done[i]:
                self._finish(r, i, RequestStatus.DONE, now)
        return [TokenEvent(uid=r.uid, token=r.out[idx], index=idx,
                           final=(r.done and idx == len(r.out) - 1))
                for r, idx in emitted]

    def step(self) -> List[TokenEvent]:
        """One scheduler tick: cancellations → admission (+ prefill) →
        one decode chunk → the single fetch.  Returns the tick's tokens
        in emission order (empty when nothing is live)."""
        self._ensure_device_state()
        self._apply_cancels()
        self._admit()
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not live:
            return []
        generator = self._generator(self._temps[live])
        chunk = self._backend.begin_chunk(live, sampled=generator is not None)
        t0 = time.perf_counter()
        chunk(self.params, self._cache, self._bufs, self._temps, generator)
        tokens, emitted, done, tally = self._bufs.fetch(_fetch)  # one sync
        self.sync_count += 1
        self._stats["drafted"] += int(tally[0])
        self._stats["accepted"] += int(tally[1])
        events = self._collect(tokens, emitted, done,
                               time.perf_counter() - t0)
        self._backend.end_chunk(
            [i for i in live if self._slot_req[i] is not None])
        return events

    # --- convenience wrappers -------------------------------------------

    def run(self) -> List[Request]:
        """Serve until the queue drains; returns the finished requests
        (cumulative across calls)."""
        while self.queue or self.num_live:
            if not self.step() and not self.num_live and self.queue:
                raise RuntimeError("admission is blocked with nothing live")
        return self.finished

    def generate(self, prompts: Sequence[Any], *,
                 max_new: Optional[int] = None,
                 temperature: Optional[float] = None) -> List[List[int]]:
        """Submit a batch of prompts, serve to completion, and return each
        request's tokens in submission order."""
        handles = [self.submit(p, max_new=max_new, temperature=temperature)
                   for p in prompts]
        self.run()
        return [h.tokens for h in handles]
