"""The streaming :class:`Engine` of the port.

  * ``submit(prompt, *, max_new=None, temperature=None, stream=False,
    priority=0, deadline_ms=None)`` → :class:`RequestHandle`; admission
    happens at the next ``step()``, highest priority first.  With
    ``ServeConfig.max_queue`` a submission past the bound comes back
    ``REJECTED``.
  * ``step()`` → ``list[TokenEvent]`` — one scheduler tick: apply pending
    cancellations and deadlines, admit queued requests into free slots
    (per-slot prefill, zero host syncs; a whole-batch wave prefill when
    every slot is free and the layout allows it; under pool exhaustion a
    lower-priority slot is preempted), then run ONE guarded decode chunk
    on the card, make the single device→host fetch and check the block.
    On the card every chunk after its key's first is the replay of one
    captured CUDA graph (``serving.loops.DecodeChunk``).
  * ``cancel(handle)`` — takes effect at the next chunk boundary.
  * ``run()`` / ``generate()`` — drain-the-queue wrappers over ``step()``.
  * ``register_prefix(tokens)`` → :class:`PrefixHandle` — pin a shared
    prompt head in the paged backend's prefix index;
    ``submit(..., prefix=handle)`` prepends it.  Sharing itself is
    automatic (by content, at admission) whenever
    ``ServeConfig.prefix_cache`` is on.
  * ``snapshot(dir)`` / ``Engine.restore(...)`` — with
    ``ServeConfig.journal_path`` every submission, pin, admission,
    delivered chunk and terminal status goes to a write-ahead journal
    (``serving.journal``) before ``step()`` returns; a fresh engine
    restored from the latest snapshot plus the journal's tail resumes
    every request with no token duplicated or dropped
    (``serving.supervisor`` does it on a crash or a hang).
  * speculative decoding with ``ServeConfig.spec_k > 0``: each decode
    step drafts ``spec_k`` tokens per slot with the draft params (the
    model itself, ``spec_draft="self"``, or its sparse packs,
    ``"pack"``) and verifies them in one block forward of the verify
    params; greedy output equals the plain loop's for any draft.

Sync contract (as in the JAX engine): ``step()`` performs exactly one
device→host transfer when any slot is live and zero otherwise — the
speculative drafted/accepted counts ride in it; ``sync_count`` counts
them (a retried fetch counts once).  Faults are contained by the
:class:`~repro_torch.serving.faults.FaultTolerance` mixin (its docstring
holds the policy); ``REPRO_CHAOS_SEED`` attaches a
:class:`~repro_torch.serving.chaos.ChaosMonkey` at construction.
Sharding is ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import os
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
from repro_torch.serving.faults import FaultTolerance
from repro_torch.serving.journal import (Journal, recover_engine,
                                         snapshot_engine)
from repro_torch.serving.prefix import PrefixHandle
from repro_torch.serving.state import (IDLE_TICKS, TERMINAL_STATUSES,
                                       ChunkBuffers, EngineStats, Request,
                                       RequestHandle, RequestStatus,
                                       TokenEvent, _device_fetch, fresh_stats)

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


def _fetch_chunk(bufs: ChunkBuffers) -> tuple:
    """The engine's ``_device_fetch`` seam: the chunk's one transfer,
    unpacked into host ``(tokens, emitted, done, tally)``."""
    return bufs.fetch(_fetch)


class Engine(FaultTolerance):
    """Slot-based continuous batching on one device, request-level API.

    Every slot carries its own position, done flag, token budget and
    temperature, all on the device between host fetches.  Finished or
    cancelled slots are refilled at the next chunk boundary by a
    per-slot prefill; in-flight slots never stall.  ``params`` must lie
    on ``device``; the engine keeps its cache and decode buffers at fixed
    addresses for its whole life (its chunk graphs hold them).

    ``priority`` and ``deadline_ms`` per request and ``scfg.max_queue``
    bound what a request waits for; a contained fault in a chunk (an
    injected dispatch raise, a dropped fetch, non-finite tokens) costs
    the requests it touched a retry and degrades the engine onto the
    plain versions for a while, never the tick; a real kernel error
    raises (``serving.faults``).

    Under speculation (``scfg.spec_k > 0``) ``params`` verify and
    ``draft_params`` draft; without them the draft is ``params`` itself
    (``spec_draft="self"``) or ``core.sparse_linear.make_draft_params``
    of them (``"pack"``: the config's sparse packs of the same weights,
    sharing every unpacked tensor).
    """

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Any, *,
                 draft_params: Any = None, device="cuda"):
        scfg.validate()
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
        self._tick = 0                  # completed scheduler ticks
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
        # --- fault tolerance: the seams a chaos monkey wraps per engine
        self.degraded = False
        self._clean_chunks = 0          # fault-free chunks in a row
        self._device_fetch = _fetch_chunk
        self._chaos = None
        if self.device.type == "cuda":
            # a build or load error raises here, never inside a guarded
            # chunk, where it would degrade the engine instead
            dispatch.load_kernels()
        # --- crash safety: pinned prefixes by pid and the journal
        self._pins: Dict[int, PrefixHandle] = {}
        self._pin_next = 0
        self.journal: Optional[Journal] = None
        if scfg.journal_path:
            self.journal = Journal(scfg.journal_path)
            self.journal.log_config(scfg)
        if os.environ.get("REPRO_CHAOS_SEED"):
            from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey
            ChaosMonkey(self, ChaosConfig.from_env()).attach()

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
                           graph_captures=list(d["graph_captures"]),
                           timeouts=d["timeouts"],
                           rejections=d["rejections"],
                           preemptions=d["preemptions"],
                           numeric_faults=d["numeric_faults"],
                           kernel_failures=d["kernel_failures"],
                           fetch_errors=d["fetch_errors"],
                           degraded=self.degraded,
                           degraded_recoveries=d["degraded_recoveries"],
                           restarts=d["restarts"])

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
            with dispatch.plain_versions(self.degraded):
                self._cache = fill(
                    self.params, torch.from_numpy(arr[None]).to(self.device),
                    self._cache, torch.from_numpy(page_row).to(self.device))
        h = PrefixHandle(self, arr.copy(), nodes)
        h._pid = self._pin_next
        self._pin_next += 1
        self._pins[h._pid] = h
        if self.journal is not None:
            self.journal.log_pin(h._pid, arr)
        return h

    def _release_prefix(self, handle: PrefixHandle) -> None:
        self._backend.release_prefix(handle._nodes)
        if handle._pid is not None:
            self._pins.pop(handle._pid, None)
            if self.journal is not None:
                self.journal.log_unpin(handle._pid)

    def submit(self, prompt: Union[Sequence[int], np.ndarray], *,
               max_new: Optional[int] = None,
               temperature: Optional[float] = None,
               stream: bool = False,
               prefix: Optional[PrefixHandle] = None,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> RequestHandle:
        """Queue one request.  Prompts longer than the prefill window are
        left-truncated to their last ``prompt_rows`` tokens; shorter ones
        are left-padded with token 0 (the pads are attended, as in the
        JAX engine).  ``prefix`` prepends a :meth:`register_prefix`
        handle's tokens to ``prompt``.  Under speculation every request
        samples at ``ServeConfig.temperature`` (residual acceptance
        needs the draft and verify distributions at one temperature), so
        another ``temperature`` raises.

        ``priority`` orders admission (higher first, FIFO within a level)
        and arms preemption: under pool exhaustion the scheduler evicts
        the lowest-priority running slot strictly below the blocked
        head's priority.  ``deadline_ms`` is a wall-clock budget from
        submission: at the first chunk boundary past it the request ends
        ``TIMED_OUT``, queued or running.  With ``scfg.max_queue`` a
        submission past the bound returns an already finished
        ``REJECTED`` handle."""
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
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms}")
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
                      temperature=temperature, stream=stream,
                      priority=int(priority), deadline_ms=deadline_ms)
        self._uid_next += 1
        if scfg.max_queue and len(self.queue) >= scfg.max_queue:
            self._stats["rejections"] += 1
            self._finish(req, None, RequestStatus.REJECTED,
                         time.perf_counter())
        else:
            self.queue.append(req)
        if self.journal is not None:    # durable before the handle is
            self.journal.log_submit(req)    # returned to the caller
        return RequestHandle(self, req)

    def cancel(self, handle: Union[RequestHandle, Request, int]) -> None:
        """Request cancellation (effective at the next chunk boundary);
        a no-op on a terminal request — finished, cancelled, timed out,
        rejected or failed — so pages are never released twice."""
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
        """Left-pad the request's effective prompt (the prompt and any
        tokens emitted before a preemption) to ``rows``.  A resumed
        request's width is ``rows0 + emitted``, so its pad count equals
        the first admission's: the padded layout (so any published prefix
        pages, and the greedy stream) survives preempt → requeue →
        re-prefill."""
        eff = r.eff_prompt
        tokens = np.zeros((1, rows), np.int32)
        L = min(len(eff), rows)
        tokens[0, rows - L:] = eff[-L:]                      # left-pad
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
        req.set_status(status)
        req.finish_s = now
        self.finished.append(req)
        if slot is not None:
            self._retire_slot(slot)

    def _apply_cancels(self) -> None:
        """Chunk-boundary cancellation: freeze the slot's decode state in
        place, retire it (pages freed) and drop cancelled queue entries;
        each request's flag is consumed exactly once."""
        now = time.perf_counter()
        for i, r in enumerate(self._slot_req):
            if r is not None and r.cancel_requested:
                r.cancel_requested = False
                self._freeze_slot(i)
                self._finish(r, i, RequestStatus.CANCELLED, now)
        for r in [r for r in self.queue if r.cancel_requested]:
            r.cancel_requested = False
            self.queue.remove(r)
            self._finish(r, None, RequestStatus.CANCELLED, now)

    def _temp(self, r: Request) -> float:
        return self.scfg.temperature if r.temperature is None \
            else float(r.temperature)

    def _generator(self, temps) -> Optional[torch.Generator]:
        return self._gen if np.any(np.asarray(temps) > 0) else None

    def _admit(self) -> None:
        """Fill free slots from the queue, highest priority first and FIFO
        within a level (a stable sort on the submission uid; a preempted
        request keeps its uid, so it re-admits ahead of later arrivals of
        its level).  One wave prefill when every slot is free, no queued
        request is a resumption and the backend has one; else per-slot
        refill gated by the backend's admission check.  When the head is
        blocked the lowest-priority running slot strictly below it is
        preempted, else the head waits (head-of-line blocking keeps FIFO
        fairness)."""
        scfg = self.scfg
        self.queue.sort(key=lambda r: (-r.priority, r.uid))
        head = self.queue[:scfg.slots]
        wave = self._backend.wave_step() if head and self.num_live == 0 \
            and all(r.rows0 is None for r in head) else None
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
            eff_len = len(r.prompt) + len(r.out)
            rows = r.resume_rows or self._backend.prompt_rows(eff_len)
            # the padded rows are what the prefix index keys on: matching
            # and the copy-on-write plan happen in the backend
            padded = self._pad_prompt(r, rows)
            if not self._backend.can_admit(eff_len, r.remaining_new,
                                           tokens=padded[0], rows=rows):
                victim = self._victim_slot(r.priority)
                if victim is None:
                    self._stats["admission_waits"] += 1
                    break
                self._preempt(victim, time.perf_counter())
                continue
            self.queue.pop(0)
            i = free[0]
            rows = self._backend.admit(i, eff_len, r.remaining_new,
                                       tokens=padded[0], rows=rows)
            if r.rows0 is None:
                r.rows0 = rows
            start, cow = self._backend.prefill_plan(i)
            temp = self._temp(r)
            tokens = torch.from_numpy(padded[:, start:]).to(self.device)
            self._cache, _ = self._backend.prefill_step(rows, start, cow)(
                self.params, tokens, self._cache, self._bufs.state, i,
                r.remaining_new, temp, self._generator([temp]),
                *self._backend.prefill_args(i))
            self._temps[i] = temp
            self._start(r, i)
            self._stats["prefills"] += 1

    def _start(self, r: Request, slot: int) -> None:
        r.slot = slot
        r.set_status(RequestStatus.RUNNING)
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
        """One scheduler tick: cancellations → deadlines → admission
        (+ prefill, preempting lower-priority slots under pool
        exhaustion) → one guarded decode chunk → the single fetch → the
        numeric guard → the chunk's health → the journal's chunk boundary.
        Returns the tick's tokens in emission order (empty when nothing is
        live).  Never raises on an injected or transient fault: the
        requests it touched end terminal or go back to the queue.  Every
        tick counts in ``_tick``, an idle one too; with a journal its
        records are fsync'd before the tokens are returned."""
        self._ensure_device_state()
        self._apply_cancels()
        self._apply_deadlines()
        with dispatch.plain_versions(self.degraded):
            self._admit()
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        events = self._decode(live) if live else []
        self._tick += 1
        if self.journal is not None:    # the chunk-boundary fsync runs
            self.journal.record_tick(self, events)  # BEFORE delivery
        return events

    def _decode(self, live: List[int]) -> List[TokenEvent]:
        """One guarded decode chunk over the ``live`` slots, its fetch,
        the numeric guard and the chunk's health; the tick's tokens."""
        generator = self._generator(self._temps[live])
        chunk = self._backend.begin_chunk(live, sampled=generator is not None)
        t0 = time.perf_counter()
        f0 = self._fault_count()
        fetched = self._run_chunk(chunk, generator)
        dt = time.perf_counter() - t0
        events: List[TokenEvent] = []
        if fetched is None:         # every fetch failed: the chunk's
            now = time.perf_counter()   # tokens are lost
            for i in live:
                self._quarantine(i, now)
        else:
            blk, emit = self._guard_block(fetched[0], fetched[1])
            events = self._collect(blk, emit, fetched[2], dt)
        self._note_chunk_health(self._fault_count() != f0)
        self._backend.end_chunk(
            [i for i in live if self._slot_req[i] is not None])
        return events

    # --- crash safety ---------------------------------------------------

    def snapshot(self, directory: str) -> str:
        """One atomic, digest-verified checkpoint of the scheduler state
        (config, queue and slot occupancy, pins, stats, the generator
        state) through :mod:`repro_torch.checkpoint.store`; returns the
        step directory (``serving.journal.snapshot_engine``)."""
        return snapshot_engine(self, directory)

    @classmethod
    def restore(cls, cfg: ModelConfig, params: Any, *,
                scfg: Optional[ServeConfig] = None,
                draft_params: Any = None,
                journal_path: Optional[str] = None,
                snapshot_dir: Optional[str] = None, device="cuda"):
        """A fresh engine on ``device`` with the snapshot and the journal
        replayed into it; non-terminal requests are re-queued to resume
        exactly.  Returns the :class:`~repro_torch.serving.journal.Recovered`
        bundle (``.engine``, ``.handles``, ``.prefixes``, ``.timings``)."""
        return recover_engine(cfg, params, scfg=scfg,
                              draft_params=draft_params,
                              journal_path=journal_path,
                              snapshot_dir=snapshot_dir, device=device)

    # --- convenience wrappers -------------------------------------------

    def run(self) -> List[Request]:
        """Serve until the queue drains; returns the finished requests
        (cumulative across calls).  Past ``IDLE_TICKS`` empty ticks in a
        row a blocked admission with nothing live raises."""
        idle = 0
        while self.queue or self.num_live:
            if self.step() or self.num_live:
                idle = 0
                continue
            idle += 1               # admission blocked with nothing live
            if idle > IDLE_TICKS:
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
