"""Cache backends: the layout-specific half of the serving engine.

  * :class:`MonoBackend` — the monolithic ``(slots, max_len, …)`` cache:
    admission always succeeds, retirement is free, and the whole-batch
    wave prefill is available.
  * :class:`PagedBackend` — the shared page pool + per-slot page tables.
    Owns the host-side allocator: worst-case page *reservation* at
    admission (requests wait instead of running out of pages), lazy
    allocation at prefill and chunk boundaries, recycling and table
    nulling at retirement, per-request prompt buckets, and the decode
    attention view narrowed to the live slots' page bucket.  With
    ``ServeConfig.prefix_cache`` it also keeps the prefix index: full
    prompt pages shared by content, copy-on-write at a divergence inside
    a page, and pinned prefixes.

Everything here is host arithmetic over already-fetched state plus
host→device argument passing (the page table): backends never add a
device→host sync.  Each backend hands the scheduler the serving
programs of ``serving.loops`` for its layout, and owns the decode chunk
programs: one :class:`~repro_torch.serving.loops.DecodeChunk` per key
``(view_pages, sampled)``, whose CUDA graphs share one memory pool and
one capture stream; the speculative chunk body is chosen by
``scfg.spec`` in the shared base, so one spec builder serves both
layouts.  ``tokens`` in the
admission calls is the request's *padded* prompt (sharing keys on the
padded layout); layouts without an index ignore it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving import loops
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.prefix import PrefixIndex


class _BackendBase:
    paged = False

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 stats: Dict[str, Any], device: torch.device,
                 draft_params: Any = None):
        self.cfg, self.scfg, self.stats, self.device = cfg, scfg, stats, device
        self.draft_params = draft_params
        self._prefill_steps: Dict[Tuple[int, int, bool], Callable] = {}
        self._chunks: Dict[Tuple[Optional[int], bool],
                           loops.DecodeChunk] = {}
        # decode chunks run as captured CUDA graphs on the card; turned
        # off only to compare against the eager body (the chip smoke run
        # and the GPU tests)
        self._graphs = device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._graphs \
            else None
        self._stream = torch.cuda.Stream(device) if self._graphs else None

    def prefill_plan(self, slot: int) -> Tuple[int, bool]:
        """(start row, needs a copy-on-write copy) of the slot's pending
        prefill — (0, False) unless prefix sharing mapped resident
        pages."""
        return 0, False

    def prefill_step(self, rows: int, start: int = 0,
                     cow: bool = False) -> Callable:
        key = (rows, start, cow)
        fn = self._prefill_steps.get(key)
        if fn is None:
            if start or cow:
                fn = loops.build_prefix_prefill_slot_step(
                    self.cfg, self.scfg, prompt_rows=rows, start=start,
                    cow=cow)
            else:
                fn = loops.build_prefill_slot_step(
                    self.cfg, self.scfg, prompt_rows=rows, paged=self.paged)
            self._prefill_steps[key] = fn
        return fn

    def _chunk(self, view: Optional[int], sampled: bool,
               ptab: Optional[np.ndarray] = None) -> Callable:
        """The key's chunk program, bound to this chunk's page table:
        ``(params, cache, bufs, temps, generator) → None``."""
        key = (view, sampled)
        run = self._chunks.get(key)
        if run is None:
            if self.scfg.spec:
                body = loops.build_spec_decode_chunk(
                    self.cfg, self.scfg, self.draft_params,
                    paged=self.paged, view_pages=view)
            else:
                body = loops.build_decode_chunk(
                    self.cfg, self.scfg, paged=self.paged, view_pages=view)
            run = self._chunks[key] = loops.DecodeChunk(
                body, key, self.stats, self._pool, self._stream)
        return functools.partial(run, ptab=ptab, graphs=self._graphs)


class MonoBackend(_BackendBase):
    """Monolithic ``slots × max_len`` cache: no allocator, no extra loop
    operands, and the wave-prefill fast path."""

    paged = False

    def prompt_rows(self, prompt_len: int) -> int:
        return self.scfg.prompt_pad

    def can_admit(self, prompt_len: int, max_new: int,
                  tokens: Optional[np.ndarray] = None,
                  rows: Optional[int] = None) -> bool:
        return True

    def admit(self, slot: int, prompt_len: int, max_new: int,
              tokens: Optional[np.ndarray] = None,
              rows: Optional[int] = None) -> int:
        # ``rows`` is a resumed request's exact prefill width (rows0 +
        # emitted); fresh admissions use the uniform prompt_pad
        return rows or self.scfg.prompt_pad

    def prefill_args(self, slot: int) -> Tuple:
        return ()

    def wave_step(self) -> Optional[Callable]:
        return loops.build_prefill_wave_step(self.cfg, self.scfg)

    def begin_chunk(self, live_slots: List[int], sampled: bool) -> Callable:
        return self._chunk(None, sampled)

    def note_commit(self, slot: int) -> None:
        pass

    def end_chunk(self, live_slots: List[int]) -> None:
        pass

    def retire(self, slot: int) -> None:
        pass


class PagedBackend(_BackendBase):
    """Shared page pool + per-slot page tables.  The admission
    reservation guarantees a request, once admitted, can always reach its
    budget: waiting happens at admission, never mid-decode.

    With ``scfg.prefix_cache`` a :class:`~repro_torch.serving.prefix
    .PrefixIndex` keys resident full prompt pages by content: admission
    maps matched pages read-only at the head of the slot's table
    (refcount +1 each), reserves only the private remainder, and plans
    the prefill to start at the first non-shared row — with a
    copy-on-write page copy when the divergence falls inside a page.
    Decode only ever reads shared pages (each slot writes at its own
    positions, past its prompt rows).  At retirement shared pages are
    decref'd, not freed: refcount zero keeps them warm in the index, and
    they rejoin the free list only through eviction.  With the flag off
    every path reduces to the plain allocator (same free-list order,
    same stats).  The accounting is per slot, whatever the number of
    paged KV layers: zamba2 pages the KV of its 6 shared slots only,
    and mamba2 has no KV, so its tables reach no pool (the JAX backend
    counts pages the same way).
    """

    paged = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        scfg = self.scfg
        self.free_pages: List[int] = list(range(scfg.pool_pages, 0, -1))
        self.reserved = 0
        self.slot_pages: List[List[int]] = [[] for _ in range(scfg.slots)]
        self.slot_need = [0] * scfg.slots
        self.slot_rows = [0] * scfg.slots
        self.ptab = np.zeros((scfg.slots, scfg.max_pages), np.int32)
        # --- prefix sharing ------------------------------------------
        self.prefix_on = scfg.prefix_cache
        self.index: Optional[PrefixIndex] = (
            PrefixIndex(scfg.page_size, scfg.prefix_cache_pages)
            if self.prefix_on else None)
        self.slot_shared: List[List[Any]] = [[] for _ in range(scfg.slots)]
        self.slot_resv = [0] * scfg.slots      # private pages reserved
        self.slot_plan: List[Tuple[int, int, int]] = \
            [(0, 0, 0)] * scfg.slots           # (start, cow_src, cow_dst)
        self._prefix_fills: Dict[int, Callable] = {}

    # --- admission / prefill ------------------------------------------

    def prompt_rows(self, prompt_len: int) -> int:
        return self.scfg.prompt_rows(prompt_len)

    def can_admit(self, prompt_len: int, max_new: int,
                  tokens: Optional[np.ndarray] = None,
                  rows: Optional[int] = None) -> bool:
        rows = rows or self.scfg.prompt_rows(prompt_len)
        need = self.scfg.rows_pages(rows, max_new)
        if not self.prefix_on:
            return self.reserved + need <= self.scfg.pool_pages
        # shared hits shrink the private need; retained (refcount-zero)
        # pages are reclaimable on demand, so only live ones count
        if tokens is not None:
            nodes, _ = self.index.match(tokens, rows)
            need -= min(len(nodes), (rows - 1) // self.scfg.page_size)
        return (self.reserved + need + self.index.live_pages
                <= self.scfg.pool_pages)

    def admit(self, slot: int, prompt_len: int, max_new: int,
              tokens: Optional[np.ndarray] = None,
              rows: Optional[int] = None) -> int:
        scfg = self.scfg
        ps = scfg.page_size
        rows = rows or scfg.prompt_rows(prompt_len)
        need = scfg.rows_pages(rows, max_new)
        self.slot_need[slot] = need
        self.slot_rows[slot] = rows
        self.ptab[slot] = 0
        self.slot_plan[slot] = (0, 0, 0)
        if not (self.prefix_on and tokens is not None):
            self.slot_resv[slot] = need
            self.reserved += need
            self._alloc(slot, -(-rows // ps))
            return rows
        nodes, partial = self.index.match(tokens, rows)
        maxb = (rows - 1) // ps        # >= 1 row must be recomputed for
        if len(nodes) > maxb:          # the first token's logits: a full
            partial = (nodes[maxb], ps)    # match copies its tail page
            nodes = nodes[:maxb]           # and redoes the last row
        m = len(nodes)
        start = m * ps
        r = 0
        if partial is not None:
            pnode, r = partial
            r = min(r, rows - 1 - start)
        for b, nd in enumerate(nodes):
            self.index.acquire(nd)
            self.ptab[slot, b] = nd.page
        self.slot_shared[slot] = list(nodes)
        self.slot_resv[slot] = need - m
        self.reserved += self.slot_resv[slot]
        self._alloc(slot, -(-rows // ps))
        cow_src = cow_dst = 0
        if r >= 1:
            cow_src, cow_dst = pnode.page, int(self.ptab[slot, m])
            start = m * ps + r
            self.stats["cow_copies"] += 1
        if start:
            self.stats["prefix_hits"] += 1
            self.stats["shared_pages"] += m
        self.slot_plan[slot] = (start, cow_src, cow_dst)
        self._index_prompt(slot, tokens, rows, m)
        return rows

    def _index_prompt(self, slot: int, tokens: np.ndarray, rows: int,
                      m: int) -> None:
        """Publish the slot's freshly computed full prompt pages
        (``[m, rows // ps)``) into the index: their ownership moves from
        the slot's private list to the trie (refcount 1 for this slot,
        decref'd at retirement instead of freed).  Their content is
        written by this admission's prefill, which the card runs before
        any later reader."""
        ps = self.scfg.page_size
        shared = self.slot_shared[slot]
        parent = shared[-1] if shared else None
        created = []
        for b in range(m, rows // ps):
            node, ok = self.index.insert(
                parent, tokens[b * ps:(b + 1) * ps],
                int(self.ptab[slot, b]))
            if not ok:      # the same page is already published (the
                break       # full-match tail copy): keep this one private
            self.index.acquire(node)
            created.append(node)
            parent = node
        if created:
            self.slot_pages[slot] = self.slot_pages[slot][len(created):]
            shared.extend(created)

    def prefill_plan(self, slot: int) -> Tuple[int, bool]:
        start, _, cow_dst = self.slot_plan[slot]
        return start, cow_dst != 0

    def prefill_args(self, slot: int) -> Tuple:
        _, cow_src, cow_dst = self.slot_plan[slot]
        args: Tuple = (torch.from_numpy(self.ptab[slot].copy())
                       .to(self.device),)
        if cow_dst:
            args += (cow_src, cow_dst)
        return args

    def wave_step(self) -> Optional[Callable]:
        return None                 # paged always refills per slot

    # --- registered (pinned) prefixes ---------------------------------

    def register_prefix(self, tokens: np.ndarray
                        ) -> Tuple[List[Any], Optional[np.ndarray]]:
        """Pin ``tokens`` (a whole number of pages) in the index: reuse
        resident pages, take pages for the rest, refcount +1 on the whole
        chain.  Returns ``(nodes, page_row)``: ``page_row`` is the fill
        step's page table when any page needs computing, ``None`` when
        the head was all resident."""
        scfg = self.scfg
        ps = scfg.page_size
        F = len(tokens) // ps
        nodes: List[Any] = []
        kids = self.index.children
        parent = None
        b = 0
        while b < F:
            child = kids.get(tokens[b * ps:(b + 1) * ps].tobytes())
            if child is None:
                break
            nodes.append(child)
            parent, kids = child, child.children
            b += 1
        n_new = F - b
        if self.reserved + self.index.live_pages + n_new > scfg.pool_pages:
            raise RuntimeError(
                f"cannot pin a {F}-page prefix: {n_new} new pages needed "
                f"but reservations + pinned/live shared pages leave no "
                f"room in the {scfg.pool_pages}-page pool — raise "
                f"num_pages or release other prefixes")
        for bb in range(b, F):
            node, _ = self.index.insert(
                parent, tokens[bb * ps:(bb + 1) * ps], self._take_page())
            nodes.append(node)
            parent = node
        for nd in nodes:
            self.index.acquire(nd)
        page_row = None
        if n_new:
            page_row = np.zeros(scfg.max_pages, np.int32)
            for bb, nd in enumerate(nodes):
                page_row[bb] = nd.page
        self._note_peak()
        return nodes, page_row

    def release_prefix(self, nodes: List[Any]) -> None:
        for nd in nodes:
            self.free_pages.extend(self.index.release(nd))

    def prefix_fill_step(self, rows: int) -> Callable:
        fn = self._prefix_fills.get(rows)
        if fn is None:
            fn = self._prefix_fills[rows] = loops.build_prefix_fill_step(
                self.cfg, self.scfg, prompt_rows=rows)
        return fn

    # --- page bookkeeping ---------------------------------------------

    def _take_page(self) -> int:
        """One free page: from the free list, else by evicting a retained
        (refcount-zero) prefix page.  The admission accounting
        (reservations + live shared pages <= pool) guarantees one of the
        two serves every call."""
        if self.free_pages:
            return self.free_pages.pop()
        if self.prefix_on:
            page = self.index.evict_one()
            if page is not None:
                return page
        raise RuntimeError("page pool exhausted — admission reservation "
                           "accounting violated")

    def _note_peak(self) -> None:
        """Pool high-water mark: pages neither free nor retained."""
        in_use = self.scfg.pool_pages - len(self.free_pages) \
            - (self.index.retained_pages if self.prefix_on else 0)
        self.stats["peak_pages"] = max(self.stats["peak_pages"], in_use)

    def _alloc(self, i: int, target: int) -> None:
        """Grow slot ``i``'s page count (shared head + private) to
        ``target``, writing the host table past the shared head (the
        reservation guarantees there are enough pages)."""
        base = len(self.slot_shared[i])
        while base + len(self.slot_pages[i]) < target:
            page = self._take_page()
            self.ptab[i, base + len(self.slot_pages[i])] = page
            self.slot_pages[i].append(page)
        self._note_peak()

    def _ensure(self, i: int) -> None:
        """Cover the next decode chunk, capped at the slot's reservation.
        ``chunk_tokens`` is the chunk's commit bound: under speculation
        the drafted and verified rows past any commit need no page of
        their own (their writes land in the null page and what they read
        there only costs acceptance, never a committed token)."""
        scfg = self.scfg
        self._alloc(i, min(
            -(-min(self.slot_rows[i] + scfg.chunk_tokens, scfg.max_len)
              // scfg.page_size),
            self.slot_need[i]))

    def _view_pages(self, live_rows: int) -> Optional[int]:
        """Decode view bucket covering ``live_rows`` cache rows."""
        scfg = self.scfg
        if not scfg.page_view_chunk:
            return None
        vc = scfg.page_view_chunk
        pages = -(-live_rows // scfg.page_size)
        return min(-(-pages // vc) * vc, scfg.max_pages)

    def _trim(self, i: int) -> None:
        """Return the pages slot ``i`` holds past its committed rows: a
        speculative chunk's cover runs ahead of the commits when drafts
        are rejected, and waiting requests can admit on those pages (the
        next chunk's ``_ensure`` covers the slot again)."""
        target = max(-(-self.slot_rows[i] // self.scfg.page_size), 1)
        base = len(self.slot_shared[i])
        while base + len(self.slot_pages[i]) > target and self.slot_pages[i]:
            page = self.slot_pages[i].pop()
            self.ptab[i, base + len(self.slot_pages[i])] = 0
            self.free_pages.append(page)

    def begin_chunk(self, live_slots: List[int], sampled: bool) -> Callable:
        # the view covers every row the chunk can write: its commits
        # (chunk_tokens) and, under speculation, the verify block's
        # uncommitted tail (spec_k rows), or a live slot's block write
        # would be clipped into a page it still reads
        scfg = self.scfg
        span = scfg.chunk_tokens + scfg.spec_k
        live_rows = 0
        for i in live_slots:
            self._ensure(i)
            live_rows = max(live_rows, min(self.slot_rows[i] + span,
                                           scfg.max_len))
        return self._chunk(self._view_pages(live_rows), sampled, self.ptab)

    def note_commit(self, slot: int) -> None:
        self.slot_rows[slot] += 1   # pos advances once per emitted token

    def end_chunk(self, live_slots: List[int]) -> None:
        """At a speculative chunk's boundary, the pages its cover took
        that the commits never reached go back to the pool."""
        if self.scfg.spec:
            for i in live_slots:
                self._trim(i)

    def retire(self, slot: int) -> None:
        """Return the slot's private pages to the pool, decref its shared
        pages (refcount zero keeps them warm in the index) and null its
        table row — the next chunk's table refresh sends a dead slot's
        residual writes to the null page, so recycled pages are never
        touched."""
        for nd in self.slot_shared[slot]:
            self.free_pages.extend(self.index.release(nd))
        self.slot_shared[slot] = []
        self.slot_plan[slot] = (0, 0, 0)
        self.free_pages.extend(reversed(self.slot_pages[slot]))
        self.slot_pages[slot] = []
        self.reserved -= self.slot_resv[slot]
        self.slot_resv[slot] = 0
        self.slot_need[slot] = 0
        self.slot_rows[slot] = 0
        self.ptab[slot] = 0


def make_backend(cfg: ModelConfig, scfg: ServeConfig, stats: Dict[str, Any],
                 device: torch.device, draft_params: Any = None
                 ) -> _BackendBase:
    kind = PagedBackend if scfg.paged else MonoBackend
    return kind(cfg, scfg, stats, device, draft_params)
