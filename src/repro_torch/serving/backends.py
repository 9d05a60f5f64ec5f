"""Cache backends: the layout-specific half of the serving engine.

  * :class:`MonoBackend` — the monolithic ``(slots, max_len, …)`` cache:
    admission always succeeds, retirement is free, and the whole-batch
    wave prefill is available.
  * :class:`PagedBackend` — the shared page pool + per-slot page tables.
    Owns the host-side allocator: worst-case page *reservation* at
    admission (requests wait instead of running out of pages), lazy
    allocation at prefill and chunk boundaries, recycling and table
    nulling at retirement, per-request prompt buckets, and the decode
    attention view narrowed to the live slots' page bucket.

Everything here is host arithmetic over already-fetched state plus
host→device argument passing (the page table): backends never add a
device→host sync.  Each backend hands the scheduler the serving
programs of ``serving.loops`` for its layout.  The prefix index of the
JAX backend is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving import loops
from repro_torch.serving.config import ServeConfig


class _BackendBase:
    paged = False

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 stats: Dict[str, Any], device: torch.device):
        self.cfg, self.scfg, self.stats, self.device = cfg, scfg, stats, device
        self._decode_loops: Dict[Optional[int], Callable] = {}

    def prefill_step(self, rows: int) -> Callable:
        return loops.build_prefill_slot_step(self.cfg, self.scfg,
                                             prompt_rows=rows,
                                             paged=self.paged)

    def _decode_loop(self, view: Optional[int]) -> Callable:
        fn = self._decode_loops.get(view)
        if fn is None:
            fn = self._decode_loops[view] = loops.build_decode_loop(
                self.cfg, self.scfg, paged=self.paged, view_pages=view)
        return fn


class MonoBackend(_BackendBase):
    """Monolithic ``slots × max_len`` cache: no allocator, no extra loop
    operands, and the wave-prefill fast path."""

    paged = False

    def prompt_rows(self, prompt_len: int) -> int:
        return self.scfg.prompt_pad

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return True

    def admit(self, slot: int, prompt_len: int, max_new: int) -> int:
        return self.scfg.prompt_pad

    def prefill_args(self, slot: int) -> Tuple:
        return ()

    def wave_step(self) -> Optional[Callable]:
        return loops.build_prefill_wave_step(self.cfg, self.scfg)

    def begin_chunk(self, live_slots: List[int]) -> Tuple[Callable, Tuple]:
        return self._decode_loop(None), ()

    def note_commit(self, slot: int) -> None:
        pass

    def retire(self, slot: int) -> None:
        pass


class PagedBackend(_BackendBase):
    """Shared page pool + per-slot page tables.  The admission
    reservation guarantees a request, once admitted, can always reach its
    budget: waiting happens at admission, never mid-decode."""

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

    def prompt_rows(self, prompt_len: int) -> int:
        return self.scfg.prompt_rows(prompt_len)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        need = self.scfg.request_pages(prompt_len, max_new)
        return self.reserved + need <= self.scfg.pool_pages

    def admit(self, slot: int, prompt_len: int, max_new: int) -> int:
        scfg = self.scfg
        rows = scfg.prompt_rows(prompt_len)
        need = scfg.rows_pages(rows, max_new)
        self.slot_need[slot] = need
        self.slot_rows[slot] = rows
        self.ptab[slot] = 0
        self.reserved += need
        self._alloc(slot, -(-rows // scfg.page_size))
        return rows

    def prefill_args(self, slot: int) -> Tuple:
        return (torch.from_numpy(self.ptab[slot].copy()).to(self.device),)

    def wave_step(self) -> Optional[Callable]:
        return None                 # paged always refills per slot

    def _alloc(self, i: int, target: int) -> None:
        """Grow slot ``i`` to ``target`` pages from the free list (the
        reservation guarantees there are enough) and track the pool
        high-water mark."""
        while len(self.slot_pages[i]) < target:
            if not self.free_pages:
                raise RuntimeError("page pool exhausted — admission "
                                   "reservation accounting violated")
            page = self.free_pages.pop()
            self.ptab[i, len(self.slot_pages[i])] = page
            self.slot_pages[i].append(page)
        in_use = self.scfg.pool_pages - len(self.free_pages)
        self.stats["peak_pages"] = max(self.stats["peak_pages"], in_use)

    def _ensure(self, i: int) -> None:
        """Cover the next decode chunk, capped at the slot's reservation."""
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

    def begin_chunk(self, live_slots: List[int]) -> Tuple[Callable, Tuple]:
        scfg = self.scfg
        live_rows = 0
        for i in live_slots:
            self._ensure(i)
            live_rows = max(live_rows, min(self.slot_rows[i]
                                           + scfg.chunk_tokens, scfg.max_len))
        loop = self._decode_loop(self._view_pages(live_rows))
        return loop, (self.ptab,)

    def note_commit(self, slot: int) -> None:
        self.slot_rows[slot] += 1   # pos advances once per emitted token

    def retire(self, slot: int) -> None:
        """Return the slot's pages to the pool and null its table row —
        the next chunk's table refresh sends a dead slot's residual
        writes to the null page, so recycled pages are never touched."""
        self.free_pages.extend(reversed(self.slot_pages[slot]))
        self.slot_pages[slot] = []
        self.reserved -= self.slot_need[slot]
        self.slot_need[slot] = 0
        self.slot_rows[slot] = 0
        self.ptab[slot] = 0


def make_backend(cfg: ModelConfig, scfg: ServeConfig, stats: Dict[str, Any],
                 device: torch.device) -> _BackendBase:
    kind = PagedBackend if scfg.paged else MonoBackend
    return kind(cfg, scfg, stats, device)
