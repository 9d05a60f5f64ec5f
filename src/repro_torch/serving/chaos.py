"""Deterministic fault injection and the engine invariant auditor.

:class:`ChaosMonkey` wraps one :class:`~repro_torch.serving.api.Engine`'s
fault seams — the device→host fetch (``engine._device_fetch``), the
decode-chunk invocation (``engine._invoke_loop``) and the page allocator
(phantom pool pressure) — and injects faults from a seeded schedule:

  * **nan** — the fetched token block gets one slot's column poisoned
    with non-finite values (exercises the numeric guard + quarantine).
  * **drop** — the first fetch attempt raises (exercises the bounded
    fetch retry); **delay** sleeps the fetch briefly.
  * **kernel** — the decode-chunk invocation raises *before* the chunk
    runs: no kernel launches and no captured graph replays, so the chunk
    buffers are untouched and the engine's degraded retry is sound.
  * **pressure** — phantom page reservations (``backend.reserved`` grows
    without taking real pages) for a few ticks, forcing admission waits
    and priority preemption without ever starving a running slot's lazy
    allocation.
  * **crash** — the fetch raises :class:`ChaosCrashError`, a
    ``BaseException`` no engine guard catches: it kills ``step()``
    mid-tick like a SIGKILL, after the decode chunk ran.  Armed by rate
    or pinned to one tick (``crash_tick`` / ``REPRO_CHAOS_CRASH_TICK``);
    sticky until a fetch consumes it.  Only the
    :class:`~repro_torch.serving.supervisor.Supervisor` catches it: it
    tears the engine down and restores a fresh one from the journal.
  * **hang** — the device wedges: once triggered (``hang_rate`` /
    ``hang_tick``), every later fetch stalls ``hang_s`` seconds (the
    supervisor's watchdog trips on it).

Determinism: every tick consumes exactly the same number of draws (six
uniforms and one slot index) whatever the engine's state, so the fault
schedule is a function of ``(seed, rate, tick)`` alone: two runs with
the same seed and the same submissions see the same faults and reach
the same final statuses.  Enable on any engine through the environment
(read at construction)::

    REPRO_CHAOS_SEED=7 REPRO_CHAOS_RATE=0.01 \\
        python -m repro_torch.examples.serve_stream

or in code::

    monkey = ChaosMonkey(engine, ChaosConfig(seed=7, rate=0.05))
    monkey.attach()           # wraps step/fetch/dispatch
    ...
    monkey.detach()           # restores, releases held pages

:func:`audit_engine` (also ``engine.audit()``) checks the structural
invariants — page-id conservation across the free list, the slot tables
and the prefix trie; reservation accounting; the legality of every
request's status history — and raises :class:`AuditError` on a
violation.  Under chaos it runs after every step.  With a journal
attached it also holds the journal's mirror to the engine: the mirror
may trail the engine but never lead it.  The port keeps its own copy of
the JAX package's module; the shard checks report nothing until the
port has a sharded backend (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.state import (LEGAL_TRANSITIONS,
                                       TERMINAL_STATUSES, RequestStatus)


class AuditError(AssertionError):
    """An engine structural invariant does not hold."""


class ChaosError(RuntimeError):
    """Base class for injected faults (never raised by real code)."""


class ChaosFetchError(ChaosError):
    """Injected device→host fetch failure."""


class ChaosKernelError(ChaosError):
    """Injected decode-chunk dispatch failure."""


class ChaosCrashError(BaseException):
    """Injected mid-tick process death.  Deliberately NOT an
    ``Exception`` (and not a :class:`ChaosError`): the in-engine guards
    — fetch retry, degraded-mode dispatch retry — contain only their
    own :class:`ChaosError`, and a crash must defeat every handler and
    propagate out of ``step()`` exactly like a kill signal.  Only the
    supervisor catches it."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Injection knobs.  Per-site rates default to the global ``rate``;
    set a site to ``0.0`` to disable it individually."""
    seed: int = 0
    rate: float = 0.01              # per-tick probability per site
    nan_rate: Optional[float] = None
    drop_rate: Optional[float] = None
    delay_rate: Optional[float] = None
    kernel_rate: Optional[float] = None
    pressure_rate: Optional[float] = None
    delay_s: float = 0.001          # injected fetch latency
    pressure_pages: int = 2         # phantom pages seized per event
    pressure_ticks: int = 2         # ticks a seizure is held
    audit_every_step: bool = True
    # crash/hang do NOT inherit the global rate (a background chaos env
    # should not randomly kill engines): explicit rate or pinned tick
    crash_rate: float = 0.0
    hang_rate: float = 0.0
    crash_tick: Optional[int] = None  # kill exactly this monkey tick
    hang_tick: Optional[int] = None   # wedge the device at this tick
    hang_s: float = 0.05            # per-fetch stall once wedged

    def of(self, site: str) -> float:
        v = getattr(self, f"{site}_rate")
        return self.rate if v is None else v

    @classmethod
    def from_env(cls) -> "ChaosConfig":
        """Build from ``REPRO_CHAOS_SEED`` / ``REPRO_CHAOS_RATE`` (plus
        the optional ``REPRO_CHAOS_CRASH_TICK`` / ``_HANG_TICK`` pins) —
        the engine auto-attaches a monkey when the seed variable is
        set."""
        def tick(name):
            v = os.environ.get(name)
            return int(v) if v else None
        return cls(seed=int(os.environ["REPRO_CHAOS_SEED"]),
                   rate=float(os.environ.get("REPRO_CHAOS_RATE", "0.01")),
                   crash_tick=tick("REPRO_CHAOS_CRASH_TICK"),
                   hang_tick=tick("REPRO_CHAOS_HANG_TICK"))


class ChaosMonkey:
    """Seeded fault injector bound to one engine (see module docstring).

    ``schedule`` records every armed fault as ``(tick, site, detail)``
    — the determinism tests compare two runs' schedules verbatim.
    """

    def __init__(self, engine: Any, cfg: ChaosConfig):
        self.engine = engine
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.tick = 0
        self.schedule: List[Tuple[int, str, Any]] = []
        self.held_pages = 0
        self._hold_left = 0
        self._pending_drop = False
        self._pending_delay = False
        self._pending_nan: Optional[int] = None
        self._pending_kernel = False
        self._pending_crash = False     # sticky until a fetch consumes it
        self._hung = False              # sticky forever: a wedged device
        self._attached = False
        self._orig: Dict[str, Any] = {}

    # --- wiring -------------------------------------------------------

    def attach(self) -> "ChaosMonkey":
        """Wrap the engine's step/fetch/dispatch seams (instance
        attributes — no module monkeypatching).  Detaches any monkey
        already on the engine first."""
        if self._attached:
            return self
        old = getattr(self.engine, "_chaos", None)
        if old is not None:
            old.detach()
        self._orig = {"step": self.engine.step,
                      "fetch": self.engine._device_fetch,
                      "invoke": self.engine._invoke_loop}
        self.engine.step = self._step
        self.engine._device_fetch = self._fetch
        self.engine._invoke_loop = self._invoke
        self.engine._chaos = self
        self._attached = True
        return self

    def detach(self) -> None:
        """Restore the wrapped seams and release any held pages."""
        if not self._attached:
            return
        self.engine.step = self._orig["step"]
        self.engine._device_fetch = self._orig["fetch"]
        self.engine._invoke_loop = self._orig["invoke"]
        self.engine._chaos = None
        self._attached = False
        self.release_pressure()

    # --- pool pressure ------------------------------------------------

    def seize_pages(self, pages: int, ticks: int = 0) -> int:
        """Phantom-reserve up to ``pages`` pool pages (admission sees
        them as taken; no real page leaves the free list, so running
        slots' lazy allocation is never starved).  Held for ``ticks``
        steps (0 → until :meth:`release_pressure`).  Returns the count
        actually seized.  The fairness tests drive this directly."""
        b = self.engine._backend
        if not getattr(b, "paged", False):
            return 0
        avail = (self.engine.scfg.pool_pages - b.reserved
                 - (b.index.live_pages if b.prefix_on else 0))
        n = max(0, min(pages, avail))
        b.reserved += n
        self.held_pages += n
        if n and ticks:
            self._hold_left = ticks
        return n

    def release_pressure(self) -> None:
        if self.held_pages:
            self.engine._backend.reserved -= self.held_pages
            self.held_pages = 0
        self._hold_left = 0

    # --- the wrapped seams --------------------------------------------

    def _arm(self) -> None:
        """One tick's fault draws — ALWAYS six uniforms and one slot
        index, so the schedule never depends on engine state."""
        cfg = self.cfg
        u = self.rng.uniform(size=6)
        slot = int(self.rng.integers(0, self.engine.scfg.slots))
        if u[4] < cfg.crash_rate or self.tick == cfg.crash_tick:
            self._pending_crash = True
            self.schedule.append((self.tick, "crash", None))
        if not self._hung and (u[5] < cfg.hang_rate
                               or self.tick == cfg.hang_tick):
            self._hung = True
            self.schedule.append((self.tick, "hang", None))
        if u[0] < cfg.of("kernel"):
            self._pending_kernel = True
            self.schedule.append((self.tick, "kernel", None))
        if u[1] < cfg.of("drop"):
            self._pending_drop = True
            self.schedule.append((self.tick, "drop", None))
        elif u[1] < cfg.of("drop") + cfg.of("delay"):
            self._pending_delay = True
            self.schedule.append((self.tick, "delay", None))
        if u[2] < cfg.of("nan"):
            self._pending_nan = slot
            self.schedule.append((self.tick, "nan", slot))
        if self._hold_left > 0:
            self._hold_left -= 1
            if self._hold_left == 0:
                self.release_pressure()
        elif u[3] < cfg.of("pressure"):
            n = self.seize_pages(cfg.pressure_pages, cfg.pressure_ticks)
            if n:
                self.schedule.append((self.tick, "pressure", n))

    def _step(self) -> List[Any]:
        self._arm()
        events = self._orig["step"]()
        # a tick's unconsumed faults don't leak into the next one (an
        # idle tick makes no fetch/dispatch); crash/hang are the
        # exception — an armed crash stays armed until a fetch consumes
        # it, and a wedged device stays wedged
        self._pending_drop = self._pending_delay = False
        self._pending_nan = None
        self._pending_kernel = False
        if self.cfg.audit_every_step:
            audit_engine(self.engine)
        self.tick += 1
        return events

    def _fetch(self, bufs: Any) -> Any:
        if self._pending_crash:
            # the decode chunk already ran: the tick dies between the
            # chunk and the delivery of its tokens
            self._pending_crash = False
            raise ChaosCrashError(
                f"injected mid-tick crash @tick {self.tick}")
        if self._hung:
            time.sleep(self.cfg.hang_s)
        if self._pending_drop:
            self._pending_drop = False
            raise ChaosFetchError(f"injected fetch drop @tick {self.tick}")
        if self._pending_delay:
            self._pending_delay = False
            time.sleep(self.cfg.delay_s)
        out = self._orig["fetch"](bufs)
        if self._pending_nan is not None and isinstance(out, tuple) \
                and len(out) >= 3:
            slot = self._pending_nan
            self._pending_nan = None
            blk = np.asarray(out[0]).astype(np.float64)
            blk[:, slot % blk.shape[1]] = np.nan
            out = (blk,) + tuple(out[1:])
        return out

    def _invoke(self, loop: Any, args: tuple) -> Any:
        # raise BEFORE the chunk runs: no launch, no replay, the chunk
        # buffers untouched, so the engine's degraded retry is sound
        if self._pending_kernel:
            self._pending_kernel = False
            raise ChaosKernelError(
                f"injected dispatch failure @tick {self.tick}")
        return self._orig["invoke"](loop, args)


# --- the invariant auditor ------------------------------------------


def _fail(why: str) -> None:
    raise AuditError(why)


def _audit_requests(engine: Any) -> Dict[str, int]:
    seen: List[Any] = []
    for i, r in enumerate(engine._slot_req):
        if r is None:
            continue
        seen.append(r)
        if r.status is not RequestStatus.RUNNING:
            _fail(f"slot {i} holds request {r.uid} with status "
                  f"{r.status.value!r} (want running)")
        if r.slot != i:
            _fail(f"slot {i} holds request {r.uid} whose .slot is "
                  f"{r.slot}")
    for r in engine.queue:
        seen.append(r)
        if r.status not in (RequestStatus.QUEUED, RequestStatus.PREEMPTED):
            _fail(f"queued request {r.uid} has status {r.status.value!r}")
        if r.slot is not None or r.done:
            _fail(f"queued request {r.uid} still bound (slot={r.slot}, "
                  f"done={r.done})")
    for r in engine.finished:
        seen.append(r)
        if r.status not in TERMINAL_STATUSES or not r.done:
            _fail(f"finished request {r.uid} is non-terminal "
                  f"({r.status.value!r}, done={r.done})")
    for r in seen:
        for a, b in zip(r.history, r.history[1:]):
            if b not in LEGAL_TRANSITIONS[a]:
                _fail(f"request {r.uid} made an illegal transition "
                      f"{a.value!r} → {b.value!r} "
                      f"(history: {[s.value for s in r.history]})")
    return {"live": engine.num_live, "queued": len(engine.queue),
            "finished": len(engine.finished)}


def _audit_pages(engine: Any) -> Dict[str, int]:
    b = engine._backend
    if not getattr(b, "paged", False):
        return {}
    pool = engine.scfg.pool_pages
    owners: Dict[int, str] = {}

    def claim(page: int, who: str) -> None:
        if not (1 <= page <= pool):
            _fail(f"{who} holds out-of-range page {page} "
                  f"(pool is 1..{pool})")
        if page in owners:
            _fail(f"page {page} owned twice: {owners[page]} and {who}")
        owners[page] = who

    for p in b.free_pages:
        claim(p, "free list")
    for i, pages in enumerate(b.slot_pages):
        for p in pages:
            claim(p, f"slot {i}")
    n_live = 0
    if b.prefix_on:
        for nd in b.index.iter_nodes():
            claim(nd.page, "prefix index")
            if nd.refs > 0:
                n_live += 1
            elif nd not in b.index.retained:
                _fail(f"refcount-zero index page {nd.page} missing from "
                      "the retained set")
        if n_live != b.index.live_pages:
            _fail(f"index live_pages={b.index.live_pages} but "
                  f"{n_live} nodes have refs > 0")
    if len(owners) != pool:
        missing = sorted(set(range(1, pool + 1)) - set(owners))
        _fail(f"page conservation violated: {len(owners)}/{pool} pages "
              f"accounted for (missing {missing[:8]}...)")
    held = engine._chaos.held_pages if engine._chaos is not None else 0
    if b.reserved != sum(b.slot_resv) + held:
        _fail(f"reservation accounting violated: reserved={b.reserved} "
              f"!= sum(slot_resv)={sum(b.slot_resv)} + held={held}")
    for i in range(engine.scfg.slots):
        shared = [nd.page for nd in b.slot_shared[i]]
        expect = shared + list(b.slot_pages[i])
        row = list(b.ptab[i])
        if row[:len(expect)] != expect or any(row[len(expect):]):
            _fail(f"slot {i} page-table row {row} does not match its "
                  f"shared+private pages {expect}")
    return {"pages_free": len(b.free_pages), "reserved": b.reserved,
            "index_live": n_live,
            "index_retained": (b.index.retained_pages
                               if b.prefix_on else 0)}


def _audit_journal(engine: Any) -> Dict[str, int]:
    """Journal/engine consistency (only when a journal is attached): the
    journal's in-memory mirror, built by the same ``_apply`` path a
    replay uses, must agree with the engine at every chunk boundary.
    The mirror may trail the engine by an unflushed chunk but may never
    be ahead of it (a journal that replays tokens the engine never
    emitted would duplicate them after recovery)."""
    j = getattr(engine, "journal", None)
    if j is None:
        return {}
    st = j.state
    fin = {r.uid: r for r in engine.finished}
    for i, r in enumerate(engine._slot_req):
        if r is not None and r.uid not in st.reqs:
            _fail(f"slot {i} runs request {r.uid} the journal never saw")
    for uid, jr in st.reqs.items():
        r = next((c for c in engine.queue + engine._slot_req
                  if c is not None and c.uid == uid), None) or fin.get(uid)
        if r is None:
            if jr.status not in {s.value for s in TERMINAL_STATUSES}:
                _fail(f"journal holds non-terminal request {uid} the "
                      "engine does not know")
            continue
        if len(jr.out) > len(r.out) or jr.out != r.out[:len(jr.out)]:
            _fail(f"journal is ahead of engine for request {uid}: "
                  f"journal={jr.out} engine={r.out}")
        if jr.rows0 is not None and r.rows0 is not None \
                and jr.rows0 != r.rows0:
            _fail(f"request {uid} admit width diverged: journal rows0="
                  f"{jr.rows0}, engine rows0={r.rows0}")
    return {"journaled": len(st.reqs), "journal_tick": st.tick,
            "journal_pins": len(st.pins)}


def _audit_shards(engine: Any) -> Dict[str, int]:
    """Per-shard page-table checks of a sharded backend: the port serves
    on one device (sharding is ROADMAP queue 1 item 13), so there is
    nothing to check."""
    if not getattr(engine._backend, "sharded", False):
        return {}
    raise NotImplementedError("the shard audit comes with the sharded "
                              "backend (ROADMAP queue 1 item 13)")


def audit_engine(engine: Any) -> Dict[str, Any]:
    """Check every structural invariant the serving stack promises —
    see the module docstring.  Returns a small report dict; raises
    :class:`AuditError` naming the first violation."""
    report = _audit_requests(engine)
    report.update(_audit_pages(engine))
    report.update(_audit_journal(engine))
    report.update(_audit_shards(engine))
    return report
