"""Supervised serving: watchdog, teardown, restore, handle re-binding.

:class:`Supervisor` wraps one :class:`~repro_torch.serving.api.Engine`
behind the same stepping surface (``submit`` / ``step`` / ``run`` /
``cancel`` / ``register_prefix`` / ``stats`` / ``audit``) and keeps
requests alive across engine death:

  * **crash** — ``step()`` raising anything (including
    :class:`~repro_torch.serving.chaos.ChaosCrashError`, the injected
    ``BaseException`` that models a mid-tick SIGKILL) is caught here and
    only here.  The dead engine is torn down and a fresh one is
    restored from the latest snapshot plus the journal's tail
    (:func:`~repro_torch.serving.journal.recover_engine`).
  * **hang** — a watchdog measures each step's wall time; a step slower
    than ``watchdog_ms`` means a wedged device and triggers the same
    teardown and restore.  It holds fire for the first two steps after
    a (re)start and for any step whose decode chunk warmed up or
    captured a CUDA graph (``chunk_runs`` says ``"eager"`` with graphs
    on, or ``"capture"``): a view bucket's capture takes seconds and can
    first come many ticks after a restart.
  * **re-binding** — every :class:`~repro_torch.serving.state.RequestHandle`
    the supervisor issued keeps working across the restart: its ``_req``
    is swapped for the recovered record (same uid, same emitted tokens,
    so a ``for tok in handle:`` loop continues where it stopped, with no
    token duplicated or dropped), and pinned
    :class:`~repro_torch.serving.prefix.PrefixHandle` objects are
    re-pointed at their re-registered (re-prefilled) pages.

**Teardown on the card.**  A crash leaves the engine's captured chunk
buffers mid-tick, so nothing of it is reused: the monkey is detached,
the journal closed, and every reference the dead engine holds to its
KV cache, its :class:`~repro_torch.serving.state.ChunkBuffers`, its
captured :class:`~repro_torch.serving.loops.DecodeChunk` graphs and its
own draft params is dropped; ``torch.cuda.synchronize()`` then runs
before the fresh engine allocates, so the pool it frees is the pool the
new engine takes.  The restored engine is a new engine with new buffers
and new graphs; no old graph is ever replayed.  Degraded mode is a
per-engine scope of the plain versions, so nothing process-wide needs
resetting.  A real kernel fault that poisons the CUDA context (an
illegal address) makes every fresh engine in the process fail again:
the supervisor then reaches ``max_restarts`` and raises
:class:`SupervisorError`, which is the honest outcome.

Handles issued by the supervisor drive ``supervisor.step()`` when
iterated, so a blocking ``handle.result()`` survives a crash mid-stream.
Periodic snapshots (``snapshot_every`` ticks into ``snapshot_dir``)
bound the journal replay a recovery pays; with no snapshot directory
the journal alone recovers everything.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.api import Engine
from repro_torch.serving.chaos import ChaosCrashError
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.journal import earlier_serve, recover_engine
from repro_torch.serving.prefix import PrefixHandle
from repro_torch.serving.state import IDLE_TICKS, Request, RequestHandle

__all__ = ["Supervisor", "SupervisorError"]

#: steps after a (re)start during which the watchdog holds fire
_GRACE_STEPS = 2


class SupervisorError(RuntimeError):
    """The engine died more than ``max_restarts`` times: the fault is not
    transient and a supervised restart cannot mask it."""


class Supervisor:
    """Crash-safe facade over one engine (see the module docstring).

    It starts a fresh serve, so it refuses a journal file or a snapshot
    directory that an earlier serve left (``journal.earlier_serve``):
    the first recovery would bring that serve's requests back."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Any, *,
                 draft_params: Any = None, device="cuda",
                 journal_path: str, snapshot_dir: Optional[str] = None,
                 watchdog_ms: float = 0.0, snapshot_every: int = 0,
                 max_restarts: int = 8):
        if not journal_path:
            raise ValueError("the supervisor needs a journal_path: "
                             "recovery without a journal cannot keep "
                             "delivered tokens")
        stale = earlier_serve(journal_path, snapshot_dir)
        if stale is not None:
            raise ValueError(f"a supervisor starts a fresh serve: {stale}")
        self.cfg, self.params, self.device = cfg, params, device
        self.draft_params = draft_params
        self.scfg = dataclasses.replace(scfg, journal_path=journal_path)
        self.journal_path = journal_path
        self.snapshot_dir = snapshot_dir
        self.watchdog_ms = watchdog_ms
        self.snapshot_every = snapshot_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.last_recovery: Dict[str, float] = {}
        self._handles: Dict[int, RequestHandle] = {}
        self._dead_finished: Dict[int, Request] = {}
        self._prefixes: Dict[int, PrefixHandle] = {}
        self._grace = _GRACE_STEPS
        self._last_snap = -1
        self.engine = Engine(cfg, self.scfg, params,
                             draft_params=draft_params, device=device)

    # --- the engine surface handles drive -----------------------------

    @property
    def num_live(self) -> int:
        return self.engine.num_live

    @property
    def num_queued(self) -> int:
        return self.engine.num_queued

    @property
    def queue(self) -> List[Request]:
        return self.engine.queue

    @property
    def finished(self) -> List[Request]:
        """Every finished request: those the dead engines finished, then
        the live engine's (a uid both hold is the live engine's)."""
        live = self.engine.finished
        uids = {r.uid for r in live}
        return [r for u, r in self._dead_finished.items()
                if u not in uids] + live

    def stats(self):
        return self.engine.stats()

    def ttfts_s(self) -> List[float]:
        return [r.ttft_s for r in self.finished if r.ttft_s is not None]

    def audit(self) -> Dict[str, Any]:
        return self.engine.audit()

    def cancel(self, handle) -> None:
        self.engine.cancel(handle)

    def submit(self, prompt: Union[Sequence[int], np.ndarray], **kw
               ) -> RequestHandle:
        """``Engine.submit``, with the handle bound to the supervisor:
        iterating it drives supervised steps, so the stream survives a
        crash mid-iteration."""
        h = self.engine.submit(prompt, **kw)
        h._engine = self
        self._handles[h.uid] = h
        return h

    def register_prefix(self, tokens) -> PrefixHandle:
        h = self.engine.register_prefix(tokens)
        self._prefixes[h._pid] = h
        return h

    def snapshot(self) -> Optional[str]:
        """Write a snapshot now (also called every ``snapshot_every``
        ticks from :meth:`step`)."""
        if not self.snapshot_dir:
            return None
        self._last_snap = self.engine._tick
        return self.engine.snapshot(self.snapshot_dir)

    # --- supervised stepping ------------------------------------------

    def step(self) -> List[Any]:
        """One supervised tick: a periodic snapshot, then the engine's
        ``step()`` under the crash guard and the watchdog.  A tick that
        triggers recovery returns ``[]``: the crashed chunk's tokens were
        either journaled (and already in the recovered requests' ``out``)
        or never delivered, so the streams resume without loss or
        duplication."""
        eng = self.engine
        if (self.snapshot_every and self.snapshot_dir and eng._tick > 0
                and eng._tick % self.snapshot_every == 0
                and eng._tick != self._last_snap):
            self.snapshot()
        runs = len(eng._stats["chunk_runs"])
        t0 = time.perf_counter()
        # the restart runs after the handler: a live exception's
        # traceback holds the dead tick's frames, and with them its
        # cache and buffers
        try:
            events = eng.step()
        except ChaosCrashError as e:    # BaseException: the "SIGKILL"
            reason = f"engine died mid-tick: {e!r}"
        except Exception as e:
            reason = f"step() raised: {e!r}"
        else:
            dt_ms = (time.perf_counter() - t0) * 1e3
            warming = self._warming(eng, eng._stats["chunk_runs"][runs:])
            if self._grace > 0:
                self._grace -= 1        # the first steps after a start
                return events
            if warming or not self.watchdog_ms or dt_ms <= self.watchdog_ms:
                return events
            reason = (f"watchdog: step took {dt_ms:.0f} ms (budget "
                      f"{self.watchdog_ms:g} ms): engine wedged")
        return self._restart(reason)

    @staticmethod
    def _warming(eng: Engine, runs) -> bool:
        """Whether the step's chunk warmed up or captured its key's graph
        (on the CPU, or with graphs off, every chunk is eager and none
        is a warm-up)."""
        graphs = eng._backend._graphs
        return any(how == "capture" or (how == "eager" and graphs)
                   for _, how in runs)

    def run(self) -> List[Request]:
        """Serve until the queue drains (the supervised ``Engine.run``);
        past ``IDLE_TICKS`` plus ``restarts`` empty ticks in a row with
        admission blocked it raises, as ``Engine.run`` does."""
        idle = 0
        while self.engine.queue or self.engine.num_live:
            if self.step() or self.engine.num_live:
                idle = 0
                continue
            idle += 1
            if idle > IDLE_TICKS + self.restarts:
                raise RuntimeError("admission is blocked with nothing live")
        return self.finished

    # --- teardown and restore -----------------------------------------

    def _teardown(self, old: Engine) -> None:
        """Detach the monkey, close the journal (its file carries on) and
        drop every reference the dead engine holds to device memory: its
        cache, chunk buffers, captured graphs and its own draft params;
        then wait for the card before the fresh engine allocates."""
        if old._chaos is not None:
            old._chaos.detach()
        if old.journal is not None:
            old.journal.close()
        old._cache = None
        old._bufs = None
        old._backend._chunks.clear()
        old.draft_params = old._backend.draft_params = None
        if old.device.type == "cuda":
            torch.cuda.synchronize(old.device)

    def _restart(self, reason: str) -> List[Any]:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise SupervisorError(
                f"engine died {self.restarts} times (cap "
                f"{self.max_restarts}); last failure: {reason}")
        warnings.warn(f"supervisor restarting engine: {reason}",
                      RuntimeWarning, stacklevel=3)
        t0 = time.perf_counter()
        self._dead_finished.update((r.uid, r) for r in self.engine.finished)
        self._teardown(self.engine)
        rec = recover_engine(self.cfg, self.params, scfg=self.scfg,
                             draft_params=self.draft_params,
                             journal_path=self.journal_path,
                             snapshot_dir=self.snapshot_dir,
                             device=self.device)
        eng = rec.engine
        eng._stats["restarts"] = self.restarts
        # re-bind live handles: the same handle object, the recovered
        # record
        for uid, h in self._handles.items():
            nh = rec.handles.get(uid)
            if nh is not None:          # terminal before the crash: keep
                h._req = nh._req        # the old (final) record
            h._engine = self
        for pid, h in self._prefixes.items():
            nh = rec.prefixes.get(pid)
            if nh is None:              # released before the crash
                continue
            h._nodes = nh._nodes
            h._engine = eng
            eng._pins[pid] = h          # the registry keeps the caller's
        self.engine = eng
        self._grace = _GRACE_STEPS
        self.last_recovery = dict(
            rec.timings, total_ms=(time.perf_counter() - t0) * 1e3)
        return []
