"""Fault tolerance: the engine's failure-handling layer.

:class:`FaultTolerance` is the mixin the port's
:class:`~repro_torch.serving.api.Engine` takes its robustness from —
deadlines, priority preemption, the numeric guard, degraded mode and the
bounded fetch retry — so that ``api.py`` stays about scheduling.  It is
the JAX package's ``serving/faults.py`` with one difference by design,
in degraded mode (below).

The failure policy, in one place:

  * **deadline** — at the first chunk boundary past ``deadline_ms`` the
    request ends ``TIMED_OUT``, queued or running (a running slot is
    frozen and retired exactly like a cancel).
  * **pool exhaustion** — when the queue head cannot reserve pages, the
    lowest-priority running slot *strictly below* the head's priority is
    preempted: frozen, retired (its shared prompt pages drop to refcount
    zero in the prefix index and stay warm) and re-queued ``PREEMPTED``.
    Re-admission prefills the effective prompt at the exact original
    width (``rows0 + emitted``), so the warm pages line up and only the
    suffix is recomputed.
  * **non-finite tokens** — the fetched block is checked on the host; a
    poisoned slot's column is cleared (its chunk tokens are discarded,
    never surfaced), the slot quarantined and the engine degraded.  One
    retry per request; a second fault ends it ``FAILED``.
  * **raising dispatch** — a decode chunk whose dispatch seam raises
    :class:`~repro_torch.serving.chaos.ChaosKernelError` degrades the
    engine and is retried once, on the plain versions.  That fault is
    raised before any launch or replay, so the chunk's buffers and the
    cache are untouched and the retry is sound.  Every other exception
    propagates: a kernel that refuses a shape or fails to launch, a
    failed graph capture (``loops.ChunkGraphError``), a fault on the
    retry.  Nothing shows that such a raise came before the chunk wrote
    the cache, and containing it would run the plain versions in a
    kernel's place.
  * **fetch errors** — a chunk's one device→host transfer that fails with
    :class:`~repro_torch.serving.chaos.ChaosFetchError` (a dropped
    transfer) is retried up to twice; if every attempt fails the chunk is
    lost and every live slot is quarantined.  A CUDA error at that sync
    (an illegal address, a device assert) is a kernel's fault and
    propagates at once.

**Degraded mode on the card.**  The JAX engine sets a process-global
dispatch override to its reference path and re-traces its programs.  The
port has no override: a degraded engine enters
:func:`~repro_torch.kernels.dispatch.plain_versions` around its own
prefills and decode chunks, so *that engine's* calls run the plain
PyTorch versions (``kernels/ref.py``) on the card, eagerly, each counted
in its kernel module's ``plain_launches``; every other engine keeps its
kernels.  A degraded chunk is never captured (``chunk_runs`` records it
as ``"plain"``).  After ``degraded_recover_chunks`` clean chunks the
engine leaves the scope and its keys' captured graphs replay again, with
no new capture.  Kernel build and load errors are not faults of this
layer: the engine loads every library when it is made
(``dispatch.load_kernels``), so they raise there and never degrade.

Every path ends with the affected request terminal or back in the
queue: ``step()`` never raises on an injected fault, and
``engine.audit()`` (:func:`repro_torch.serving.chaos.audit_engine`)
checks the structural invariants after any tick.  A hybrid slot's
recurrent state is zeroed in place when it retires and rebuilt by the
resume prefill.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import models as MZ
from repro_torch.kernels import dispatch
from repro_torch.serving.chaos import (ChaosFetchError, ChaosKernelError,
                                       audit_engine)
from repro_torch.serving.state import Request, RequestStatus


class FaultTolerance:
    """Mixin carrying the engine's failure handling (see the module
    docstring for the policy).  Expects the host class to provide the
    scheduler state (``_slot_req``, ``queue``, ``_backend``, ``_stats``,
    ``_bufs``, ``_cache``, ``scfg``, ``_finish``, ...)."""

    # --- deadlines ----------------------------------------------------

    def _apply_deadlines(self) -> None:
        """Chunk-boundary deadlines: queued or running, a request past
        its ``deadline_ms`` ends ``TIMED_OUT`` (a running slot is frozen
        and retired exactly like a cancel)."""
        now = time.perf_counter()
        for i, r in enumerate(self._slot_req):
            if r is not None and r.past_deadline(now):
                self._freeze_slot(i)
                self._stats["timeouts"] += 1
                self._finish(r, i, RequestStatus.TIMED_OUT, now)
        for r in [r for r in self.queue if r.past_deadline(now)]:
            self.queue.remove(r)
            self._stats["timeouts"] += 1
            self._finish(r, None, RequestStatus.TIMED_OUT, now)

    # --- slots ----------------------------------------------------------

    def _freeze_slot(self, i: int) -> None:
        """Stop slot ``i`` decoding without a fetch: two scalar writes
        into the chunk buffers, in place (a captured chunk holds their
        addresses)."""
        self._bufs.state["done"][i] = True
        self._bufs.state["left"][i] = 0

    def _retire_slot(self, i: int) -> None:
        """Free slot ``i``: its pages go back to the backend and a hybrid
        slot's recurrent state is zeroed in place (the next request's
        prefill rebuilds it)."""
        self._slot_req[i] = None
        self._backend.retire(i)
        for t in (MZ.recurrent_state(self._cache) or {}).values():
            t[:, i].zero_()

    # --- preemption / quarantine --------------------------------------

    def _evict_slot(self, i: int) -> Request:
        """Freeze and retire slot ``i`` and detach its request (its shared
        prompt pages drop to refcount zero in the prefix index: warm for
        the re-admission's suffix-only prefill)."""
        r = self._slot_req[i]
        self._freeze_slot(i)
        self._retire_slot(i)
        r.slot = None
        return r

    def _requeue(self, r: Request, now: float) -> None:
        """Send an evicted request back to the queue as ``PREEMPTED``, or
        finish it if it has nothing left to decode."""
        if r.remaining_new <= 0 or (r.resume_rows or 0) >= self.scfg.max_len:
            self._finish(r, None, RequestStatus.DONE, now)
            return
        r.set_status(RequestStatus.PREEMPTED)
        self.queue.append(r)

    def _preempt(self, i: int, now: float) -> None:
        r = self._evict_slot(i)
        r.preempts += 1
        self._stats["preemptions"] += 1
        self._requeue(r, now)

    def _victim_slot(self, priority: int) -> Optional[int]:
        """The lowest-priority running slot strictly below ``priority``;
        ties evict the youngest (the least sunk work); ``None`` if every
        running request is at or above the requester's level."""
        best = None
        for i, r in enumerate(self._slot_req):
            if r is None or r.priority >= priority:
                continue
            if best is None or (r.priority, -r.uid) < (
                    self._slot_req[best].priority,
                    -self._slot_req[best].uid):
                best = i
        return best

    def _quarantine(self, i: int, now: float) -> None:
        """Pull slot ``i`` out of the batch after a numeric or device
        fault: its chunk tokens are discarded, its pages retired and the
        request re-queued to retry once (on the plain versions, the
        engine being degraded).  A second fault ends it ``FAILED``."""
        r = self._slot_req[i]
        if r is None:
            return
        r.faults += 1
        self._evict_slot(i)
        if r.faults > 1:
            self._finish(r, None, RequestStatus.FAILED, now)
            return
        self._requeue(r, now)

    # --- guarded chunk execution --------------------------------------

    def _invoke_loop(self, chunk, args: tuple) -> None:
        """The dispatch seam: every decode chunk is invoked here, so the
        chaos harness can make one engine's chunks raise
        :class:`ChaosKernelError` before they run (and :meth:`_run_chunk`
        can retry on the plain versions)."""
        chunk(*args)

    def _fetch_block(self, bufs) -> Optional[tuple]:
        """The chunk's one device→host transfer through the engine's
        ``_device_fetch`` seam, with bounded retry: a dropped transfer
        (:class:`ChaosFetchError`, counted in ``fetch_errors``) is retried
        up to twice; if every attempt fails the chunk's tokens are lost
        (``None``) and the caller quarantines the live slots.  Any other
        error propagates."""
        for _ in range(3):
            try:
                out = self._device_fetch(bufs)
            except ChaosFetchError:
                self._stats["fetch_errors"] += 1
                continue
            self.sync_count += 1
            return out
        return None

    def _run_chunk(self, chunk, generator) -> Optional[tuple]:
        """Invoke one decode chunk and make its one fetch; the speculative
        drafted/accepted counts ride in it.  A :class:`ChaosKernelError`
        at the seam degrades the engine and retries the chunk once on the
        plain versions; any other raise, and a failing retry, propagates.
        Returns ``(tokens, emitted, done)``, or ``None`` when the fetch is
        lost."""
        args = (self.params, self._cache, self._bufs, self._temps, generator)
        try:
            with dispatch.plain_versions(self.degraded):
                self._invoke_loop(chunk, args)
        except ChaosKernelError as e:
            self._stats["kernel_failures"] += 1
            self._enter_degraded(f"decode chunk raised: {e!r}")
            with dispatch.plain_versions():
                self._invoke_loop(chunk, args)
        fetched = self._fetch_block(self._bufs)
        if fetched is None:
            return None
        tokens, emitted, done, tally = fetched
        self._stats["drafted"] += int(tally[0])
        self._stats["accepted"] += int(tally[1])
        return tokens, emitted, done

    def _guard_block(self, blk, emit):
        """The numeric guard on the fetched token block: a slot whose
        emitted tokens hold non-finite values is quarantined (its column
        cleared, so ``_collect`` never sees them) and the engine
        degrades."""
        if not np.issubdtype(np.asarray(blk).dtype, np.floating):
            return blk, emit
        bad = np.any(~np.isfinite(np.asarray(blk)) & (emit != 0), axis=0)
        if not bad.any():
            return blk, emit
        emit = np.array(emit)
        now = time.perf_counter()
        for i in np.nonzero(bad)[0]:
            if self._slot_req[int(i)] is None:
                continue
            emit[:, i] = False
            self._stats["numeric_faults"] += 1
            self._quarantine(int(i), now)
        self._enter_degraded("non-finite tokens in the fetched block")
        return blk, emit

    def _enter_degraded(self, reason: str) -> None:
        """Run this engine's prefills and chunks on the plain versions
        from now on (idempotent); nothing outside the engine changes."""
        if self.degraded:
            return
        self.degraded = True
        self._clean_chunks = 0
        warnings.warn(
            f"engine entering degraded mode (the plain versions on "
            f"{self.device}): {reason}", RuntimeWarning, stacklevel=2)

    def _fault_count(self) -> int:
        """Monotone tally of every fault class a chunk can hit: the
        before/after difference tells ``step()`` whether a chunk was
        clean."""
        return (self._stats["numeric_faults"]
                + self._stats["kernel_failures"]
                + self._stats["fetch_errors"])

    def _note_chunk_health(self, had_fault: bool) -> None:
        """Recovery: after ``degraded_recover_chunks`` fault-free chunks
        in a row the engine returns to its kernels (counted in
        ``degraded_recoveries``); the keys' captured graphs replay
        again.  A fault during probation resets the streak;
        ``degraded_recover_chunks=0`` keeps degraded mode one-way."""
        if not self.degraded or not self.scfg.degraded_recover_chunks:
            return
        self._clean_chunks = 0 if had_fault else self._clean_chunks + 1
        if self._clean_chunks < self.scfg.degraded_recover_chunks:
            return
        self.degraded = False
        self._clean_chunks = 0
        self._stats["degraded_recoveries"] += 1
        warnings.warn(
            "engine leaving degraded mode: "
            f"{self.scfg.degraded_recover_chunks} clean chunks in a row; "
            "back on the kernels", RuntimeWarning, stacklevel=2)

    # --- invariants ---------------------------------------------------

    def audit(self) -> Dict[str, Any]:
        """Check the engine's structural invariants (page conservation,
        page-table and pool consistency, the request state machine);
        returns a report, raises
        :class:`~repro_torch.serving.chaos.AuditError` on a violation.
        The chaos harness runs it after every step."""
        return audit_engine(self)
