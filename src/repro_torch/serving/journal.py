"""Crash safety: the write-ahead request journal and engine
snapshot/restore.

Persist just enough to rebuild the batch and let the engine recompute
the rest.  The journal records what cannot be recomputed — which
requests exist, which tokens were already delivered to callers, the
sampling generator's state, the pinned prefixes — while the KV cache,
the page tables, the chunk buffers and the captured CUDA graphs are
rebuilt from scratch on recovery (a resumed request's re-admission
prefills its effective prompt at ``rows0 + emitted`` rows, which
recomputes its attention state exactly).

**Journal** (:class:`Journal`): append-only JSONL, one record per line,
the JAX package's format line for line:

  * ``cfg``    — the ServeConfig (written once at attach)
  * ``submit`` — uid, prompt, budget, sampling/priority/deadline knobs,
    and the wall-clock arrival (``wall0``) so deadlines keep ticking
    across a restart
  * ``pin`` / ``unpin`` — ``register_prefix`` pins by pid
  * ``admit`` — uid → ``rows0`` (the first-admission prefill width the
    resume path must reproduce)
  * ``commit`` — one chunk's tokens for one request with their output
    offset; replay is idempotent (offsets dedupe), so a record written
    twice or replayed over a snapshot never re-emits a token
  * ``term``   — terminal status
  * ``tick``   — the completed-tick counter and ``key``, the engine's
    sampling generator state (``torch.Generator.get_state()`` as a list
    of ints, where the JAX journal holds a threefry key)

Records are buffered per scheduler tick and flushed with one ``fsync``
at the chunk boundary, before ``step()`` returns its events: a crash
can lose an undelivered chunk (it is recomputed) but never a delivered
one.  ``submit``/``pin`` records flush to the OS page cache at once
(durable against the process crash recovery handles; the next chunk
boundary's fsync adds power-loss durability).  The journal keeps an
in-memory mirror (``state``) by applying every record through the same
``_apply`` path replay uses, so ``engine.audit()`` can check journal
against engine at any tick.

**Snapshot** (:func:`snapshot_engine` / ``Engine.snapshot``): one
atomic, digest-verified checkpoint through
:mod:`repro_torch.checkpoint.store` carrying the ServeConfig, queue and
slot occupancy (as resumable request records), pinned-prefix tokens,
the stats counters and the generator state.  A snapshot bounds replay
work; the journal alone is enough.

**Recovery** (:func:`recover_engine` / ``Engine.restore``): construct a
fresh engine (new cache, new chunk buffers, no graph), merge snapshot
and journal (the journal is authoritative for request progress, the
snapshot for cumulative stats; ``chunk_runs`` and ``graph_captures``
describe the dead engine's programs and are not carried over), set the
generator state before the first chunk, re-pin prefixes (their KV is
recomputed: the honest cost; unpinned retained trie warmth is dropped)
and re-queue every non-terminal request at its original arrival clock:
never-admitted ones as QUEUED, in-flight ones as PREEMPTED so the next
admission takes the warm ``resume_rows`` path.  Greedy output after
recovery equals an uninterrupted run's, and delivered tokens are never
re-emitted (they are already in ``Request.out``; handle iterators
resume at their own offset).  The port advances its generator only on
sampled chunks, where JAX splits its key every chunk: greedy decoding
is the contract.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (LOAD_ERRORS, _steps,
                                          load_checkpoint, save_checkpoint)
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.state import (TERMINAL_STATUSES, Request,
                                       RequestHandle, RequestStatus)

__all__ = ["Journal", "Recovered", "recover_engine", "snapshot_engine",
           "earlier_serve"]

_TERMINAL_VALUES = frozenset(s.value for s in TERMINAL_STATUSES)

#: stats entries that describe one engine's programs, not the serve: a
#: restored engine starts its own
_PROGRAM_STATS = ("chunk_runs", "graph_captures")


@dataclasses.dataclass
class _JReq:
    """In-memory mirror of one journaled request."""
    uid: int
    prompt: List[int]
    max_new: int
    temperature: Optional[float]
    stream: bool
    priority: int
    deadline_ms: Optional[float]
    wall0: float                    # wall-clock arrival (time.time())
    out: List[int] = dataclasses.field(default_factory=list)
    rows0: Optional[int] = None     # set by the admit record
    status: str = "queued"


@dataclasses.dataclass
class JournalState:
    """What a full replay of the journal reconstructs."""
    scfg: Optional[dict] = None
    reqs: Dict[int, _JReq] = dataclasses.field(default_factory=dict)
    pins: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    key: Optional[List[int]] = None  # generator state after the last tick
    tick: int = 0                    # completed scheduler ticks

    @property
    def next_uid(self) -> int:
        return max(self.reqs, default=-1) + 1


class Journal:
    """Append-only write-ahead request journal (see the module docstring).

    Opening an existing file replays it into ``state`` first, then
    appends, so a recovered engine continues the same log.  A torn final
    line from a mid-write crash is dropped: the file is cut back to the
    end of its last whole record before anything is appended, so the
    next record starts a line of its own.
    """

    def __init__(self, path: str):
        self.path = path
        self.state = JournalState()
        self.fsyncs = 0             # chunk-boundary fsyncs made
        self._fin_seen = 0          # engine.finished watermark
        self._suspended = False
        newline = True
        if os.path.exists(path):
            whole = 0               # bytes up to the last whole record
            with open(path, "rb") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break       # torn tail: the crash ate this record
                    self._apply(rec)
                    whole += len(line)
                    newline = line.endswith(b"\n")
            if os.path.getsize(path) > whole:
                os.truncate(path, whole)
        self._f = open(path, "a", encoding="utf-8")
        if not newline:             # a whole record that lost its newline
            self._f.write("\n")

    # --- the single record-application path ---------------------------

    def _apply(self, rec: dict) -> None:
        t, st = rec["t"], self.state
        if t == "submit":
            st.reqs[rec["uid"]] = _JReq(
                uid=rec["uid"], prompt=rec["prompt"],
                max_new=rec["max_new"], temperature=rec["temp"],
                stream=rec["stream"], priority=rec["prio"],
                deadline_ms=rec["deadline_ms"], wall0=rec["wall0"])
        elif t == "commit":
            jr = st.reqs.get(rec["uid"])
            if jr is not None and rec["off"] <= len(jr.out):
                jr.out[rec["off"]:rec["off"] + len(rec["toks"])] = \
                    rec["toks"]
        elif t == "admit":
            jr = st.reqs.get(rec["uid"])
            if jr is not None:
                jr.rows0 = rec["rows0"]
        elif t == "term":
            jr = st.reqs.get(rec["uid"])
            if jr is not None:
                jr.status = rec["status"]
        elif t == "tick":
            st.tick = rec["n"]
            st.key = rec["key"]
        elif t == "pin":
            st.pins[rec["pid"]] = rec["tokens"]
        elif t == "unpin":
            st.pins.pop(rec["pid"], None)
        elif t == "cfg":
            st.scfg = rec["scfg"]
        # unknown record types are skipped: a newer engine's journal
        # still replays on this one

    def _append(self, rec: dict) -> None:
        if self._suspended:
            return
        self._apply(rec)
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def _flush(self) -> None:
        """Push buffered records into the OS page cache: they survive a
        process crash (the model the chaos harness injects) without an
        fsync per submit."""
        if not self._suspended:
            self._f.flush()

    def _commit(self) -> None:
        """Flush and fsync: the chunk-boundary recovery point that also
        survives power loss."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsyncs += 1

    @contextlib.contextmanager
    def suspended(self):
        """No-op all appends inside the block: recovery re-drives engine
        entry points whose records are already durable."""
        self._suspended = True
        try:
            yield self
        finally:
            self._suspended = False

    def close(self) -> None:
        if not self._f.closed:
            self._commit()
            self._f.close()

    # --- engine-facing logging ----------------------------------------

    def log_config(self, scfg: ServeConfig) -> None:
        if self.state.scfg is None:
            self._append({"t": "cfg", "scfg": dataclasses.asdict(scfg)})
            self._commit()

    def log_submit(self, req: Request) -> None:
        """Written (and crash-durable, see :meth:`_flush`) before the
        caller's handle is usable: the submit, and a terminal record for
        an immediate rejection."""
        self._append({
            "t": "submit", "uid": req.uid,
            "prompt": [int(x) for x in req.prompt],
            "max_new": req.max_new, "temp": req.temperature,
            "stream": req.stream, "prio": req.priority,
            "deadline_ms": req.deadline_ms, "wall0": time.time()})
        if req.status in TERMINAL_STATUSES:
            self._append({"t": "term", "uid": req.uid,
                          "status": req.status.value})
        self._flush()

    def log_pin(self, pid: int, tokens: np.ndarray) -> None:
        self._append({"t": "pin", "pid": pid,
                      "tokens": [int(x) for x in tokens]})
        self._flush()

    def log_unpin(self, pid: int) -> None:
        self._append({"t": "unpin", "pid": pid})
        self._flush()

    def record_tick(self, engine: Any, events: List[Any]) -> None:
        """One chunk boundary: admits for newly slotted requests, the
        tick's token commits, terminal records for requests that
        finished, then the tick marker, all under one fsync before
        ``step()`` returns the events to the caller (write-ahead for
        delivery: a delivered token is always recoverable)."""
        if self._suspended:
            return
        fin = engine.finished
        if self._fin_seen > len(fin):   # a benchmark's finished.clear()
            self._fin_seen = 0
        new_fin = fin[self._fin_seen:]
        self._fin_seen = len(fin)
        wrote = False
        live = [r for r in engine._slot_req if r is not None]
        for r in live + new_fin:
            jr = self.state.reqs.get(r.uid)
            if jr is None or r.rows0 is None or jr.rows0 is not None:
                continue
            self._append({"t": "admit", "uid": r.uid, "rows0": r.rows0})
            wrote = True
        by_uid: Dict[int, List[Any]] = {}
        for ev in events:
            by_uid.setdefault(ev.uid, []).append(ev)
        for uid, evs in by_uid.items():
            if uid not in self.state.reqs:
                continue
            self._append({"t": "commit", "uid": uid, "off": evs[0].index,
                          "toks": [ev.token for ev in evs]})
            wrote = True
        for r in new_fin:
            jr = self.state.reqs.get(r.uid)
            if jr is not None and jr.status not in _TERMINAL_VALUES:
                self._append({"t": "term", "uid": r.uid,
                              "status": r.status.value})
                wrote = True
        if wrote or events:
            self._append({"t": "tick", "n": engine._tick,
                          "key": _generator_state(engine)})
            self._commit()


def _generator_state(engine: Any) -> List[int]:
    """The engine's sampling generator state as a list of ints (16 bytes
    of seed and offset on the card, the Mersenne Twister's state on the
    CPU)."""
    return [int(x) for x in engine._gen.get_state().tolist()]


def _set_generator_state(engine: Any, key: List[int]) -> None:
    engine._gen.set_state(torch.tensor(key, dtype=torch.uint8))


# --- snapshot --------------------------------------------------------


def _wall0(r: Request) -> float:
    """The request's arrival on the wall clock (``arrival_s`` is a
    perf_counter stamp, meaningless across processes)."""
    return time.time() - (time.perf_counter() - r.arrival_s)


def snapshot_engine(engine: Any, directory: str) -> str:
    """``Engine.snapshot(dir)``: one atomic checkpoint of everything a
    fresh process needs to resume (see the module docstring).  Returns
    the step directory (step number = completed ticks)."""
    if engine.journal is not None:
        engine.journal._commit()
    tree: Dict[str, np.ndarray] = {
        "key": np.asarray(_generator_state(engine), np.uint8)}
    reqs: Dict[str, dict] = {}
    for r in [r for r in engine._slot_req if r is not None] + engine.queue:
        reqs[str(r.uid)] = {
            "max_new": r.max_new, "temperature": r.temperature,
            "stream": r.stream, "priority": r.priority,
            "deadline_ms": r.deadline_ms, "rows0": r.rows0,
            "wall0": _wall0(r), "faults": r.faults,
            "preempts": r.preempts, "slot": r.slot}
        tree[f"req.{r.uid}.prompt"] = np.asarray(r.prompt, np.int32)
        tree[f"req.{r.uid}.out"] = np.asarray(r.out, np.int32)
    for pid, handle in engine._pins.items():
        tree[f"pin.{pid}"] = np.asarray(handle.tokens, np.int32)
    meta = {
        "scfg": dataclasses.asdict(engine.scfg),
        "tick": engine._tick, "next_uid": engine._uid_next,
        "sync_count": engine.sync_count,
        "stats": {k: v for k, v in engine._stats.items()},
        "slots": [r.uid if r is not None else None
                  for r in engine._slot_req],
        "finished": [[r.uid, r.status.value] for r in engine.finished],
        "reqs": reqs, "pins": sorted(engine._pins),
    }
    return save_checkpoint(directory, engine._tick, tree, meta)


def _load_snapshot(directory: str):
    """Newest digest-valid snapshot → (arrays by name, meta), or
    ``(None, None)``.  Walks backwards so one corrupt step never bricks
    recovery."""
    for name in reversed(_steps(directory)):
        try:
            flat, manifest = load_checkpoint(os.path.join(directory, name))
        except LOAD_ERRORS:
            continue
        return {k: t.numpy() for k, t in flat.items()}, manifest["meta"]
    return None, None


# --- recovery --------------------------------------------------------


@dataclasses.dataclass
class _Resume:
    """One non-terminal request to rebuild into the fresh engine."""
    uid: int
    prompt: np.ndarray
    out: List[int]
    max_new: int
    temperature: Optional[float]
    stream: bool
    priority: int
    deadline_ms: Optional[float]
    wall0: float
    rows0: Optional[int]
    faults: int = 0
    preempts: int = 0


@dataclasses.dataclass
class Recovered:
    """What :func:`recover_engine` hands the supervisor: the fresh
    engine, per-uid handles for every rebuilt (non-terminal) request so
    live iterators can be re-bound, re-pinned prefix handles by pid, and
    the recovery's timings in milliseconds (``load_ms``, ``replay_ms``,
    ``pin_prefill_ms``)."""
    engine: Any
    handles: Dict[int, RequestHandle]
    prefixes: Dict[int, Any]
    timings: Dict[str, float]


def recover_engine(cfg: Any, params: Any, *,
                   scfg: Optional[ServeConfig] = None,
                   draft_params: Any = None,
                   journal_path: Optional[str] = None,
                   snapshot_dir: Optional[str] = None,
                   device="cuda") -> Recovered:
    """Build a fresh :class:`~repro_torch.serving.api.Engine` on
    ``device`` and restore the latest snapshot plus the journal's tail
    into it (either source alone suffices; with both, the journal is
    authoritative for request progress and the snapshot for cumulative
    stats).  ``scfg`` defaults to the snapshot's, or the journal
    header's, round-tripped ServeConfig."""
    from repro_torch.serving.api import Engine

    t0 = time.perf_counter()
    flat, meta = (None, None)
    if snapshot_dir:
        flat, meta = _load_snapshot(snapshot_dir)
    if scfg is None:
        head = meta["scfg"] if meta is not None else _journal_cfg(
            journal_path)
        if head is None:
            raise ValueError(
                "recover_engine needs an explicit scfg, a snapshot, or a "
                "journal with a cfg header")
        scfg = ServeConfig(**head)
    if journal_path:
        scfg = dataclasses.replace(scfg, journal_path=journal_path)
    engine = Engine(cfg, scfg, params, draft_params=draft_params,
                    device=device)
    if engine._chaos is not None:
        # the environment's monkey injected the fault that killed the old
        # engine; the recovered engine runs without one (the monkey dies
        # with the engine it killed)
        engine._chaos.detach()
    load_ms = (time.perf_counter() - t0) * 1e3

    t1 = time.perf_counter()
    resumes: Dict[int, _Resume] = {}
    pins: Dict[int, List[int]] = {}
    key: Optional[List[int]] = None
    tick, next_uid = 0, 0
    if meta is not None:
        engine._stats.update({k: v for k, v in meta["stats"].items()
                              if k not in _PROGRAM_STATS})
        engine.sync_count = meta["sync_count"]
        tick, next_uid = meta["tick"], meta["next_uid"]
        key = [int(x) for x in np.ravel(flat["key"])]
        for uid_s, d in meta["reqs"].items():
            uid = int(uid_s)
            resumes[uid] = _Resume(
                uid=uid, prompt=flat[f"req.{uid}.prompt"],
                out=[int(x) for x in flat[f"req.{uid}.out"]],
                max_new=d["max_new"], temperature=d["temperature"],
                stream=d["stream"], priority=d["priority"],
                deadline_ms=d["deadline_ms"], wall0=d["wall0"],
                rows0=d["rows0"], faults=d["faults"],
                preempts=d["preempts"])
        for pid in meta["pins"]:
            pins[int(pid)] = [int(x) for x in flat[f"pin.{pid}"]]
    jst = engine.journal.state if engine.journal is not None else None
    if jst is not None and jst.reqs:
        # the journal sees everything after the snapshot: newer commits,
        # newer submissions, terminal records; rebuild from its mirror
        for uid, jr in jst.reqs.items():
            if jr.status in _TERMINAL_VALUES:
                resumes.pop(uid, None)
                continue
            old = resumes.get(uid)
            resumes[uid] = _Resume(
                uid=uid, prompt=np.asarray(jr.prompt, np.int32),
                out=list(jr.out), max_new=jr.max_new,
                temperature=jr.temperature, stream=jr.stream,
                priority=jr.priority, deadline_ms=jr.deadline_ms,
                wall0=jr.wall0, rows0=jr.rows0,
                faults=old.faults if old is not None else 0,
                preempts=old.preempts if old is not None else 0)
        pins = dict(jst.pins)
        if jst.key is not None:
            key, tick = jst.key, max(tick, jst.tick)
        next_uid = max(next_uid, jst.next_uid)
    engine._tick = tick
    engine._uid_next = max(next_uid, engine._uid_next)
    if key is not None:
        _set_generator_state(engine, key)
    replay_ms = (time.perf_counter() - t1) * 1e3

    # --- re-pin prefixes (KV recomputed: the honest re-prefill cost);
    # unpinned retained trie warmth died with the old pool
    t2 = time.perf_counter()
    prefixes: Dict[int, Any] = {}
    guard = (engine.journal.suspended() if engine.journal is not None
             else contextlib.nullcontext())
    with guard:
        for pid in sorted(pins):
            h = engine.register_prefix(np.asarray(pins[pid], np.int32))
            if h._pid != pid:
                engine._pins[pid] = engine._pins.pop(h._pid)
                h._pid = pid
            engine._pin_next = max(engine._pin_next, pid + 1)
            prefixes[pid] = h
    prefill_ms = (time.perf_counter() - t2) * 1e3

    # --- rebuild non-terminal requests at their original arrival clock
    handles: Dict[int, RequestHandle] = {}
    now_p, now_w = time.perf_counter(), time.time()
    for uid in sorted(resumes):
        rs = resumes[uid]
        spent = rs.rows0 is not None and (
            rs.max_new - len(rs.out) <= 0
            or rs.rows0 + len(rs.out) >= scfg.max_len)
        status = (RequestStatus.DONE if spent
                  else RequestStatus.PREEMPTED if rs.rows0 is not None
                  else RequestStatus.QUEUED)
        r = Request(uid=uid, prompt=np.asarray(rs.prompt, np.int32),
                    max_new=rs.max_new, out=list(rs.out), status=status,
                    temperature=rs.temperature, stream=rs.stream,
                    priority=rs.priority, deadline_ms=rs.deadline_ms,
                    rows0=rs.rows0, faults=rs.faults, preempts=rs.preempts)
        # the deadline clock: elapsed wall time (the downtime included)
        # maps back onto the fresh engine's perf_counter timeline
        r.arrival_s = now_p - max(0.0, now_w - rs.wall0)
        handles[uid] = RequestHandle(engine, r)
        if spent:
            r.done = True
            r.finish_s = now_p
            engine.finished.append(r)
        else:
            engine.queue.append(r)
    return Recovered(engine=engine, handles=handles, prefixes=prefixes,
                     timings={"load_ms": load_ms, "replay_ms": replay_ms,
                              "pin_prefill_ms": prefill_ms})


def earlier_serve(journal_path: Optional[str],
                  snapshot_dir: Optional[str] = None) -> Optional[str]:
    """Why a fresh serve cannot start on these paths, or ``None``: a
    journal file that holds records, or a snapshot directory that holds
    a snapshot, is an earlier serve's state.  Only a restore may take it
    up; a fresh serve on it would replay that serve's requests at its
    first recovery."""
    if journal_path and os.path.exists(journal_path) \
            and os.path.getsize(journal_path) > 0:
        return (f"{journal_path} holds the journal of an earlier serve "
                "(restore it with Engine.restore, or remove it)")
    if snapshot_dir and _steps(snapshot_dir):
        return (f"{snapshot_dir} holds the snapshots of an earlier serve "
                "(restore them with Engine.restore, or remove them)")
    return None


def _journal_cfg(journal_path: Optional[str]) -> Optional[dict]:
    """The cfg-header record of a journal, without opening it for append
    (the ServeConfig is resolved before the engine exists)."""
    if not journal_path or not os.path.exists(journal_path):
        return None
    with open(journal_path, "r", encoding="utf-8") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                return None
            if rec.get("t") == "cfg":
                return rec["scfg"]
    return None
