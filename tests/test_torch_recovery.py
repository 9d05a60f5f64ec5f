"""The port's crash safety (``repro_torch.serving.journal``,
``.supervisor``) against the JAX package's, on the CPU: the twins of
``tests/test_recovery.py``'s six classes — the write-ahead journal,
snapshot/restore, supervised kill-and-recover (dense and 2:4 × mono,
paged and speculative), the watchdog, prefix pins across a restart and
the deadline clock across a restart.

Both engines serve the same weights: the JAX init of ``TINY`` and
``NM_TINY`` at float32 (2:4-packed for the ``nm`` cases), carried over by
``convert.params_from_numpy``; the JAX engines run on a 1x1 mesh with
Auto axes, the port on the CPU.  Each scenario is written once, against
either package, and returns what it saw: token streams, the journal's
records (every field but ``wall0`` and the generator ``key``, the one
field whose format differs), the restored engine's tick, uid counter,
stats and restarts, and the audit's journal counts.  The JAX side runs
once per scenario (memoized for the module; its engines are the file's
cost); the port's must be equal.  The JAX journal reader also replays
the port's journal files, record for record.  The wall-clock cases
(deadline, watchdog grace, the restart cap) run on the port alone.
"""

import dataclasses
import functools
import json
import os
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import ChaosConfig as JChaosConfig
from repro.serving import ChaosMonkey as JChaosMonkey
from repro.serving import Engine as JEngine
from repro.serving import Journal as JJournal
from repro.serving import ServeConfig as JServeConfig
from repro.serving import Supervisor as JSupervisor
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import (ChaosConfig, ChaosCrashError, ChaosMonkey,
                                 Journal, RequestStatus, Supervisor,
                                 SupervisorError)
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from repro_torch.serving.supervisor import _GRACE_STEPS
from test_torch_model import flatten, jax_mesh

TINY = dict(name="tiny", n_layers=2, d_model=64, vocab_size=512, n_heads=4,
            n_kv_heads=2, d_ff=128, remat=False, dtype="float32")
NM_TINY = dict(name="tiny-nm", n_layers=2, d_model=128, vocab_size=512,
               n_heads=4, n_kv_heads=2, d_ff=256, remat=False,
               dtype="float32")
NM = dict(format="nm", n=2, m=4, block_n=64)

# three requests over two slots: the third rides the queue across the
# crash, so recovery re-queues both an in-flight and a never-admitted
# request
PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.arange(20, 30, dtype=np.int32),
           np.arange(40, 44, dtype=np.int32)]

BASE = dict(slots=2, max_len=64, prompt_pad=16, max_new_tokens=8,
            decode_chunk=2, eos_token=-1, temperature=0.0)
KINDS = {
    "mono": {},
    "paged": dict(page_size=8, prompt_buckets=8),
    "spec": dict(spec_k=2, spec_draft="self"),
}
#: ``TestPrefixPinsAcrossRestart``'s config: two pinned 8-row pages
PINNED = dict(BASE, page_size=8, prompt_buckets=8, prefix_cache=True,
              prompt_pad=32, max_len=96)
HEAD = np.arange(1, 17, dtype=np.int32)
TAILS = [np.arange(60, 68, dtype=np.int32), np.arange(70, 78, dtype=np.int32)]

#: the counters both engines keep, compared after a restore
COUNTERS = ("prefills", "peak_pages", "admission_waits", "drafted",
            "accepted", "prefix_hits", "shared_pages", "cow_copies",
            "timeouts", "rejections", "preemptions", "numeric_faults",
            "kernel_failures", "fetch_errors", "degraded_recoveries",
            "restarts", "sync_count")


@functools.lru_cache(maxsize=None)
def weights(fmt: str):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    if fmt == "dense":
        jcfg, tcfg = JModelConfig(**TINY), TModelConfig(**TINY)
    else:
        jcfg = JModelConfig(**NM_TINY, mlp_sparsity=JSparsity(**NM))
        tcfg = TModelConfig(**NM_TINY, mlp_sparsity=TSparsity(**NM))
    jp = JM.init_model(jax.random.key(0), jcfg)
    if fmt != "dense":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


class Side:
    """One package's engine, supervisor, restore and monkey."""

    def __init__(self, name: str, fmt: str = "dense"):
        jcfg, jp, tcfg, tp = weights(fmt)
        self.jax = name == "jax"
        self.cfg, self.params = (jcfg, jp) if self.jax else (tcfg, tp)

    def scfg(self, kind="mono", jp="", **kw):
        base = PINNED if kind == "pinned" else dict(BASE, **KINDS[kind])
        return (JServeConfig if self.jax else TServeConfig)(
            **dict(base, journal_path=jp, **kw))

    def engine(self, scfg):
        if self.jax:
            return JEngine(self.cfg, jax_mesh(), scfg, self.params)
        return TEngine(self.cfg, scfg, self.params, device="cpu")

    def supervisor(self, scfg, **kw):
        if self.jax:
            return JSupervisor(self.cfg, jax_mesh(), scfg, self.params, **kw)
        return Supervisor(self.cfg, scfg, self.params, device="cpu", **kw)

    def restore(self, **kw):
        if self.jax:
            return JEngine.restore(self.cfg, jax_mesh(), self.params, **kw)
        return TEngine.restore(self.cfg, self.params, device="cpu", **kw)

    def monkey(self, eng, **kw):
        if self.jax:
            return JChaosMonkey(eng, JChaosConfig(**kw))
        return ChaosMonkey(eng, ChaosConfig(**kw))


def records(path: str) -> list:
    """The journal's records as plain values, without ``wall0``, the
    generator ``key`` and the cfg header's ``journal_path``."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("wall0", None)
            rec.pop("key", None)
            if rec["t"] == "cfg":
                rec["scfg"] = {k: v for k, v in rec["scfg"].items()
                               if k != "journal_path"}
            out.append(rec)
    return out


def engine_state(eng) -> dict:
    """A (restored) engine's scheduler state: tick, uid counter, the
    queue's requests and the counters both packages keep."""
    st = eng.stats()
    return {"tick": eng._tick, "uid_next": eng._uid_next,
            "queue": [(r.uid, list(r.out), r.rows0, r.status.value)
                      for r in eng.queue],
            "stats": {k: getattr(st, k) for k in COUNTERS}}


def journal_counts(report: dict) -> dict:
    return {k: report[k] for k in ("journaled", "journal_tick",
                                   "journal_pins")}


def quiet_steps(step, n: int) -> list:
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(n):
            events += step()
    return events


# --- the scenarios, written once for either package -------------------------

def uninterrupted(side, d, kind="mono"):
    """Serve ``PROMPTS`` to the end on a journaled engine: the
    transcripts every recovery must reproduce, and the journal of an
    uninterrupted serve."""
    jp = os.path.join(d, "j.jsonl")
    eng = side.engine(side.scfg(kind, jp))
    hs = [eng.submit(p) for p in PROMPTS]
    eng.run()
    report = journal_counts(eng.audit())
    eng.journal.close()
    mirror = (JJournal if side.jax else Journal)(jp).state
    return {"tokens": [h.tokens for h in hs],
            "rows0": [h._req.rows0 for h in hs],
            "tick": eng._tick, "records": records(jp), "audit": report,
            "mirror": {"uids": sorted(mirror.reqs), "tick": mirror.tick,
                       "next_uid": mirror.next_uid,
                       "status": [mirror.reqs[h.uid].status for h in hs],
                       "out": [mirror.reqs[h.uid].out for h in hs],
                       "rows0": [mirror.reqs[h.uid].rows0 for h in hs]},
            "path": jp}


def crash(side, d, kind="mono"):
    """``TestKillAndRecover``'s script: a crash pinned to tick 2 under
    the supervisor, snapshots every 2 ticks."""
    jp, sd = os.path.join(d, "j.jsonl"), os.path.join(d, "snap")
    sup = side.supervisor(side.scfg(kind), journal_path=jp,
                          snapshot_dir=sd, snapshot_every=2)
    side.monkey(sup.engine, seed=7, rate=0.0, crash_tick=2).attach()
    hs = [sup.submit(q) for q in PROMPTS]
    events = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(60):
            events += sup.step()
            if all(h.done for h in hs):
                break
    report = sup.audit()
    return {"tokens": [h.tokens for h in hs], "restarts": sup.restarts,
            "indices": [[ev.index for ev in events if ev.uid == h.uid]
                        for h in hs],
            "records": records(jp), "audit": journal_counts(report),
            "state": engine_state(sup.engine),
            "timings": sorted(sup.last_recovery),
            "total_ms": sup.last_recovery["total_ms"],
            "statuses": [h.status.value for h in hs]}


def journal_only(side, d):
    """Two ticks of the paged serve, the engine abandoned, then restored
    from the journal alone (the ServeConfig from its cfg header)."""
    jp = os.path.join(d, "j.jsonl")
    eng = side.engine(side.scfg("paged", jp))
    hs = [eng.submit(p) for p in PROMPTS]
    eng.step()
    eng.step()
    pre = [list(h.tokens) for h in hs]
    rec = side.restore(journal_path=jp)
    restored = engine_state(rec.engine)
    page_size = rec.engine.scfg.page_size
    rec.engine.run()
    return {"pre": pre, "page_size": page_size, "restored": restored,
            "tokens": [rec.handles[i].tokens for i in range(3)],
            "audit": journal_counts(rec.engine.audit()),
            "records": records(jp)}


def snapshot_tail(side, d):
    """A tick, a snapshot, one more tick of journal tail past it, then
    restored from both."""
    jp, sd = os.path.join(d, "j.jsonl"), os.path.join(d, "snap")
    eng = side.engine(side.scfg("mono", jp))
    hs = [eng.submit(p) for p in PROMPTS]
    eng.step()
    eng.snapshot(sd)
    eng.step()
    src = {h.uid: (list(h._req.out), h._req.rows0) for h in hs}
    rec = side.restore(journal_path=jp, snapshot_dir=sd)
    restored = engine_state(rec.engine)
    timings = sorted(rec.timings)
    rec.engine.run()
    return {"tick": eng._tick, "src": src, "restored": restored,
            "timings": timings, "load_ms": rec.timings["load_ms"],
            "tokens": [rec.handles[i].tokens for i in range(3)],
            "audit": journal_counts(rec.engine.audit())}


def pinned(side, d):
    """``TestPrefixPinsAcrossRestart``'s script: an uninterrupted serve
    of two tails behind a pinned head, then the supervised one with a
    crash at tick 1."""
    ref_eng = side.engine(side.scfg("pinned"))
    rh = ref_eng.register_prefix(HEAD)
    ref_hs = [ref_eng.submit(t, prefix=rh) for t in TAILS]
    ref_eng.run()
    jp = os.path.join(d, "j.jsonl")
    sup = side.supervisor(side.scfg("pinned"), journal_path=jp)
    side.monkey(sup.engine, seed=0, rate=0.0, crash_tick=1).attach()
    ph = sup.register_prefix(HEAD)
    hs = [sup.submit(t, prefix=ph) for t in TAILS]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sup.run()
    report = journal_counts(sup.audit())
    rebound = ph._engine is sup.engine
    ph.release()
    after = journal_counts(sup.audit())
    return {"ref": [h.tokens for h in ref_hs],
            "tokens": [h.tokens for h in hs], "restarts": sup.restarts,
            "pages": ph.n_pages, "released": ph.released,
            "rebound": rebound, "audit": report, "after": after,
            "records": records(jp)}


_JAX_RUNS = {}


def on_jax(tmp_path_factory, scenario, *args):
    """The JAX side of ``scenario``, run once per module."""
    key = (scenario.__name__,) + args
    if key not in _JAX_RUNS:
        fmt = args[0] if args else "dense"
        d = str(tmp_path_factory.mktemp("jax"))
        _JAX_RUNS[key] = scenario(Side("jax", fmt), d, *args[1:])
    return _JAX_RUNS[key]


def on_port(scenario, tmp_path, *args):
    fmt = args[0] if args else "dense"
    d = str(tmp_path / "port")
    os.makedirs(d, exist_ok=True)
    return scenario(Side("torch", fmt), d, *args[1:])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs torch on one thread: the tiny models' CPU ops
    are slower on the machine's whole thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_run(tmp_path_factory):
    """``jax_run(scenario, *args)``: :func:`on_jax` with this fixture's
    temporary directories."""
    return functools.partial(on_jax, tmp_path_factory)


# --- the twins of tests/test_recovery.py ------------------------------------

class TestJournal:
    def test_mirror_round_trips_a_run(self, tmp_path, jax_run):
        """The port's journal of an uninterrupted serve equals the JAX
        engine's record for record, and both journal readers replay it
        into the same mirror: every request's tokens, status, rows0 and
        prompt, the tick and the next uid."""
        want = jax_run(uninterrupted, "dense", "mono")
        got = on_port(uninterrupted, tmp_path, "dense", "mono")
        assert got["tokens"] == want["tokens"]
        assert got["records"] == want["records"]
        assert got["mirror"] == want["mirror"]
        assert got["audit"] == want["audit"]
        m = got["mirror"]
        assert m["uids"] == [0, 1, 2] and m["next_uid"] == 3
        assert m["out"] == got["tokens"] and m["rows0"] == got["rows0"]
        assert m["status"] == ["done"] * 3 and m["tick"] == got["tick"]
        assert got["records"][0]["scfg"]["max_new_tokens"] == 8
        jm = JJournal(got["path"]).state     # the JAX reader, port's file
        pm = Journal(got["path"]).state
        assert {u: dataclasses.asdict(r) for u, r in jm.reqs.items()} == \
            {u: dataclasses.asdict(r) for u, r in pm.reqs.items()}
        assert (jm.tick, jm.key, jm.pins) == (pm.tick, pm.key, pm.pins)

    def test_torn_tail_is_tolerated(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        eng.submit(PROMPTS[0])
        for _ in range(2):
            eng.step()
        eng.journal.close()
        with open(jp, "a") as f:        # a crash mid-write tears a line
            f.write('{"t": "commit", "uid": 0, "of')
        mirror = Journal(jp).state
        assert 0 in mirror.reqs         # everything before the tear holds
        assert len(mirror.reqs[0].out) > 0
        assert JJournal(jp).state.reqs[0].out == mirror.reqs[0].out

    def test_torn_tail_is_cut_before_appending(self, tmp_path, jax_run):
        """A journal whose last record a crash tore, restored twice: the
        first restore cuts the torn bytes before it appends, so each
        record it writes is a line of its own and the second restore
        loses none of them; the served tokens are the uninterrupted
        serve's."""
        ref = jax_run(uninterrupted, "dense", "mono")["tokens"]
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        [eng.submit(p) for p in PROMPTS]
        eng.step()
        eng.step()
        eng.journal.close()
        with open(jp, "r+b") as f:      # the crash ate the last record's end
            f.truncate(os.path.getsize(jp) - 12)
        first = side.restore(journal_path=jp)
        first.engine.step()
        wrote = first.engine.journal.state
        first.engine.journal.close()
        with open(jp, encoding="utf-8") as f:
            lines = f.readlines()
        assert all(line.endswith("\n") for line in lines)
        assert [json.loads(line)["t"] for line in lines][-1] == "tick"
        again = Journal(jp).state
        assert {u: r.out for u, r in again.reqs.items()} == \
            {u: r.out for u, r in wrote.reqs.items()}
        assert again.tick == wrote.tick == first.engine._tick
        second = side.restore(journal_path=jp)
        second.engine.run()
        second.engine.journal.close()
        assert [r.out for _, r in sorted(Journal(jp).state.reqs.items())] \
            == ref

    def test_a_whole_last_record_keeps_its_place(self, tmp_path):
        """A last record that reached the file whole but lost its newline
        is replayed, and the next record starts a line of its own."""
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        eng.submit(PROMPTS[0])
        eng.step()
        eng.journal.close()
        want = Journal(jp).state
        with open(jp, "r+b") as f:
            f.truncate(os.path.getsize(jp) - 1)
        j = Journal(jp)
        assert (j.state.tick, j.state.reqs[0].out) == \
            (want.tick, want.reqs[0].out)
        j.log_unpin(0)
        j.close()
        with open(jp, encoding="utf-8") as f:
            recs = [json.loads(line) for line in f]
        assert [r["t"] for r in recs[-2:]] == ["tick", "unpin"]

    def test_submit_is_durable_before_first_step(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        eng.submit(PROMPTS[0], priority=3, deadline_ms=5000.0)
        # no step(), no close(): the submit record is already on disk
        with open(jp) as f:
            recs = [json.loads(line) for line in f]
        assert [r["t"] for r in recs] == ["cfg", "submit"]
        assert recs[1]["prio"] == 3
        assert recs[1]["deadline_ms"] == 5000.0
        assert sorted(recs[1]) == ["deadline_ms", "max_new", "prio",
                                   "prompt", "stream", "t", "temp", "uid",
                                   "wall0"]

    def test_rejected_submission_journals_terminal(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp, max_queue=1))
        eng.submit(PROMPTS[0])
        h = eng.submit(PROMPTS[1])      # bounced off the bounded queue
        assert h.status is RequestStatus.REJECTED
        eng.journal.close()
        assert Journal(jp).state.reqs[h.uid].status == "rejected"
        assert JJournal(jp).state.reqs[h.uid].status == "rejected"

    def test_tick_key_is_the_generator_state(self, tmp_path):
        """The one field whose format differs from the JAX journal: the
        tick record's ``key`` is the engine generator's state, and a
        restore sets it before the first chunk."""
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        eng.submit(PROMPTS[0], temperature=1.0)
        eng.step()
        eng.step()
        want = eng._gen.get_state().tolist()
        assert Journal(jp).state.key == want
        rec = side.restore(journal_path=jp)
        assert rec.engine._gen.get_state().tolist() == want


class TestSnapshotRestore:
    def test_journal_only_restore_is_bit_identical(self, tmp_path, jax_run):
        ref = jax_run(uninterrupted, "dense", "paged")["tokens"]
        want = jax_run(journal_only)
        got = on_port(journal_only, tmp_path)
        assert any(got["pre"])          # tokens were delivered pre-crash
        assert got["page_size"] == 8
        assert got["tokens"] == ref == want["tokens"]
        for i, p in enumerate(got["pre"]):  # delivered never re-emitted
            assert got["tokens"][i][: len(p)] == p
        assert got["restored"] == want["restored"]
        assert got["records"] == want["records"]
        assert got["audit"] == want["audit"]

    def test_snapshot_plus_tail_restore(self, tmp_path, jax_run):
        ref = jax_run(uninterrupted, "dense", "mono")["tokens"]
        want = jax_run(snapshot_tail)
        got = on_port(snapshot_tail, tmp_path)
        st = got["restored"]
        assert st["tick"] == got["tick"]    # the tail wins over the snapshot
        assert sorted(u for u, *_ in st["queue"]) == [0, 1, 2]
        for uid, out, rows0, status in st["queue"]:
            assert (out, rows0) == tuple(got["src"][uid])
            assert status == ("preempted" if rows0 is not None
                              else "queued")
        assert got["load_ms"] >= 0.0
        assert got["timings"] == want["timings"] == [
            "load_ms", "pin_prefill_ms", "replay_ms"]
        assert got["tokens"] == ref == want["tokens"]
        assert st == want["restored"]
        assert got["audit"] == want["audit"]

    def test_stats_and_uid_counter_survive(self, tmp_path):
        jp, sd = str(tmp_path / "j.jsonl"), str(tmp_path / "snap")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        [eng.submit(p) for p in PROMPTS]
        for _ in range(3):
            eng.step()
        eng.snapshot(sd)
        want = engine_state(eng)["stats"]
        rec = side.restore(journal_path=jp, snapshot_dir=sd)
        assert engine_state(rec.engine)["stats"] == want
        assert rec.engine._stats["prefills"] == eng._stats["prefills"]
        assert rec.engine._uid_next == 3    # new uids never collide
        assert rec.engine._tick == eng._tick == 3
        # the dead engine's program records are not carried over
        assert rec.engine.stats().chunk_runs == []
        h = rec.engine.submit(PROMPTS[0])
        assert h.uid == 3


class TestKillAndRecover:
    """The acceptance property: a mid-wave crash and supervised restore
    is invisible in the transcript, for every backend kind and both
    weight packs, and the port's journal and restored engine are the
    JAX engine's."""

    @pytest.mark.parametrize("kind", ["mono", "paged", "spec"])
    @pytest.mark.parametrize("pack", ["dense", "nm"])
    def test_crash_mid_wave_bit_identical(self, tmp_path, jax_run, kind,
                                          pack):
        ref = jax_run(uninterrupted, pack, kind)["tokens"]
        want = jax_run(crash, pack, kind)
        got = on_port(crash, tmp_path, pack, kind)
        assert got["restarts"] == want["restarts"] == 1
        assert got["tokens"] == ref == want["tokens"]
        # across the crash each request's event indices are 0..n-1,
        # each exactly once: no token duplicated or dropped
        for idx, toks in zip(got["indices"], got["tokens"]):
            assert idx == list(range(len(toks)))
        assert got["indices"] == want["indices"]
        assert got["records"] == want["records"]
        assert got["state"] == want["state"]
        assert got["state"]["stats"]["restarts"] == 1
        assert got["audit"] == want["audit"]
        assert got["timings"] == want["timings"]
        assert got["total_ms"] > 0.0
        assert got["statuses"] == ["done"] * 3

    def test_handle_iteration_streams_through_crash(self, tmp_path,
                                                    jax_run):
        ref = jax_run(uninterrupted, "dense", "mono")["tokens"]
        side = Side("torch")
        sup = side.supervisor(side.scfg("mono"),
                              journal_path=str(tmp_path / "j.jsonl"))
        side.monkey(sup.engine, seed=0, rate=0.0, crash_tick=1).attach()
        hs = [sup.submit(q) for q in PROMPTS]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            streamed = [t for t in hs[0]]   # blocks through the crash
            sup.run()
        assert sup.restarts == 1
        assert streamed == ref[0]
        assert [h.tokens for h in hs] == ref

    def test_restart_cap_raises(self, tmp_path):
        side = Side("torch")
        sup = side.supervisor(side.scfg("mono"),
                              journal_path=str(tmp_path / "j.jsonl"),
                              max_restarts=1)

        def always_crash():
            raise ChaosCrashError("wedged for good")

        sup.engine.step = always_crash
        sup.submit(PROMPTS[0])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sup.step()                  # restart 1: tolerated
            sup.engine.step = always_crash
            with pytest.raises(SupervisorError):
                sup.step()              # restart 2: past the cap
        assert sup.restarts == 2

    def test_supervisor_requires_journal(self):
        side = Side("torch")
        with pytest.raises(ValueError, match="journal_path"):
            side.supervisor(side.scfg("mono"), journal_path="")

    def test_supervisor_refuses_an_earlier_serves_state(self, tmp_path):
        """A supervisor starts a fresh serve: a journal that holds an
        earlier serve's records, or a snapshot directory that holds its
        snapshot, is refused (its first recovery would bring that serve's
        requests back); an empty journal file is taken."""
        side = Side("torch")
        jp, sd = str(tmp_path / "j.jsonl"), str(tmp_path / "snap")
        eng = side.engine(side.scfg("mono", jp))
        eng.submit(PROMPTS[0])
        eng.step()
        eng.snapshot(sd)
        eng.journal.close()
        with pytest.raises(ValueError, match="earlier serve"):
            side.supervisor(side.scfg("mono"), journal_path=jp)
        fresh = str(tmp_path / "fresh.jsonl")
        with pytest.raises(ValueError, match="earlier serve"):
            side.supervisor(side.scfg("mono"), journal_path=fresh,
                            snapshot_dir=sd)
        open(fresh, "w").close()
        sup = side.supervisor(side.scfg("mono"), journal_path=fresh)
        assert sup.submit(PROMPTS[0]).uid == 0

    def test_teardown_drops_the_dead_engines_device_state(self, tmp_path):
        """The dead engine keeps no cache, chunk buffers, chunk programs
        or draft params (on the card: its pool and graphs are freed
        before the fresh engine allocates), and the restored engine is a
        new engine with buffers of its own."""
        side = Side("torch")
        sup = side.supervisor(side.scfg("spec"),
                              journal_path=str(tmp_path / "j.jsonl"))
        mk = side.monkey(sup.engine, seed=7, rate=0.0, crash_tick=2)
        mk.attach()
        hs = [sup.submit(q) for q in PROMPTS]
        quiet_steps(sup.step, 3)
        dead = mk.engine
        assert sup.restarts == 1 and sup.engine is not dead
        assert dead._cache is None and dead._bufs is None
        assert dead._backend._chunks == {} and dead.draft_params is None
        assert dead._chaos is None and dead.journal._f.closed
        assert sup.engine._chaos is None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sup.run()
        assert all(h.done for h in hs)
        assert sup.engine._bufs is not None


class TestWatchdog:
    def test_hang_trips_watchdog_and_recovers(self, tmp_path, jax_run):
        """A 250 ms watchdog (JAX's test: 50 ms; a loaded CPU's tiny step
        stays far under either) and a 1 s stall a fetch from tick 1."""
        ref = jax_run(uninterrupted, "dense", "mono")["tokens"]
        side = Side("torch")
        sup = side.supervisor(side.scfg("mono"),
                              journal_path=str(tmp_path / "j.jsonl"),
                              watchdog_ms=250.0)
        side.monkey(sup.engine, seed=0, rate=0.0, hang_tick=1,
                    hang_s=1.0).attach()
        hs = [sup.submit(q) for q in PROMPTS]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            sup.run()
        assert sup.restarts == 1        # a wedged device: one restore
        assert [h.tokens for h in hs] == ref
        sup.audit()

    def test_grace_period_tolerates_slow_first_steps(self, tmp_path):
        side = Side("torch")
        # an absurdly tight budget: only the grace window keeps a healthy
        # engine alive
        sup = side.supervisor(side.scfg("mono"),
                              journal_path=str(tmp_path / "j.jsonl"),
                              watchdog_ms=1e-6)
        sup.submit(PROMPTS[0], max_new=2)
        sup.step()                      # the first tick: grace, no restart
        assert sup.restarts == 0 and _GRACE_STEPS == 2

    def test_warm_up_and_capture_steps_are_exempt(self, tmp_path):
        """A chunk that warmed up or captured its key's graph never trips
        the watchdog; with graphs off (the CPU) an eager chunk is the
        steady state and counts."""
        side = Side("torch")
        sup = side.supervisor(side.scfg("mono"),
                              journal_path=str(tmp_path / "j.jsonl"))
        eng = sup.engine
        key = (None, False)
        assert not sup._warming(eng, [(key, "eager"), (key, "replay")])
        assert sup._warming(eng, [(key, "capture")])
        eng._backend._graphs = True
        assert sup._warming(eng, [(key, "eager")])
        assert not sup._warming(eng, [(key, "replay"), (key, "plain")])


class TestPrefixPinsAcrossRestart:
    def test_pins_survive_and_rebind(self, tmp_path, jax_run):
        want = jax_run(pinned)
        got = on_port(pinned, tmp_path)
        assert got["restarts"] == want["restarts"] == 1
        assert got["tokens"] == got["ref"] == want["ref"] == want["tokens"]
        assert got["pages"] == 2 and got["released"] and got["rebound"]
        assert got["audit"]["journal_pins"] == 1
        assert got["audit"] == want["audit"]
        assert got["after"] == want["after"]
        assert got["after"]["journal_pins"] == 0
        assert got["records"] == want["records"]


class TestDeadlineAcrossRestart:
    def test_deadline_keeps_ticking_through_recovery(self, tmp_path):
        """``deadline_ms`` measures from the original wall-clock arrival:
        downtime between the crash and the restore still counts, so a
        restored request times out when an uninterrupted one would."""
        jp = str(tmp_path / "j.jsonl")
        side = Side("torch")
        eng = side.engine(side.scfg("mono", jp))
        h = eng.submit(PROMPTS[0], deadline_ms=120.0)
        eng.step()
        assert not h.done
        # the process dies; the outage outlives the deadline
        time.sleep(0.15)
        rec = side.restore(journal_path=jp)
        r = rec.engine.queue[0]
        assert r.deadline_ms == 120.0
        rec.engine.step()               # the first tick enforces the clock
        assert rec.handles[h.uid].status is RequestStatus.TIMED_OUT
