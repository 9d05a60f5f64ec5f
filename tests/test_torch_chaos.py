"""The port's fault layer (``repro_torch.serving.faults``, ``.chaos``)
against the JAX package's, on the CPU: the twins of
``tests/test_chaos.py``'s classes — deadlines and the bounded queue,
priority preemption with warm-page resume, the numeric guard, kernel and
fetch faults, the seeded chaos harness, admission fairness under
injected pool pressure, the deadline clock, degraded-mode recovery and
the hybrid and enc-dec families — plus the port's own degraded scope.

Both engines serve the same weights: the JAX init of ``TINY`` (and of
the hybrid ``HY`` and enc-dec ``ED`` configs) at float32, 2:4-packed for
the ``nm`` cases, carried over by ``convert.params_from_numpy``; the JAX
engine runs on a 1x1 mesh with Auto axes, the port on the CPU.  Each
scenario is written once, against either package, and returns what it
saw: token streams, status histories, final statuses, fault and
preemption counts, the stats counters, ``sync_count`` and the chaos
schedule.  The JAX side runs once per scenario (memoized for the
module; its engines are the file's cost); the port's must be equal.
The deadline cases depend on the wall clock, and the rate-0 monkey and
the one-way degraded mode are checked against the port's own serves, so
those run on the port alone.
"""

import dataclasses
import functools
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.kernels import dispatch as jdispatch
from repro.models.config import LayerKind
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import ChaosConfig as JChaosConfig
from repro.serving import ChaosMonkey as JChaosMonkey
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.chaos import audit_engine as jaudit
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import nm_spmm as tnm
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import (TERMINAL_STATUSES, AuditError, ChaosConfig,
                                 ChaosMonkey, RequestStatus)
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from repro_torch.serving.chaos import audit_engine
from test_torch_model import flatten, jax_mesh

TINY = dict(name="tiny", n_layers=2, d_model=64, vocab_size=512, n_heads=4,
            n_kv_heads=2, d_ff=128, remat=False, dtype="float32")
HY = dict(name="hy", n_layers=3, d_model=64, vocab_size=256, n_heads=4,
          n_kv_heads=2, d_ff=128, remat=False, dtype="float32",
          layer_kinds=(int(LayerKind.MAMBA), int(LayerKind.SHARED_ATTN),
                       int(LayerKind.MAMBA)))
#: ``test_chaos.py``'s ED in the layout the port serves (seamless's:
#: an ungated MLP, frames into the encoder; a prompt prefills over a
#: null source), as ``tests/test_torch_encdec.py``'s engine config
ED = dict(name="ed", n_layers=2, n_encoder_layers=2, d_model=64,
          vocab_size=256, n_heads=4, n_kv_heads=2, d_ff=128, remat=False,
          dtype="float32", is_encoder_decoder=True, input_mode="embeds",
          mlp_gated=False)
MODELS = {"lm": TINY, "hy": HY, "ed": ED}
#: the MLP's 2:4 packs (g = 64: d_model 64, d_ff 128)
NM = dict(format="nm", n=2, m=4, block_n=64)

# paged + bucketed + prefix-shared: the geometry every fault path runs
# through.  16-token prompts fill exactly two pages (bucket 16), so
# preemption leaves two warm trie pages behind.
PAGED = dict(slots=2, max_len=64, prompt_pad=32, max_new_tokens=16,
             decode_chunk=2, eos_token=-1, page_size=8, prompt_buckets=8,
             prefix_cache=True, temperature=0.0)
#: the families' monolithic config (``TestChaosFamilies.SCFG``)
FAMILY = dict(slots=2, max_len=64, prompt_pad=16, max_new_tokens=6,
              decode_chunk=2, eos_token=-1, temperature=0.0)
#: the hybrid preemption config (paged, no prefix sharing)
HY_PAGED = dict(slots=2, max_len=64, prompt_pad=32, max_new_tokens=12,
                decode_chunk=2, eos_token=-1, temperature=0.0, page_size=8,
                prompt_buckets=8, num_pages=6)

PROMPT = np.arange(1, 17, dtype=np.int32)
PROMPT_HI = np.arange(20, 36, dtype=np.int32)

#: the counters both engines keep, compared field by field
COUNTERS = ("timeouts", "rejections", "preemptions", "numeric_faults",
            "kernel_failures", "fetch_errors", "degraded",
            "degraded_recoveries", "prefills", "prefix_hits", "shared_pages",
            "cow_copies", "peak_pages", "admission_waits", "sync_count")


@functools.lru_cache(maxsize=None)
def weights(model: str, fmt: str):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    kw = MODELS[model]
    if fmt == "dense":
        jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    else:
        jcfg = JModelConfig(**kw, mlp_sparsity=JSparsity(**NM))
        tcfg = TModelConfig(**kw, mlp_sparsity=TSparsity(**NM))
    jp = JM.init_model(jax.random.key(0), jcfg)
    if fmt != "dense":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


class Side:
    """One package's engine, monkey and audit, behind one surface."""

    def __init__(self, name: str, model: str = "lm", fmt: str = "dense"):
        self.name, self.model, self.fmt = name, model, fmt
        jcfg, jp, tcfg, tp = weights(model, fmt)
        self.jax = name == "jax"
        self.cfg, self.params = (jcfg, jp) if self.jax else (tcfg, tp)

    def engine(self, base=PAGED, **kw):
        if self.jax:
            return JEngine(self.cfg, jax_mesh(), JServeConfig(**base, **kw),
                           self.params)
        return TEngine(self.cfg, TServeConfig(**base, **kw), self.params,
                       device="cpu")

    def monkey(self, eng, **kw):
        if self.jax:
            return JChaosMonkey(eng, JChaosConfig(**kw))
        return ChaosMonkey(eng, ChaosConfig(**kw))

    def audit(self, eng):
        return (jaudit if self.jax else audit_engine)(eng)


def drain(eng, handles, max_steps=200):
    """Drive ``step()`` until every handle is terminal (bounded)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(max_steps):
            eng.step()
            if all(h.done for h in handles):
                return
    raise AssertionError(
        f"not terminal after {max_steps} steps: "
        f"{[h.status.value for h in handles]}")


def steps(eng, n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(n):
            eng.step()


def observe(eng, handles, monkey=None, **extra):
    """What a scenario saw, as plain values both packages give alike."""
    st = eng.stats()
    return {"tokens": [h.tokens for h in handles],
            "status": [h.status.value for h in handles],
            "history": [[s.value for s in h._req.history] for h in handles],
            "faults": [h._req.faults for h in handles],
            "preempts": [h._req.preempts for h in handles],
            "stats": {k: getattr(st, k) for k in COUNTERS},
            "schedule": None if monkey is None else list(monkey.schedule),
            **extra}


# --- the scenarios, written once for either package -------------------------

def bounded_queue(side):
    eng = side.engine(num_pages=8, max_queue=2)
    hs = [eng.submit(PROMPT, max_new=2) for _ in range(3)]
    at_submit = [h.status.value for h in hs]
    rejected_tokens = hs[2].tokens
    drain(eng, hs)
    side.audit(eng)
    return observe(eng, hs, at_submit=at_submit,
                   rejected_tokens=rejected_tokens)


def preempt_warm(side):
    eng = side.engine(num_pages=6)
    lo = eng.submit(PROMPT, max_new=12)
    steps(eng, 3)
    before = (len(lo.tokens), eng.stats().prefix_hits)
    hi = eng.submit(PROMPT_HI, max_new=12, priority=5)
    drain(eng, [lo, hi])
    side.audit(eng)
    return observe(eng, [lo, hi], before=before)


def uninterrupted(side):
    """``preempt_warm``'s two requests served alone, each on an engine of
    its own with room to spare: the streams a preemption must keep."""
    out = []
    for p in (PROMPT, PROMPT_HI):
        eng = side.engine(num_pages=10)
        out.append(eng.submit(p, max_new=12).result())
    return out


def equal_priority(side):
    eng = side.engine(num_pages=4)
    first = eng.submit(PROMPT, max_new=12)
    eng.step()
    second = eng.submit(PROMPT_HI, max_new=2)
    eng.step()
    mid = [first.status.value, second.status.value]
    drain(eng, [first, second])
    return observe(eng, [first, second], mid=mid)


def nan_quarantine(side):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=0, rate=0.0, nan_rate=1.0,
                     audit_every_step=False)
    a = eng.submit(PROMPT, max_new=6)
    b = eng.submit(PROMPT_HI, max_new=6)
    eng.step()
    mk.attach()
    steps(eng, 1)
    mk.detach()
    mid = (eng.stats().numeric_faults, eng.degraded,
           [h._req.faults for h in (a, b)])
    drain(eng, [a, b])
    side.audit(eng)
    return observe(eng, [a, b], mk, mid=mid)


def second_fault(side):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=0, rate=0.0, nan_rate=1.0,
                     audit_every_step=True)
    h = eng.submit(PROMPT, max_new=8)
    mk.attach()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(40):
            eng.step()
            if h.done:
                break
    mk.detach()
    side.audit(eng)
    return observe(eng, [h], mk)


def kernel_failure(side):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=0, rate=0.0, kernel_rate=1.0)
    h = eng.submit(PROMPT, max_new=6)
    mk.attach()
    drain(eng, [h])
    mk.detach()
    return observe(eng, [h], mk), eng


def fetch_drop(side):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=0, rate=0.0, drop_rate=1.0)
    h = eng.submit(PROMPT, max_new=6)
    mk.attach()
    drain(eng, [h])
    mk.detach()
    return observe(eng, [h], mk)


def chaos_run(side, seed=3):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=seed, rate=0.25).attach()
    hs = [eng.submit(np.arange(1 + i, 17 + i, dtype=np.int32), max_new=6)
          for i in range(4)]
    drain(eng, hs)
    mk.detach()
    return observe(eng, hs, mk)


def zero_rate(side):
    eng = side.engine(num_pages=10)
    mk = side.monkey(eng, seed=0, rate=0.0).attach()
    h = eng.submit(PROMPT, max_new=8)
    drain(eng, [h])
    return observe(eng, [h], mk)


def pressured(side):
    eng = side.engine(num_pages=8)
    mk = side.monkey(eng, seed=0, rate=0.0).attach()
    seized = mk.seize_pages(eng.scfg.pool_pages)
    return eng, mk, seized


def fifo(side):
    eng, mk, seized = pressured(side)
    hs = [eng.submit(PROMPT, max_new=2) for _ in range(3)]
    steps(eng, 3)
    blocked = ([h.status.value for h in hs], eng.stats().admission_waits)
    mk.release_pressure()
    order = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(100):
            order += [ev.uid for ev in eng.step() if ev.final]
            if all(h.done for h in hs):
                break
    mk.detach()
    side.audit(eng)
    return observe(eng, hs, mk, seized=seized, blocked=blocked,
                   order=order, uids=[h.uid for h in hs])


def priority_jump(side):
    eng, mk, _ = pressured(side)
    lo = [eng.submit(PROMPT, max_new=2) for _ in range(2)]
    hi = eng.submit(PROMPT_HI, max_new=2, priority=3)
    eng.step()
    blocked = [h.status.value for h in lo + [hi]]
    mk.release_pressure()
    eng.step()
    after = [h.status.value for h in lo + [hi]]
    drain(eng, lo + [hi])
    first = hi._req.first_token_s <= min(h._req.first_token_s for h in lo)
    mk.detach()
    side.audit(eng)
    return observe(eng, lo + [hi], mk, blocked=blocked, after=after,
                   hi_first=first)


def degrade(side, eng):
    mk = side.monkey(eng, seed=0, rate=0.0, kernel_rate=1.0).attach()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(5):
            eng.step()
            if eng.degraded:
                break
    assert eng.degraded
    return mk


def recover(side):
    eng = side.engine(num_pages=10, degraded_recover_chunks=3)
    h = eng.submit(PROMPT, max_new=14)
    mk = degrade(side, eng)
    mk.detach()
    drain(eng, [h])
    side.audit(eng)
    return observe(eng, [h], mk, degraded=eng.degraded), eng


def one_way(side):
    eng = side.engine(num_pages=10, degraded_recover_chunks=0)
    h = eng.submit(PROMPT, max_new=14)
    mk = degrade(side, eng)
    mk.detach()
    drain(eng, [h])
    return observe(eng, [h], mk, degraded=eng.degraded)


def probation(side):
    eng = side.engine(num_pages=10, degraded_recover_chunks=4)
    h = eng.submit(PROMPT, max_new=16)
    mk = degrade(side, eng)
    steps(eng, 2)                   # still faulting: the streak stays 0
    streak = eng._clean_chunks
    mk.detach()
    steps(eng, 3)                   # 3 clean < threshold 4
    still = eng.degraded
    drain(eng, [h])                 # the 4th clean chunk recovers
    return observe(eng, [h], mk, streak=streak, still=still,
                   degraded=eng.degraded)


def family_chaos(side):
    eng = side.engine(FAMILY)
    mk = side.monkey(eng, seed=5, rate=0.0, drop_rate=0.3, kernel_rate=0.3,
                     audit_every_step=True).attach()
    hs = [eng.submit(PROMPT), eng.submit(PROMPT_HI)]
    drain(eng, hs)
    mk.detach()
    side.audit(eng)
    return observe(eng, hs, mk)


def hybrid_preempt(side):
    eng = side.engine(HY_PAGED)
    lo = eng.submit(PROMPT)
    steps(eng, 3)
    early = len(lo.tokens)
    hi = eng.submit(PROMPT_HI, max_new=12, priority=5)
    drain(eng, [lo, hi])
    side.audit(eng)
    return observe(eng, [lo, hi], early=early)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs torch on one thread: the tiny models' CPU ops
    are slower on the machine's whole thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_override():
    """The JAX engine's degraded mode flips a process-global dispatch
    override: never leak it across tests."""
    yield
    jdispatch.set_mode_override(None)


_JAX_RUNS = {}


def on_jax(scenario, model="lm", fmt="dense", **kw):
    """The JAX side of ``scenario``, run once per module."""
    key = (scenario.__name__, model, fmt, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jdispatch.set_mode_override(None)
        try:
            _JAX_RUNS[key] = scenario(Side("jax", model, fmt), **kw)
        finally:
            jdispatch.set_mode_override(None)
    return _JAX_RUNS[key]


def on_port(scenario, model="lm", fmt="dense", **kw):
    return scenario(Side("torch", model, fmt), **kw)


def chunk_hows(eng):
    return [how for _, how in eng.stats().chunk_runs]


# --- the twins of tests/test_chaos.py ----------------------------------------

class TestDeadlinesAndRejection:
    def test_queued_deadline_times_out(self):
        eng = Side("torch").engine(num_pages=4)
        blocker = eng.submit(PROMPT, max_new=12)
        doomed = eng.submit(PROMPT_HI, max_new=12, deadline_ms=0.01)
        eng.step()          # blocker admits; doomed waits past deadline
        eng.step()
        assert doomed.status is RequestStatus.TIMED_OUT
        assert doomed.tokens == []
        assert eng.stats().timeouts == 1
        assert [s.value for s in doomed._req.history] == ["queued",
                                                          "timed_out"]
        drain(eng, [blocker])
        assert blocker.status is RequestStatus.DONE
        audit_engine(eng)

    def test_running_deadline_times_out_and_frees_pages(self):
        eng = Side("torch").engine(num_pages=4)
        h = eng.submit(PROMPT, max_new=16, deadline_ms=0.01)
        eng.step()
        eng.step()          # past the deadline at this chunk boundary
        assert h.status is RequestStatus.TIMED_OUT
        b = eng._backend
        assert sum(b.slot_resv) == 0 and b.reserved == 0
        assert eng._bufs.state["done"].all()
        audit_engine(eng)

    def test_bounded_queue_rejects(self):
        want = on_jax(bounded_queue)
        got = on_port(bounded_queue)
        assert got == want
        assert got["at_submit"] == ["queued", "queued", "rejected"]
        assert got["rejected_tokens"] == [] and got["status"][2] == \
            "rejected"
        assert got["stats"]["rejections"] == 1
        assert got["status"][0] == "done"

    def test_deadline_validation(self):
        eng = Side("torch").engine(num_pages=8)
        with pytest.raises(ValueError, match="deadline_ms"):
            eng.submit(PROMPT, deadline_ms=0)


class TestPreemption:
    @pytest.mark.parametrize("fmt", ["dense"])
    def test_high_priority_preempts_and_resumes_warm(self, fmt):
        """A high-priority arrival under pool exhaustion evicts the
        low-priority slot; the victim's prompt pages stay warm and its
        re-admission maps them (a prefix hit, a suffix-only prefill);
        both streams equal the JAX engine's and the uninterrupted
        ones."""
        want = on_jax(preempt_warm, fmt=fmt)
        got = on_port(preempt_warm, fmt=fmt)
        assert got == want
        st = got["stats"]
        assert got["before"][0] > 0
        assert st["preemptions"] == 1 and got["preempts"] == [1, 0]
        assert got["history"][0] == ["queued", "running", "preempted",
                                     "running", "done"]
        assert st["prefix_hits"] == got["before"][1] + 1
        assert st["shared_pages"] >= 2
        assert got["tokens"] == on_port(uninterrupted, fmt=fmt)

    def test_equal_priority_never_preempts(self):
        want = on_jax(equal_priority)
        got = on_port(equal_priority)
        assert got == want
        assert got["mid"] == ["running", "queued"]
        assert got["stats"]["preemptions"] == 0
        assert got["stats"]["admission_waits"] > 0


class TestNumericGuard:
    def test_nan_block_quarantines_only_affected_slot(self):
        """A poisoned block costs only the poisoned slot its chunk: the
        other stream is untouched, the victim retries once on the plain
        versions, no non-finite value reaches a caller."""
        want = on_jax(nan_quarantine)
        got = on_port(nan_quarantine)
        assert got == want
        assert got["mid"][:2] == (1, True)
        assert sorted(got["mid"][2]) == [0, 1]
        victim = got["mid"][2].index(1)
        assert "preempted" in got["history"][victim]
        assert got["tokens"] == on_port(uninterrupted_short)
        assert all(np.isfinite(t) for ts in got["tokens"] for t in ts)

    def test_second_fault_fails_request(self):
        want = on_jax(second_fault)
        got = on_port(second_fault)
        assert got == want
        assert got["status"] == ["failed"] and got["faults"] == [2]
        assert got["stats"]["numeric_faults"] == 2


def uninterrupted_short(side):
    """The two nan-test requests served clean (6 new tokens each)."""
    eng = side.engine(num_pages=10)
    return eng.generate([PROMPT, PROMPT_HI], max_new=6)


class TestKernelAndFetchFaults:
    def test_kernel_failure_degrades_and_retries(self):
        want, _ = on_jax(kernel_failure)
        got, eng = on_port(kernel_failure)
        assert got == want
        assert got["stats"]["kernel_failures"] >= 1
        assert got["stats"]["degraded"] and got["status"] == ["done"]
        # the first chunk raised before it ran and was retried plain;
        # every later one ran plain from the start
        assert set(chunk_hows(eng)) == {"plain"}

    def test_fetch_drop_is_retried_transparently(self):
        want = on_jax(fetch_drop)
        got = on_port(fetch_drop)
        assert got == want
        assert got["stats"]["fetch_errors"] >= 1
        assert not got["stats"]["degraded"]   # a retried fetch: no fault
        assert got["status"] == ["done"]
        # every chunk's first attempt dropped, its retry counted once
        assert got["stats"]["sync_count"] == got["stats"]["fetch_errors"]


class TestChaosHarness:
    def test_same_seed_same_faults_same_outcome(self):
        """Two runs at one seed arm the same schedule, never raise out of
        ``step()``, audit clean after every tick and land every request
        in the same terminal status with the same tokens — and so does
        the JAX engine."""
        a, b = on_port(chaos_run), on_port(chaos_run)
        assert a == b
        assert a == on_jax(chaos_run)
        assert len(a["schedule"]) > 0
        assert all(s in {x.value for x in TERMINAL_STATUSES}
                   for s in a["status"])

    @pytest.mark.parametrize("fmt", ["nm"])
    def test_same_seed_on_packed_weights(self, fmt):
        assert on_port(chaos_run, fmt=fmt) == on_jax(chaos_run, fmt=fmt)

    def test_different_seed_different_schedule(self):
        assert on_port(chaos_run, seed=3)["schedule"] != \
            on_port(chaos_run, seed=4)["schedule"]

    def test_zero_rate_is_bit_identical_to_no_chaos(self):
        """An attached monkey at rate 0 is a pure observer (the port
        alone: the serve it must equal is the port's own)."""
        got = on_port(zero_rate)
        assert got["schedule"] == [] and not got["stats"]["degraded"]
        eng = Side("torch").engine(num_pages=10)
        assert got["tokens"] == [eng.submit(PROMPT, max_new=8).result()]

    def test_audit_flags_corruption(self):
        eng = Side("torch").engine(num_pages=10)
        h = eng.submit(PROMPT, max_new=8)
        eng.step()
        audit_engine(eng)               # clean while running
        page = eng._backend.slot_pages[h.slot][0]
        eng._backend.free_pages.append(page)    # double-own one page
        with pytest.raises(AuditError, match="owned twice"):
            audit_engine(eng)
        eng._backend.free_pages.pop()
        h._req.history.append(RequestStatus.QUEUED)     # running→queued
        with pytest.raises(AuditError, match="illegal transition"):
            eng.audit()
        h._req.history.pop()
        drain(eng, [h])


class TestAdmissionFairness:
    def test_fifo_among_equal_priority(self):
        want = on_jax(fifo)
        got = on_port(fifo)
        assert got == want
        assert got["seized"] == 8
        assert got["blocked"][0] == ["queued"] * 3 and got["blocked"][1] > 0
        assert got["order"] == got["uids"]

    def test_priority_jumps_queue(self):
        want = on_jax(priority_jump)
        got = on_port(priority_jump)
        assert got == want
        assert got["blocked"] == ["queued"] * 3
        assert got["after"][2] != "queued" and got["after"][1] == "queued"
        assert got["hi_first"]


class TestDeadlineClock:
    """``deadline_ms`` counts from the original arrival: neither
    preemption nor resumption restarts the clock (the port alone: the
    cases read the wall clock)."""

    def _preempt(self, eng, lo, hi_kw):
        hi = eng.submit(PROMPT_HI, priority=5, **hi_kw)
        for _ in range(20):
            if lo._req.preempts:
                break
            eng.step()
        assert lo._req.preempts == 1
        return hi

    def test_preempted_deadline_counts_from_original_arrival(self):
        eng = Side("torch").engine(num_pages=6)
        lo = eng.submit(PROMPT, max_new=12, deadline_ms=60_000.0)
        steps(eng, 3)
        hi = self._preempt(eng, lo, dict(max_new=12))
        assert lo.status is RequestStatus.PREEMPTED
        lo._req.arrival_s -= 61.0       # age the one true clock
        for _ in range(5):
            eng.step()
            if lo.done:
                break
        assert lo.status is RequestStatus.TIMED_OUT
        drain(eng, [hi])
        audit_engine(eng)

    def test_resumed_deadline_counts_from_original_arrival(self):
        eng = Side("torch").engine(num_pages=6)
        lo = eng.submit(PROMPT, max_new=16, deadline_ms=60_000.0)
        steps(eng, 3)
        hi = self._preempt(eng, lo, dict(max_new=2))
        drain(eng, [hi])                # frees pages; lo re-admits
        for _ in range(10):
            if lo.status is RequestStatus.RUNNING:
                break
            eng.step()
        assert lo.status is RequestStatus.RUNNING
        assert lo._req.preempts == 1
        lo._req.arrival_s -= 61.0       # older than its 60 s deadline
        for _ in range(5):
            eng.step()
            if lo.done:
                break
        assert lo.status is RequestStatus.TIMED_OUT
        drain(eng, [lo])
        audit_engine(eng)


class TestDegradedRecovery:
    """After ``degraded_recover_chunks`` clean chunks the engine returns
    to its kernels; on the port the degraded chunks are recorded as
    ``"plain"`` and the later ones run as before."""

    @pytest.mark.parametrize("fmt", ["dense"])
    def test_recovers_after_clean_chunks(self, fmt):
        want, _ = on_jax(recover, fmt=fmt)
        got, eng = on_port(recover, fmt=fmt)
        assert got == want
        assert not got["degraded"] and not got["stats"]["degraded"]
        assert got["stats"]["degraded_recoveries"] == 1
        hows = chunk_hows(eng)
        n_plain = hows.index("eager", hows.index("plain"))
        assert set(hows[hows.index("plain"):n_plain]) == {"plain"}
        assert hows[n_plain:] == ["eager"] * (len(hows) - n_plain)
        eng2 = Side("torch", fmt=fmt).engine(num_pages=10)
        assert got["tokens"] == [eng2.submit(PROMPT, max_new=14).result()]

    def test_zero_threshold_stays_one_way(self):
        """``degraded_recover_chunks=0`` keeps degraded mode one-way (the
        port alone; ``test_recovers_after_clean_chunks`` holds the round
        trip to the JAX engine's)."""
        got = on_port(one_way)
        assert got["degraded"] and got["status"] == ["done"]
        assert got["stats"]["degraded_recoveries"] == 0
        assert got["stats"]["kernel_failures"] >= 1

    def test_fault_during_probation_resets_streak(self):
        want = on_jax(probation)
        got = on_port(probation)
        assert got == want
        assert got["streak"] == 0 and got["still"]
        assert not got["degraded"]
        assert got["stats"]["degraded_recoveries"] == 1


class TestChaosFamilies:
    """The chaos suite beyond the decoder-only LM: hybrid (SSM + shared
    attention) and enc-dec engines under injected faults, audited every
    step; a hybrid request preempted mid-decode resumes from a rebuilt
    recurrent state."""

    @pytest.mark.parametrize("model", ["hy", "ed"])
    def test_chaos_audits_clean(self, model):
        want = on_jax(family_chaos, model=model)
        got = on_port(family_chaos, model=model)
        assert got == want
        assert got["status"] == ["done", "done"]
        # drop and kernel faults are transparent: the streams are the
        # clean serve's
        eng = Side("torch", model).engine(FAMILY)
        assert got["tokens"] == eng.generate([PROMPT, PROMPT_HI])

    def test_hybrid_ssm_state_preempt_resume_parity(self):
        want = on_jax(hybrid_preempt, model="hy")
        got = on_port(hybrid_preempt, model="hy")
        assert got == want
        assert got["early"] > 0 and got["preempts"] == [1, 0]
        eng = Side("torch", "hy").engine(dict(HY_PAGED, num_pages=10))
        assert got["tokens"] == eng.generate([PROMPT, PROMPT_HI],
                                             max_new=12)


# --- the port's own: degraded mode is one engine's scope ---------------------

class TestDegradedScope:
    def test_degraded_scope_is_the_engines_own(self):
        """One engine degrades; another in the same process keeps its
        normal chunks and both serve the clean streams."""
        side = Side("torch")
        sick, well = side.engine(num_pages=10), side.engine(num_pages=10)
        a, b = sick.submit(PROMPT, max_new=6), well.submit(PROMPT, max_new=6)
        mk = side.monkey(sick, seed=0, rate=0.0, kernel_rate=1.0).attach()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            while not (a.done and b.done):
                sick.step()
                well.step()
        mk.detach()
        assert sick.degraded and not well.degraded
        assert set(chunk_hows(sick)) == {"plain"}
        assert set(chunk_hows(well)) == {"eager"}
        assert a.tokens == b.tokens

    def test_plain_versions_count_in_place_of_the_kernel(self, monkeypatch):
        """Inside ``plain_versions`` a call the card would give to a
        kernel runs the plain version and counts in ``plain_launches``;
        outside it, and with ``on=False``, it goes to the kernel's
        wrapper (here on a CPU tensor standing in for the card's)."""
        jcfg, jp, tcfg, tp = weights("lm", "nm")
        pack = tp["layers"][0]["mlp"]["w_in"]
        x = torch.randn(3, pack.K, generator=torch.Generator().manual_seed(0))
        monkeypatch.setattr(tdispatch, "resolve_mode", lambda d: "kernel")
        calls = []
        entry = dataclasses.replace(
            tdispatch._REGISTRY["nm_spmm"],
            run=lambda x, w, mode: calls.append(mode) or
            tdispatch._nm_run(x, w, "ref"))
        monkeypatch.setitem(tdispatch._REGISTRY, "nm_spmm", entry)
        monkeypatch.setattr(tnm, "plain_launches", 0)
        want = tdispatch.sparse_matmul(x, pack)
        with tdispatch.plain_versions(False):
            tdispatch.sparse_matmul(x, pack)
        with tdispatch.plain_versions():
            got = tdispatch.sparse_matmul(x, pack)
        assert calls == ["kernel", "kernel", "ref"]
        assert tnm.plain_launches == 1
        torch.testing.assert_close(got, want)

    @pytest.mark.parametrize("seam", ["_invoke_loop", "_device_fetch"])
    def test_real_errors_are_not_contained(self, seam, monkeypatch):
        """Only an injected fault is contained: any other raise at the
        dispatch seam or the fetch propagates out of ``step()``, with no
        retry, no counted fault and no degraded mode (a kernel's error
        never turns into the plain versions)."""
        eng = Side("torch").engine(num_pages=10)
        eng.submit(PROMPT, max_new=6)

        def fail(*args):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(eng, seam, fail)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            with pytest.raises(RuntimeError, match="illegal memory access"):
                eng.step()
        st = eng.stats()
        assert not eng.degraded
        assert (st.kernel_failures, st.fetch_errors, st.numeric_faults) == \
            (0, 0, 0)

    def test_env_seed_attaches_a_monkey(self, monkeypatch):
        monkeypatch.setenv("REPRO_CHAOS_SEED", "7")
        monkeypatch.setenv("REPRO_CHAOS_RATE", "0.5")
        eng = Side("torch").engine(num_pages=10)
        assert isinstance(eng._chaos, ChaosMonkey)
        assert (eng._chaos.cfg.seed, eng._chaos.cfg.rate) == (7, 0.5)
        eng._chaos.detach()
        assert eng._chaos is None
        assert "REPRO_CHAOS_SEED" in os.environ
