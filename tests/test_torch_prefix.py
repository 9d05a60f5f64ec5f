"""Prefix sharing in the port against the JAX package: the radix index
case by case, the Engine on the scripts of ``tests/test_prefix.py``
(shared-prefix parity, copy-on-write, the page lifecycle, pinned
prefixes, the sync contract), ``decode_block`` at a nonzero offset at
the logits, ``copy_page``, and the validation errors.

Both engines serve the same 2:4-packed TINY weights (float32, CPU; the
JAX engine on a 1x1 mesh with Auto axes).  Each ``ServeConfig`` gets one
engine a side, and the scripts run on it back to back: every comparison
is between the two sides after the same calls, so pages left resident
by an earlier script are the same on both.  Each script brings prompts
of its own (distinct leading tokens), so its hits come from its own
requests.  Prompts fill their 16-row window: sharing keys on the
left-padded rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.serving import Engine as JEngine
from repro.serving import EngineStats as JEngineStats
from repro.serving import ServeConfig as JServeConfig
from repro.serving.prefix import PrefixIndex as JPrefixIndex
from repro_torch import models as TM
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import EngineStats as TEngineStats
from repro_torch.serving import ServeConfig as TServeConfig
from repro_torch.serving.prefix import PrefixIndex as TPrefixIndex
from test_torch_model import ATOL, build_params, identity_table, jax_mesh

PS = 8
SHARED = dict(slots=3, max_len=64, prompt_pad=16, max_new_tokens=5,
              decode_chunk=4, eos_token=-1, page_size=PS, prefix_cache=True)
CONFIGS = {
    "shared": SHARED,
    "unshared": dict(SHARED, prefix_cache=False),
    "mono": dict(SHARED, page_size=0, prefix_cache=False),
    # a pool with no slack: one request needs every page
    "pressure": dict(SHARED, slots=1, num_pages=3),
    "pad24": dict(SHARED, prompt_pad=24),
    "pad24_off": dict(SHARED, prompt_pad=24, prefix_cache=False),
}
STATS = ("sync_count", "prefix_hits", "shared_pages", "cow_copies",
         "peak_pages", "admission_waits", "prefills")


@pytest.fixture(scope="module")
def params():
    return build_params("nm")


@pytest.fixture(scope="module")
def engines(params):
    """``engines(name)`` → (JAX engine, port engine) for ``CONFIGS[name]``,
    built once per module."""
    jcfg, jp, tcfg, tp = params
    made = {}

    def get(name):
        if name not in made:
            kw = CONFIGS[name]
            made[name] = (JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp),
                          TEngine(tcfg, TServeConfig(**kw), tp,
                                  device="cpu"))
        return made[name]

    return get


def counters(eng):
    s = eng.stats()
    return {k: getattr(s, k) for k in STATS}


def serve_both(engines, name, script):
    """Run ``script(engine)`` on both sides of ``name``; the results and
    the counters must agree.  Returns (port result, port engine, the
    port's counters before and after)."""
    results = []
    for eng in engines(name):
        before = counters(eng)
        results.append((script(eng), before, counters(eng)))
    (jout, _, jafter), (tout, tbefore, tafter) = results
    assert tout == jout
    assert tafter == jafter
    return tout, engines(name)[1], tbefore, tafter


def delta(before, after, key):
    return after[key] - before[key]


def block(*vals):
    return np.asarray(vals, np.int32)


def two_prompts(lead):
    """Two 16-token prompts sharing a 12-token head led by ``lead``: they
    diverge inside the second page."""
    head = np.arange(lead, lead + 12, dtype=np.int32)
    return [np.concatenate([head, block(101, 102, 103, 104)]),
            np.concatenate([head, block(201, 202, 203, 204)])]


# --- (a) the index, case by case --------------------------------------------

def _blocks(*vals):
    return [np.full(PS, v, np.int32) for v in vals]


def index_match_walks_full_blocks(Index):
    idx = Index(PS)
    a, b = _blocks(1, 2)
    n1, _ = idx.insert(None, a, 10)
    n2, _ = idx.insert(n1, b, 11)
    idx.acquire(n1), idx.acquire(n2)
    tokens = np.concatenate([a, b, _blocks(3)[0]])
    nodes, partial = idx.match(tokens, len(tokens))
    return [n.page for n in nodes], partial


def index_partial_match(Index):
    idx = Index(PS)
    blk = np.arange(PS, dtype=np.int32)
    node, _ = idx.insert(None, blk, 7)
    idx.acquire(node)
    query = blk.copy()
    query[5:] += 100                    # diverges at row 5
    nodes, partial = idx.match(query, PS)
    first = (nodes, partial[0] is node, partial[1])
    nodes, partial = idx.match(query + 1, PS)   # diverges at row 0
    return first, (nodes, partial)


def index_insert_duplicate(Index):
    idx = Index(PS)
    blk = _blocks(4)[0]
    n1, created1 = idx.insert(None, blk, 3)
    n2, created2 = idx.insert(None, blk, 9)
    return created1, created2, n2 is n1, n1.page


def index_release_then_capacity_evicts(Index):
    idx = Index(PS, capacity=1)
    a, b = _blocks(1, 2)
    n1, _ = idx.insert(None, a, 10)
    n2, _ = idx.insert(None, b, 11)
    idx.acquire(n1), idx.acquire(n2)
    first = idx.release(n1)
    counts = (idx.retained_pages, idx.live_pages)
    freed = idx.release(n2)
    nodes, _ = idx.match(a, PS)
    return first, counts, freed, (idx.retained_pages, idx.live_pages), nodes


def index_evict_one_skips_inner_nodes(Index):
    idx = Index(PS)
    a, b = _blocks(1, 2)
    n1, _ = idx.insert(None, a, 10)
    n2, _ = idx.insert(n1, b, 11)
    idx.acquire(n1), idx.acquire(n2)
    idx.release(n2), idx.release(n1)
    return idx.evict_one(), idx.evict_one(), idx.evict_one()


#: each case with what ``tests/test_prefix.py::TestPrefixIndex`` expects
INDEX_CASES = {
    "match_walks_full_blocks": (index_match_walks_full_blocks,
                                ([10, 11], None)),
    "partial_match": (index_partial_match, (([], True, 5), ([], None))),
    "insert_duplicate": (index_insert_duplicate, (True, False, True, 3)),
    "release_then_capacity_evicts": (index_release_then_capacity_evicts,
                                     ([], (1, 1), [10], (1, 0), [])),
    "evict_one_skips_inner_nodes": (index_evict_one_skips_inner_nodes,
                                    (11, 10, None)),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_prefix_index_equals_jax(case):
    script, expect = INDEX_CASES[case]
    assert script(TPrefixIndex) == script(JPrefixIndex) == expect


# --- (b) the Engine on test_prefix.py's scripts -------------------------------

def test_shared_parity_and_fewer_pages(engines):
    """Two prompts with a 12-token head: the same tokens shared, private
    and monolithic, on both sides, and fewer pages at peak when shared."""
    prompts = two_prompts(1)
    out, teng, before, after = serve_both(
        engines, "shared", lambda e: e.generate(prompts))
    unshared, _, _, off = serve_both(engines, "unshared",
                                     lambda e: e.generate(prompts))
    mono, _, _, _ = serve_both(engines, "mono", lambda e: e.generate(prompts))
    assert out == unshared == mono
    assert delta(before, after, "prefix_hits") == 1
    assert delta(before, after, "shared_pages") == 1
    assert after["peak_pages"] < off["peak_pages"]


def test_cow_on_divergence_mid_page(engines):
    """The second prompt diverges at row 12, inside page 1: that page is
    copied and the suffix computed from row 12."""
    prompts = two_prompts(20)
    out, teng, before, after = serve_both(engines, "shared",
                                          lambda e: e.generate(prompts))
    assert delta(before, after, "cow_copies") == 1
    off, _, _, _ = serve_both(engines, "unshared",
                              lambda e: e.generate(prompts))
    assert out == off


def test_identical_prompts_full_match(engines):
    """A byte-identical resident prompt matches in full; its tail page is
    copied so the last row still computes the first token."""
    p = np.arange(40, 56, dtype=np.int32)
    out, _, before, after = serve_both(engines, "shared",
                                       lambda e: e.generate([p, p]))
    assert out[0] == out[1]
    assert delta(before, after, "prefix_hits") == 1
    assert delta(before, after, "cow_copies") == 1
    assert delta(before, after, "shared_pages") == 1


def test_cancel_midflight_decrefs_without_freeing_shared(engines):
    """Cancelling one of two slots that share a page drops only its
    refcount: the survivor decodes on, and the pool closes at drain."""
    pa, pb = two_prompts(60)

    def script(eng):
        ha = eng.submit(pa, max_new=12)
        hb = eng.submit(pb, max_new=12)
        eng.step()                          # both admitted, first chunk
        b = eng._backend
        survivor = list(b.slot_shared[0])
        assert survivor and survivor[0] in b.slot_shared[1]
        hb.cancel()
        eng.step()                          # retire the cancelled slot
        assert not ha.done
        assert all(nd.refs >= 1 and nd.page not in b.free_pages
                   for nd in survivor)
        ha.result()
        eng.run()
        assert len(b.free_pages) + b.index.total_pages == \
            eng.scfg.pool_pages
        assert b.reserved == 0
        return ha.tokens, hb.tokens, hb.status.value

    (a, b, status), _, _, _ = serve_both(engines, "shared", script)
    assert len(a) == 12 and len(b) < 12 and status == "cancelled"


def test_pages_return_to_pool_only_at_refcount_zero(engines):
    """A shared page stays out of the free list while any slot maps it;
    after the last unmap it is retained, not freed."""
    pa, pb = two_prompts(80)

    def script(eng):
        ha = eng.submit(pa, max_new=2)      # finishes a chunk early
        hb = eng.submit(pb, max_new=12)
        eng.step()
        b = eng._backend
        shared = list(b.slot_shared[0])
        while not ha.done:
            eng.step()
        eng.step()                          # slot 0 retired, slot 1 live
        assert not hb.done
        assert all(nd.page not in b.free_pages for nd in shared if nd.refs)
        eng.run()
        assert b.index.live_pages == 0
        assert all(nd.refs == 0 for nd in shared)
        assert len(b.free_pages) + b.index.total_pages == \
            eng.scfg.pool_pages
        return ha.tokens, hb.tokens

    serve_both(engines, "shared", script)


def test_pool_pressure_evicts_retained_pages(engines):
    """Serving a request that needs the whole pool reclaims the retained
    page of a released pin."""
    p = np.arange(1, 17, dtype=np.int32)

    def script(eng):
        h = eng.register_prefix(np.arange(50, 58, dtype=np.int32))
        idx = eng._backend.index
        counts = [(idx.live_pages, idx.retained_pages)]
        h.release()
        counts.append((idx.live_pages, idx.retained_pages))
        out = eng.generate([p])
        return out, counts, idx.total_pages

    (_, counts, total), _, _, _ = serve_both(engines, "pressure", script)
    assert counts == [(1, 0), (0, 1)]
    assert total < CONFIGS["pressure"]["num_pages"]


def test_register_prefix_roundtrip(engines):
    """``register_prefix`` + ``submit(prefix=)`` hit the pinned pages and
    give the tokens of the unshared concatenation; a released handle is
    refused."""
    head = np.arange(1, 17, dtype=np.int32)         # 2 pinned pages
    tails = [np.arange(101, 109, dtype=np.int32),
             np.arange(201, 209, dtype=np.int32)]

    def script(eng):
        h = eng.register_prefix(head)
        pinned = (h.n_pages, h.released)
        handles = [eng.submit(t, prefix=h) for t in tails]
        eng.run()
        h.release()
        h.release()                         # idempotent
        with pytest.raises(ValueError):
            eng.submit(tails[0], prefix=h)
        return pinned, h.released, [r.tokens for r in handles]

    (pinned, released, out), _, before, after = serve_both(
        engines, "pad24", script)
    assert pinned == (2, False) and released
    assert delta(before, after, "prefix_hits") == 2
    assert delta(before, after, "shared_pages") == 4
    off, _, _, _ = serve_both(
        engines, "pad24_off",
        lambda e: e.generate([np.concatenate([head, t]) for t in tails]))
    assert out == off


def test_one_sync_per_chunk_under_sharing(engines):
    """Sharing adds no device→host transfer: 8 tokens in chunks of 4 are
    two fetches, the full-match copy included."""
    p = np.arange(120, 136, dtype=np.int32)

    def script(eng):
        hs = [eng.submit(p, max_new=8), eng.submit(p, max_new=8)]
        eng.run()
        return [h.tokens for h in hs]

    out, _, before, after = serve_both(engines, "shared", script)
    assert [len(o) for o in out] == [8, 8]
    assert delta(before, after, "sync_count") == 2
    assert delta(before, after, "prefix_hits") == 1


def test_stats_typed_and_nothing_resident(engines):
    """A prompt whose pages match nothing resident counts no hit; the
    snapshot is the typed record on both sides."""
    p = np.arange(140, 156, dtype=np.int32)
    _, teng, before, after = serve_both(engines, "shared",
                                        lambda e: e.generate([p]))
    jeng = engines("shared")[0]
    assert isinstance(teng.stats(), TEngineStats)
    assert isinstance(jeng.stats(), JEngineStats)
    assert delta(before, after, "prefills") == 1
    assert delta(before, after, "prefix_hits") == 0
    assert delta(before, after, "shared_pages") == 0


def test_prefix_cache_off_is_the_plain_allocator(engines):
    """``prefix_cache=False``: no index, the same tokens and counters as
    the JAX engine's plain allocator, every page back at drain."""
    p = np.arange(1, 17, dtype=np.int32)
    _, teng, _, after = serve_both(engines, "unshared",
                                   lambda e: e.generate([p]))
    assert teng._backend.index is None
    assert len(teng._backend.free_pages) == teng.scfg.pool_pages
    assert after["prefix_hits"] == after["cow_copies"] == 0


def test_mixed_hit_and_miss_slots(engines):
    """A sharing slot and a slot that shares nothing decode in the same
    chunks, each as it would alone."""
    share_a, share_b = two_prompts(160)
    lone = np.asarray([190, 191, 192], np.int32)
    out, _, before, after = serve_both(
        engines, "shared", lambda e: e.generate([share_a, share_b, lone]))
    alone, _, _, _ = serve_both(
        engines, "unshared", lambda e: e.generate([share_a, share_b, lone]))
    assert out == alone
    assert delta(before, after, "prefix_hits") == 1


# --- (c) decode_block at a nonzero offset, at the logits ---------------------

@pytest.mark.parametrize("start", [8, 13])
def test_decode_block_logits_match_jax(params, start):
    """A prompt of ``start`` rows prefilled into paged caches, then a
    5-token block at ``start``: logits for every block position within
    ``ATOL`` of ``MZ.decode_block`` (float32 caches on both sides)."""
    jcfg, jp, tcfg, tp = params
    B, T, max_len = 2, 5, 48
    rng = np.random.default_rng(start)
    toks = rng.integers(1, jcfg.vocab_size, (B, start + T)).astype(np.int32)
    table = identity_table(B, max_len // PS)
    jcache = JM.set_page_table(
        JM.init_cache(jcfg, B, max_len, page_size=PS, dtype=jnp.float32),
        jnp.asarray(table))
    tcache = TM.set_page_table(
        TM.init_cache(tcfg, B, max_len, page_size=PS, dtype=torch.float32,
                      device="cpu"), table)
    _, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :start])},
                           jcache)
    TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :start])},
               tcache)
    jl, _, _ = JM.decode_block(jp, jcfg, jnp.asarray(toks[:, start:]), jcache,
                               jnp.full((B,), start, jnp.int32))
    tl, _ = TM.decode_block(tp, tcfg, torch.from_numpy(toks[:, start:]),
                            tcache, start)
    assert tl.shape == (B, T, tcfg.vocab_padded)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_offset_prefill_needs_the_paged_cache(params):
    _, _, tcfg, tp = params
    cache = TM.init_cache(tcfg, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        TM.decode_block(tp, tcfg, torch.ones((1, 3), dtype=torch.int32),
                        cache, 8)


# --- (d) copy_page ----------------------------------------------------------

def test_copy_page_equals_jax(params):
    jcfg, _, tcfg, _ = params
    jcache = JM.init_cache(jcfg, 2, 32, page_size=PS)
    tcache = TM.init_cache(tcfg, 2, 32, page_size=PS, device="cpu")
    rng = np.random.default_rng(0)
    for key in ("kp", "vp"):
        pool = rng.normal(size=jcache[key].shape).astype(np.float32)
        jcache[key] = jnp.asarray(pool, jcache[key].dtype)
        tcache[key].copy_(torch.from_numpy(pool).to(tcache[key].dtype))
    jcache = JM.copy_page(jcache, jnp.int32(3), jnp.int32(5))
    tcache = TM.copy_page(tcache, 3, 5)
    for key in ("kp", "vp"):
        np.testing.assert_array_equal(
            tcache[key].float().numpy(),
            np.asarray(jcache[key].astype(jnp.float32)))
        assert torch.equal(tcache[key][:, 5], tcache[key][:, 3])


# --- (e) validation ---------------------------------------------------------

def test_register_prefix_and_submit_validation(engines, params, tmp_path):
    """Both sides refuse the same misuses with ``ValueError``."""
    _, _, tcfg, tp = params
    jshared, tshared = engines("shared")
    jpad, tpad = engines("pad24")
    joff, toff = engines("unshared")
    for shared, other, off in ((jshared, jpad, joff),
                               (tshared, tpad, toff)):
        with pytest.raises(ValueError, match="whole number of pages"):
            shared.register_prefix(np.arange(1, 6, dtype=np.int32))
        with pytest.raises(ValueError, match="prefix_cache"):
            off.register_prefix(np.arange(1, 9, dtype=np.int32))
        h = other.register_prefix(np.arange(210, 218, dtype=np.int32))
        with pytest.raises(ValueError, match="different engine"):
            shared.submit([1, 2], prefix=h)
        h.release()
        with pytest.raises(ValueError, match="released"):
            other.submit([1, 2], prefix=h)
    bad = dict(SHARED, page_size=0)
    for S in (JServeConfig, TServeConfig):
        with pytest.raises(ValueError, match="paged"):
            S(**bad).validate()
    with pytest.raises(ValueError, match="lm"):
        TEngine(dataclasses.replace(tcfg, is_encoder_decoder=True),
                TServeConfig(**SHARED), tp, device="cpu")
    # the bounded queue and the journal are served: a pin is journaled
    TEngine(tcfg, TServeConfig(**SHARED, max_queue=2), tp, device="cpu")
    jp = str(tmp_path / "j.jsonl")
    eng = TEngine(tcfg, TServeConfig(**SHARED, journal_path=jp), tp,
                  device="cpu")
    h = eng.register_prefix(np.arange(210, 218, dtype=np.int32))
    assert h._pid == 0
    assert eng.journal.state.pins == {0: list(range(210, 218))}
    h.release()
    assert eng.journal.state.pins == {}
