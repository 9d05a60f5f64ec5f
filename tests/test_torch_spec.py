"""Speculative decoding of the port against the JAX ``Engine``: the lm
twins of ``tests/test_spec.py`` on the CPU at float32 (TINY of
``test_torch_model``, bf16 KV caches, the engines' default; the JAX engine
on a 1x1 mesh with Auto axes).

In every greedy case the port's tokens, ``sync_count``, drafted and
accepted equal the JAX engine's, for monolithic and paged caches and for
the self draft and a ``pack`` draft in each of the four formats, and
over shared prefix pages (hits, shared pages and copies equal too); and
the tokens equal the plain loop's (greedy speculation is lossless).  Beside
them: ``decode_block`` at ragged per-slot offsets against the JAX logits,
the served chunk body against the functional ``build_spec_decode_loop``,
and the residual acceptance rule held statistically (JAX's threefry
draws cannot be matched)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core.sparse_linear import make_draft_params as jax_draft_params
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import make_draft_params
from repro_torch.core.sparsity import PACK_TYPES
from repro_torch.serving import (ChunkBuffers, DecodeChunk, ServeConfig,
                                 build_prefill_slot_step,
                                 build_spec_decode_chunk,
                                 build_spec_decode_loop)
from repro_torch.serving import Engine as TEngine
from repro_torch.serving.loops import accept_drafts
from test_torch_model import (ATOL, FORMATS, configs, flatten,
                              identity_table, jax_mesh)

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.asarray([7, 9, 11], np.int32)]
BUDGETS = [5, 9, 3]
BASE = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=16,
            decode_chunk=4, eos_token=-1)


def dense_params(fmt, seed=0):
    """(JAX config, JAX params, port config, port params): dense weights
    from the JAX init under ``fmt``'s config, so a ``pack`` draft packs
    them and the verify stays dense."""
    jcfg, tcfg = configs(fmt)
    jp = JM.init_model(jax.random.key(seed), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


@pytest.fixture(scope="module")
def dense():
    return dense_params("dense")


def serve(eng, prompts, budgets):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


def serve_both(params, kw, prompts=PROMPTS, budgets=BUDGETS, draft=None):
    """Serve on both engines; ``draft`` is a seed of garbage draft params
    (another JAX init) or None.  Returns (JAX tokens, port tokens, JAX
    engine, port engine)."""
    jcfg, jp, tcfg, tp = params
    jd = td = None
    if draft is not None:
        _, jd, _, td = dense_params("dense", seed=draft)
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp, draft_params=jd)
    teng = TEngine(tcfg, ServeConfig(**kw), tp, draft_params=td,
                   device="cpu")
    return (serve(jeng, prompts, budgets), serve(teng, prompts, budgets),
            jeng, teng)


def plain(params, kw, prompts=PROMPTS, budgets=BUDGETS):
    """The port's non-speculative serve of the same stream."""
    _, _, tcfg, tp = params
    kw = {k: v for k, v in kw.items() if k not in ("spec_k", "spec_draft")}
    return serve(TEngine(tcfg, ServeConfig(**kw), tp, device="cpu"),
                 prompts, budgets)


def assert_same(jout, tout, jeng, teng):
    """Tokens, syncs, drafted and accepted equal; pages too when paged."""
    assert tout == jout
    js, ts = jeng.stats(), teng.stats()
    assert ts.sync_count == js.sync_count == teng.sync_count
    assert (ts.drafted, ts.accepted) == (js.drafted, js.accepted)
    assert ts.peak_pages == js.peak_pages
    assert ts.drafted > 0


LAYOUTS = {"mono": {}, "paged": dict(page_size=8)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_self_draft_equals_jax_and_the_plain_loop(dense, layout):
    kw = dict(BASE, spec_k=3, **LAYOUTS[layout])
    jout, tout, jeng, teng = serve_both(dense, kw)
    assert_same(jout, tout, jeng, teng)
    assert tout == plain(dense, kw)
    assert teng.acceptance_rate() > 0.9          # self-draft ~ always


#: speculation over shared pages: a 16-token head (two 8-row pages) led
#: by 4 prompts of 24 tokens on 2 slots — two tails, a full repeat of the
#: first prompt (copy-on-write of its last page) and a third tail
SPEC_HEAD = np.arange(1, 17, dtype=np.int32)
SPEC_PREFIX_PROMPTS = [np.concatenate([SPEC_HEAD, t]) for t in (
    np.arange(101, 109, dtype=np.int32), np.arange(201, 209, dtype=np.int32),
    np.arange(101, 109, dtype=np.int32), np.arange(301, 309, dtype=np.int32))]


@pytest.mark.parametrize("draft", [None, 7], ids=["self", "garbage"])
def test_speculation_with_prefix_sharing_equals_jax(dense, draft):
    """``spec_k=3`` on the paged cache with ``prefix_cache=True``: tokens,
    syncs, drafted, accepted, peak pages, hits, shared pages and copies
    equal the JAX engine's, and the tokens the plain loop's."""
    kw = dict(BASE, spec_k=3, page_size=8, prompt_pad=24, prefix_cache=True)
    budgets = [6, 5, 6, 4]
    jout, tout, jeng, teng = serve_both(dense, kw, SPEC_PREFIX_PROMPTS,
                                        budgets, draft=draft)
    assert_same(jout, tout, jeng, teng)
    js, ts = jeng.stats(), teng.stats()
    shared = ("prefix_hits", "shared_pages", "cow_copies")
    assert [getattr(ts, k) for k in shared] == \
        [getattr(js, k) for k in shared]
    assert ts.prefix_hits > 0 and ts.shared_pages > 0 and ts.cow_copies > 0
    assert tout == plain(dense, kw, SPEC_PREFIX_PROMPTS, budgets)
    if draft is None:
        assert teng.acceptance_rate() > 0.9


def test_paged_view_bucketed(dense):
    """The decode view in 1-page buckets: the chunk's view must cover the
    verify block's uncommitted tail too."""
    kw = dict(BASE, spec_k=3, page_size=8, page_view_chunk=1)
    jout, tout, jeng, teng = serve_both(dense, kw)
    assert_same(jout, tout, jeng, teng)
    assert tout == plain(dense, dict(BASE))


@pytest.mark.parametrize("fmt", [f for f in FORMATS if f != "dense"])
def test_pack_draft_equals_jax(fmt):
    """The sparse-draft / dense-verify split: the draft is the config's
    packs of the dense weights (``spec_draft="pack"``), the verify the
    dense weights; the output is the dense greedy stream, and the
    acceptance the pack earns equals the JAX engine's."""
    params = dense_params(fmt)
    kw = dict(BASE, spec_k=4, spec_draft="pack", page_size=8)
    jout, tout, jeng, teng = serve_both(params, kw, PROMPTS[:2], BUDGETS[:2])
    assert_same(jout, tout, jeng, teng)
    assert tout == plain(params, kw, PROMPTS[:2], BUDGETS[:2])
    kernel = {"nm": "nm_spmm", "combined": "csa_matmul",
              "block": "bsr_matmul", "lookahead": "lookahead_decode"}[fmt]
    assert {r["kernel"] for r in teng.draft_plan} == {kernel}
    assert teng.verify_plan == []                # the verify is dense
    assert 0.0 <= teng.acceptance_rate() < 1.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eos_inside_a_drafted_block(dense, layout):
    """EOS landing inside a drafted block truncates exactly there: later
    accepted drafts of the same block do not leak out."""
    prompt = np.random.default_rng(2).integers(1, 512, 8).astype(np.int32)
    free = plain(dense, dict(slots=1, max_len=64, prompt_pad=8,
                             max_new_tokens=12, decode_chunk=8,
                             eos_token=-1), [prompt], [12])[0]
    # a token new to the stream at index 2..4: a draft of the first block
    eos = next(t for i, t in enumerate(free[:5]) if i >= 2
               and t not in free[:i])
    kw = dict(slots=1, max_len=64, prompt_pad=8, max_new_tokens=12,
              decode_chunk=4, spec_k=4, eos_token=eos, **LAYOUTS[layout])
    jout, tout, jeng, teng = serve_both(dense, kw, [prompt], [12])
    assert_same(jout, tout, jeng, teng)
    assert tout[0] == free[:free.index(eos) + 1]
    if layout == "paged":
        assert len(teng._backend.free_pages) == teng.scfg.pool_pages
        assert (teng._backend.ptab == 0).all()


def test_rollback_keeps_the_pool_consistent(dense):
    """A garbage draft (acceptance ~0) over a 2-page pool: the pages a
    chunk covered past its commits come back at every chunk boundary and
    are reused by the next refill; peak and free pages equal the JAX
    engine's and the output equals the plain loop's."""
    prompts = [np.arange(1 + i, 7 + i, dtype=np.int32) for i in range(4)]
    base = dict(slots=1, max_len=32, prompt_pad=8, max_new_tokens=4,
                decode_chunk=2, eos_token=-1, page_size=8, spec_k=3)
    jout, tout, jeng, teng = serve_both(dense, dict(base, num_pages=2),
                                        prompts, [4] * 4, draft=7)
    assert_same(jout, tout, jeng, teng)
    assert teng.stats().peak_pages == 2
    assert len(teng._backend.free_pages) == \
        len(jeng._backend.free_pages) == 2
    assert (teng._backend.ptab == 0).all()
    assert teng.acceptance_rate() < 0.5
    _, tp_garbage = dense_params("dense", seed=7)[2:]
    roomy = serve(TEngine(dense[2], ServeConfig(**base), dense[3],
                          draft_params=tp_garbage, device="cpu"),
                  prompts, [4] * 4)
    assert tout == roomy == plain(dense, base, prompts, [4] * 4)


def test_spec_needs_block_headroom(dense):
    scfg = dict(slots=1, max_len=16, prompt_pad=12, spec_k=8)
    with pytest.raises(ValueError):
        JEngine(dense[0], jax_mesh(), JServeConfig(**scfg), dense[1])
    with pytest.raises(ValueError):
        TEngine(dense[2], ServeConfig(**scfg), dense[3], device="cpu")


def test_one_sync_per_chunk(dense):
    """Drafting, verifying and the drafted/accepted counts ride on the
    chunk's one transfer: 12 tokens at 3 per step and 2 steps per chunk
    are 2 chunks, 2 syncs."""
    kw = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=12,
              decode_chunk=2, spec_k=2, eos_token=-1, page_size=8,
              page_view_chunk=1)
    prompts = [np.arange(1, 6, dtype=np.int32)] * 2
    jout, tout, jeng, teng = serve_both(dense, kw, prompts, [12, 12])
    assert_same(jout, tout, jeng, teng)
    assert [len(t) for t in tout] == [12, 12]
    assert teng.sync_count == 2


def test_chunk_tokens_bound(dense):
    """A chunk emits at most decode_chunk * (spec_k + 1) tokens a slot."""
    kw = dict(slots=1, max_len=64, prompt_pad=8, max_new_tokens=16,
              decode_chunk=2, spec_k=3, eos_token=-1)
    assert ServeConfig(**kw).chunk_tokens == 8
    jout, tout, jeng, teng = serve_both(dense, kw, PROMPTS[:1], [16])
    assert_same(jout, tout, jeng, teng)
    assert teng.sync_count == 2
    assert max(teng.stats().chunk_tokens) == 8


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_same_seed_same_tokens(dense, layout):
    """Greedy: the same tokens with and without speculation; sampled
    (temperature 0.7): two engines of one seed repeat each other's
    tokens, within the vocabulary and the budgets."""
    kw = dict(BASE, seed=3, **LAYOUTS[layout])
    tcfg, tp = dense[2:]
    spec = serve(TEngine(tcfg, ServeConfig(**kw, spec_k=3), tp,
                         device="cpu"), PROMPTS, BUDGETS)
    assert spec == plain(dense, kw)
    hot = dict(kw, max_new_tokens=8, temperature=0.7, seed=5, spec_k=3)
    runs = [serve(TEngine(tcfg, ServeConfig(**hot), tp, device="cpu"),
                  PROMPTS[:2], [8, 8]) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(o) == 8 for o in runs[0])
    assert all(0 <= t < tcfg.vocab_size for o in runs[0] for t in o)


def test_self_draft_residual_acceptance_is_one(dense):
    """At temperature > 0 the residual rule accepts a self draft with
    probability min(1, p / p) = 1."""
    tcfg, tp = dense[2:]
    eng = TEngine(tcfg, ServeConfig(**dict(BASE, max_new_tokens=6),
                                    temperature=0.9, seed=11, spec_k=2),
                  tp, device="cpu")
    assert [len(t) for t in serve(eng, PROMPTS[:1], [6])] == [6]
    assert eng.stats().drafted > 0
    assert eng.acceptance_rate() == 1.0
    with pytest.raises(ValueError):          # one temperature under spec
        eng.submit(PROMPTS[0], temperature=0.5)


def test_residual_rule_commits_the_verify_distribution():
    """The first committed token of a verify block (the draft when
    accepted, else the residual draw) is distributed as p_verify, for a
    draft distribution that differs from it: 40,000 draws of one K = 1
    block, a chi-square test over 8 tokens (7 degrees of freedom; 24.32
    is the 0.1% point), generator seeded so the test is not flaky."""
    n, V, T = 40_000, 8, 0.8
    rng = np.random.default_rng(0)
    pv = rng.dirichlet(np.ones(V))
    pd = rng.dirichlet(np.ones(V))
    drafts = torch.from_numpy(rng.choice(V, size=(n, 1), p=pd)
                              .astype(np.int32))
    vlg = torch.from_numpy(np.log(pv) * T).float()[None, None] \
        .expand(n, 2, V)
    dlg = torch.from_numpy(np.log(pd) * T).float()[None].expand(n, V)
    gen = torch.Generator().manual_seed(0)
    acc, j, carry = accept_drafts(vlg, drafts, [dlg], T, gen)
    first = torch.where(j > 0, drafts[:, 0], carry).numpy()
    counts = np.bincount(first, minlength=V)
    chi2 = float(((counts - n * pv) ** 2 / (n * pv)).sum())
    assert chi2 < 24.32, (chi2, counts / n, pv)
    rate = float(j.float().mean())           # P(accept) = sum min(pv, pd)
    assert abs(rate - np.minimum(pv, pd).sum()) < 0.02
    greedy = accept_drafts(vlg, drafts, [dlg], 0.0, None)
    top = int(np.argmax(pv))
    assert torch.equal(greedy[1], (drafts[:, 0] == top).to(torch.int64))
    assert (greedy[2] == top).all()


def test_plan_geometries():
    """The draft plans its packs at the decode geometry (M = slots), the
    verify its weights at M = slots * (spec_k + 1), the decode plan
    carries both; each as the JAX engine's rows (kernel, M, pattern; the
    JAX rows of the paged-attention geometry aside)."""
    jcfg, jp, tcfg, tp = dense_params("nm")
    kw = dict(slots=8, max_len=64, prompt_pad=16, max_new_tokens=4,
              spec_k=4, page_size=8)

    def rows(plan):
        return sorted((r["kernel"], r["M"], r["pattern"]) for r in plan
                      if r["kernel"] != "paged_attention")

    for draft, jparams, tparams in (
            ("pack", jp, tp),
            ("self", jax_draft_params(jp, jcfg), make_draft_params(tp, tcfg))):
        scfg = dict(kw, spec_draft=draft)
        jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**scfg), jparams)
        teng = TEngine(tcfg, ServeConfig(**scfg), tparams, device="cpu")
        assert teng.draft_plan and {r["M"] for r in teng.draft_plan} == {8}
        assert {r["kernel"] for r in teng.draft_plan} == {"nm_spmm"}
        assert all(r["M"] == 40 for r in teng.verify_plan)
        assert bool(teng.verify_plan) == (draft == "self")
        for name in ("draft_plan", "verify_plan", "decode_plan"):
            assert sorted(set(rows(getattr(teng, name)))) == \
                sorted(set(rows(getattr(jeng, name)))), (draft, name)


def test_reset_stats_clears_acceptance(dense):
    tcfg, tp = dense[2:]
    eng = TEngine(tcfg, ServeConfig(**BASE, spec_k=2), tp, device="cpu")
    serve(eng, PROMPTS[:1], [4])
    assert eng.stats().drafted > 0 and eng.acceptance_rate() > 0
    eng.reset_stats()
    st = eng.stats()
    assert (st.drafted, st.accepted, st.acceptance_rate) == (0, 0, 0.0)
    assert eng.acceptance_rate() == 0.0


def test_make_draft_params_shares_unpacked_leaves():
    """Only the weights a SparsityConfig governs become packs (equal to
    the JAX draft's); everything else is the verify params' own tensor.
    An all-dense config returns the params themselves."""
    jcfg, jp, tcfg, tp = dense_params("nm")
    d = make_draft_params(tp, tcfg)
    assert d["embed"] is tp["embed"]
    assert d["ln_final"]["scale"] is tp["ln_final"]["scale"]
    want = flatten(jax_draft_params(jp, jcfg))
    for layer, (got, src) in enumerate(zip(d["layers"], tp["layers"])):
        assert got["ln_attn"]["scale"] is src["ln_attn"]["scale"]
        for fam in ("attn", "mlp"):
            for name, w in got[fam].items():
                if name.endswith("_norm"):
                    assert w["scale"] is src[fam][name]["scale"]
                    continue
                assert isinstance(w, PACK_TYPES)
                ref = want["layers"][fam][name]
                np.testing.assert_array_equal(w.values.numpy(),
                                              ref["values"][layer])
    _, _, dcfg, dp = dense_params("dense")
    assert make_draft_params(dp, dcfg) is dp


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_decode_block_at_ragged_offsets_matches_jax(dense, page_size):
    """A (B, 4) block written at per-slot offsets 12 and 19 after a
    prefill, then a second block at the advanced offsets: logits of every
    block position within 1e-4 of JAX's, with fp32 caches on both
    sides."""
    jcfg, jp, tcfg, tp = dense
    B, prompt, max_len = 2, 12, 48
    jcache = JM.init_cache(jcfg, B, max_len, page_size=page_size,
                           dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, max_len, page_size=page_size,
                           dtype=torch.float32, device="cpu")
    if page_size:
        table = identity_table(B, max_len // page_size)
        jcache = JM.set_page_table(jcache, jnp.asarray(table))
        TM.set_page_table(tcache, table)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    _, jcache = jax.jit(lambda p, t, c: JM.prefill(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jcache)
    TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tcache)
    jblock = jax.jit(lambda p, t, c, s: JM.decode_block(p, jcfg, t, c, s))
    pos = np.asarray([prompt, prompt + 7], np.int32)     # ragged offsets
    for _ in range(2):
        blk = rng.integers(1, jcfg.vocab_size, (B, 4)).astype(np.int32)
        jl, jcache, _ = jblock(jp, jnp.asarray(blk), jcache,
                               jnp.asarray(pos))
        tl, tcache = TM.decode_block(tp, tcfg, torch.from_numpy(blk),
                                     tcache, torch.from_numpy(pos))
        assert tl.shape == (B, 4, tcfg.vocab_padded)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        pos = pos + 4


def _prefilled(tcfg, tp, scfg, ptab):
    """A cache and chunk buffers with both slots prefilled (greedy)."""
    cache = TM.init_cache(tcfg, scfg.slots, scfg.max_len,
                          page_size=scfg.page_size, device="cpu")
    bufs = ChunkBuffers(scfg.slots, scfg.chunk_tokens,
                        scfg.max_pages if scfg.paged else 0, "cpu")
    step = build_prefill_slot_step(tcfg, scfg, paged=scfg.paged)
    for slot, (prompt, budget) in enumerate(zip(PROMPTS[:2], (16, 11))):
        tokens = np.zeros((1, scfg.prompt_pad), np.int32)
        tokens[0, -len(prompt):] = prompt
        args = (torch.from_numpy(ptab[slot].copy()),) if scfg.paged else ()
        cache, _ = step(tp, torch.from_numpy(tokens), cache, bufs.state,
                        slot, budget, 0.0, None, *args)
    return cache, bufs


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_chunk_body_equals_the_functional_loop(dense, layout, sampled):
    """Three chunks of the served spec body (garbage draft, so drafts are
    rejected) equal the functional loop's tokens, emits, drafted and
    accepted counts, final state and cache, with slot 1 cancelled and
    slot 0 given a new page between chunks."""
    tcfg, tp = dense[2:]
    garbage = dense_params("dense", seed=7)[3]
    scfg = ServeConfig(**dict(BASE, **LAYOUTS[layout]), spec_k=3,
                       temperature=0.8 if sampled else 0.0)
    view = 4 if scfg.paged else None
    ptab = np.zeros((2, scfg.max_pages), np.int32)
    ptab[0, :2], ptab[1, :2] = (1, 2), (9, 10)
    temps = np.full(2, scfg.temperature, np.float32)
    ref_cache, ref_bufs = _prefilled(tcfg, tp, scfg, ptab)
    cache, bufs = _prefilled(tcfg, tp, scfg, ptab)
    state = {k: v.clone() for k, v in ref_bufs.state.items()}
    ref_gen = torch.Generator().manual_seed(3) if sampled else None
    gen = torch.Generator().manual_seed(3) if sampled else None
    loop = build_spec_decode_loop(tcfg, scfg, paged=scfg.paged,
                                  view_pages=view)
    stats = {"chunk_runs": [], "graph_captures": []}
    chunk = DecodeChunk(build_spec_decode_chunk(
        tcfg, scfg, garbage, paged=scfg.paged, view_pages=view),
        (view, sampled), stats)
    total = [0, 0]
    for c in range(3):
        if c == 1:
            for st in (state, bufs.state):
                st["done"][1] = True
                st["left"][1] = 0
            ptab[1] = 0
        if c == 2:
            ptab[0, 2] = 3
        ref_cache, state, tokens, emitted, dr, ac = loop(
            tp, garbage, ref_cache, state, ref_gen,
            ptab if scfg.paged else None)
        chunk(tp, cache, bufs, temps, gen, ptab if scfg.paged else None)
        assert tokens.shape == (scfg.chunk_tokens, 2)
        assert torch.equal(bufs.tokens, tokens), c
        assert torch.equal(bufs.emitted, emitted), c
        assert bufs.tally.tolist() == [int(dr), int(ac)], c
        for k in state:
            assert torch.equal(bufs.state[k], state[k]), (c, k)
        total[0] += int(dr)
        total[1] += int(ac)
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k]), k
    assert total[1] < total[0]
    assert stats["chunk_runs"] == [((view, sampled), "eager")] * 3
    if sampled:
        assert torch.equal(gen.get_state(), ref_gen.get_state())
