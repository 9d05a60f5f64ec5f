"""The served decode chunk of the port on the CPU: the static-buffer body
that the card captures as one CUDA graph per key (``serving.loops
.build_decode_chunk`` run by ``DecodeChunk``) against the functional
``build_decode_loop``, the engine's buffers at fixed addresses, and a
serve with a cancel and a refill mid-stream against the JAX ``Engine``
(TINY 2:4-packed weights, float32; the JAX engine on a 1x1 mesh with Auto
axes).  On the CPU there are no graphs: the same body runs directly, so
these tests run the code the card captures."""

import numpy as np
import pytest
import torch

from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import models as TM
from repro_torch.serving import (ChunkBuffers, DecodeChunk, ServeConfig,
                                 build_decode_chunk, build_decode_loop,
                                 build_prefill_slot_step)
from repro_torch.serving import Engine as TEngine
from test_torch_model import build_params, jax_mesh

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.asarray([7, 9, 11], np.int32),
           np.arange(20, 27, dtype=np.int32)]
LAYOUTS = {"mono": {}, "paged": dict(page_size=8)}


@pytest.fixture(scope="module")
def params():
    return build_params("nm")


def addresses(bufs):
    """The storage address of every chunk buffer, by name."""
    named = dict(bufs.state, temps=bufs.temps, tokens=bufs.tokens,
                 emitted=bufs.emitted, ptab=bufs.ptab)
    return {k: t.data_ptr() for k, t in named.items() if t is not None}


def _prefilled(cfg, tp, scfg, ptab, seed):
    """A cache and decode state with both slots prefilled from the same
    prompts (slot 1 also samples its first token at temperature 0.8 when
    a generator is made)."""
    cache = TM.init_cache(cfg, scfg.slots, scfg.max_len,
                          page_size=scfg.page_size, device="cpu")
    bufs = ChunkBuffers(scfg.slots, scfg.decode_chunk,
                        scfg.max_pages if scfg.paged else 0, "cpu")
    gen = torch.Generator().manual_seed(seed)
    step = build_prefill_slot_step(cfg, scfg, paged=scfg.paged)
    for slot, (prompt, budget) in enumerate(zip(PROMPTS[:2], (16, 11))):
        tokens = np.zeros((1, scfg.prompt_pad), np.int32)
        tokens[0, -len(prompt):] = prompt
        args = (torch.from_numpy(ptab[slot].copy()),) if scfg.paged else ()
        cache, _ = step(tp, torch.from_numpy(tokens), cache, bufs.state,
                        slot, budget, 0.8 * slot, gen, *args)
    return cache, bufs, gen


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunk_body_equals_the_functional_loop(params, layout, sampled):
    """Three successive chunks of the served body equal the functional
    loop's tokens, emits, final state and cache, with a new page for
    slot 0 and a cancelled (then retired) slot 1 between chunks."""
    _, _, cfg, tp = params
    scfg = ServeConfig(slots=2, max_len=64, prompt_pad=8, decode_chunk=4,
                       max_new_tokens=16, eos_token=-1,
                       **LAYOUTS[layout])
    view = 4 if scfg.paged else None
    ptab = np.zeros((2, scfg.max_pages), np.int32)
    ptab[0, :2], ptab[1, :2] = (1, 2), (9, 10)
    temps = np.asarray([0.0, 0.8 if sampled else 0.0], np.float32)
    ref_cache, ref_bufs, ref_gen = _prefilled(cfg, tp, scfg, ptab, 3)
    cache, bufs, gen = _prefilled(cfg, tp, scfg, ptab, 3)
    state = {k: v.clone() for k, v in ref_bufs.state.items()}
    loop = build_decode_loop(cfg, scfg, paged=scfg.paged, view_pages=view)
    stats = {"chunk_runs": [], "graph_captures": []}
    chunk = DecodeChunk(build_decode_chunk(cfg, scfg, paged=scfg.paged,
                                           view_pages=view),
                        (view, sampled), stats)
    before = addresses(bufs)
    for c in range(3):
        if c == 1:                  # cancel slot 1, as Engine._apply_cancels
            for st in (state, bufs.state):
                st["done"][1] = True
                st["left"][1] = 0
            ptab[1] = 0             # ... and its retirement nulls its row
        if c == 2:
            ptab[0, 2] = 3          # slot 0 grows into a third page
        ref_cache, state, tokens, emitted = loop(
            tp, ref_cache, state, torch.from_numpy(temps),
            ref_gen if sampled else None, ptab if scfg.paged else None)
        chunk(tp, cache, bufs, temps, gen if sampled else None,
              ptab if scfg.paged else None)
        assert torch.equal(bufs.tokens, tokens), c
        assert torch.equal(bufs.emitted, emitted), c
        for k in state:
            assert torch.equal(bufs.state[k], state[k]), (c, k)
    assert addresses(bufs) == before
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k]), k
    assert stats["chunk_runs"] == [((view, sampled), "eager")] * 3
    assert not bool(bufs.state["done"][0]) and bool(bufs.state["done"][1])
    if sampled:      # both generators drew the same noise, and some of it
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        assert gen.get_state().ne(
            torch.Generator().manual_seed(3).get_state()).any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_buffers_keep_their_addresses(params, layout):
    """The cache and the decode buffers keep their storage across a serve
    with a wave prefill (monolithic: all slots free at the first tick) and
    per-slot refills of finished slots."""
    _, _, cfg, tp = params
    eng = TEngine(cfg, ServeConfig(slots=2, max_len=64, prompt_pad=8,
                                   decode_chunk=4, max_new_tokens=6,
                                   eos_token=-1, **LAYOUTS[layout]),
                  tp, device="cpu")
    eng._ensure_device_state()

    def storage():
        return (addresses(eng._bufs),
                {k: t.data_ptr() for k, t in eng._cache.items()})

    before = storage()
    handles = [eng.submit(p, max_new=n)
               for p, n in zip(PROMPTS, (3, 9, 5, 6))]
    eng.run()
    assert storage() == before
    assert [len(h.tokens) for h in handles] == [3, 9, 5, 6]
    st = eng.stats()
    assert st.prefills == 4
    assert st.sync_count == len(st.chunk_s) == len(st.chunk_runs)
    assert {how for _, how in st.chunk_runs} == {"eager"}
    assert st.graph_captures == []


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cancel_and_refill_mid_stream_equals_jax(params, layout):
    """Four requests on two slots; after the second tick the first request
    is cancelled and the third refills its slot mid-stream: tokens and
    ``sync_count`` equal the JAX Engine's."""
    jcfg, jp, tcfg, tp = params
    kw = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=16,
              decode_chunk=4, eos_token=-1, **LAYOUTS[layout])
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, ServeConfig(**kw), tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        handles = [eng.submit(p, max_new=n)
                   for p, n in zip(PROMPTS, (12, 10, 7, 5))]
        eng.step()
        eng.step()
        handles[0].cancel()
        eng.run()
        assert handles[0].status.value == "cancelled"
        assert [h.status.value for h in handles[1:]] == ["done"] * 3
        outs.append([h.tokens for h in handles])
    assert outs[1] == outs[0]
    assert [len(t) for t in outs[1][1:]] == [10, 7, 5]
    assert teng.sync_count == jeng.sync_count
