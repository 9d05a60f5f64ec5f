"""The port's serving Engine against the JAX Engine on the same weights:
greedy transcripts and sync counts, monolithic and paged layouts, on the
CPU at float32 (bf16 KV cache, the engines' default).  This file serves
dense projections; ``test_torch_engine_{nm,combined,block,lookahead}.py``
run the same tests on packed ones (``FORMAT`` of the collecting module
picks)."""

import numpy as np
import pytest

from conftest import reference_decode
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_model import build_params, jax_mesh

FORMAT = "dense"

# the prompt set and budgets of tests/test_paged.py
PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.asarray([7, 9, 11], np.int32)]
BUDGETS = [5, 9, 3]
SERVE = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=16,
             decode_chunk=4, eos_token=-1)
LAYOUTS = {"mono": {}, "paged": dict(page_size=8, page_view_chunk=1)}


def served_params(fmt, zero_tiles=False):
    """Params of ``fmt`` plus the 1-token-at-a-time JAX oracle's
    transcripts."""
    jcfg, jp, tcfg, tp = build_params(fmt, zero_tiles=zero_tiles)
    oracle = [reference_decode(jp, jcfg, p, n, SERVE["eos_token"],
                               SERVE["prompt_pad"], SERVE["max_len"])
              for p, n in zip(PROMPTS, BUDGETS)]
    return jcfg, jp, tcfg, tp, oracle


@pytest.fixture(scope="module")
def served(request):
    return served_params(request.module.FORMAT)


def serve_both(served, layout):
    jcfg, jp, tcfg, tp, _ = served
    kw = dict(SERVE, **LAYOUTS[layout])
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        handles = [eng.submit(p, max_new=n) for p, n in zip(PROMPTS, BUDGETS)]
        eng.run()
        outs.append([h.tokens for h in handles])
    return outs, jeng, teng


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_transcripts_match_jax(served, layout):
    (jout, tout), jeng, teng = serve_both(served, layout)
    assert tout == jout
    assert tout == served[-1]
    assert [len(t) for t in tout] == BUDGETS
    assert teng.sync_count == jeng.sync_count
    if layout == "paged":
        assert teng.stats().peak_pages > 0
        assert len(teng._backend.free_pages) == teng.scfg.pool_pages


def check_tile_zeroed_parity(fmt):
    """Paged serving of ``fmt`` packs with half of every projection's
    tiles zeroed (tile density 0.50, strips of different counts, padding
    slots from the JAX stack) matches the JAX Engine and the oracle."""
    served = served_params(fmt, zero_tiles=True)
    (jout, tout), jeng, teng = serve_both(served, "paged")
    assert tout == jout == served[-1]
    assert teng.sync_count == jeng.sync_count
    tag = {"block": "bsr128x128d0.50", "combined": "csa128x128d0.50+2:4"}
    assert {r["pattern"] for r in teng.decode_plan} == {tag[fmt]}
    packs = [served[3]["layers"][0]["mlp"][n] for n in ("w_in", "w_out")]
    assert any(int(p.counts.max()) < p.max_nnz for p in packs)


def test_cancel_frees_pages_and_emits_nothing_more(served):
    _, _, tcfg, tp, _ = served
    eng = TEngine(tcfg, TServeConfig(**SERVE, **LAYOUTS["paged"]), tp,
                  device="cpu")
    a = eng.submit(PROMPTS[0], max_new=12)
    b = eng.submit(PROMPTS[1], max_new=4)
    eng.step()
    got = len(a.tokens)
    a.cancel()
    eng.run()
    assert a.status.value == "cancelled" and len(a.tokens) == got
    assert len(b.tokens) == 4
    assert len(eng._backend.free_pages) == eng.scfg.pool_pages


def test_engine_validates_requests(served):
    _, _, tcfg, tp, _ = served
    eng = TEngine(tcfg, TServeConfig(**SERVE), tp, device="cpu")
    for bad in ([], [[1, 2]], [1.5, 2.0], list(range(70)), [tcfg.vocab_size]):
        with pytest.raises(ValueError):
            eng.submit(bad)
    with pytest.raises(NotImplementedError):
        TEngine(tcfg, TServeConfig(**SERVE, spec_k=2), tp, device="cpu")
