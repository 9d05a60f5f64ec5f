"""Edge cases of the port's serving Engine against the JAX Engine, in the
manner of ``tests/test_paged.py::TestPagedServer``: EOS in the middle of
a chunk, a pool smaller than the request stream, admission waits, prompt
buckets, truncated prompts, more requests than slots, and requests that
reach ``max_len``.  Each compares the greedy tokens, ``sync_count``,
admission waits, prefills and peak pages of the two engines on the same
2:4-packed TINY weights (float32, CPU; the JAX engine on a 1x1 mesh with
Auto axes)."""

import numpy as np
import pytest

from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_model import build_params, jax_mesh

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.asarray([7, 9, 11], np.int32)]
LAYOUTS = {"mono": {}, "paged": dict(page_size=8)}


@pytest.fixture(scope="module")
def params():
    return build_params("nm")


def serve_both(params, kw, prompts, budgets):
    """Serve ``prompts`` on both engines; returns (JAX tokens, port tokens,
    JAX engine, port engine)."""
    jcfg, jp, tcfg, tp = params
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    outs = []
    for eng in (jeng, teng):
        handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
        eng.run()
        outs.append([h.tokens for h in handles])
    return outs[0], outs[1], jeng, teng


def assert_same(jout, tout, jeng, teng):
    assert tout == jout
    js, ts = jeng.stats(), teng.stats()
    assert ts.sync_count == js.sync_count == jeng.sync_count == \
        teng.sync_count
    assert ts.admission_waits == js.admission_waits
    assert ts.prefills == js.prefills
    assert ts.peak_pages == js.peak_pages


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eos_mid_chunk(params, layout):
    """EOS as the third token of an 8-token chunk truncates both engines
    at the same place (pages freed at retirement)."""
    base = dict(slots=1, max_len=64, prompt_pad=8, max_new_tokens=12,
                decode_chunk=8, **LAYOUTS[layout])
    prompt = [np.arange(1, 9, dtype=np.int32)]
    jfree, tfree, _, _ = serve_both(params, dict(base, eos_token=-1),
                                    prompt, [12])
    assert tfree == jfree and len(tfree[0]) == 12
    eos = tfree[0][2]
    jout, tout, jeng, teng = serve_both(params, dict(base, eos_token=eos),
                                        prompt, [12])
    assert_same(jout, tout, jeng, teng)
    cut = tfree[0].index(eos)
    assert tout[0] == tfree[0][:cut + 1] and tout[0][-1] == eos
    if layout == "paged":
        assert len(teng._backend.free_pages) == teng.scfg.pool_pages


def test_refill_through_a_two_page_pool(params):
    """4 requests through 1 slot on a 2-page pool: each request needs both
    pages, so every refill reuses retired pages."""
    kw = dict(slots=1, max_len=32, prompt_pad=8, max_new_tokens=4,
              decode_chunk=4, eos_token=-1, page_size=8, num_pages=2)
    prompts = [np.arange(1 + i, 7 + i, dtype=np.int32) for i in range(4)]
    jout, tout, jeng, teng = serve_both(params, kw, prompts, [4] * 4)
    assert_same(jout, tout, jeng, teng)
    assert teng.stats().peak_pages == 2
    assert len(teng._backend.free_pages) == 2


def test_tight_pool_admission_wait(params):
    """2 slots on a pool that fits one request: the second waits, on both
    sides, then serves as it would have in parallel."""
    kw = dict(slots=2, max_len=32, prompt_pad=8, max_new_tokens=4,
              decode_chunk=4, eos_token=-1, page_size=8, num_pages=2)
    jout, tout, jeng, teng = serve_both(params, kw, PROMPTS[:2], [4, 4])
    assert_same(jout, tout, jeng, teng)
    assert teng.stats().admission_waits > 0
    roomy = dict(kw, num_pages=0)
    _, troomy, _, teng2 = serve_both(params, roomy, PROMPTS[:2], [4, 4])
    assert teng2.stats().admission_waits == 0
    assert troomy == tout


def test_prompt_buckets(params):
    """Each prompt padded to its own bucket of 8 rows, not to
    ``prompt_pad``."""
    kw = dict(slots=2, max_len=64, prompt_pad=32, max_new_tokens=4,
              decode_chunk=4, eos_token=-1, page_size=8, prompt_buckets=8)
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(1, 20, dtype=np.int32)]
    jout, tout, jeng, teng = serve_both(params, kw, prompts, [4, 4])
    assert_same(jout, tout, jeng, teng)
    assert [teng.scfg.prompt_rows(len(p)) for p in prompts] == [8, 24]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prompt_truncated_to_prompt_pad(params, layout):
    """A 20-token prompt in an 8-row prefill window keeps its last 8
    tokens on both sides."""
    kw = dict(slots=2, max_len=48, prompt_pad=8, max_new_tokens=6,
              decode_chunk=4, eos_token=-1, **LAYOUTS[layout])
    prompts = [np.arange(1, 21, dtype=np.int32), PROMPTS[2]]
    jout, tout, jeng, teng = serve_both(params, kw, prompts, [6, 5])
    assert_same(jout, tout, jeng, teng)
    _, tail, _, _ = serve_both(params, kw, [prompts[0][-8:]], [6])
    assert tout[0] == tail[0]


def test_six_requests_on_three_slots_default_view(params):
    """More requests than slots, refilled as slots retire, on the default
    decode view chunk (``page_view_chunk=8``)."""
    kw = dict(slots=3, max_len=64, prompt_pad=8, max_new_tokens=8,
              decode_chunk=4, eos_token=-1, page_size=8)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n).astype(np.int32)
               for n in (3, 8, 5, 7, 2, 6)]
    budgets = [8, 3, 6, 5, 8, 2]
    jout, tout, jeng, teng = serve_both(params, kw, prompts, budgets)
    assert_same(jout, tout, jeng, teng)
    assert [len(t) for t in tout] == budgets
    assert teng.stats().prefills == 6


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_requests_reach_max_len(params, layout):
    """Budgets past ``max_len``: both engines stop each request at the
    same length."""
    kw = dict(slots=2, max_len=16, prompt_pad=8, max_new_tokens=12,
              decode_chunk=4, eos_token=-1, **LAYOUTS[layout])
    jout, tout, jeng, teng = serve_both(params, kw, PROMPTS[:2], [12, 12])
    assert_same(jout, tout, jeng, teng)
    assert all(len(t) < 12 for t in tout)
