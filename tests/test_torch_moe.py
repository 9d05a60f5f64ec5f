"""The MoE family of the port (``repro_torch/models/moe.py``, the MoE
block, qwen2-moe-a2.7b and dbrx-132b) served against the JAX package, on
the CPU at float32 (JAX on a 1x1 mesh with Auto axes, weights carried
over with ``convert.params_from_numpy``):

* the configs field by field, and the expert rows of each capacity;
* prefill and decode logits within 1e-4, monolithic and paged, dense and
  packed (2:4) experts, on a qwen2-moe-shaped tiny config (shared
  experts, 2:4 on the shared FFN too) and a dbrx-shaped one (GQA, no
  shared experts) — the JAX side on the pruned dense experts where the
  port runs packs, since the JAX ``moe_sorted`` cannot take packs;
* ``Engine`` greedy transcripts and ``sync_count`` equal to the JAX
  ``Engine``, both layouts, with a slot that goes dead mid-serve and
  dropped routes counted at decode and at prefill;
* speculation and prefix sharing refused for MoE configs.

The MoE functions themselves, packing and conversion are held in
``test_torch_moe_dispatch.py``; the helpers here serve both files.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import models as JM
from repro.core import sparse_linear as JSL
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparse_linear import pack_params
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_engine import BUDGETS, LAYOUTS, PROMPTS, SERVE
from test_torch_families import caches, decode_both, to_port
from test_torch_model import ATOL, NM, flatten, jax_mesh

FN_ATOL = 1e-5

#: qwen2-moe's shape: shared experts, kv heads = heads; 8 experts top-2,
#: so 2 decode slots get C = 1 and an 8-row prompt C = 3
QWEN = dict(name="tiny-qwen2-moe", n_layers=2, d_model=128, vocab_size=512,
            n_heads=4, n_kv_heads=4, d_ff=128, n_experts=8,
            n_shared_experts=2, top_k=2, d_expert=128, moe_sharding="tp",
            moe_impl="sorted", rope_theta=1_000_000.0, dtype="float32",
            remat=False)
#: dbrx's shape: GQA, no shared experts; 8 experts top-3 (C = 1 at 2
#: decode slots, 4 for an 8-row prompt)
DBRX = dict(name="tiny-dbrx", n_layers=2, d_model=128, vocab_size=512,
            n_heads=4, n_kv_heads=2, d_ff=128, n_experts=8, top_k=3,
            d_expert=128, moe_sharding="ep", moe_impl="sorted",
            rope_theta=500_000.0, dtype="float32", remat=False)
TINY = {"qwen2-moe": QWEN, "dbrx": DBRX}
MOE_ARCHS = ("qwen2_moe_a2_7b", "dbrx_132b")


def configs(arch, fmt):
    """(JAX config, port config): dense, or 2:4 on the experts (and the
    shared FFN where there is one), as the archs' ``sparse()``."""
    kw = TINY[arch]
    if fmt == "dense":
        return JModelConfig(**kw), TModelConfig(**kw)
    sp = dict(expert_sparsity=NM)
    if kw.get("n_shared_experts"):
        sp["mlp_sparsity"] = NM
    return (JModelConfig(**kw, **{k: JSparsity(**v) for k, v in sp.items()}),
            TModelConfig(**kw, **{k: TSparsity(**v) for k, v in sp.items()}))


def pruned(w, scfg):
    """An ``(L, E, K, N)`` expert stack pruned slice by slice, dense: what
    the JAX packs of it hold."""
    return jnp.asarray(np.stack([np.stack([np.asarray(
        JSL.prune_weight(jnp.asarray(s), scfg)[0]) for s in layer])
        for layer in np.asarray(w)]))


@functools.lru_cache(maxsize=None)
def jax_trees(arch, fmt):
    """(JAX config, port config, JAX params, the JAX packs or None)."""
    jcfg, tcfg = configs(arch, fmt)
    jp = JM.init_model(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, (None if fmt == "dense"
                            else JSL.pack_params(jp, jcfg))


def build(arch, fmt):
    """(JAX config, JAX reference params, port config, port params on the
    CPU).  2:4: the port gets the JAX packs, the JAX side the same with
    its expert stacks pruned and dense (the shared FFN stays packed)."""
    jcfg, tcfg, jp, packed = jax_trees(arch, fmt)
    if packed is None:
        return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")
    moe = dict(packed["layers"]["moe"], **{
        k: pruned(jp["layers"]["moe"][k], jcfg.expert_sparsity)
        for k in TMOE.EXPERT_WEIGHTS})
    ref = dict(packed, layers=dict(packed["layers"], moe=moe))
    return jcfg, ref, tcfg, params_from_numpy(flatten(packed), "cpu")


def layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.fixture
def tally():
    """``models.moe.route_tally`` on the CPU for one test."""
    TMOE.route_tally = {k: torch.zeros(2, dtype=torch.int64)
                        for k in ("decode", "prefill")}
    yield TMOE.route_tally
    TMOE.route_tally = None


def inputs(jcfg, B=2, L=8, seed=0):
    x = np.random.default_rng(seed).normal(
        size=(B, L, jcfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def assert_close(got, want, atol=FN_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["config", "reduced", "sparse"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_equal_jax(arch, fn):
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), fn)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   fn)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port(jcfg) == tcfg
    assert TC.get(arch) == to_port(JC.get(arch))


def test_full_width_expert_rows():
    """The capacities the card serves at: 8 decode slots and a 128-row
    prompt."""
    q, d = TC.get("qwen2-moe-a2.7b"), TC.get("dbrx-132b")
    assert [TM.expert_rows(q, 8), TM.expert_rows(q, 128)] == [1, 11]
    assert [TM.expert_rows(d, 8), TM.expert_rows(d, 128)] == [3, 40]
    assert TM.expert_rows(TC.get("qwen3-0.6b"), 8) is None


# --- model parity ------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, f) for a in sorted(TINY)
                                        for f in ("dense", "nm")],
                ids=lambda p: "-".join(p))
def both(request):
    return build(*request.param)


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_prefill_and_decode_logits_match_jax(both, page_size):
    jcfg, jp, tcfg, tp = both
    B, prompt, max_len = 2, 12, 48
    jcache, tcache = caches(jcfg, tcfg, B, max_len, page_size)
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t, c: JM.prefill(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    decode_both(jcfg, jp, tcfg, tp, jl, jcache, tcache,
                np.asarray([prompt, prompt + 3], np.int32))


# --- Engine parity -----------------------------------------------------------

def serve(eng, prompts=PROMPTS, budgets=BUDGETS):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_transcripts_match_jax(both, layout, tally):
    """Three requests over two slots (budgets 5, 9, 3: a slot goes dead
    mid-serve and is refilled); with 2 slots each decode step has C = 1,
    so routes drop at decode and at prefill."""
    jcfg, jp, tcfg, tp = both
    kw = dict(SERVE, **LAYOUTS[layout])
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    assert [len(t) for t in tout] == BUDGETS
    assert teng.sync_count == jeng.sync_count
    for phase in ("decode", "prefill"):
        kept, routes = tally[phase].tolist()
        assert 0 < kept < routes
    if tcfg.expert_sparsity.format == "nm":
        routed = [r for r in teng.decode_plan if "/moe/w_" in r["param"]]
        assert len(routed) == 3 * tcfg.n_experts * tcfg.n_layers
        assert {r["M"] for r in routed} == {1}
        assert {r["kernel"] for r in teng.decode_plan} == {"nm_spmm"}


def test_frozen_slots_sharing_the_null_page_match_jax():
    """Four slots, budgets that leave two or three slots frozen beside a
    live one: the frozen slots' writes collide in the null page and what
    they read there routes against the live token; the port keeps the
    last colliding write, as the JAX scatter does."""
    jcfg, jp, tcfg, tp = build("dbrx", "nm")
    kw = dict(SERVE, slots=4, page_size=8, page_view_chunk=1)
    prompts = PROMPTS + [np.arange(20, 27, dtype=np.int32),
                         np.asarray([5, 4], np.int32)]
    budgets = [2, 3, 2, 13, 4]
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    assert serve(teng, prompts, budgets) == serve(jeng, prompts, budgets)
    assert teng.sync_count == jeng.sync_count


def test_last_writers_take_the_last_colliding_value():
    from repro_torch.models.attention import _last_writers
    rows = torch.tensor([[0], [3], [0], [7], [0]])
    k = torch.arange(5.0)[:, None, None].expand(5, 1, 2)
    got, = _last_writers(rows, k)
    assert got[:, 0, 0].tolist() == [4.0, 1.0, 4.0, 3.0, 4.0]
    pool = torch.zeros(8, 2)
    pool[rows[:, 0]] = got[:, 0]
    want = torch.zeros(8, 2)
    want[rows[:, 0]] = k[:, 0]           # the CPU scatter: the last wins
    assert torch.equal(pool, want)


@pytest.mark.parametrize("kw", [dict(spec_k=2), dict(prefix_cache=True)],
                         ids=["spec", "prefix"])
def test_speculation_and_prefix_sharing_are_refused(kw):
    tcfg = TC.get_reduced("dbrx-132b")
    params = TM.init_model(tcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        TEngine(tcfg, TServeConfig(**SERVE, page_size=8, **kw), params,
                device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_model_serves_the_reduced_configs(arch):
    """The port's own random init: expert stacks ``(E, K, N)``, an fp32
    router, and a finite prefill; 2:4 ``pack_params`` makes each stack a
    list of packs."""
    cfg = TC.get_reduced(arch)
    p = TM.init_model(cfg, seed=0, device="cpu")
    m = p["layers"][0]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["w_out"].shape == (cfg.n_experts, cfg.d_expert, cfg.d_model)
    assert ("shared" in m) == bool(cfg.n_shared_experts)
    cache = TM.init_cache(cfg, 1, 16, page_size=8, device="cpu")
    logits, _ = TM.prefill(p, cfg, {"tokens": torch.ones((1, 4),
                                                         dtype=torch.int32)},
                           cache)
    assert logits.shape == (1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()


def test_packed_init_equals_pack_params_of_the_dense_init():
    """``init_model(packed=True)`` packs each layer as it is drawn: the
    same draws, so the same packs as ``pack_params`` of the dense init."""
    from repro_torch.configs import qwen2_moe_a2_7b
    cfg = dataclasses.replace(
        qwen2_moe_a2_7b.sparse(), n_layers=2, layer_kinds=(), d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=128, d_expert=128, n_experts=4,
        vocab_size=512)
    got = TM.init_model(cfg, seed=3, device="cpu", packed=True)
    want = pack_params(TM.init_model(cfg, seed=3, device="cpu"), cfg)
    for a, b in zip(got["layers"], want["layers"]):
        for k in TMOE.EXPERT_WEIGHTS:
            assert len(a["moe"][k]) == cfg.n_experts
            for p, q in zip(a["moe"][k], b["moe"][k]):
                assert torch.equal(p.values, q.values)
                assert torch.equal(p.idx, q.idx)
        assert torch.equal(a["moe"]["shared"]["w_out"].values,
                           b["moe"]["shared"]["w_out"].values)
        assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])
    assert torch.equal(got["embed"], want["embed"])
