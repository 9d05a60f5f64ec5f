"""The SSM/hybrid family of the port (``repro_torch/models/hybrid.py``,
mamba2-130m and zamba2-1.2b) served against the JAX package, on the CPU
at float32 (JAX on a 1x1 mesh with Auto axes, weights carried over with
``convert.params_from_numpy``):

* the configs field by field; at the published widths ``sparse()`` packs
  ``out_proj`` and zamba2's shared MLP and leaves ``in_proj`` dense, and
  the engine's plans list those packs at M = slots (decode) and M =
  prompt rows (prefill);
* converted JAX params: ``mamba`` becomes a list of per-layer dicts,
  packs included;
* prefill, per-slot decode and ``decode_block`` logits within 1e-4 (fp32
  caches on both sides), monolithic and paged, dense and 2:4, on a
  zamba-shaped tiny config (d_model 128, g = 64, two shared slots) and an
  all-mamba one; ``decode_block``'s per-position snapshots too;
* ``Engine`` greedy transcripts and ``sync_count`` equal to the JAX
  ``Engine`` on ``tests/test_engine.py``'s ``HYBRID`` (at fp32) and on
  an all-mamba tiny config: monolithic, paged, speculative, and the
  garbage-draft twin of ``tests/test_spec.py::test_hybrid_partial_acceptance``
  (acceptance < 0.5, tokens equal to the plain loop's), mono and paged;
* a second monolithic wave, whose prompts must start from zero recurrent
  state: the port equals ``conftest.reference_decode``, the JAX
  ``Engine`` does not (its wave step seeds the prefill from the state
  the retired requests left; ROADMAP queue 3).

``prefix_cache=True`` refused for the family is held in
``test_torch_families.py``.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reference_decode
from repro import configs as JC
from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.models.config import LayerKind
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import zamba_kinds as jax_zamba_kinds
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparse_linear import pack_params
from repro_torch.core.sparsity import NMPack
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import zamba_kinds
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_engine import BUDGETS, LAYOUTS, PROMPTS, SERVE
from test_torch_families import caches, decode_both, to_port
from test_torch_model import ATOL, flatten, jax_mesh

MAMBA, SHARED = int(LayerKind.MAMBA), int(LayerKind.SHARED_ATTN)
HYBRID_ARCHS = ("mamba2_130m", "zamba2_1_2b")
NM = dict(format="nm", n=2, m=4, block_n=64)

#: zamba-shaped: the shared block before layers 1 and 3 (two KV slots),
#: d_inner 256 in 8 heads of 32, state 16; under 2:4 with g = 64
#: ``out_proj`` (256 → 128) and the shared MLP (128 ↔ 256) pack and
#: ``in_proj`` (N = 552) stays dense, as at the published widths
ZAMBA = dict(name="tiny-zamba", n_layers=4, d_model=128, vocab_size=512,
             n_heads=4, n_kv_heads=2, d_ff=256, ssm_state=16,
             ssm_head_dim=32, ssm_chunk=8, layer_kinds=zamba_kinds(4, 2),
             dtype="float32", remat=False)
#: mamba2-shaped: attention-free
MAMBA2 = dict(name="tiny-mamba2", n_layers=2, d_model=128, vocab_size=512,
              ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
              layer_kinds=(MAMBA, MAMBA), dtype="float32", remat=False)
TINY = {"zamba": ZAMBA, "mamba2": MAMBA2}

#: the engine configs: ``tests/test_engine.py``'s HYBRID at fp32 (its
#: ``ssm_state`` is the default 0, so only the conv carries state) and an
#: all-mamba one with a 16-wide state
ENGINE = {
    "hybrid": dict(name="hy", n_layers=3, d_model=64, vocab_size=256,
                   n_heads=4, n_kv_heads=2, d_ff=128, remat=False,
                   layer_kinds=(MAMBA, SHARED, MAMBA), dtype="float32"),
    "mamba": dict(name="mb", n_layers=2, d_model=64, vocab_size=256,
                  ssm_state=16, ssm_head_dim=16, ssm_chunk=8, remat=False,
                  layer_kinds=(MAMBA, MAMBA), dtype="float32"),
}


def configs(kw, fmt):
    if fmt == "dense":
        return JModelConfig(**kw), TModelConfig(**kw)
    return (JModelConfig(**kw, mlp_sparsity=JSparsity(**NM)),
            TModelConfig(**kw, mlp_sparsity=TSparsity(**NM)))


@functools.lru_cache(maxsize=None)
def build(arch, fmt, seed=0):
    """(JAX config, JAX params, port config, port params on the CPU) of a
    ``TINY`` (or ``ENGINE``) config, packed under ``fmt``."""
    jcfg, tcfg = configs({**TINY, **ENGINE}[arch], fmt)
    jp = JM.init_model(jax.random.key(seed), jcfg)
    if fmt != "dense":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


# --- configs and packing ------------------------------------------------------

@pytest.mark.parametrize("fn", ["config", "reduced", "sparse"])
@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_configs_equal_jax(arch, fn):
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), fn)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   fn)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port(jcfg) == tcfg
    assert TC.get(arch) == to_port(JC.get(arch))
    assert (tcfg.d_inner, tcfg.n_ssm_heads) == (jcfg.d_inner,
                                                jcfg.n_ssm_heads)
    assert TM.family(tcfg) == JM.family(jcfg) == "hybrid"


def test_published_shapes_and_zamba_kinds():
    m, z = TC.get("mamba2-130m"), TC.get("zamba2-1.2b")
    assert (m.d_inner, m.n_ssm_heads, m.ssm_state) == (1536, 24, 128)
    assert (z.d_inner, z.n_ssm_heads, z.ssm_state) == (4096, 64, 64)
    assert [i for i, k in enumerate(z.layer_kinds) if k == SHARED] == \
        [3, 9, 15, 21, 27, 33]
    for n, every in ((38, 6), (6, 3), (4, 2), (4, 6), (2, 6)):
        assert zamba_kinds(n, every) == jax_zamba_kinds(n, every)
    assert (m.vocab_padded, z.vocab_padded) == (50688, 32256)


@pytest.mark.parametrize("arch,layers", [("mamba2_130m", 1),
                                         ("zamba2_1_2b", 4)])
def test_sparse_packs_out_proj_and_the_shared_mlp_at_published_widths(
        arch, layers):
    """``init_model(packed=True)`` at the published widths, cut in depth
    (zamba2 to its first 4 layers, so the shared block is drawn):
    ``in_proj`` (N = 3352 / 8384, not a multiple of 128) stays dense,
    ``out_proj`` and the shared MLP are 2:4 packs, the attention dense —
    what the JAX ``pack_params`` decides (``_geometry_ok``).  The
    engine's plans list exactly those packs, at M = slots for decode and
    M = prompt rows for prefill."""
    from repro.core import sparse_linear as JSL
    base = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   "sparse")()
    cfg = dataclasses.replace(base, n_layers=layers,
                              layer_kinds=base.layer_kinds[:layers])
    p = TM.init_model(cfg, seed=0, device="cpu", packed=True)
    jcfg = to_port(cfg)
    for layer in p["mamba"]:
        assert not isinstance(layer["in_proj"], NMPack)
        assert isinstance(layer["out_proj"], NMPack)
        K, N = layer["in_proj"].shape
        assert not JSL._geometry_ok(K, N, JSparsity(**dataclasses.asdict(
            jcfg.mlp_sparsity)))
    shared = p.get("shared")
    assert (shared is not None) == (arch == "zamba2_1_2b")
    if shared:
        assert all(isinstance(w, NMPack) for w in shared["mlp"].values())
        assert not any(isinstance(w, NMPack) for w in shared["attn"].values())
    n_packs = layers + (3 if shared else 0)
    scfg = TServeConfig(slots=8, max_len=512, prompt_pad=128, page_size=16)
    eng = TEngine(cfg, scfg, p, device="cpu")
    for plan, M in ((eng.decode_plan, 8), (eng.prefill_plan, 128)):
        assert len(plan) == n_packs
        assert {r["M"] for r in plan} == {M}
        assert {r["kernel"] for r in plan} == {"nm_spmm"}
        assert sorted({r["param"].rsplit("/", 1)[-1] for r in plan}) == \
            (["out_proj", "w_gate", "w_in", "w_out"] if shared
             else ["out_proj"])


def test_packed_init_equals_pack_params_of_the_dense_init():
    cfg = TModelConfig(**ZAMBA, mlp_sparsity=TSparsity(**NM))
    got = TM.init_model(cfg, seed=3, device="cpu", packed=True)
    want = pack_params(TM.init_model(cfg, seed=3, device="cpu"), cfg)
    for a, b in zip(got["mamba"], want["mamba"]):
        assert torch.equal(a["out_proj"].values, b["out_proj"].values)
        assert torch.equal(a["out_proj"].idx, b["out_proj"].idx)
        assert torch.equal(a["in_proj"], b["in_proj"])
        assert torch.equal(a["conv_w"], b["conv_w"])
    for k in ("w_in", "w_gate", "w_out"):
        assert torch.equal(got["shared"]["mlp"][k].values,
                           want["shared"]["mlp"][k].values)
    assert torch.equal(got["embed"], want["embed"])


def test_converted_params_split_the_mamba_stack():
    jcfg, jp, tcfg, tp = build("zamba", "nm")
    assert len(tp["mamba"]) == tcfg.n_layers
    for l, layer in enumerate(tp["mamba"]):
        assert isinstance(layer["out_proj"], NMPack)
        np.testing.assert_array_equal(
            layer["out_proj"].values.numpy(),
            np.asarray(jp["mamba"]["out_proj"].values)[l])
        np.testing.assert_array_equal(layer["in_proj"].numpy(),
                                      np.asarray(jp["mamba"]["in_proj"])[l])
        np.testing.assert_array_equal(layer["A_log"].numpy(),
                                      np.asarray(jp["mamba"]["A_log"])[l])
    assert isinstance(tp["shared"]["mlp"]["w_in"], NMPack)
    assert tp["shared"]["attn"]["wq"].shape == (128, 128)


# --- model parity ------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, f) for a in TINY
                                        for f in ("dense", "nm")],
                ids=lambda p: "-".join(p))
def both(request):
    return build(*request.param)


def prefill_both(jcfg, jp, tcfg, tp, page_size, B=2, prompt=12, max_len=48):
    jcache, tcache = caches(jcfg, tcfg, B, max_len, page_size)
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t, c: JM.prefill(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    return jl, jcache, tcache


def assert_state_close(tcache, jcache):
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache["ssm"][k].numpy(),
                                   np.asarray(jcache["ssm"][k]), atol=ATOL,
                                   rtol=1e-5)


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_prefill_and_decode_logits_match_jax(both, page_size):
    jcfg, jp, tcfg, tp = both
    jl, jcache, tcache = prefill_both(jcfg, jp, tcfg, tp, page_size)
    assert_state_close(tcache, jcache)
    decode_both(jcfg, jp, tcfg, tp, jl, jcache, tcache,
                np.asarray([12, 15], np.int32))


@pytest.mark.parametrize("collect", [False, True], ids=["plain", "collect"])
@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_decode_block_matches_jax(both, page_size, collect):
    """A (2, 4) verify block at ragged offsets after the prefill: logits,
    the written state and, with ``collect_states``, the state after each
    block position."""
    jcfg, jp, tcfg, tp = both
    _, jcache, tcache = prefill_both(jcfg, jp, tcfg, tp, page_size)
    blk = np.random.default_rng(1).integers(
        1, jcfg.vocab_size, (2, 4)).astype(np.int32)
    pos = np.asarray([12, 12], np.int32)
    jl, jcache, jsnaps = jax.jit(lambda p, t, c, s: JM.decode_block(
        p, jcfg, t, c, s, collect_states=collect))(
            jp, jnp.asarray(blk), jcache, jnp.asarray(pos))
    got = TM.decode_block(tp, tcfg, torch.from_numpy(blk), tcache,
                          torch.from_numpy(pos), collect_states=collect)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    assert len(got) == (3 if collect else 2)
    assert_state_close(tcache, jcache)
    if collect:
        for k in ("conv", "ssm"):
            assert tuple(got[2][k].shape) == jsnaps[k].shape
            np.testing.assert_allclose(got[2][k].numpy(),
                                       np.asarray(jsnaps[k]), atol=ATOL,
                                       rtol=1e-5)


def test_mamba2_cache_has_no_kv_and_page_helpers_pass_through():
    _, _, tcfg, _ = build("mamba2", "dense")
    cache = TM.init_cache(tcfg, 2, 32, page_size=8, device="cpu")
    assert sorted(cache) == ["ssm"]
    assert TM.set_page_table(cache, np.ones((2, 4), np.int32)) is cache
    assert TM.cache_leaves(TM.page_view(cache, 2)) == \
        TM.cache_leaves(cache)
    assert TM.copy_page(cache, 1, 2) is cache
    blank = TM.blank_slot_cache(cache)
    assert tuple(blank["ssm"]["ssm"].shape[:2]) == (2, 1)
    zcache = TM.init_cache(TModelConfig(**ZAMBA), 2, 32, page_size=8,
                           device="cpu")
    assert zcache["kv"]["kp"].shape[0] == 2          # the two shared slots
    view = TM.page_view(zcache, 2)
    assert TM.cache_leaves(view["ssm"]) == TM.cache_leaves(zcache["ssm"])
    assert view["kv"]["ptab"].shape[-1] == 2


# --- Engine parity -------------------------------------------------------------------

def serve(eng, prompts=PROMPTS, budgets=BUDGETS):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


def engines(arch, kw, draft_seed=None):
    jcfg, jp, tcfg, tp = build(arch, "dense")
    jd = td = None
    if draft_seed is not None:
        _, jd, _, td = build(arch, "dense", seed=draft_seed)
    return (JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp,
                    draft_params=jd),
            TEngine(tcfg, TServeConfig(**kw), tp, draft_params=td,
                    device="cpu"))


SERVES = {**LAYOUTS, "spec": dict(spec_k=3),
          "spec-paged": dict(spec_k=3, page_size=8)}


@pytest.mark.parametrize("layout", sorted(SERVES))
@pytest.mark.parametrize("arch", sorted(ENGINE))
def test_greedy_transcripts_match_jax(arch, layout):
    """Three requests over two slots (budgets 5, 9, 3: a slot retires
    and is refilled from a blank state); speculation with the self
    draft.  Under monolithic speculation both first requests finish in
    the first chunk, so the third comes in a second wave: the JAX
    engine seeds that prefill from the retired state (ROADMAP queue 3;
    ``tests/test_engine.py::test_hybrid`` holds the first two only), so
    the third is held against ``reference_decode`` alone."""
    kw = dict(SERVE, **SERVES[layout])
    jeng, teng = engines(arch, kw)
    jout, tout = serve(jeng), serve(teng)
    n = 2 if layout == "spec" else 3
    assert tout[:n] == jout[:n]
    assert [len(t) for t in tout] == BUDGETS
    js, ts = jeng.stats(), teng.stats()
    assert ts.sync_count == js.sync_count == teng.sync_count
    assert (ts.drafted, ts.accepted) == (js.drafted, js.accepted)
    assert ts.peak_pages == js.peak_pages
    jcfg, jp, _, _ = build(arch, "dense")
    assert tout == [reference_decode(jp, jcfg, p, n, -1, 8, 64)
                    for p, n in zip(PROMPTS, BUDGETS)]


@pytest.mark.parametrize("layout", ["mono", "paged"])
@pytest.mark.parametrize("arch", sorted(ENGINE))
def test_garbage_draft_rolls_the_state_back(arch, layout):
    """The twin of ``test_hybrid_partial_acceptance``: a draft from
    another seed is rejected almost always, so every step rolls the
    recurrent state back to a snapshot; the tokens equal the plain
    loop's and the JAX engine's, drafted and accepted too."""
    kw = dict(SERVE, spec_k=3, **({"page_size": 8} if layout == "paged"
                                  else {}))
    jeng, teng = engines(arch, kw, draft_seed=42)
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    js, ts = jeng.stats(), teng.stats()
    assert ts.sync_count == js.sync_count
    assert (ts.drafted, ts.accepted) == (js.drafted, js.accepted)
    assert 0 < ts.drafted and teng.acceptance_rate() < 0.5
    plain = {k: v for k, v in kw.items() if k != "spec_k"}
    _, tplain = engines(arch, plain)
    assert tout == serve(tplain)


def test_second_wave_starts_from_zero_state():
    """Two requests fill both slots (a wave prefill), retire, and the same
    two come again as a second wave: the port's second wave equals
    ``reference_decode``, as its first does.  The JAX engine's second
    wave seeds the prefill from the recurrent state the first left, so it
    differs (a reference caveat, ROADMAP queue 3)."""
    prompts = PROMPTS[:2]
    kw = dict(SERVE)
    jeng, teng = engines("hybrid", kw)
    jcfg, jp, _, _ = build("hybrid", "dense")
    want = [reference_decode(jp, jcfg, p, 5, -1, 8, 64) for p in prompts]
    ptrs = None
    for wave in range(2):
        tout = serve(teng, prompts, [5, 5])
        jout = serve(jeng, prompts, [5, 5])
        assert tout == want, wave
        assert teng.stats().prefills == 2 * (wave + 1)
        if wave == 0:
            assert jout == want
            ptrs = [t.data_ptr() for t in TM.cache_leaves(teng._cache)]
        else:
            assert jout != want
    assert [t.data_ptr() for t in TM.cache_leaves(teng._cache)] == ptrs
