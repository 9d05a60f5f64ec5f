"""The encoder-decoder family of the port (``repro_torch/models/encdec.py``,
seamless-m4t-large-v2) against the JAX package, on the CPU at float32 (JAX
on a 1x1 mesh with Auto axes, weights carried over with
``convert.params_from_numpy``):

* the configs field by field; at the published widths head_dim 64, the
  padded vocabulary, and ``sparse()`` packing every encoder and decoder
  ``w_in``/``w_out`` 2:4 with every attention projection dense, the
  engine's plans listing those packs at M = slots and M = prompt rows;
* the ungated MLP (``w_out(gelu(w_in x))``) at fp32 and bf16;
* ``encode`` of random frames, and ``prefill`` with a random source at
  ``src_len`` 6 and 12 under an 8-token prompt (more queries than source
  rows, and fewer): logits and the cross cache, then per-slot decode
  steps and a verify block, monolithic and paged, dense and 2:4 (d_model
  128 with g = 64, so both MLP projections pack);
* the null-source prefill the ``Engine`` runs equals the JAX one, and a
  random source moves the logits (the encoder is alive);
* ``Engine`` greedy transcripts and ``sync_count`` equal the JAX
  ``Engine`` and ``conftest.reference_decode`` over two waves, in four
  layouts (monolithic, paged, speculative, speculative paged), one JAX
  engine per layout; a garbage draft gives the plain loop's tokens at
  low acceptance; the spec loop over a random-source prefill equals
  sequential decode steps (the twin of
  ``tests/test_spec.py::test_encdec_spec_loop``); prefix sharing is
  refused; a sampled serve is reproducible from its seed.
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
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparse_linear import pack_params
from repro_torch.core.sparsity import NMPack
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from repro_torch.serving.loops import build_spec_decode_loop
from test_torch_engine import BUDGETS, LAYOUTS, PROMPTS, SERVE
from test_torch_families import to_port
from test_torch_model import ATOL, flatten, jax_mesh

NM = dict(format="nm", n=2, m=4, block_n=64)
ENCDEC = dict(is_encoder_decoder=True, input_mode="embeds", mlp_gated=False,
              dtype="float32", remat=False)
#: model-level parity: 4 heads over 2 (G = 2, D = 32); under 2:4 with
#: g = 64 ``w_in`` (128 → 256) and ``w_out`` (256 → 128) both pack
TINY = dict(name="tiny-seamless", n_layers=2, n_encoder_layers=2,
            d_model=128, vocab_size=512, n_heads=4, n_kv_heads=2, d_ff=256,
            **ENCDEC)
#: the engine config: 2 + 2 layers, d_model 64, 4 heads over 2
ENGINE = dict(name="ed", n_layers=2, n_encoder_layers=2, d_model=64,
              vocab_size=256, n_heads=4, n_kv_heads=2, d_ff=128, **ENCDEC)
SERVES = {**LAYOUTS, "spec": dict(spec_k=2),
          "spec-paged": dict(spec_k=2, page_size=8)}


@functools.lru_cache(maxsize=None)
def build(which="tiny", fmt="dense", seed=0):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    kw = {"tiny": TINY, "engine": ENGINE}[which]
    if fmt == "dense":
        jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    else:
        jcfg = JModelConfig(**kw, mlp_sparsity=JSparsity(**NM))
        tcfg = TModelConfig(**kw, mlp_sparsity=TSparsity(**NM))
    jp = JM.init_model(jax.random.key(seed), jcfg)
    if fmt != "dense":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


# --- configs and packing -----------------------------------------------------

@pytest.mark.parametrize("fn", ["config", "reduced", "sparse"])
def test_configs_equal_jax(fn):
    arch = "seamless_m4t_large_v2"
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), fn)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   fn)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port(jcfg) == tcfg
    assert TM.family(tcfg) == JM.family(jcfg) == "encdec"
    TM._check_ported(tcfg)


def test_published_shapes():
    cfg = TC.get("seamless-m4t-large-v2")
    assert cfg == to_port(JC.get("seamless-m4t-large-v2"))
    assert (cfg.n_encoder_layers, cfg.n_layers) == (24, 24)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (64, 16, 16)
    assert cfg.vocab_padded == 256512 and cfg.tie_embeddings
    assert not cfg.mlp_gated and cfg.input_mode == "embeds"


def test_sparse_packs_the_mlps_at_published_widths():
    """``init_model(packed=True)`` at the published widths, cut to one
    encoder and one decoder layer (and a small vocabulary: the embedding
    does not decide any pack): every ``w_in``/``w_out`` is a 2:4 pack,
    every self and cross projection dense, as the JAX ``pack_params``
    decides.  The engine's plans list exactly those packs, at M = slots
    for decode and M = prompt rows for prefill."""
    from repro_torch.configs import seamless_m4t_large_v2
    cfg = dataclasses.replace(seamless_m4t_large_v2.sparse(), n_layers=1,
                              n_encoder_layers=1, layer_kinds=(),
                              vocab_size=512)
    p = TM.init_model(cfg, seed=0, device="cpu", packed=True)
    for layer, attns in ((p["encoder"][0], ("attn",)),
                         (p["decoder"][0], ("self_attn", "cross_attn"))):
        assert sorted(layer["mlp"]) == ["w_in", "w_out"]
        assert all(isinstance(w, NMPack) for w in layer["mlp"].values())
        assert (layer["mlp"]["w_in"].K, layer["mlp"]["w_in"].N) == \
            (1024, 8192)
        for a in attns:
            assert all(isinstance(w, torch.Tensor) and w.shape == (1024, 1024)
                       for w in layer[a].values())
    scfg = TServeConfig(slots=8, max_len=512, prompt_pad=128, page_size=16)
    eng = TEngine(cfg, scfg, p, device="cpu")
    for plan, M in ((eng.decode_plan, 8), (eng.prefill_plan, 128)):
        assert sorted(r["param"] for r in plan) == [
            "decoder/0/mlp/w_in", "decoder/0/mlp/w_out",
            "encoder/0/mlp/w_in", "encoder/0/mlp/w_out"]
        assert {r["M"] for r in plan} == {M}
        assert {r["kernel"] for r in plan} == {"nm_spmm"}


def test_packed_init_equals_pack_params_of_the_dense_init():
    cfg = TModelConfig(**TINY, mlp_sparsity=TSparsity(**NM))
    got = TM.init_model(cfg, seed=3, device="cpu", packed=True)
    want = pack_params(TM.init_model(cfg, seed=3, device="cpu"), cfg)
    for stack in ("encoder", "decoder"):
        for a, b in zip(got[stack], want[stack]):
            for k in ("w_in", "w_out"):
                assert torch.equal(a["mlp"][k].values, b["mlp"][k].values)
                assert torch.equal(a["mlp"][k].idx, b["mlp"][k].idx)
    assert torch.equal(got["decoder"][1]["cross_attn"]["wk"],
                       want["decoder"][1]["cross_attn"]["wk"])
    assert torch.equal(got["embed"], want["embed"])


def test_converted_params_split_the_layer_stacks():
    jcfg, jp, tcfg, tp = build("tiny", "nm")
    assert (len(tp["encoder"]), len(tp["decoder"])) == (2, 2)
    for stack in ("encoder", "decoder"):
        for l, layer in enumerate(tp[stack]):
            w = layer["mlp"]["w_out"]
            assert isinstance(w, NMPack) and "w_gate" not in layer["mlp"]
            np.testing.assert_array_equal(
                w.values.numpy(),
                np.asarray(jp[stack]["mlp"]["w_out"].values)[l])
    np.testing.assert_array_equal(
        tp["decoder"][1]["cross_attn"]["wq"].numpy(),
        np.asarray(jp["decoder"]["cross_attn"]["wq"])[1])
    assert sorted(tp) == sorted(jp)


# --- layer and model parity --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ungated_mlp_matches_jax(dtype):
    """``w_out(gelu(w_in x))`` with the tanh gelu in fp32: within 1e-5 at
    fp32, within one bf16 step of the output's scale at bf16."""
    rng = np.random.default_rng(4)
    w_in = rng.normal(size=(128, 256)).astype(np.float32) / 11
    w_out = rng.normal(size=(256, 128)).astype(np.float32) / 16
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = TL.DTYPES[dtype]
    want = JL.mlp({"w_in": jnp.asarray(w_in, jdt),
                   "w_out": jnp.asarray(w_out, jdt)},
                  jnp.asarray(x, jdt), gated=False)
    got = TL.mlp({"w_in": torch.from_numpy(w_in).to(tdt),
                  "w_out": torch.from_numpy(w_out).to(tdt)},
                 torch.from_numpy(x).to(tdt), gated=False)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    tol = 1e-5 if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("fmt", ["dense", "nm"])
def test_encode_matches_jax(fmt):
    jcfg, jp, tcfg, tp = build("tiny", fmt)
    src = np.random.default_rng(5).normal(size=(2, 12, 128)).astype(
        np.float32)
    want = jax.jit(lambda p, s: JED.encode(p, jcfg, s))(jp, jnp.asarray(src))
    got = TED.encode(tp, tcfg, torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def caches(jcfg, tcfg, B, max_len, src_len, page_size):
    """fp32 caches on both sides (the JAX default is bf16); the paged self
    caches with an identity page table."""
    jcache = JM.init_cache(jcfg, B, max_len, src_len=src_len,
                           dtype=jnp.float32, page_size=page_size)
    tcache = TM.init_cache(tcfg, B, max_len, src_len=src_len,
                           dtype=torch.float32, page_size=page_size,
                           device="cpu")
    if page_size:
        table = np.arange(1, B * (max_len // page_size) + 1,
                          dtype=np.int32).reshape(B, -1)
        jcache = JM.set_page_table(jcache, jnp.asarray(table))
        TM.set_page_table(tcache, table)
    return jcache, tcache


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("src_len", [6, 12], ids=["Lq>Ls", "Lq<Ls"])
@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
@pytest.mark.parametrize("fmt", ["dense", "nm"])
def test_prefill_decode_and_block_match_jax(fmt, page_size, src_len):
    """A random source under an 8-token prompt: prefill logits and the
    cross cache, then 4 per-slot decode steps (ragged positions) and a
    T = 3 verify block, each within 1e-4."""
    jcfg, jp, tcfg, tp = build("tiny", fmt)
    B, max_len = 2, 48
    jcache, tcache = caches(jcfg, tcfg, B, max_len, src_len, page_size)
    rng = np.random.default_rng(src_len)
    src = rng.normal(size=(B, src_len, 128)).astype(np.float32)
    toks = rng.integers(1, jcfg.vocab_size, (B, 8)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, s, t, c: JM.prefill(
        p, jcfg, {"src": s, "tokens": t}, c))(
            jp, jnp.asarray(src), jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"src": torch.from_numpy(src),
                                       "tokens": torch.from_numpy(toks)},
                            tcache)
    close(tl, jl)
    for k in ("k", "v"):
        close(tcache["cross"][k], jcache["cross"][k])
    pos = np.asarray([8, 10], np.int32)
    jdecode = jax.jit(lambda p, t, c, s: JM.decode_step(p, jcfg, t, c, s))
    tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size], -1).astype(np.int32)
    for _ in range(4):
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)
        pos = pos + 1
    blk = rng.integers(1, jcfg.vocab_size, (B, 3)).astype(np.int32)
    jl, _, _ = jax.jit(lambda p, t, c, s: JM.decode_block(p, jcfg, t, c, s))(
        jp, jnp.asarray(blk), jcache, jnp.asarray(pos))
    tl, tcache = TM.decode_block(tp, tcfg, torch.from_numpy(blk), tcache,
                                 torch.from_numpy(pos))
    assert tuple(tl.shape) == (B, 3, jcfg.vocab_padded)
    close(tl, jl)


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_null_source_prefill_matches_jax(page_size):
    """Tokens only (what the ``Engine`` feeds): both sides encode zeros
    sized to the cross cache.  A random source moves the logits, so the
    tests above cannot pass with a dead encoder."""
    jcfg, jp, tcfg, tp = build("tiny", "nm")
    jcache, tcache = caches(jcfg, tcfg, 2, 32, 32, page_size)
    toks = np.random.default_rng(7).integers(
        1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jl, _ = jax.jit(lambda p, t, c: JM.prefill(p, jcfg, {"tokens": t}, c))(
        jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            tcache)
    close(tl, jl)
    assert not tcache["cross"]["k"].any()
    src = torch.randn((2, 32, 128), generator=torch.Generator().manual_seed(1))
    moved, _ = TM.prefill(tp, tcfg, {"src": src,
                                     "tokens": torch.from_numpy(toks)},
                          tcache)
    assert (moved - tl).abs().max() > 0.1


def test_cache_helpers_on_a_paged_self_and_monolithic_cross_cache():
    """Page helpers act on the paged ``self`` subtree and pass ``cross``
    through; blank and merge act on ``cross``'s batch axis, in place."""
    _, _, tcfg, _ = build("tiny", "dense")
    cache = TM.init_cache(tcfg, 2, 32, src_len=6, page_size=8, device="cpu")
    assert sorted(cache) == ["cross", "self"]
    assert tuple(cache["cross"]["k"].shape) == (2, 2, 6, 2, 32)
    assert tuple(cache["self"]["kp"].shape) == (2, 9, 8, 2, 32)
    leaves = TM.cache_leaves(cache)
    assert len(leaves) == 5
    ptrs = [t.data_ptr() for t in leaves]
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    assert TM.set_page_table(cache, table) is cache
    assert (cache["self"]["ptab"][1] == torch.from_numpy(table)).all()
    view = TM.page_view(cache, 2)
    assert view["self"]["ptab"].shape[-1] == 2
    assert all(a is b for a, b in zip(TM.cache_leaves(view["cross"]),
                                      TM.cache_leaves(cache["cross"])))
    assert TM.unpage_view(view, cache) is cache
    cache["self"]["kp"][:, 1] = 3.0
    TM.copy_page(cache, 1, 2)
    assert (cache["self"]["kp"][:, 2] == 3.0).all()
    blank = TM.blank_slot_cache(cache)
    assert blank["self"]["kp"] is cache["self"]["kp"]
    assert tuple(blank["cross"]["v"].shape) == (2, 1, 6, 2, 32)
    assert not blank["cross"]["v"].any()
    blank["cross"]["k"].fill_(2.0)
    TM.merge_cache_slot(cache, blank, 1)
    assert (cache["cross"]["k"][:, 1] == 2.0).all()
    assert not cache["cross"]["k"][:, 0].any()
    assert [t.data_ptr() for t in TM.cache_leaves(cache)] == ptrs


# --- Engine parity -----------------------------------------------------------

def serve(eng, prompts=PROMPTS, budgets=BUDGETS):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


@functools.lru_cache(maxsize=None)
def waves(layout):
    """Two waves of the three requests (budgets 5, 9, 3 over two slots)
    on one JAX and one port engine of ``layout``: per wave, (JAX tokens,
    port tokens, JAX stats, port stats), the stats of that wave alone."""
    jcfg, jp, tcfg, tp = build("engine")
    kw = dict(SERVE, **SERVES[layout])
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    out = []
    for _ in range(2):
        for eng in (jeng, teng):
            eng.reset_stats()
        out.append((serve(jeng), serve(teng), jeng.stats(), teng.stats()))
    return out


@functools.lru_cache(maxsize=None)
def oracle():
    jcfg, jp, _, _ = build("engine")
    return [reference_decode(jp, jcfg, p, n, SERVE["eos_token"],
                             SERVE["prompt_pad"], SERVE["max_len"])
            for p, n in zip(PROMPTS, BUDGETS)]


@pytest.mark.parametrize("wave", [0, 1], ids=["first", "second"])
@pytest.mark.parametrize("layout", sorted(SERVES))
def test_greedy_transcripts_match_jax(layout, wave):
    """Greedy tokens of each wave equal the JAX ``Engine``'s and the
    one-sequence oracle's; ``sync_count``, prefills and (speculative)
    drafted and accepted counts equal the JAX engine's."""
    jout, tout, js, ts = waves(layout)[wave]
    assert tout == jout == oracle()
    assert ts.sync_count == js.sync_count > 0
    assert ts.prefills == js.prefills
    assert (ts.drafted, ts.accepted) == (js.drafted, js.accepted)
    assert (ts.drafted > 0) == ("spec" in layout)
    assert ts.peak_pages == js.peak_pages


@pytest.mark.parametrize("layout", ["mono", "paged"])
def test_garbage_draft_gives_the_plain_loop_tokens(layout):
    """A draft from another seed is rejected almost always; the committed
    tokens still equal the plain loop's (the oracle's)."""
    _, _, tcfg, tp = build("engine")
    _, _, _, garbage = build("engine", seed=42)
    kw = dict(SERVE, spec_k=2, **LAYOUTS[layout])
    eng = TEngine(tcfg, TServeConfig(**kw), tp, draft_params=garbage,
                  device="cpu")
    assert serve(eng) == oracle()
    st = eng.stats()
    assert st.drafted > 0 and eng.acceptance_rate() < 0.5


def test_spec_loop_over_a_source_equals_sequential_decode():
    """The twin of ``tests/test_spec.py::test_encdec_spec_loop``: after a
    prefill of a random source (``src_len`` 6 under an 8-token prompt)
    the speculative loop's greedy tokens equal sequential decode steps'."""
    _, _, tcfg, tp = build("engine")
    scfg = TServeConfig(slots=2, max_len=32, prompt_pad=8, max_new_tokens=8,
                        decode_chunk=3, spec_k=2, eos_token=-1)
    gen = torch.Generator().manual_seed(2)
    src = torch.randn((2, 6, 64), generator=gen)
    toks = torch.randint(1, 250, (2, 8), generator=gen, dtype=torch.int32)
    cache = TM.init_cache(tcfg, 2, 32, src_len=6, device="cpu")
    logits, cache = TM.prefill(tp, tcfg, {"src": src, "tokens": toks}, cache)
    first = torch.argmax(logits[:, :tcfg.vocab_size], -1).to(torch.int32)
    seq = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    want = [[int(first[b])] for b in range(2)]
    tok, pos = first, torch.full((2,), 8, dtype=torch.int32)
    for _ in range(scfg.max_new_tokens - 1):
        lg, seq = TM.decode_step(tp, tcfg, tok, seq, pos)
        tok = torch.argmax(lg[:, :tcfg.vocab_size], -1).to(torch.int32)
        for b in range(2):
            want[b].append(int(tok[b]))
        pos = pos + 1
    loop = build_spec_decode_loop(tcfg, scfg)
    state = {"tok": first, "pos": torch.full((2,), 8, dtype=torch.int32),
             "done": torch.zeros((2,), dtype=torch.bool),
             "left": torch.full((2,), scfg.max_new_tokens,
                                dtype=torch.int32)}
    got = [[] for _ in range(2)]
    while not bool(state["done"].all()):
        cache, state, blk, em, _, _ = loop(tp, tp, cache, state, None)
        for t in range(blk.shape[0]):
            for b in range(2):
                if em[t, b]:
                    got[b].append(int(blk[t, b]))
    assert got == want


def test_prefix_cache_is_refused():
    _, _, tcfg, tp = build("engine")
    with pytest.raises(ValueError, match="'encdec' family"):
        TEngine(tcfg, TServeConfig(**SERVE, page_size=8, prefix_cache=True),
                tp, device="cpu")


def test_sampled_serve_is_reproducible_from_its_seed():
    """Sampled serving at temperature 1: every request reaches its budget
    within the vocabulary, and two engines with one seed emit the same
    tokens (a third with another seed does not)."""
    _, _, tcfg, tp = build("engine")
    kw = dict(SERVE, page_size=8, temperature=1.0)
    outs = [serve(TEngine(tcfg, TServeConfig(**kw, seed=s), tp,
                          device="cpu")) for s in (3, 3, 4)]
    assert [len(t) for t in outs[0]] == BUDGETS
    assert all(0 <= t < tcfg.vocab_size for o in outs[0] for t in o)
    assert outs[0] == outs[1] != outs[2]
