"""The dense-lm features of stablelm-12b and qwen2-vl-72b in the port
against the JAX package, on the CPU at float32 (JAX on a 1x1 mesh with
Auto axes, weights carried over with ``convert.params_from_numpy``):

* the port's ``config()``, ``reduced()`` and ``sparse()`` of both
  architectures equal the JAX ones field by field;
* M-RoPE: ``layers.apply_rope`` with distinct (t, h, w) position triples
  equals the JAX one, equal triples equal standard RoPE, and malformed
  sections or positions raise;
* model parity: prefill and per-slot decode logits within 1e-4 (fp32
  caches on both sides), monolithic and paged, dense and 2:4, for an
  untied head at ``head_dim=160`` (G = 4, as stablelm) and for M-RoPE
  with ``input_mode="embeds"`` (its embeds prefill held against the JAX
  ``prefill(batch={"embeds": ...})``);
* Engine parity: greedy transcripts and ``sync_count`` equal the JAX
  ``Engine`` and ``conftest.reference_decode``, both layouts, both tiny
  configs, plus speculation (self and 2:4 pack draft) on the untied one;
* every config of the JAX registry passes ``_check_ported``: the gemma
  pair serves a CPU prefill (its suite is ``test_torch_gemma.py``); the
  MoE configs pass it (their own suite is ``test_torch_moe.py``), while
  their speculation and prefix sharing stay refused; the SSM/hybrid
  configs and the enc-dec seamless pass it (their suites are
  ``test_torch_ssm.py``, ``test_torch_hybrid.py`` and
  ``test_torch_encdec.py``), while their prefix sharing stays refused;
  the config registry refuses a name it does not know.
"""

import dataclasses
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
from repro.models import layers as JL
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparse_linear import make_draft_params
from repro_torch.core.sparsity import PACK_TYPES, NMPack
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_engine import BUDGETS, LAYOUTS, PROMPTS, SERVE
from test_torch_model import (ATOL, NM, PROJECTIONS, flatten, identity_table,
                              jax_mesh)

#: an untied head at head_dim 160 with G = 4 query heads per kv head, as
#: stablelm-12b; every projection divides g = 128 (q 2560, kv 640)
UNTIED = dict(name="tiny-stablelm", n_layers=2, d_model=256, vocab_size=512,
              n_heads=16, n_kv_heads=4, head_dim=160, d_ff=512,
              tie_embeddings=False, dtype="float32", remat=False)
#: M-RoPE over head_dim 64 with embeds input, as qwen2-vl-72b
MROPE = dict(name="tiny-qwen2-vl", n_layers=2, d_model=256, vocab_size=512,
             n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
             mrope_sections=(8, 12, 12), input_mode="embeds",
             rope_theta=1_000_000.0, dtype="float32", remat=False)
TINY = {"untied": UNTIED, "mrope": MROPE}
PORTED = ("stablelm_12b", "qwen2_vl_72b")


def configs(arch, fmt):
    """(JAX config, port config) of a tiny config, dense or 2:4."""
    kw = TINY[arch]
    if fmt == "dense":
        return JModelConfig(**kw), TModelConfig(**kw)
    return (JModelConfig(**kw, mlp_sparsity=JSparsity(**NM),
                         attn_sparsity=JSparsity(**NM)),
            TModelConfig(**kw, mlp_sparsity=TSparsity(**NM),
                         attn_sparsity=TSparsity(**NM)))


def build(arch, fmt, pack=True):
    """(JAX config, JAX params, port config, port params on the CPU); the
    2:4 params packed unless ``pack`` is False (a pack draft's dense
    verify weights)."""
    jcfg, tcfg = configs(arch, fmt)
    jp = JM.init_model(jax.random.key(0), jcfg)
    if fmt != "dense" and pack:
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


def to_port(jcfg):
    """The port's ModelConfig with every field of a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for k, v in kw.items():
        if isinstance(v, JSparsity):
            kw[k] = TSparsity(**dataclasses.asdict(v))
    return TModelConfig(**kw)


# --- configs -------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["config", "reduced", "sparse"])
@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_jax(arch, fn):
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), fn)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   fn)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port(jcfg) == tcfg
    if fn != "reduced":
        assert tcfg.head_dim == (160 if arch == "stablelm_12b" else 128)


def test_registry_names_the_ported_archs():
    assert TC.get("stablelm-12b") == to_port(JC.get("stablelm-12b"))
    assert TC.get_reduced("qwen2-vl-72b") == \
        to_port(JC.get_reduced("qwen2-vl-72b"))
    cfg = TC.get("stablelm-12b")
    assert not cfg.tie_embeddings and cfg.head_dim == cfg.d_model // 32
    assert TC.get("qwen2-vl-72b").mrope_sections == (16, 24, 24)
    assert TC.get("dbrx-132b") == to_port(JC.get("dbrx-132b"))
    assert TC.get("zamba2-1.2b") == to_port(JC.get("zamba2-1.2b"))
    assert TC.get("seamless-m4t-large-v2") == \
        to_port(JC.get("seamless-m4t-large-v2"))
    assert TC.get("gemma2-27b") == to_port(JC.get("gemma2-27b"))
    with pytest.raises(ValueError, match="unknown architecture"):
        TC.get("gemma4-9b")


# --- M-RoPE ----------------------------------------------------------------------

def test_mrope_equals_jax_on_distinct_triples():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 8, 3)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                         mrope_sections=(8, 12, 12))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        (8, 12, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # each section rotates by its own component: not standard RoPE of any
    std = [TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., c]),
                         1e6) for c in range(3)]
    assert all(not torch.allclose(got, s) for s in std)


def test_mrope_reduces_to_rope_on_equal_triples():
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 8, 4, 32)).astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    std = TL.apply_rope(x, pos, 10_000.0)
    tri = pos[..., None].expand(2, 8, 3)
    mr = TL.apply_rope(x, tri, 10_000.0, (4, 6, 6))
    assert torch.equal(std, mr)


def test_mrope_rejects_bad_sections_and_positions():
    x = torch.zeros((1, 4, 2, 32))
    tri = torch.zeros((1, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="sections"):
        TL.apply_rope(x, tri, 1e4, (4, 6, 8))
    with pytest.raises(ValueError, match=r"\(\.\.\., L, 3\)"):
        TL.apply_rope(x, torch.zeros((1, 4), dtype=torch.int32), 1e4,
                      (4, 6, 6))
    with pytest.raises(ValueError, match="standard RoPE"):
        TL.apply_rope(x, tri, 1e4)


# --- model parity ------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, f) for a in TINY
                                        for f in ("dense", "nm")],
                ids=lambda p: "-".join(p))
def both(request):
    return build(*request.param)


def caches(jcfg, tcfg, B, max_len, page_size):
    """fp32 caches on both sides (the JAX default is bf16), the paged ones
    with an identity page table."""
    jcache = JM.init_cache(jcfg, B, max_len, page_size=page_size,
                           dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, max_len, page_size=page_size,
                           dtype=torch.float32, device="cpu")
    if page_size:
        table = identity_table(B, max_len // page_size)
        jcache = JM.set_page_table(jcache, jnp.asarray(table))
        TM.set_page_table(tcache, table)
    return jcache, tcache


def decode_both(jcfg, jp, tcfg, tp, jl, jcache, tcache, pos, steps=4):
    """``steps`` greedy per-slot decode steps on both sides from the JAX
    prefill logits ``jl``; logits equal within ``ATOL`` at every step."""
    jdecode = jax.jit(lambda p, t, c, s: JM.decode_step(p, jcfg, t, c, s))
    tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size], -1).astype(np.int32)
    for _ in range(steps):
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)
        pos = pos + 1


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


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
@pytest.mark.parametrize("fmt", ["dense", "nm"])
def test_embeds_prefill_matches_jax(fmt, page_size):
    """An M-RoPE ``input_mode="embeds"`` prompt given as precomputed
    embeddings (not rows of the table), then decode from its cache."""
    jcfg, jp, tcfg, tp = build("mrope", fmt)
    B, prompt, max_len = 2, 10, 48
    jcache, tcache = caches(jcfg, tcfg, B, max_len, page_size)
    emb = np.random.default_rng(1).normal(
        size=(B, prompt, jcfg.d_model)).astype(np.float32) * 0.1
    jl, jcache = jax.jit(lambda p, e, c: JM.prefill(
        p, jcfg, {"embeds": e}, c))(jp, jnp.asarray(emb), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"embeds": torch.from_numpy(emb)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    decode_both(jcfg, jp, tcfg, tp, jl, jcache, tcache,
                np.asarray([prompt, prompt + 2], np.int32))


def test_embeds_of_the_tokens_equal_the_token_prefill():
    """Embeds that are the table's rows of the prompt give the token
    prefill's logits exactly."""
    _, _, tcfg, tp = build("mrope", "nm")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, tcfg.vocab_size, (2, 9)).astype(np.int32))
    got = [TM.prefill(tp, tcfg, batch, TM.init_cache(
        tcfg, 2, 32, page_size=8, device="cpu"))[0]
        for batch in ({"tokens": toks}, {"embeds": tp["embed"][toks.long()]})]
    assert torch.equal(*got)


def test_untied_params_carry_a_dense_head(both):
    """The untied config's head arrives as its own dense table; every
    projection of the 2:4 configs is an NMPack."""
    jcfg, jp, tcfg, tp = both
    assert ("unembed" in tp) == (not tcfg.tie_embeddings)
    if "unembed" in tp:
        np.testing.assert_array_equal(tp["unembed"].numpy(),
                                      np.asarray(jp["unembed"]))
        assert not isinstance(tp["unembed"], PACK_TYPES)
        assert not torch.equal(tp["unembed"], tp["embed"])
    for fam, names in PROJECTIONS:
        for name in names:
            for layer in tp["layers"]:
                assert isinstance(layer[fam][name], NMPack) == (
                    tcfg.mlp_sparsity.format == "nm")


def test_init_model_draws_the_untied_head():
    for arch in PORTED:
        cfg = importlib.import_module(f"repro_torch.configs.{arch}").reduced()
        p = TM.init_model(cfg, seed=0, device="cpu")
        assert ("unembed" in p) == (not cfg.tie_embeddings)
        if "unembed" in p:
            assert p["unembed"].shape == p["embed"].shape
            assert not torch.equal(p["unembed"], p["embed"])
        cache = TM.init_cache(cfg, 1, 16, page_size=8, device="cpu")
        tok = torch.ones((1, 4), dtype=torch.int32)
        logits, _ = TM.prefill(p, cfg, {"tokens": tok}, cache)
        assert logits.shape == (1, cfg.vocab_padded)
        assert torch.isfinite(logits).all()


# --- Engine parity -----------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(TINY))
def served(request):
    jcfg, jp, tcfg, tp = build(request.param, "nm")
    oracle = [reference_decode(jp, jcfg, p, n, SERVE["eos_token"],
                               SERVE["prompt_pad"], SERVE["max_len"])
              for p, n in zip(PROMPTS, BUDGETS)]
    return jcfg, jp, tcfg, tp, oracle


def serve(eng, prompts=PROMPTS, budgets=BUDGETS):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_greedy_transcripts_match_jax(served, layout):
    jcfg, jp, tcfg, tp, oracle = served
    kw = dict(SERVE, **LAYOUTS[layout])
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout == oracle
    assert [len(t) for t in tout] == BUDGETS
    assert teng.sync_count == jeng.sync_count


@pytest.fixture(scope="module")
def untied_dense():
    """The untied config under 2:4 over dense weights (a pack draft packs
    them; the verify stays dense)."""
    return build("untied", "nm", pack=False)


@pytest.mark.parametrize("draft", ["self", "pack"])
def test_speculation_on_the_untied_head_matches_jax(untied_dense, draft):
    jcfg, jp, tcfg, tp = untied_dense
    kw = dict(SERVE, spec_k=3, spec_draft=draft, page_size=8)
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    jout, tout = serve(jeng), serve(teng)
    assert tout == jout
    js, ts = jeng.stats(), teng.stats()
    assert ts.sync_count == js.sync_count
    assert (ts.drafted, ts.accepted) == (js.drafted, js.accepted)
    assert ts.peak_pages == js.peak_pages and ts.drafted > 0
    plain = {k: v for k, v in kw.items() if k not in ("spec_k", "spec_draft")}
    assert tout == serve(TEngine(tcfg, TServeConfig(**plain), tp,
                                 device="cpu"))
    if draft == "pack":
        assert {r["kernel"] for r in teng.draft_plan} == {"nm_spmm"}


def test_pack_draft_shares_the_untied_head(untied_dense):
    """The draft's memory contract: every unpacked leaf, the untied head
    too, is the verify params' own tensor."""
    _, _, tcfg, tp = untied_dense
    d = make_draft_params(tp, tcfg)
    assert d["unembed"] is tp["unembed"] and d["embed"] is tp["embed"]
    assert all(isinstance(layer[fam][name], NMPack)
               for layer in d["layers"] for fam, names in PROJECTIONS
               for name in names)


# --- the other families: what passes and what stays refused ---------------------------

#: the MoE family: ported (ROADMAP queue 1 item 11b), its speculation and
#: prefix sharing not yet (item 16)
MOE = ("qwen2_moe_a2_7b", "dbrx_132b")
#: the SSM/hybrid family (item 11c) and the enc-dec family (item 11d):
#: ported, prefix sharing refused as in the JAX engine (their per-request
#: state lies outside the page pool)
HYBRID = ("mamba2_130m", "zamba2_1_2b")
ENCDEC = ("seamless_m4t_large_v2",)
#: the gemma pair (item 11e): ported, nothing refused
GEMMA = ("gemma2_27b", "gemma3_1b")
REFUSED = [a for a in JC.list_archs()
           if a not in ("qwen3_0_6b", *PORTED, *MOE)]


@pytest.mark.parametrize("arch", sorted(REFUSED + list(MOE)))
def test_check_ported_refuses_the_other_families(arch):
    """Every arch passes ``_check_ported``.  The gemma pair's CPU
    ``init_model``/``init_cache`` serve a prefill with finite logits.
    What stays refused for the MoE archs is speculation and prefix
    sharing; the SSM/hybrid archs and the enc-dec seamless serve a
    prefill, and what stays refused for them is prefix sharing."""
    cfg = to_port(JC.get_reduced(arch))
    if arch in MOE:
        TM._check_ported(cfg)
        params = TM.init_model(cfg, device="cpu")
        for kw in (dict(spec_k=2), dict(prefix_cache=True)):
            with pytest.raises(NotImplementedError, match="item 16"):
                TEngine(cfg, TServeConfig(**SERVE, page_size=8, **kw),
                        params, device="cpu")
        return
    if arch in HYBRID + ENCDEC:
        TM._check_ported(cfg)
        params = TM.init_model(cfg, device="cpu")
        cache = TM.init_cache(cfg, 1, 16, page_size=8, device="cpu")
        logits, _ = TM.prefill(params, cfg, {"tokens": torch.ones(
            (1, 4), dtype=torch.int32)}, cache)
        assert torch.isfinite(logits).all()
        with pytest.raises(ValueError, match=f"'{TM.family(cfg)}' family"):
            TEngine(cfg, TServeConfig(**SERVE, page_size=8,
                                      prefix_cache=True), params,
                    device="cpu")
        return
    assert arch in GEMMA
    TM._check_ported(cfg)
    params = TM.init_model(cfg, device="cpu")
    assert all("ln_attn_post" in layer for layer in params["layers"])
    cache = TM.init_cache(cfg, 1, 32, page_size=8, device="cpu")
    TM.set_page_table(cache, np.arange(1, 5, dtype=np.int32)[None])
    logits, _ = TM.prefill(params, cfg, {"tokens": torch.arange(
        1, 21, dtype=torch.int32)[None]}, cache)
    assert logits.shape == (1, cfg.vocab_padded)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", PORTED)
def test_check_ported_accepts_stablelm_and_qwen2_vl(arch):
    for fn in ("config", "reduced", "sparse"):
        TM._check_ported(to_port(getattr(JC._module(arch), fn)()))


@pytest.mark.parametrize("arch", MOE)
def test_check_ported_accepts_the_moe_family(arch):
    for fn in ("config", "reduced", "sparse"):
        TM._check_ported(to_port(getattr(JC._module(arch), fn)()))
