"""The gemma pair (gemma2-27b, gemma3-1b) in the port against the JAX
package, on the CPU at float32 (JAX on a 1x1 mesh with Auto axes,
weights carried over with ``convert.params_from_numpy``):

* the port's ``config()``, ``reduced()`` and ``sparse()`` of both equal
  the JAX ones field by field, and ``interleave_kinds`` equals the JAX
  one;
* the scaled embedding rounds ``sqrt(d_model)`` to the table's dtype
  first, as JAX does (68.0 and 34.0 in bfloat16);
* the plain paged attention (the CPU path, and the card's oracle) with a
  sliding window and a tanh softcap equals the JAX ``mha_ref`` over the
  gathered view, one query and a Q = 4 block;
* model parity: prefill, per-slot decode and verify-block logits within
  1e-4 at positions past the window, monolithic and paged, dense and
  2:4, on both reduced configs (fp32 caches on both sides);
* Engine parity on gemma-shaped configs with an **untied** head (with
  the tied head and scaled embeddings of the smoke configs, random
  weights give a transcript that repeats the last prompt token, which
  would pass with the window and softcap wrong): monolithic, paged,
  speculation with a self and a 2:4 pack draft, and prefix sharing;
  tokens, ``sync_count``, drafted and accepted equal the JAX
  ``Engine``'s, and every transcript holds more than one distinct token.

One JAX engine is built per ``ServeConfig`` and its scripts run on it
back to back, as in ``test_torch_prefix.py``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models.config import interleave_kinds as jax_interleave_kinds
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import make_draft_params
from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models.config import LayerKind
from repro_torch.models.config import interleave_kinds
from repro_torch.serving import Engine as TEngine
from repro_torch.serving import ServeConfig as TServeConfig
from test_torch_families import to_port
from test_torch_model import ATOL, NM, flatten, identity_table, jax_mesh

ARCHS = ("gemma2_27b", "gemma3_1b")


def jax_reduced(arch, fmt, **kw):
    """The JAX reduced config of ``arch`` at float32, dense or with the
    2:4 MLP of ``sparse()``, with ``kw`` replaced."""
    cfg = importlib.import_module(f"repro.configs.{arch}").reduced()
    if fmt == "nm":
        kw["mlp_sparsity"] = JSparsity(**NM)
    return dataclasses.replace(cfg, **{"dtype": "float32", **kw})


def build(arch, fmt, pack=True, **kw):
    """(JAX config, JAX params, port config, port params on the CPU); the
    2:4 params packed unless ``pack`` is False (a pack draft's dense
    verify weights)."""
    jcfg = jax_reduced(arch, fmt, **kw)
    jp = JM.init_model(jax.random.key(0), jcfg)
    if fmt != "dense" and pack:
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, to_port(jcfg), params_from_numpy(flatten(jp), "cpu")


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["config", "reduced", "sparse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch, fn):
    jcfg = getattr(importlib.import_module(f"repro.configs.{arch}"), fn)()
    tcfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   fn)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port(jcfg) == tcfg
    assert tcfg.post_norm and tcfg.embed_scale
    assert LayerKind.ATTN_LOCAL in tcfg.layer_kinds
    TM._check_ported(tcfg)


def test_registry_serves_the_pair():
    g2, g3 = TC.get("gemma2-27b"), TC.get("gemma3-1b")
    assert (g2.n_layers, g2.head_dim, g2.window_size, g2.attn_softcap,
            g2.final_softcap) == (46, 128, 4096, 50.0, 30.0)
    assert g2.layer_kinds.count(int(LayerKind.ATTN_LOCAL)) == 23
    assert (g3.n_layers, g3.head_dim, g3.n_kv_heads, g3.window_size) == \
        (26, 256, 1, 512)
    assert g3.layer_kinds.count(int(LayerKind.ATTN_LOCAL)) == 22
    assert TC.get_reduced("gemma3-1b") == to_port(
        jax_reduced("gemma3_1b", "dense", dtype="bfloat16"))


@pytest.mark.parametrize("n,local,global_,first", [
    (46, 1, 1, True), (26, 5, 1, True), (3, 2, 1, True), (7, 5, 1, False),
    (1, 1, 1, True), (10, 3, 2, False)])
def test_interleave_kinds_equals_jax(n, local, global_, first):
    got = interleave_kinds(n, local, global_, first)
    assert got == jax_interleave_kinds(n, local, global_, first)
    assert len(got) == n


# --- the scaled embedding ----------------------------------------------------

@pytest.mark.parametrize("d,factor", [(4608, 68.0), (1152, 34.0),
                                      (64, 8.0)])
def test_scaled_embed_rounds_like_jax_in_bf16(d, factor):
    rng = np.random.default_rng(d)
    table = rng.normal(size=(16, d)).astype(np.float32)
    toks = rng.integers(0, 16, size=(2, 5)).astype(np.int32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.asarray(JL.embed(jt, jnp.asarray(toks), scale=True)
                      .astype(jnp.float32))
    tt = torch.from_numpy(table).to(torch.bfloat16)
    got = TL.embed(tt, torch.from_numpy(toks), scale=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # sqrt(d) is rounded to bf16 before the multiply
    assert torch.equal(got, tt[torch.from_numpy(toks).long()] * factor)
    np.testing.assert_array_equal(
        TL.embed(torch.from_numpy(table), torch.from_numpy(toks),
                 scale=True).numpy(),
        np.asarray(JL.embed(jnp.asarray(table), jnp.asarray(toks),
                            scale=True)))


# --- paged attention with a window and a softcap -----------------------------

@pytest.mark.parametrize("window,softcap", [
    (None, None), (7, None), (None, 5.0), (1, 5.0), (20, 5.0)])
@pytest.mark.parametrize("Q", [1, 4])
def test_paged_ref_equals_jax_mha_over_the_gathered_view(Q, window,
                                                          softcap):
    """Each sequence's query ``i`` at ``lens - Q + i`` over the first
    ``lens`` rows of its gathered pages: JAX ``mha_ref`` with the last Q
    queries of ``lens`` keys."""
    B, H, Hk, D, ps, P, mp = 5, 4, 1, 32, 8, 24, 5
    rng = np.random.default_rng(Q * 100 + (window or 0))
    q = rng.normal(size=(B, Q, H, D)).astype(np.float32) * 3
    kp, vp = (rng.normal(size=(P, ps, Hk, D)).astype(np.float32)
              for _ in range(2))
    ptab = rng.integers(1, P, size=(B, mp)).astype(np.int32)
    lens = np.asarray([Q, 9, 17, 30, 40], np.int32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, ptab, lens)]
    got = tref.paged_attention_ref(*t, window=window, softcap=softcap)
    if Q == 1:
        one = tref.paged_attention_ref(t[0][:, 0], *t[1:], window=window,
                                       softcap=softcap)
        assert torch.equal(one, got[:, 0])
    for b in range(B):
        k = kp[ptab[b]].reshape(-1, Hk, D)[:lens[b]].transpose(1, 0, 2)
        v = vp[ptab[b]].reshape(-1, Hk, D)[:lens[b]].transpose(1, 0, 2)
        want = jref.mha_ref(jnp.asarray(q[b].transpose(1, 0, 2))[None],
                            jnp.asarray(k)[None], jnp.asarray(v)[None],
                            window=window, softcap=softcap)
        np.testing.assert_allclose(
            got[b].numpy(), np.asarray(want)[0].transpose(1, 0, 2),
            atol=1e-5, rtol=0)
    if window is not None:
        plain = tref.paged_attention_ref(*t, softcap=softcap)
        assert not torch.allclose(plain[-1], got[-1])


def test_paged_ref_rows_without_keys_are_zero():
    q = torch.randn(2, 4, 2, 16)
    kp, vp = torch.randn(6, 4, 1, 16), torch.randn(6, 4, 1, 16)
    ptab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([0, 2], dtype=torch.int32)
    got = tref.paged_attention_ref(q, kp, vp, ptab, lens, window=3,
                                   softcap=2.0)
    assert (got[0] == 0).all() and (got[1, :2] == 0).all()
    assert (got[1, 2:] != 0).any()


# --- model parity past the window --------------------------------------------

@pytest.fixture(scope="module", params=[(a, f) for a in ARCHS
                                        for f in ("dense", "nm")],
                ids=lambda p: "-".join(p))
def both(request):
    return build(*request.param)


def caches(jcfg, tcfg, B, max_len, page_size):
    jcache = JM.init_cache(jcfg, B, max_len, page_size=page_size,
                           dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, max_len, page_size=page_size,
                           dtype=torch.float32, device="cpu")
    if page_size:
        table = identity_table(B, max_len // page_size)
        jcache = JM.set_page_table(jcache, jnp.asarray(table))
        TM.set_page_table(tcache, table)
    return jcache, tcache


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_logits_past_the_window_match_jax(both, page_size):
    """A 24-token prompt (the window is 16), 4 per-slot decode steps at
    positions 24.. and 29.., then a T = 4 verify block at each slot's
    next offset: every logit within 1e-4 of JAX's."""
    jcfg, jp, tcfg, tp = both
    assert tcfg.window_size == 16
    B, prompt, max_len = 2, 24, 64
    jcache, tcache = caches(jcfg, tcfg, B, max_len, page_size)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t, c: JM.prefill(
        p, jcfg, {"tokens": t}, c))(jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jdecode = jax.jit(lambda p, t, c, s: JM.decode_step(p, jcfg, t, c, s))
    tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size], -1).astype(np.int32)
    pos = np.asarray([prompt, prompt + 5], np.int32)
    for _ in range(4):
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)
        pos = pos + 1
    blk = rng.integers(1, jcfg.vocab_size, (B, 4)).astype(np.int32)
    jl, _, _ = jax.jit(lambda p, t, c, s: JM.decode_block(
        p, jcfg, t, c, s))(jp, jnp.asarray(blk), jcache, jnp.asarray(pos))
    tl, _ = TM.decode_block(tp, tcfg, torch.from_numpy(blk), tcache,
                            torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_the_window_and_softcap_move_the_logits():
    """The reduced gemma2's logits past the window differ without the
    window, and without the attention softcap: the parity above sees
    both."""
    _, jp, tcfg, tp = build("gemma2_27b", "dense")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, tcfg.vocab_size, (1, 40)).astype(np.int32))

    def logits(cfg):
        cache = TM.init_cache(cfg, 1, 48, page_size=8, dtype=torch.float32,
                              device="cpu")
        TM.set_page_table(cache, identity_table(1, 6))
        return TM.prefill(tp, cfg, {"tokens": toks}, cache)[0]

    base = logits(tcfg)
    for kw in (dict(window_size=1000), dict(attn_softcap=None)):
        other = logits(dataclasses.replace(tcfg, **kw))
        assert (other - base).abs().max() > 1e-3, kw


def test_params_carry_the_post_norms(both):
    """Each layer's two post-norms arrive from the JAX tree; the port's
    own init draws them too, with the same leaves."""
    jcfg, jp, tcfg, tp = both
    for name in ("ln_attn_post", "ln_mlp_post"):
        for l, layer in enumerate(tp["layers"]):
            np.testing.assert_array_equal(
                layer[name]["scale"].numpy(),
                np.asarray(jp["layers"][name]["scale"][l]))
    mine = TM.init_model(tcfg, device="cpu")
    assert [sorted(layer) for layer in mine["layers"]] == \
        [sorted(layer) for layer in tp["layers"]]


def test_pack_draft_shares_the_post_norms_and_the_scaled_embedding():
    """The draft's memory contract under gemma: the tied, scaled
    embedding and every norm, the post-norms too, are the verify
    params' own tensors; only the MLP's projections are packs."""
    _, _, tcfg, tp = build("gemma3_1b", "nm", pack=False)
    d = make_draft_params(tp, tcfg)
    assert d["embed"] is tp["embed"] and "unembed" not in d
    for dl, tl in zip(d["layers"], tp["layers"]):
        for name in ("ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post"):
            assert dl[name]["scale"] is tl[name]["scale"]
        assert dl["attn"]["q_norm"]["scale"] is tl["attn"]["q_norm"]["scale"]
        assert all(dl["attn"][k] is tl["attn"][k]
                   for k in ("wq", "wk", "wv", "wo"))
        assert isinstance(dl["mlp"]["w_in"], NMPack)
        assert isinstance(dl["mlp"]["w_gate"], NMPack)


# --- Engine parity on untied gemma-shaped configs ----------------------------

PROMPTS = [np.arange(1, 6, dtype=np.int32),
           np.arange(3, 11, dtype=np.int32),
           np.asarray([7, 9, 11], np.int32)]
#: budgets that carry every slot past the 16-row window
BUDGETS = [30, 24, 12]
SERVE = dict(slots=2, max_len=64, prompt_pad=8, max_new_tokens=32,
             decode_chunk=4, eos_token=-1)
HEAD = np.arange(40, 52, dtype=np.int32)
#: prefix sharing: two prompts over one 12-token head, then a repeat
PREFIX_PROMPTS = [np.concatenate([HEAD, np.asarray(t, np.int32)]) for t in (
    [101, 102, 103, 104], [201, 202, 203, 204], [101, 102, 103, 104])]
PREFIX_BUDGETS = [24, 20, 16]
LAYOUTS = {
    "mono": (dict(SERVE), PROMPTS, BUDGETS),
    "paged": (dict(SERVE, page_size=8), PROMPTS, BUDGETS),
    "spec_self": (dict(SERVE, page_size=8, spec_k=3), PROMPTS, BUDGETS),
    "spec_pack": (dict(SERVE, page_size=8, spec_k=3, spec_draft="pack"),
                  PROMPTS, BUDGETS),
    "prefix": (dict(SERVE, prompt_pad=16, page_size=8, prefix_cache=True),
               PREFIX_PROMPTS, PREFIX_BUDGETS),
}
STATS = ("sync_count", "drafted", "accepted", "prefix_hits", "shared_pages",
         "cow_copies", "peak_pages", "prefills")


@pytest.fixture(scope="module", params=ARCHS)
def untied(request):
    """The untied reduced config under 2:4 over dense weights: the pack
    draft packs them, every other layout serves them dense."""
    return build(request.param, "nm", pack=False, tie_embeddings=False)


def serve(eng, prompts, budgets):
    handles = [eng.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
    eng.run()
    return [h.tokens for h in handles]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_matches_jax(untied, layout):
    """The JAX ``Engine``'s transcripts are the oracle: not constant,
    every budget reached, equal to the port's, and so are the stats."""
    jcfg, jp, tcfg, tp = untied
    kw, prompts, budgets = LAYOUTS[layout]
    jeng = JEngine(jcfg, jax_mesh(), JServeConfig(**kw), jp)
    teng = TEngine(tcfg, TServeConfig(**kw), tp, device="cpu")
    jout = serve(jeng, prompts, budgets)
    tout = serve(teng, prompts, budgets)
    assert tout == jout
    assert [len(t) for t in tout] == budgets
    assert all(len(set(t)) > 1 for t in tout), tout
    js, ts = jeng.stats(), teng.stats()
    assert {k: getattr(ts, k) for k in STATS} == \
        {k: getattr(js, k) for k in STATS}
    if kw.get("spec_k"):
        assert ts.drafted > 0
        plain = {k: v for k, v in kw.items()
                 if k not in ("spec_k", "spec_draft")}
        assert tout == serve(TEngine(tcfg, TServeConfig(**plain), tp,
                                     device="cpu"), prompts, budgets)
    if kw.get("spec_draft") == "pack":
        assert {r["kernel"] for r in teng.draft_plan} == {"nm_spmm"}
    if kw.get("prefix_cache"):
        assert ts.prefix_hits > 0 and ts.shared_pages > 0
