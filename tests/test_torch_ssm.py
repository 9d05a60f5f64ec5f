"""The port's Mamba-2 block (``repro_torch/models/ssm.py``) and the
recurrent-state helpers of ``repro_torch.models`` against the JAX
package, on the CPU at float32, numpy inputs from a seed:

* ``ssd_chunked`` at chunk 1, 4 and 8, from zero and from a given initial
  state, and with ``return_states`` (the state after every position);
* ``_causal_conv`` with and without a carried state;
* ``mamba_block`` in its four branches (no cache; prefill into a cache;
  the l = 1 update; ``collect_states`` with ``conv_seq``/``ssm_seq``),
  dense and with a 2:4 ``out_proj``, one and two B/C groups; the port
  writes the cache in place, and the written state equals the JAX one;
* ``select_recurrent`` and ``where_slot`` against the JAX helpers.

Tolerance 1e-5 absolute (float32; the einsums contract in other
orders); the block's outputs and carried states, which grow to tens and
reach the outputs through a norm, also 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.models import ssm as JS
from repro.models.config import LayerKind
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparsity import NMPack
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TModelConfig
from test_torch_model import flatten

ATOL = 1e-5
BLOCK_RTOL = 1e-5

#: one mamba layer: d_inner 256, 16 heads of 16, state 16, chunk 8; the
#: 2:4 case packs ``out_proj`` (256 → 128) with g = 64, ``in_proj``
#: (N = 560) stays dense as at the published widths
BLOCK = dict(name="tiny-mamba", n_layers=1, d_model=128, vocab_size=256,
             ssm_state=16, ssm_head_dim=16, ssm_chunk=8, dtype="float32",
             layer_kinds=(int(LayerKind.MAMBA),), remat=False)
NM = dict(format="nm", n=2, m=4, block_n=64)


def rng(seed=0):
    return np.random.default_rng(seed)


def both(*arrays):
    """Each numpy array as (jnp, torch)."""
    return [(jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a)))
            for a in arrays]


def close(got, want, atol=ATOL, rtol=0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def scan_inputs(b=2, l=16, h=4, p=8, n=6, seed=0):
    r = rng(seed)
    x = r.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, l, h)))).astype(np.float32)
    A = -np.exp(r.normal(size=(h,))).astype(np.float32)
    B = r.normal(size=(b, l, h, n)).astype(np.float32)
    C = r.normal(size=(b, l, h, n)).astype(np.float32)
    s0 = r.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, s0


# --- the scan -------------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_ssd_chunked_matches_jax(chunk, init):
    x, dt, A, B, C, s0 = scan_inputs()
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (js, ts) = \
        both(x, dt, A, B, C, s0)
    jy, jf = JS.ssd_chunked(jx, jdt, jA, jB, jC, chunk,
                            init_state=js if init else None)
    ty, tf = TS.ssd_chunked(tx, tdt, tA, tB, tC, chunk,
                            init_state=ts if init else None)
    assert ty.dtype == tf.dtype == torch.float32
    close(ty, jy)
    close(tf, jf)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
def test_ssd_return_states_matches_jax(init):
    """``return_states`` forces chunk 1 and gives the state after every
    position; the last equals the final state, and at chunk 8 the
    outputs are the same scan's."""
    x, dt, A, B, C, s0 = scan_inputs(l=12, seed=1)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (js, ts) = \
        both(x, dt, A, B, C, s0)
    kw = dict(return_states=True)
    jy, jf, jseq = JS.ssd_chunked(jx, jdt, jA, jB, jC, 4,
                                  init_state=js if init else None, **kw)
    ty, tf, tseq = TS.ssd_chunked(tx, tdt, tA, tB, tC, 4,
                                  init_state=ts if init else None, **kw)
    assert tseq.shape == (2, 12, 4, 8, 6)
    close(ty, jy)
    close(tf, jf)
    close(tseq, jseq)
    assert torch.equal(tseq[:, -1], tf)
    y4, _ = TS.ssd_chunked(tx, tdt, tA, tB, tC, 4,
                           init_state=ts if init else None)
    close(y4, ty.numpy(), atol=1e-4)


def test_segsum_and_pick_chunk():
    a = rng(2).normal(size=(3, 5)).astype(np.float32)
    (ja, ta), = both(a)
    got, want = TS._segsum(ta), np.asarray(JS._segsum(ja))
    assert torch.isneginf(got).numpy().tolist() == np.isneginf(want).tolist()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], atol=ATOL)
    for l, t in ((128, 256), (200, 256), (12, 8), (7, 4), (1, 256)):
        assert TS._pick_chunk(l, t) == JS._pick_chunk(l, t)


@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state"])
def test_causal_conv_matches_jax(state):
    r = rng(3)
    x = r.normal(size=(2, 7, 12)).astype(np.float32)
    w = r.normal(size=(4, 12)).astype(np.float32)
    bias = r.normal(size=(12,)).astype(np.float32)
    st = r.normal(size=(2, 3, 12)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb), (js, ts) = both(x, w, bias, st)
    jo, jn = JS._causal_conv(jx, jw, jb, js if state else None)
    to, tn = TS._causal_conv(tx, tw, tb, ts if state else None)
    close(to, jo)
    close(tn, jn)


# --- the block -------------------------------------------------------------------

def block_params(fmt, groups):
    """(JAX config, JAX layer params, port config, port layer params):
    one JAX ``init_mamba`` layer (packed per ``fmt``) carried over."""
    kw = dict(BLOCK, ssm_groups=groups)
    if fmt == "nm":
        jcfg = JModelConfig(**kw, mlp_sparsity=JSparsity(**NM))
        tcfg = TModelConfig(**kw, mlp_sparsity=TSparsity(**NM))
    else:
        jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jp = JS.init_mamba(jax.random.key(0), jcfg, dtype=jnp.float32)
    # nonzero conv bias, dt bias and D: every term of the block counts
    r = rng(4)
    for k in ("conv_b", "dt_bias", "D"):
        jp[k] = jnp.asarray(r.normal(size=jp[k].shape).astype(np.float32))
    if fmt == "nm":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


def caches(jcfg, tcfg, b, seed=5):
    """A nonzero cached state on both sides: (JAX layer cache, port
    stacked cache, port layer views)."""
    jc = JS.init_ssm_cache(jcfg, b, n_layers=1)
    r = rng(seed)
    vals = {k: r.normal(size=v.shape).astype(np.float32) * 0.5
            for k, v in jc.items()}
    jlayer = {k: jnp.asarray(v[0]) for k, v in vals.items()}
    tstack = {k: torch.from_numpy(v.copy()) for k, v in vals.items()}
    return jlayer, tstack, {k: v[0] for k, v in tstack.items()}


BRANCHES = {"nocache": (8, False, False), "prefill": (8, True, False),
            "update": (1, True, False), "collect": (4, True, True)}


@pytest.mark.parametrize("groups", [1, 2], ids=["g1", "g2"])
@pytest.mark.parametrize("fmt", ["dense", "nm"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_mamba_block_matches_jax(branch, fmt, groups):
    l, cached, collect = BRANCHES[branch]
    jcfg, jp, tcfg, tp = block_params(fmt, groups)
    if fmt == "nm":
        assert isinstance(tp["out_proj"], NMPack)
        assert not isinstance(tp["in_proj"], NMPack)
    x = rng(6).normal(size=(2, l, jcfg.d_model)).astype(np.float32)
    (jx, tx), = both(x)
    jc = tc = tstack = None
    if cached:
        jc, tstack, tc = caches(jcfg, tcfg, 2)
        ptrs = [t.data_ptr() for t in tstack.values()]
    jo, jnew = JS.mamba_block(jp, jcfg, jx, cache=jc,
                              sparsity=jcfg.mlp_sparsity,
                              collect_states=collect)
    to, tnew = TS.mamba_block(tp, tcfg, tx, cache=tc,
                              sparsity=tcfg.mlp_sparsity,
                              collect_states=collect)
    close(to, jo, rtol=BLOCK_RTOL)
    if not cached:
        assert jnew is None and tnew is None
        return
    assert sorted(tnew) == sorted(jnew)
    for k in jnew:
        close(tnew[k], jnew[k], rtol=BLOCK_RTOL)
    # written in place: the stacked cache holds the new state
    assert [t.data_ptr() for t in tstack.values()] == ptrs
    for k in ("conv", "ssm"):
        assert tnew[k].data_ptr() == tstack[k].data_ptr()
        close(tstack[k][0], jnew[k], rtol=BLOCK_RTOL)
        assert tstack[k].dtype == torch.float32
    if collect:
        assert tnew["ssm_seq"].shape == (2, l, tcfg.n_ssm_heads,
                                         tcfg.ssm_head_dim, tcfg.ssm_state)
        assert torch.equal(tnew["ssm_seq"][:, -1], tstack["ssm"][0])
        assert torch.equal(tnew["conv_seq"][:, -1], tstack["conv"][0])


def test_block_chain_equals_one_prefill():
    """Prefill of 8 rows into a cache, then two l = 1 updates, gives the
    outputs of one cache-less scan over the 10 rows (the recurrence is
    exact in fp32 up to summation order)."""
    _, _, tcfg, tp = block_params("dense", 1)
    x = torch.from_numpy(rng(7).normal(
        size=(2, 10, tcfg.d_model)).astype(np.float32))
    whole, _ = TS.mamba_block(tp, tcfg, x)
    cache = TS.init_ssm_cache(tcfg, 2, device="cpu")
    layer = {k: v[0] for k, v in cache.items()}
    parts = [TS.mamba_block(tp, tcfg, x[:, :8], cache=layer)[0]]
    for t in (8, 9):
        parts.append(TS.mamba_block(tp, tcfg, x[:, t:t + 1], cache=layer)[0])
    close(torch.cat(parts, 1), whole.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssm_cache_is_fp32_whatever_the_model_dtype(dtype):
    cfg = TModelConfig(**dict(BLOCK, dtype=dtype))
    c = TS.init_ssm_cache(cfg, 3, n_layers=2, device="cpu")
    jc = JS.init_ssm_cache(JModelConfig(**dict(BLOCK, dtype=dtype)), 3,
                           n_layers=2)
    for k in ("conv", "ssm"):
        assert c[k].dtype == torch.float32
        assert tuple(c[k].shape) == jc[k].shape
    p = TS.init_mamba(cfg, getattr(torch, dtype), torch.Generator(),
                      "cpu")
    jp = JS.init_mamba(jax.random.key(0), JModelConfig(**BLOCK))
    assert {k: tuple(v.shape) for k, v in p.items() if k != "norm"} == \
        {k: v.shape for k, v in jp.items() if k != "norm"}
    assert p["A_log"].dtype == p["D"].dtype == torch.float32


# --- the rollback helpers -------------------------------------------------------

def snapshots(seed=8):
    r = rng(seed)
    return {"conv": r.normal(size=(3, 4, 5, 3, 6)).astype(np.float32),
            "ssm": r.normal(size=(3, 4, 5, 2, 3, 2)).astype(np.float32)}


def test_select_recurrent_matches_jax():
    snaps = snapshots()
    idx = np.asarray([0, 4, 2, 3], np.int32)
    want = JM.select_recurrent({k: jnp.asarray(v) for k, v in snaps.items()},
                               jnp.asarray(idx))
    got = TM.select_recurrent({k: torch.from_numpy(v)
                               for k, v in snaps.items()},
                              torch.from_numpy(idx))
    for k in snaps:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_where_slot_matches_jax():
    a, b = snapshots(9), snapshots(10)
    mask = np.asarray([True, False, False, True])
    want = JM.where_slot(jnp.asarray(mask),
                         {k: jnp.asarray(v) for k, v in a.items()},
                         {k: jnp.asarray(v) for k, v in b.items()})
    got = TM.where_slot(torch.from_numpy(mask),
                        {k: torch.from_numpy(v) for k, v in a.items()},
                        {k: torch.from_numpy(v) for k, v in b.items()})
    for k in a:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_recurrent_state_is_written_in_place():
    cfg = TModelConfig(**dict(BLOCK, n_layers=2, layer_kinds=(
        int(LayerKind.MAMBA),) * 2))
    cache = TM.init_cache(cfg, 2, 16, device="cpu")
    rec = TM.recurrent_state(cache)
    assert rec is cache["ssm"] and "kv" not in cache
    ptrs = [t.data_ptr() for t in TM.cache_leaves(cache)]
    new = {k: torch.ones_like(v) for k, v in rec.items()}
    assert TM.set_recurrent_state(cache, new) is cache
    assert [t.data_ptr() for t in TM.cache_leaves(cache)] == ptrs
    assert all(bool((t == 1).all()) for t in rec.values())
    lm = TModelConfig(name="lm", n_layers=1, d_model=64, vocab_size=256,
                      n_heads=4, n_kv_heads=2, d_ff=128)
    assert TM.recurrent_state(TM.init_cache(lm, 1, 8, device="cpu")) is None
