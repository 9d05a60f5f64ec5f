"""The MoE functions of the port (``repro_torch/models/moe.py``) against
the JAX package's, on the CPU at float32, atol 1e-5, on one layer of the
tiny configs of ``test_torch_moe.py``:

* ``route_topk`` and the four dispatches (``moe``, ``moe_grouped``,
  ``moe_sorted``, ``moe_sparse_expert``), output and aux, with shared
  experts on (the qwen2-moe shape) and off (the dbrx shape);
  ``moe_sorted`` and ``moe_grouped`` with drops (C = 1), with ample
  capacity and with several groups (a small ``group_size``);
* packed (2:4) experts against JAX ``moe_sorted`` on the pruned dense
  experts and against JAX ``moe_sparse_expert`` on the JAX packs, and
  one matmul per expert and projection on its C rows;
* ``pack_params`` of an expert stack array-equal to the JAX
  ``_pack_stacked``, and ``convert`` of ``(L, E, …)`` trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_linear as JSL
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.models import moe as JMOE
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparse_linear import pack_params
from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import dispatch
from repro_torch.models import moe as TMOE
from test_torch_model import SPARSE, flatten
from test_torch_moe import (FN_ATOL, TINY, assert_close, build, configs,
                            inputs, jax_trees, layer0, tally)


# --- routing and the four dispatches -----------------------------------------

def test_route_topk_matches_jax():
    logits = np.random.default_rng(1).normal(size=(12, 8)).astype(np.float32)
    jc, jd = JMOE.route_topk(jnp.asarray(logits), 3)
    tcomb, tdisp = TMOE.route_topk(torch.from_numpy(logits), 3)
    assert_close(tcomb, jc)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jd))
    assert tdisp.sum() == 12 * 3


@pytest.fixture(scope="module", params=sorted(TINY))
def moe_layer(request):
    """(JAX config, JAX layer-0 ``moe`` params, port config, port ones),
    dense experts."""
    jcfg, jp, tcfg, tp = build(request.param, "dense")
    return jcfg, layer0(jp["layers"]["moe"]), tcfg, tp["layers"][0]["moe"]


FUNCTIONS = {
    "moe": lambda m, p, c, x: m.moe(p, c, x),
    "grouped": lambda m, p, c, x: m.moe_grouped(p, c, x),
    "sorted": lambda m, p, c, x: m.moe_sorted(p, c, x),
    "sparse_expert": lambda m, p, c, x: m.moe_sparse_expert(
        p, c, x, sparsity=c.expert_sparsity),
}


@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_moe_functions_match_jax(moe_layer, fn):
    """Output and aux of each dispatch; the qwen2-moe-shaped layer runs
    its shared experts, the dbrx-shaped one has none."""
    jcfg, jl, tcfg, tl = moe_layer
    jx, tx = inputs(jcfg)
    jy, jaux = FUNCTIONS[fn](JMOE, jl, jcfg, jx)
    ty, taux = FUNCTIONS[fn](TMOE, tl, tcfg, tx)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    assert_close(ty, jy)
    assert abs(float(taux) - float(jaux)) < FN_ATOL
    assert ("shared" in tl) == bool(tcfg.n_shared_experts)


@pytest.mark.parametrize("impl", ["sorted", "grouped"])
@pytest.mark.parametrize("case", ["drops", "ample", "groups"])
def test_capacity_dispatch_matches_jax(moe_layer, impl, case, tally):
    """C = 1 (capacity_factor 0.25 over 16 tokens: most routes dropped),
    ample capacity (no drop, equal to the dense dispatch), and 4 groups of
    4 tokens at C = 1 per group."""
    jcfg, jl, tcfg, tl = moe_layer
    jx, tx = inputs(jcfg, seed=3)
    kw = {"drops": dict(capacity_factor=0.25),
          "ample": dict(capacity_factor=float(tcfg.n_experts)),
          "groups": dict(group_size=4, capacity_factor=0.5)}[case]
    name = "moe_" + impl
    jy, jaux = getattr(JMOE, name)(jl, jcfg, jx, **kw)
    ty, taux = getattr(TMOE, name)(tl, tcfg, tx, **kw)
    assert_close(ty, jy)
    assert abs(float(taux) - float(jaux)) < FN_ATOL
    dense = TMOE.moe(tl, tcfg, tx)[0]
    if case == "ample":
        torch.testing.assert_close(ty, dense, atol=FN_ATOL, rtol=0)
    else:
        assert not torch.allclose(ty, dense, atol=1e-3)
    if impl == "sorted":
        kept, routes = tally["prefill"].tolist()
        assert routes == 16 * tcfg.top_k
        assert (kept == routes) == (case == "ample")


def test_sorted_drops_match_the_slot_major_rule(moe_layer, tally):
    """The kept routes of ``moe_sorted`` at C = 1: in slot-major order, the
    first route of each expert, recomputed on the host from the JAX
    top-k."""
    jcfg, jl, tcfg, tl = moe_layer
    jx, tx = inputs(jcfg, B=1, L=6, seed=5)
    TMOE.moe_sorted(tl, tcfg, tx, capacity_factor=0.1)
    logits = np.asarray(jx.reshape(6, -1)) @ np.asarray(jl["router"])
    _, eidx = jax.lax.top_k(jnp.asarray(logits), tcfg.top_k)
    order = np.asarray(eidx).T.reshape(-1)           # slot-major
    assert tally["prefill"].tolist() == [len(set(order.tolist())),
                                         order.size]


def test_moe_sorted_is_deterministic(moe_layer):
    jcfg, _, tcfg, tl = moe_layer
    _, tx = inputs(jcfg, seed=7)
    a = TMOE.moe_sorted(tl, tcfg, tx)[0]
    assert torch.equal(a, TMOE.moe_sorted(tl, tcfg, tx)[0])


# --- packed experts ----------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(TINY))
def packed_layer(request):
    """JAX config, JAX packed layer 0, JAX pruned-dense layer 0, port
    config, port packed layer 0."""
    jcfg, jref, tcfg, tp = build(request.param, "nm")
    packed = jax_trees(request.param, "nm")[3]
    return (jcfg, layer0(packed["layers"]["moe"]),
            layer0(jref["layers"]["moe"]), tcfg, tp["layers"][0]["moe"])


def test_packed_experts_match_jax_sorted_on_pruned(packed_layer, tally):
    """The served path: packed experts through nm_spmm's plain version
    against JAX ``moe_sorted`` on the same experts pruned and dense, with
    capacity drops (16 tokens, C = 5 or 8 under capacity_factor 1.25)."""
    jcfg, _, jref, tcfg, tl = packed_layer
    assert all(isinstance(w, NMPack) for k in TMOE.EXPERT_WEIGHTS
               for w in tl[k]) and len(tl["w_in"]) == tcfg.n_experts
    jx, tx = inputs(jcfg, seed=11)
    for kw in ({}, dict(capacity_factor=0.25)):
        jy, _ = JMOE.moe_sorted(jref, jcfg, jx, **kw)
        ty, _ = TMOE.moe_sorted(tl, tcfg, tx, **kw)
        assert_close(ty, jy)
    kept, routes = tally["prefill"].tolist()
    assert kept < routes


def test_packed_experts_match_jax_sparse_expert(packed_layer):
    """``moe_sparse_expert`` on the port's packs against the JAX function
    on the JAX packs (every expert on every token, ample capacity)."""
    jcfg, jpacked, _, tcfg, tl = packed_layer
    jx, tx = inputs(jcfg, seed=13)
    jy, jaux = JMOE.moe_sparse_expert(jpacked, jcfg, jx,
                                      jcfg.expert_sparsity)
    ty, taux = TMOE.moe_sparse_expert(tl, tcfg, tx, tcfg.expert_sparsity)
    assert_close(ty, jy)
    assert abs(float(taux) - float(jaux)) < FN_ATOL
    torch.testing.assert_close(
        ty, TMOE.moe_sorted(tl, tcfg, tx, capacity_factor=8.0)[0],
        atol=FN_ATOL, rtol=0)


def test_packed_layer_launches_3e_plus_3_matmuls(packed_layer, monkeypatch):
    """One nm_spmm call per expert and projection on its C rows, plus the
    shared FFN's three: what the card's launch gates count."""
    _, _, _, tcfg, tl = packed_layer
    calls = []
    entry = dispatch._REGISTRY["nm_spmm"]
    monkeypatch.setitem(dispatch._REGISTRY, "nm_spmm", dataclasses.replace(
        entry, run=lambda x, w, mode: calls.append(x.shape[0])
        or entry.run(x, w, mode)))
    x = torch.randn((2, 1, tcfg.d_model))
    TMOE.moe_sorted(tl, tcfg, x)
    E, shared = tcfg.n_experts, 3 if tcfg.n_shared_experts else 0
    assert TM.expert_rows(tcfg, 2) == 1
    assert calls == [1] * (3 * E) + [2] * shared


# --- packing and conversion --------------------------------------------------

@pytest.mark.parametrize("fmt", ["nm", "combined"])
def test_pack_params_of_an_expert_stack_equals_jax(fmt):
    """Each expert's pack array-equal to its slice of the JAX stacked pack
    (a combined stack padded to one ``max_nnz``)."""
    w = np.random.default_rng(17).normal(size=(4, 128, 256)).astype(
        np.float32)
    tcfg = dataclasses.replace(configs("dbrx", "dense")[1],
                               expert_sparsity=TSparsity(**SPARSE[fmt]))
    want = JSL._pack_stacked(jnp.asarray(w), JSparsity(**SPARSE[fmt]))
    packs = pack_params({"moe": {"w_in": torch.from_numpy(w)}},
                        tcfg)["moe"]["w_in"]
    assert isinstance(packs, list) and len(packs) == 4
    for e, p in enumerate(packs):
        for f in dataclasses.fields(p):
            a, b = getattr(p, f.name), getattr(want, f.name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b)[e])
            else:
                assert a == b


@pytest.mark.parametrize("fmt", ["dense", "nm"])
def test_convert_takes_layer_and_expert_slices(fmt):
    jcfg, _, jp, packed = jax_trees("qwen2-moe", fmt)
    jp = jp if packed is None else packed
    tp = params_from_numpy(flatten(jp), "cpu")
    jm = jp["layers"]["moe"]
    for l, layer in enumerate(tp["layers"]):
        m = layer["moe"]
        assert m["router"].dtype == torch.float32
        np.testing.assert_array_equal(m["router"].numpy(),
                                      np.asarray(jm["router"][l]))
        for k in TMOE.EXPERT_WEIGHTS:
            if fmt == "dense":
                assert m[k].shape == (jcfg.n_experts,) + jm[k].shape[2:]
                np.testing.assert_array_equal(m[k].numpy(),
                                              np.asarray(jm[k][l]))
                continue
            assert len(m[k]) == jcfg.n_experts
            for e, p in enumerate(m[k]):
                np.testing.assert_array_equal(
                    p.values.numpy(), np.asarray(jm[k].values[l, e]))
                np.testing.assert_array_equal(
                    p.idx.numpy(), np.asarray(jm[k].idx[l, e]))
        shared = m["shared"]["w_in"]
        assert isinstance(shared, NMPack) == (fmt == "nm")
