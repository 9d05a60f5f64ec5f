"""The port's N:M pruning and packing against the JAX package's, and the
parameter bridge: same weights in, array-equal packs out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.core import sparsity as jsparsity
from repro_torch.core import pruning, sparsity
from repro_torch.core.sparse_linear import (SparsityConfig, apply_linear,
                                            pack_params)
from repro_torch.core.sparsity import NMPack
from test_torch_model import build_params


@pytest.mark.parametrize("n,m,g", [(2, 4, 128), (1, 4, 64), (4, 8, 128)])
def test_prune_and_pack_equal_jax(n, m, g):
    w = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    jw, jmask = jpruning.n_m(jnp.asarray(w), n, m, group=g)
    tw, tmask = pruning.n_m(torch.from_numpy(w), n, m, group=g)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jp = jsparsity.pack_nm(jw, n, m, g=g)
    tp = sparsity.pack_nm(tw, n, m, g=g)
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    assert (tp.K, tp.N, tp.n, tp.m, tp.g, tp.Kc) == \
        (jp.K, jp.N, jp.n, jp.m, jp.g, jp.Kc)
    np.testing.assert_array_equal(tp.src_rows().numpy(),
                                  np.asarray(jp.src_rows()))
    np.testing.assert_array_equal(tp.densify().numpy(),
                                  np.asarray(jp.densify()))
    # pack_nm(n_m(w)) round-trips: the pack holds exactly the kept weights
    np.testing.assert_array_equal(tp.densify().numpy(), tw.numpy())
    assert sparsity.metadata_bytes(tp) == tp.idx.numel() * 4
    assert sparsity.values_bytes(tp) == tp.values.numel() * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,g", [(2, 4, 128), (1, 4, 64), (4, 8, 128)])
def test_device_pruning_and_packing_equal_the_host_pass(n, m, g, dtype):
    """``n_m`` and ``pack_nm``, which run in torch ops on the weight's
    device, equal the host numpy passes (``n_m_numpy``, the JAX package's
    ``pack_nm``) on bf16 and fp32 weights without near ties."""
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(512, 384)).astype(np.float32)).to(dtype)
    tw, tmask = pruning.n_m(w, n, m, group=g)
    hw, hmask = pruning.n_m_numpy(w.float().numpy(), n, m, group=g)
    assert tw.dtype == dtype and tmask.dtype == dtype
    np.testing.assert_array_equal(tw.float().numpy(), hw)
    np.testing.assert_array_equal(tmask.float().numpy(), hmask)
    tp, hp = sparsity.pack_nm(tw, n, m, g=g), jsparsity.pack_nm(hw, n, m, g=g)
    np.testing.assert_array_equal(tp.values.float().numpy(),
                                  np.asarray(hp.values))
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(hp.idx))
    assert tp.idx.dtype == torch.int32 and tp.values.dtype == dtype
    assert torch.equal(tp.densify(), tw)
    with pytest.raises(ValueError):
        pruning.n_m(w[:, :100], n, m, group=g)


def test_bf16_pack_keeps_the_weights():
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(128, 256)).astype(np.float32)).to(torch.bfloat16)
    pw, _ = pruning.n_m(w, 2, 4, group=128)
    p = sparsity.pack_nm(pw, 2, 4, g=128)
    assert p.values.dtype == torch.bfloat16 and p.idx.dtype == torch.int32
    assert torch.equal(p.densify(), pw)


def test_pack_params_equals_jax_pack_params():
    """The port's offline pass packs the same weights into the same packs
    (per layer) as the JAX pass does (stacked)."""
    jcfg, jp_packed, tcfg, tp_packed = build_params("nm")
    _, jp_dense, _, tp_dense = build_params("dense")
    mine = pack_params(tp_dense, tcfg)
    for l, layer in enumerate(mine["layers"]):
        for fam, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_in", "w_gate", "w_out"))):
            for name in names:
                got = layer[fam][name]
                want = tp_packed["layers"][l][fam][name]
                assert isinstance(got, NMPack)
                assert torch.equal(got.values, want.values)
                assert torch.equal(got.idx, want.idx)
        assert torch.equal(layer["attn"]["q_norm"]["scale"],
                           tp_dense["layers"][l]["attn"]["q_norm"]["scale"])
    assert torch.equal(mine["embed"], tp_dense["embed"])
    # the geometry check leaves weights that do not divide dense
    odd = {"mlp": {"w_in": torch.zeros(256, 96)}}
    cfg = type("C", (), {"mlp_sparsity": SparsityConfig(format="nm")})()
    assert isinstance(pack_params(odd, cfg)["mlp"]["w_in"], torch.Tensor)


def test_params_from_numpy_round_trips_a_jax_packed_tree():
    jcfg, jp, _, tp = build_params("nm")
    jpack = jp["layers"]["mlp"]["w_gate"]
    for l in range(jcfg.n_layers):
        got = tp["layers"][l]["mlp"]["w_gate"]
        one = jsparsity.NMPack(values=jpack.values[l], idx=jpack.idx[l],
                               K=jpack.K, N=jpack.N, n=jpack.n, m=jpack.m,
                               g=jpack.g)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(one.values))
        np.testing.assert_array_equal(got.densify().numpy(),
                                      np.asarray(one.densify()))
        np.testing.assert_array_equal(
            tp["layers"][l]["ln_attn"]["scale"].numpy(),
            np.asarray(jp["layers"]["ln_attn"]["scale"][l]))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 5, jcfg.d_model)).astype(np.float32))
    got = apply_linear(x, tp["layers"][0]["mlp"]["w_gate"])
    want = x.reshape(-1, jcfg.d_model).numpy() @ np.asarray(
        jsparsity.NMPack(values=jpack.values[0], idx=jpack.idx[0], K=jpack.K,
                         N=jpack.N, n=2, m=4, g=128).densify())
    np.testing.assert_allclose(got.reshape(15, -1).numpy(), want,
                               rtol=2e-5, atol=1e-4)


def test_bf16_tree_converts_bit_exactly():
    from repro_torch.convert import params_from_numpy
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32),
                               jnp.bfloat16))
    got = params_from_numpy({"embed": a.reshape(3, 4)}, "cpu")["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  a.astype(np.float32).reshape(3, 4))

