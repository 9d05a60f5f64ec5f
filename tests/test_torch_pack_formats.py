"""The port's block, combined and lookahead pruning and packing against
the JAX package's, and the parameter bridge for their stacked packs: the
same weights in, array-equal packs out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.core import sparsity as jsparsity
from repro_torch.core import pruning, sparsity
from repro_torch.core.sparse_linear import format_stats, pack_params
from test_torch_model import PROJECTIONS, build_params, zero_half_tiles

BK = BN = 128


def tile_zeroed(seed, K=512, N=384, dtype=np.float32):
    """Random weights with half of the (128, 128) tiles zeroed and strip
    2 emptied whole, so a pack has a ``counts == 0`` strip and strips of
    different counts."""
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(dtype)
    w = zero_half_tiles(w[None], seed)[0]
    w[:, 2 * BN:3 * BN] = 0
    return w


def tile_map(w):
    """Bool map of the non-zero (128, 128) tiles of ``w``."""
    w = np.asarray(w, np.float32)
    K, N = w.shape
    return np.abs(w).reshape(K // BK, BK, N // BN, BN).sum((1, 3)) > 0


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def assert_packs_equal(tp, jp, fields):
    for f in fields:
        equal(getattr(tp, f).numpy(), getattr(jp, f))
    for f in ("K", "N", "bk", "bn", "max_nnz"):
        assert getattr(tp, f) == getattr(jp, f)


@pytest.mark.parametrize("zeroed", [False, True], ids=["iid", "tiles"])
def test_block_pruning_equals_jax(zeroed):
    w = tile_zeroed(0) if zeroed else \
        np.random.default_rng(0).normal(size=(512, 384)).astype(np.float32)
    for block in (4, BK):
        jw, jmask = jpruning.block_semi_structured(jnp.asarray(w), 0.5,
                                                   block=block)
        tw, tmask = pruning.block_semi_structured(torch.from_numpy(w), 0.5,
                                                  block=block)
        equal(tw, jw)
        equal(tmask, jmask)
    jw, jmask = jpruning.combined_nm(jnp.asarray(w), 0.5, 2, 4, group=BN,
                                     block=BK)
    tw, tmask = pruning.combined_nm(torch.from_numpy(w), 0.5, 2, 4, group=BN,
                                    block=BK)
    equal(tw, jw)
    equal(tmask, jmask)
    if zeroed:                     # every non-zero tile survives pruning
        equal(tile_map(tw), tile_map(w))


@pytest.mark.parametrize("pad_to", [None, 6])
def test_block_pack_equals_jax(pad_to):
    w = tile_zeroed(1)
    jw, _ = jpruning.block_semi_structured(jnp.asarray(w), 0.5, block=BK)
    tw = torch.from_numpy(np.asarray(jw))
    jp = jsparsity.pack_block_sparse(jw, BK, BN, pad_to=pad_to)
    tp = sparsity.pack_block_sparse(tw, BK, BN, pad_to=pad_to)
    assert_packs_equal(tp, jp, ("values", "indices", "counts"))
    assert tp.indices.dtype == tp.counts.dtype == torch.int32
    assert 0 in tp.counts.tolist() and len(set(tp.counts.tolist())) > 1
    assert tp.max_nnz == (pad_to or int(tp.counts.max()))
    assert tp.density == jp.density == tile_map(w).mean()
    equal(tp.densify(), jp.densify())
    equal(tp.densify(), tw)
    assert sparsity.metadata_bytes(tp) == jsparsity.metadata_bytes(jp)
    assert sparsity.values_bytes(tp) == jsparsity.values_bytes(jp)
    assert format_stats(tp)["density"] == tp.density
    with pytest.raises(ValueError):
        sparsity.pack_block_sparse(tw, BK, BN, pad_to=1)


@pytest.mark.parametrize("pad_to", [None, 6])
def test_combined_pack_equals_jax(pad_to):
    w = tile_zeroed(2)
    jw, _ = jpruning.combined_nm(jnp.asarray(w), 0.5, 2, 4, group=BN,
                                 block=BK)
    tw = torch.from_numpy(np.asarray(jw))
    jp = jsparsity.pack_combined(jw, 2, 4, BK, BN, pad_to=pad_to)
    tp = sparsity.pack_combined(tw, 2, 4, BK, BN, pad_to=pad_to)
    assert_packs_equal(tp, jp, ("values", "gidx", "indices", "counts"))
    assert (tp.n, tp.m, tp.bkc) == (jp.n, jp.m, jp.bkc) == (2, 4, 64)
    assert tp.gidx.dtype == torch.int32
    equal(tp.densify(), jp.densify())
    equal(tp.densify(), tw)
    assert sparsity.metadata_bytes(tp) == jsparsity.metadata_bytes(jp)
    assert sparsity.values_bytes(tp) == jsparsity.values_bytes(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookahead_pack_equals_jax(dtype):
    w = tile_zeroed(3)
    jw, _ = jpruning.block_semi_structured(jnp.asarray(w).astype(dtype), 0.5,
                                           block=4)
    tw, _ = pruning.block_semi_structured(
        torch.from_numpy(w).to(getattr(torch, dtype)), 0.5, block=4)
    equal(tw.float(), np.asarray(jw).astype(np.float32))
    jp = jsparsity.LookaheadPack.from_float(jw)
    tp = sparsity.LookaheadPack.from_float(tw)
    equal(tp.enc, jp.enc)
    equal(tp.scale, jp.scale)
    assert tp.scale.dtype == torch.float32 and (tp.K, tp.N) == (jp.K, jp.N)
    equal(tp.decode(), jp.decode())
    equal(tp.decode_int(), jp.decode_int())
    jb, tb = jp.to_block_sparse(BK, BN), tp.to_block_sparse(BK, BN)
    assert_packs_equal(tb, jb, ("values", "indices", "counts"))
    assert sparsity.metadata_bytes(tp) == 0
    assert sparsity.values_bytes(tp) == jsparsity.values_bytes(jp)


@pytest.mark.parametrize("fmt", ["combined", "block", "lookahead"])
def test_pack_params_equals_jax_pack_params(fmt):
    """The port's offline pass gives every layer the pack the JAX pass
    stacked for it; a block or combined layer may hold fewer padding
    slots (the JAX stack pads all layers to the largest count)."""
    _, _, _, tp_dense = build_params("dense", zero_tiles=True)
    _, _, cfg, tp_packed = build_params(fmt, zero_tiles=True)
    mine = pack_params(tp_dense, cfg)
    for l, layer in enumerate(mine["layers"]):
        for fam, names in PROJECTIONS:
            for name in names:
                got, want = layer[fam][name], tp_packed["layers"][l][fam][name]
                assert type(got) is type(want)
                if fmt == "lookahead":
                    equal(got.enc, want.enc)
                    equal(got.scale, want.scale)
                    continue
                equal(got.densify(), want.densify())
                equal(got.counts, want.counts)
                n = got.max_nnz
                assert n == int(got.counts.max()) <= want.max_nnz
                equal(got.indices, want.indices[:, :n])
                equal(got.values, want.values[:, :n])
                if fmt == "combined":
                    equal(got.gidx, want.gidx[:, :n])
                assert got.density == 0.5
    equal(mine["embed"], tp_dense["embed"])


@pytest.mark.parametrize("fmt", ["combined", "block", "lookahead"])
def test_params_from_numpy_carries_stacked_packs(fmt):
    """Each converted layer is the JAX stack's slice, padding included."""
    jcfg, jp, _, tp = build_params(fmt, zero_tiles=True)
    for fam, names in PROJECTIONS:
        for name in names:
            stack = jp["layers"][fam][name]
            arrays = ("enc", "scale") if fmt == "lookahead" else \
                ("values", "indices", "counts") + (
                    ("gidx",) if fmt == "combined" else ())
            for l in range(jcfg.n_layers):
                got = tp["layers"][l][fam][name]
                for f in arrays:
                    equal(getattr(got, f), np.asarray(getattr(stack, f))[l])
                    assert getattr(got, f).dtype in (torch.int8,
                                                     torch.int32,
                                                     torch.float32)
                assert (got.K, got.N) == (stack.K, stack.N)
            if fmt != "lookahead":
                assert got.max_nnz == stack.max_nnz
    if fmt != "lookahead":          # some strips hold padding slots
        packs = [layer[f][n] for layer in tp["layers"]
                 for f, ns in PROJECTIONS for n in ns]
        assert any(int(p.counts.min()) < p.max_nnz for p in packs)


def test_pack_to_moves_every_tensor():
    w = torch.from_numpy(tile_zeroed(4))
    for p in (sparsity.pack_block_sparse(w, BK, BN),
              sparsity.pack_combined(pruning.combined_nm(
                  w, 0.5, 2, 4, group=BN, block=BK)[0], 2, 4, BK, BN),
              sparsity.LookaheadPack.from_float(w),
              sparsity.pack_nm(pruning.n_m(w, 2, 4, BN)[0], 2, 4, BN)):
        moved = p.to("cpu")
        assert type(moved) is type(p)
        assert all(t.device.type == "cpu" for t in vars(moved).values()
                   if isinstance(t, torch.Tensor))
