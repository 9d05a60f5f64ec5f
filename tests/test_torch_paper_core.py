"""The paper layer's offline helpers of the port against the JAX package's:
``encoding.quantize_int8`` / ``tile_zero_map`` / ``tile_skip_counts``,
``pruning.unstructured`` / ``combined`` / ``iterative_schedule`` /
``sparsity_of`` / ``prune`` and ``sparse_linear.sparsify_weight``.  The
same numpy inputs give array-equal outputs (masks, quantized weights,
packs); the schedule is Python float arithmetic and equal too."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tinyml import FIG10_CONFIGS as JFIG10
from repro.core import encoding as jenc
from repro.core import pruning as jpruning
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import sparsify_weight as jsparsify
from repro_torch.configs.tinyml import FIG10_CONFIGS, PAPER_MODELS
from repro_torch.core import encoding, pruning
from repro_torch.core.sparse_linear import SparsityConfig, sparsify_weight


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


# --- encoding -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_equals_jax(dtype, axis):
    w = normal(0, (256, 384))
    w[:, 7] = 0                                  # an all-zero channel
    w[3] = 0                                     # an all-zero row
    w[5, 5] = 1e-3                               # halves at the rounding
    jq, js = jenc.quantize_int8(jnp.asarray(w).astype(dtype), axis=axis)
    tq, ts = encoding.quantize_int8(
        torch.from_numpy(w).to(getattr(torch, dtype)), axis=axis)
    equal(tq.numpy(), jq)
    equal(ts.float().numpy(), np.asarray(js, np.float32))
    assert tq.dtype == torch.int8 and int(tq.abs().max()) <= 127


def tile_zeroed(seed, K, N, bk, bn):
    w = normal(seed, (K, N))
    rng = np.random.default_rng(seed + 1)
    zero = rng.random((K // bk, N // bn)) < 0.6
    zero[1:, 0] = True                           # a run past the cap
    return w * np.repeat(np.repeat(~zero, bk, 0), bn, 1)


@pytest.mark.parametrize("bk,bn", [(4, 4), (8, 16), (128, 128)])
def test_tile_zero_map_and_skip_counts_equal_jax(bk, bn):
    K, N = bk * 40, bn * 3
    w = tile_zeroed(bk + bn, K, N, bk, bn)
    equal(encoding.tile_zero_map(torch.from_numpy(w), bk, bn).numpy(),
          jenc.tile_zero_map(jnp.asarray(w), bk, bn))
    for cap in (15, 3):
        got = encoding.tile_skip_counts(torch.from_numpy(w), bk, bn, cap=cap)
        want = jenc.tile_skip_counts(jnp.asarray(w), bk, bn, cap=cap)
        assert got.dtype == torch.uint8
        equal(got.numpy(), want)


def test_tile_zero_map_refuses_ragged_tiles():
    with pytest.raises(ValueError):
        encoding.tile_zero_map(torch.zeros(130, 128), 128, 128)


# --- pruning ------------------------------------------------------------------

SHAPES = [(64, 8), (256, 96), (1000, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.77])
def test_unstructured_equals_jax(shape, sparsity):
    for seed in (0, 1, 2):
        w = normal(seed, shape)
        w.reshape(-1)[:7] = 0.5                  # ties at a threshold
        jw, jmask = jpruning.unstructured(jnp.asarray(w), sparsity)
        tw, tmask = pruning.unstructured(torch.from_numpy(w), sparsity)
        equal(tmask.numpy(), jmask)
        equal(tw.numpy(), jw)


@pytest.mark.parametrize("shape", [(64, 8), (256, 96), (1024, 3)], ids=str)
@pytest.mark.parametrize("x_ss,x_us", [(0.5, 0.5), (0.25, 0.7),
                                       (0.6, 0.6), (0.0, 0.33)])
def test_combined_equals_jax(shape, x_ss, x_us):
    for seed in (0, 1, 2):
        w = normal(seed + 10, shape)
        jw, jmask = jpruning.combined(jnp.asarray(w), x_ss=x_ss, x_us=x_us)
        tw, tmask = pruning.combined(torch.from_numpy(w), x_ss=x_ss,
                                     x_us=x_us)
        equal(tmask.numpy(), jmask)
        equal(tw.numpy(), jw)


@pytest.mark.parametrize("x_us,x_ss", FIG10_CONFIGS)
def test_combined_full_vgg16_layer_equals_jax(x_us, x_ss):
    """One full-width VGG16 layer (3·3·512 × 512) at each Fig. 10 point:
    the float32 ``keep`` rounds as JAX's does."""
    assert (x_us, x_ss) in JFIG10
    w = normal(7, (4608, 512))
    _, jmask = jpruning.combined(jnp.asarray(w), x_ss=x_ss, x_us=x_us)
    _, tmask = pruning.combined(torch.from_numpy(w), x_ss=x_ss, x_us=x_us)
    equal(tmask.numpy(), jmask)
    want = x_ss + (1 - x_ss) * x_us
    assert abs(pruning.sparsity_of(tmask) - want) < 1e-3


def test_fig10_configs_and_models_equal_jax():
    from repro.configs import tinyml as jt
    from repro_torch.configs import tinyml as tt
    assert FIG10_CONFIGS == jt.FIG10_CONFIGS
    assert PAPER_MODELS == jt.PAPER_MODELS
    assert dataclasses.asdict(tt.TinyMLRun("dscnn")) == \
        dataclasses.asdict(jt.TinyMLRun("dscnn"))


@pytest.mark.parametrize("target,steps,power", [(0.9, 10, 3.0),
                                                (0.5, 1, 3.0),
                                                (0.75, 7, 2.0)])
def test_iterative_schedule_equals_jax(target, steps, power):
    got = pruning.iterative_schedule(target, steps, power)
    assert got == jpruning.iterative_schedule(target, steps, power)
    assert got[-1] == target


def test_iterative_schedule_refuses_no_steps():
    with pytest.raises(ValueError):
        pruning.iterative_schedule(0.5, 0)


@pytest.mark.parametrize("shape", [(3, 7), (256, 96), (11, 13, 17)],
                         ids=str)
def test_sparsity_of_equals_jax(shape):
    for seed in range(3):
        w = normal(seed, shape)
        w[np.random.default_rng(seed).random(shape) < 0.37] = 0
        assert pruning.sparsity_of(torch.from_numpy(w)) == \
            jpruning.sparsity_of(jnp.asarray(w))


@pytest.mark.parametrize("method,kw", [
    ("unstructured", dict(sparsity=0.6)),
    ("block", dict(sparsity=0.5, block=4)),
    ("nm", dict(n=2, m=4, group=8)),
    ("combined", dict(x_ss=0.5, x_us=0.5)),
    ("combined_nm", dict(x_ss=0.5, n=2, m=4, group=8)),
])
def test_prune_dispatch_equals_jax(method, kw):
    w = normal(3, (128, 64))
    jw, jmask = jpruning.prune(jnp.asarray(w), method, **kw)
    tw, tmask = pruning.prune(torch.from_numpy(w), method, **kw)
    equal(tmask.numpy(), jmask)
    equal(tw.numpy(), jw)


def test_prune_refuses_unknown_method():
    with pytest.raises(ValueError):
        pruning.prune(torch.zeros(8, 8), "magic")


# --- sparsify_weight -----------------------------------------------------------

FORMATS = {
    "nm": dict(format="nm", n=2, m=4, block_n=128),
    "block": dict(format="block", sparsity=0.5, block_k=128, block_n=128),
    "combined": dict(format="combined", sparsity=0.5, n=2, m=4,
                     block_k=128, block_n=128),
    "lookahead": dict(format="lookahead", sparsity=0.5),
    "dense": dict(format="dense"),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_sparsify_weight_equals_jax(fmt):
    w = normal(4, (512, 384))
    w[:256, 128:256] = 0                         # one empty tile pair
    tp = sparsify_weight(torch.from_numpy(w), SparsityConfig(**FORMATS[fmt]))
    jp = jsparsify(jnp.asarray(w), JSparsity(**FORMATS[fmt]))
    if fmt == "dense":
        equal(tp.numpy(), jp)
        return
    for f in dataclasses.fields(jp):
        got, want = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(want, int):
            assert got == want, f.name
        else:
            equal(got.numpy(), want)
