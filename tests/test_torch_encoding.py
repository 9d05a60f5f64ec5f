"""The port's lookahead encoding (paper Algorithms 1 + 2) against the JAX
package's: the same int8 or float inputs give array-equal outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import sparsity as jsparsity
from repro_torch.core import encoding, sparsity


def int8_weights(seed, shape, zero_blocks=0.6):
    """int8 in [-100, 100] (the clamp has work to do) with about
    ``zero_blocks`` of the 4-blocks along axis 0 zeroed, plus one run of
    40 zero blocks (2..41) between non-zero blocks 1 and 42 in column 0 —
    longer than either cap."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-100, 101, size=shape).astype(np.int8)
    K, N = shape
    keep = rng.random((K // 4, N)) >= zero_blocks
    w = w * np.repeat(keep, 4, axis=0).astype(np.int8)
    w[8:168, 0] = 0
    w[4:8, 0] = w[168:172, 0] = 1
    return w


def equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int7_equals_jax(dtype):
    w = np.random.default_rng(0).normal(size=(256, 384)).astype(np.float32)
    w[:, 7] = 0                                  # an all-zero channel
    w[::5] = 0
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = jenc.quantize_int7(jw, axis=0)
    tq, ts = encoding.quantize_int7(tw, axis=0)
    assert tq.dtype == torch.int8 and ts.dtype == tw.dtype
    equal(tq, jq)
    equal(ts.float(), np.asarray(js).astype(np.float32))
    assert int(tq.min()) >= -64 and int(tq.max()) <= 63
    assert (tq[w == 0] == 0).all()               # zeros stay zero


@pytest.mark.parametrize("cap", [15, 3])
def test_skip_counts_equal_jax(cap):
    rng = np.random.default_rng(cap)
    z = rng.random((6, 96)) < 0.8
    z[0, 10:60] = True                           # a run longer than cap
    z[1] = True                                  # an all-zero stream
    z[2] = False
    got = encoding.skip_counts(torch.from_numpy(z), cap=cap)
    assert got.dtype == torch.uint8 and int(got.max()) == cap
    equal(got, jenc.skip_counts(jnp.asarray(z), cap=cap))


@pytest.mark.parametrize("cap", [15, 3])
def test_encode_and_decode_equal_jax(cap):
    w = int8_weights(cap, (256, 64))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    equal(encoding.clamp_int7(tw), jenc.clamp_int7(jw))
    equal(encoding.block_is_zero(tw.T), jenc.block_is_zero(jw.T))
    enc = encoding.encode_weight_matrix(tw, cap=cap)
    jenc_w = jenc.encode_weight_matrix(jw, cap=cap)
    equal(enc, jenc_w)
    vals, skips = encoding.decode_weight_matrix(enc)
    jvals, jskips = jenc.decode_weight_matrix(jenc_w)
    equal(vals, jvals)
    equal(skips, jskips)
    equal(vals, np.clip(w, -64, 63))             # lossless given the clamp
    s = torch.from_numpy(np.random.default_rng(1).integers(
        0, 16, size=(64, 64)).astype(np.uint8))
    blocks = encoding.clamp_int7(tw.T).reshape(64, 64, 4)
    bits = encoding.encode_block_bits(blocks, s)
    equal(bits, jenc.encode_block_bits(jnp.asarray(blocks.numpy()),
                                       jnp.asarray(s.numpy())))
    equal(encoding.decode_skip(bits), s)
    equal(encoding.decode_values(bits), blocks)


@pytest.mark.parametrize("cap", [15, 3])
def test_walks_equal_jax(cap):
    w = int8_weights(10 + cap, (256, 24))
    enc = encoding.encode_weight_matrix(torch.from_numpy(w), cap=cap)
    for j in range(w.shape[1]):
        got = encoding.simulate_walk(enc[:, j].numpy(), cap=cap)
        assert got == jenc.simulate_walk(enc[:, j].numpy(), cap=cap)
        nonzero = np.nonzero(np.any(
            w[:, j].reshape(-1, 4) != 0, axis=1))[0].tolist()
        assert set(nonzero) <= set(got)          # every non-zero block
    assert sparsity.skip_lists_from_encoded(enc) == \
        jsparsity.skip_lists_from_encoded(np.asarray(enc))
    # column 0's 40-block run is crossed in hops of cap + 1 blocks: the
    # walker lands on the zero blocks whose counters continue the chain
    walk0 = encoding.simulate_walk(enc[:, 0].numpy(), cap=cap)
    assert 1 in walk0 and 42 in walk0
    assert sum(2 <= b < 42 for b in walk0) == 40 // (cap + 1)
