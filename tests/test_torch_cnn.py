"""The port's TinyML CNNs (``repro_torch.models.cnn``) against the JAX
package's on the same weights: JAX ``init`` → ``cnn_params_from_numpy``
→ the port's ``apply`` against JAX's ``apply``, at width 0.25 and batch
2 on the paper's input geometries, dense, INT7/INT8 fake-quantized and
combined-pruned.

Tolerance: logits agree to rtol 1e-4 of the largest logit (float32 on
the CPU; the convolutions and the batch-norm reductions sum in other
orders in the two frameworks).  Quantized and pruned weights are
array-equal before they reach the model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.models import cnn as jcnn
from repro_torch.configs.tinyml import PAPER_MODELS
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.models import cnn

RTOL = 1e-4
WIDTH, BATCH = 0.25, 2
X_SS = X_US = 0.6                  # the largest Fig. 10 point


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_equal(tp, jp):
    """The port's params equal the JAX params carried over."""
    want = jax.tree_util.tree_leaves(cnn_params_from_numpy(to_numpy(jp),
                                                           device="cpu"))
    got = jax.tree_util.tree_leaves(tp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def jax_prune_combined(params, x_ss, x_us):
    """The JAX side of ``cnn.prune_combined``: ``pruning.combined`` on each
    kernel's HWIO-flattened view, K zero-padded to the block of 4."""
    def prune(w):
        flat = w.reshape(-1, w.shape[-1])
        K = flat.shape[0]
        pw, _ = jpruning.combined(jnp.pad(flat, ((0, -K % 4), (0, 0))),
                                  x_ss=x_ss, x_us=x_us)
        return pw[:K].reshape(w.shape)
    return jcnn.map_weights(params, prune)


@pytest.fixture(scope="module")
def models():
    """Per model: JAX params, the jitted JAX apply and a batch of inputs."""
    out = {}
    for i, (name, spec) in enumerate(PAPER_MODELS.items()):
        jinit, japply = jcnn.CNN_ZOO[name]
        jp = jinit(jax.random.key(i), num_classes=spec["classes"],
                   width=WIDTH)
        x = np.random.default_rng(i).normal(
            size=(BATCH, *spec["input"])).astype(np.float32)
        out[name] = (jp, jax.jit(japply), x)
    return out


def variant(name, jp, which):
    """(JAX params, port params) of one weight variant."""
    tp = cnn_params_from_numpy(to_numpy(jp), device="cpu")
    if which == "dense":
        return jp, tp
    if which in ("int7", "int8"):
        bits7 = which == "int7"
        return (jcnn.quantize_dequantize(jp, bits7=bits7),
                cnn.quantize_dequantize(tp, bits7=bits7))
    return (jax_prune_combined(jp, X_SS, X_US),
            cnn.prune_combined(tp, X_SS, X_US))


@pytest.mark.parametrize("which", ["dense", "int7", "int8", "combined"])
@pytest.mark.parametrize("name", list(PAPER_MODELS))
def test_logits_equal_jax(models, name, which):
    jp0, japply, x = models[name]
    jp, tp = variant(name, jp0, which)
    leaves_equal(tp, jp)
    want = np.asarray(japply(jp, jnp.asarray(x)))
    got = cnn.CNN_ZOO[name][1](tp, torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, PAPER_MODELS[name]["classes"])
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_combined_pruning_reaches_the_target():
    tp = cnn.init_dscnn(seed=0, width=1.0, device="cpu")
    pruned = cnn.prune_combined(tp, X_SS, X_US)
    w = cnn.oihw_to_hwio(pruned["blocks"][0]["pw"]["w"])
    zeros = float((w == 0).float().mean())
    assert abs(zeros - (X_SS + (1 - X_SS) * X_US)) < 0.01


def test_dscnn_stem_same_padding_equals_jax():
    """The (10, 4) stem at stride 2 on 49×10: XLA's "SAME" pads H 4/5 and
    W 1/1, so the output is (25, 5) and equal to JAX's, not shifted."""
    assert cnn.same_pad(49, 10, 2) == (4, 5)
    assert cnn.same_pad(10, 4, 2) == (1, 1)
    assert cnn.same_pad(96, 3, 2) == (0, 1)
    assert cnn.same_pad(32, 3, 2) == (0, 1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 49, 10, 1)).astype(np.float32)
    w = rng.normal(size=(10, 4, 1, 8)).astype(np.float32)
    want = np.asarray(jcnn.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2))
    got = cnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     cnn.hwio_to_oihw(torch.from_numpy(w)), stride=2)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 25, 5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,groups", [(2, 1), (1, 1), (2, 8)])
def test_conv_same_padding_equals_jax(stride, groups):
    """3×3 convolutions, dense and depthwise, at both strides on an even
    (32) and an odd (15) input."""
    rng = np.random.default_rng(stride + groups)
    for hw in (32, 15):
        x = rng.normal(size=(1, hw, hw, 8)).astype(np.float32)
        w = rng.normal(size=(3, 3, 8 // groups, 8)).astype(np.float32)
        want = np.asarray(jcnn.conv2d(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride, groups=groups))
        got = cnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         cnn.hwio_to_oihw(torch.from_numpy(w)),
                         stride=stride, groups=groups)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_map_weights_leaves_proj_alone_as_jax():
    """``map_weights`` touches only kernels whose key starts with ``w``:
    ResNet-56's ``proj`` shortcuts keep their weights, in both packages."""
    jp = jcnn.init_resnet56(jax.random.key(0), width=0.25, n_blocks=1)
    jz = jcnn.map_weights(jp, lambda w: w * 0)
    tz = cnn.map_weights(cnn_params_from_numpy(to_numpy(jp), device="cpu"),
                         lambda w: w * 0)
    leaves_equal(tz, jz)
    blk = tz["stages"][1][0]
    assert (blk["w1"] == 0).all() and (tz["fc"]["w"] == 0).all()
    assert (blk["proj"] != 0).any()
    assert (blk["bn1"]["scale"] == 1).all()


@pytest.mark.parametrize("name", list(PAPER_MODELS))
def test_init_shapes_match_jax(name):
    """The port's own init builds the JAX tree's shapes (convs in OIHW)."""
    spec = PAPER_MODELS[name]
    jp = jcnn.CNN_ZOO[name][0](jax.random.key(0), num_classes=spec["classes"],
                                width=WIDTH)
    tp = cnn.CNN_ZOO[name][0](seed=0, num_classes=spec["classes"],
                              width=WIDTH, device="cpu")
    want = jax.tree_util.tree_leaves(cnn_params_from_numpy(to_numpy(jp),
                                                           device="cpu"))
    got = jax.tree_util.tree_leaves(tp)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    again = cnn.CNN_ZOO[name][0](seed=0, num_classes=spec["classes"],
                                 width=WIDTH, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(got, jax.tree_util.tree_leaves(again)))
