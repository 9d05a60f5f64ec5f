"""Table II's CNN training in the port
(``repro_torch.benchmarks.bench_int7._train``) against the JAX package's
``benchmarks/bench_int7.py::_train``, on the CPU.

Both train the DS-CNN of Table II's third row (width 0.5, 12 classes,
49 x 10 inputs) for three AdamW steps from the same weights: the JAX init
of seed 0, carried over by ``convert.cnn_params_from_numpy``; the batches
come from the same numpy generator on both sides.  Adam runs at eps 1e-3
in both (patched here, never in the JAX file): its first step is ±lr for
any gradient, so at eps 1e-8 a gradient of ~1e-9 that sums to another
sign moves a weight by 2 lr.

The two run in float64 (weights and data; AdamW keeps its float32
moments and rounds each step through float32 on both sides, as it does
for any dtype), on one ``class_data`` draw of 4096 training samples and
256 held out (the bench draws 1024 held out; evaluating them in float64
is most of the test's time, and both sides see the same draw).  In float32 the JAX package's gradients of this CNN on
the CPU are ~1e-2 of each leaf's largest entry off their float64 values
(the batch-statistics BatchNorm backward), while the port's are ~1e-6
off; in float64 the two frameworks' gradients agree to 1e-13, so the
comparison sees the port's training and not the reference's rounding.

Tolerances: every trained leaf within 1e-5 of its largest entry; the INT8
and INT7 fake-quantizations of one set of weights equal in the two
frameworks, those of the two trained sets within one quantization step;
accuracies and prediction agreements within one held-out sample.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_int7 as jbench
from repro import optim as joptim
from repro.models import cnn as jcnn
from repro_torch import optim as toptim
from repro_torch.benchmarks import bench_int7 as tbench
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.models import cnn as tcnn

STEPS = 3
EPS = 1e-3
RTOL = 1e-5
HELD_OUT = 256                      # held-out samples after the 4096
ONE_SAMPLE = 1 / HELD_OUT + 1e-9
MODEL, SHAPE, CLASSES, WIDTH, _ = next(r for r in jbench.RUNS
                                       if r[0] == "dscnn")
QUANT = (None, False, True)         # fp32, INT8, INT7


def carried(jparams):
    """JAX CNN params as the port's (OIHW convolutions), on the CPU."""
    return cnn_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")


def flat(tree):
    return jax.tree_util.tree_leaves(tree)


def float64_data(class_data):
    """``class_data`` as ``_train`` calls it, in float64 and with
    ``HELD_OUT`` samples after the 4096 it trains on."""
    @functools.wraps(class_data)
    def data(seed, n, shape, classes):
        x, y = class_data(seed, 4096 + HELD_OUT, shape, classes)
        return x.astype(np.float64), y
    return data


def quantized(cnn, params, bits7):
    return params if bits7 is None else \
        cnn.quantize_dequantize(params, bits7=bits7)


@pytest.fixture(scope="module")
def trained():
    """Both sides after ``STEPS`` steps from one init: ``params`` (the
    port's tree; JAX's carried over), ``preds`` (held-out predictions
    per ``QUANT``), ``quant`` (the INT8 / INT7 trees) and, on the port's
    side, ``of_jax``: the port's quantizations of the JAX weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(joptim, "AdamWConfig",
               functools.partial(joptim.AdamWConfig, eps=EPS))
    mp.setattr(toptim, "AdamWConfig",
               functools.partial(toptim.AdamWConfig, eps=EPS))
    mp.setattr(jbench, "class_data", float64_data(jbench.class_data))
    mp.setattr(tbench, "class_data", float64_data(tbench.class_data))
    jinit, japply = jcnn.CNN_ZOO[MODEL]
    mp.setitem(jcnn.CNN_ZOO, MODEL, (lambda *a, **kw: jax.tree.map(
        lambda t: t.astype(jnp.float64), jinit(*a, **kw)), japply))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with jax.enable_x64(True):
            init = jcnn.CNN_ZOO[MODEL][0](jax.random.key(0),
                                          num_classes=CLASSES, width=WIDTH)
            jp, _, jpreds = jbench._train(MODEL, SHAPE, CLASSES, WIDTH,
                                          STEPS)
            jpred = [np.asarray(jpreds(quantized(jcnn, jp, b)))
                     for b in QUANT]
            out["jax"] = {"params": carried(jp), "preds": jpred,
                          "quant": [carried(quantized(jcnn, jp, b))
                                    for b in QUANT[1:]]}
            out["init"] = carried(init)
            tp, _, tpreds = tbench._train(MODEL, SHAPE, CLASSES, WIDTH,
                                          STEPS, params=carried(init),
                                          device="cpu")
            out["port"] = {
                "params": tp,
                "preds": [tpreds(quantized(tcnn, tp, b)).numpy()
                          for b in QUANT],
                "quant": [quantized(tcnn, tp, b) for b in QUANT[1:]],
                "of_jax": [tcnn.quantize_dequantize(carried(jp), bits7=b)
                           for b in QUANT[1:]]}
        yield out
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def test_default_init_is_the_ports_own():
    """Without ``params`` the port trains from its own seeded init, the
    CNN of the port's ``CNN_ZOO``."""
    params, acc_of, _ = tbench._train(MODEL, SHAPE, CLASSES, WIDTH, 0,
                                      device="cpu")
    want = tcnn.CNN_ZOO[MODEL][0](seed=0, num_classes=CLASSES, width=WIDTH,
                                  device="cpu")
    for a, b in zip(flat(params), flat(want)):
        assert torch.equal(a, b)
    assert 0.0 <= acc_of(params) <= 1.0


def test_trained_params_match_jax(trained):
    """Every leaf after the steps within ``RTOL`` of its largest entry;
    the steps moved the weights (the comparison is not of the init)."""
    got, want = flat(trained["port"]["params"]), \
        flat(trained["jax"]["params"])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=RTOL * float(b.abs().max()) + 1e-12)
    assert any(float((a - b).abs().max()) > 1e-4
               for a, b in zip(got, flat(trained["init"])))


@pytest.mark.parametrize("i,bits7", [(0, False), (1, True)])
def test_quantize_dequantize_matches_jax(trained, i, bits7):
    """The JAX-trained weights fake-quantized in each framework are equal;
    the two trained sets' quantizations are within one quantization step
    (an entry at a rounding boundary may round either way)."""
    want = flat(trained["jax"]["quant"][i])
    for a, b in zip(flat(trained["port"]["of_jax"][i]), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    levels = 63 if bits7 else 127
    for a, b, w in zip(flat(trained["port"]["quant"][i]), want,
                       flat(trained["jax"]["params"])):
        step = float(w.abs().max()) / levels
        assert float((a.double() - b.double()).abs().max()) <= \
            step * 1.001 + 1e-12


def test_accuracies_match_jax(trained):
    """fp32, INT8 and INT7 accuracies and the agreements with the fp32
    predictions (``bench_int7.run``'s columns)."""
    _, y = float64_data(jbench.class_data)(0, None, SHAPE, CLASSES)
    y = y[4096:]
    for key in ("acc", "agree"):
        got, want = ([float(np.mean(p == (y if key == "acc" else
                                          trained[side]["preds"][0])))
                      for p in trained[side]["preds"]]
                     for side in ("port", "jax"))
        np.testing.assert_allclose(got, want, rtol=0, atol=ONE_SAMPLE)
