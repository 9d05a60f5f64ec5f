"""The port's training path against the JAX package on the CPU.

  * schedules: equal at every step (to 1 ulp: XLA's float32 cosine is
    not correctly rounded, the port's is);
  * AdamW with masks, clipping and a schedule: params, moments and
    metrics within 1e-6 of JAX's after each of 3 steps;
  * int8 compression: payload equal, scale within 1 ulp, and
    ``compress_tree``'s error feedback (the twin of
    ``tests/test_optim_trainer.py``'s drift test);
  * three ``build_train_step`` steps from the same JAX init, optimizer
    state and numpy batches as the jitted JAX step (Auto-axis mesh):
    params within 1e-6 plus 1e-5 of each leaf's largest, loss and grad
    norm within 1e-5 relative, with 2 microbatches and masks; with
    compressed grads the first step's state (a few int8 codes may round
    apart) and every step's loss and grad norm; 2 microbatches equal the
    full batch on the port;
  * weight decay on a layer stack's 1-d leaves, as JAX decays its
    stacked ``(L, d)`` leaves;
  * the twins of ``TestTrainerEndToEnd`` on the port: loss drops, a
    restart resumes bitwise, compressed grads still learn, masks survive;
  * a retry after a failure injected after the backward equals an
    undisturbed run bitwise; other errors are not retried;
  * the twins of ``tests/test_checkpoint.py`` (resharding comes with
    tensor parallelism) with bfloat16 leaves;
  * the data stream's structure, determinism and host sharding, and
    ``class_data`` bit-equal to JAX's;
  * the training route reaches no kernel, and a kernel wrapper refuses
    an input that requires grad;
  * ``python -m repro_torch.launch.train`` on the CPU.
"""

import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.core import pruning as jpruning
from repro.data import class_data as jclass_data
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedules as jschedules
from repro.train import trainer as jtrainer
from repro_torch import models as TM
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    restore_latest, save_checkpoint)
from repro_torch.convert import params_from_numpy
from repro_torch.core import pruning
from repro_torch.data import DataConfig, batch_for, class_data, make_batch
from repro_torch.data import pipeline
from repro_torch.kernels import dispatch
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_int8, compress_tree, cosine_warmup,
                               decompress_int8, linear_warmup)
from repro_torch.optim import schedules as tschedules
from repro_torch.train import (TrainConfig, Trainer, build_train_step,
                               init_opt_state)
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves, tree_map, with_paths
from test_torch_loss import O0, jax_init
from test_torch_model import jax_mesh

TINY_KW = dict(name="tiny", n_layers=2, d_model=64, vocab_size=512,
               n_heads=4, n_kv_heads=2, d_ff=128, remat=False)
TINY = TModelConfig(**TINY_KW)
STEP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matmuls on several CPU threads spend their time in the
    thread pool; one thread per test process is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(node):
    """A JAX tree as nested dicts of numpy arrays, ``None`` kept."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: flatten(v) for k, v in node.items()}
    return np.asarray(node)


def by_path(tree):
    return {k: v for k, v in with_paths(tree) if v is not None}


def assert_trees_close(got, want, rtol=0.0, atol=0.0, scaled=None,
                       outliers=0.0):
    """Leaf by leaf by path; ``scaled`` adds ``scaled × max|want leaf|``
    to the absolute tolerance; ``outliers`` is the share of a leaf's
    elements allowed outside it (at least one where it is not 0)."""
    got, want = by_path(got), by_path(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g = got[k].numpy()
        tol = atol + (scaled * float(np.abs(w).max()) if scaled else 0.0)
        bad = np.abs(g - w) > tol + rtol * np.abs(w)
        if bad.sum() > (max(1, outliers * bad.size) if outliers else 0):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# schedules, AdamW, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["constant", "linear", "cosine",
                                   "cosine_short"])
def test_schedules_equal_jax_at_every_step(which):
    make = {"constant": lambda m: m.constant(),
            "linear": lambda m: m.linear_warmup(7),
            "cosine": lambda m: m.cosine_warmup(10, 100),
            "cosine_short": lambda m: m.cosine_warmup(20, 120, 0.1)}[which]
    jf, tf = make(jschedules), make(tschedules)
    want = np.array([np.float32(jf(jnp.asarray(s, jnp.int32)))
                     for s in range(150)])
    got = np.array([tf(s) for s in range(150)])
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _adamw_tree(rng):
    return {"w": rng.normal(size=(8, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "blk": {"k": rng.normal(size=(4, 16)).astype(np.float32)}}


def test_adamw_update_matches_jax_with_masks_clip_schedule():
    rng = np.random.default_rng(0)
    params = _adamw_tree(rng)
    mask = (rng.random((8, 8)) < 0.5).astype(np.float32)
    params["w"] *= mask
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip=0.5)
    jcfg = jadamw.AdamWConfig(**kw,
                              schedule=jschedules.cosine_warmup(2, 10))
    tcfg = AdamWConfig(**kw, schedule=cosine_warmup(2, 10))
    jp = jax.tree.map(jnp.asarray, params)
    jm = {"w": jnp.asarray(mask), "b": None, "blk": {"k": None}}
    tp = tree_map(torch.from_numpy, params)
    tm = {"w": torch.from_numpy(mask), "b": None, "blk": {"k": None}}
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        grads = _adamw_tree(rng)
        jp, js, jmet = jadamw.adamw_update(
            jcfg, jp, jax.tree.map(jnp.asarray, grads), js, masks=jm)
        tp, ts, tmet = adamw_update(tcfg, tp, tree_map(torch.from_numpy,
                                                       grads), ts, masks=tm)
        assert_trees_close(tp, flatten(jp), atol=1e-6)
        assert_trees_close(ts["mu"], flatten(js["mu"]), atol=1e-6)
        assert_trees_close(ts["nu"], flatten(js["nu"]), atol=1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].device.type == "cpu"
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        assert tmet["lr"] == np.float32(jmet["lr"])
        assert float(tmet["grad_norm"]) > kw["grad_clip"]  # the clip bites
    assert bool((tp["w"][torch.from_numpy(mask) == 0] == 0).all())


def test_adamw_decays_layer_stacks_by_their_stacked_rank():
    """JAX decays leaves of rank >= 2 in its stacked tree, where a layer
    stack's 1-d norm scales are ``(L, d)`` matrices: the port decays them
    in its per-layer lists too, and leaves unstacked 1-d leaves alone."""
    rng = np.random.default_rng(4)

    def tree():
        return {"embed": rng.normal(size=(16, 8)).astype(np.float32),
                "layers": {"ln": rng.normal(size=(3, 8)).astype(np.float32),
                           "w": rng.normal(size=(3, 8, 8)).astype(np.float32)},
                "final_norm": rng.normal(size=(8,)).astype(np.float32)}

    params = tree()
    kw = dict(lr=0.05, weight_decay=0.5, grad_clip=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    jupdate = jax.jit(functools.partial(jadamw.adamw_update, jcfg))
    for _ in range(3):
        grads = tree()
        jp, js, _ = jupdate(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, _ = adamw_update(tcfg, tp, params_from_numpy(grads, "cpu"),
                                 ts)
        assert_trees_close(tp, params_from_numpy(flatten(jp), "cpu"),
                           atol=1e-6)
    # and the rule is what moved them: without decay the scales differ
    nodecay = dataclasses.replace(tcfg, weight_decay=0.0)
    tp0 = params_from_numpy(params, "cpu")
    g0 = params_from_numpy(tree(), "cpu")
    a = adamw_update(tcfg, tp0, g0, adamw_init(tp0))[0]
    b = adamw_update(nodecay, tp0, g0, adamw_init(tp0))[0]
    assert not torch.equal(a["layers"][0]["ln"], b["layers"][0]["ln"])
    assert torch.equal(a["final_norm"], b["final_norm"])


def test_adamw_leaves_its_inputs_untouched():
    """The update is functional: a retried step sees the same state."""
    rng = np.random.default_rng(1)
    tp = tree_map(torch.from_numpy, _adamw_tree(rng))
    ts = adamw_init(tp)
    grads = tree_map(torch.from_numpy, _adamw_tree(rng))
    before = [t.clone() for t in leaves([tp, ts["mu"], ts["nu"], grads])]
    adamw_update(AdamWConfig(), tp, grads, ts)
    after = leaves([tp, ts["mu"], ts["nu"], grads])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(ts["step"]) == 0


def test_descends_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([2.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        params, state, _ = adamw_update(cfg, params,
                                        {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.1
    assert float(linear_warmup(4)(2)) == 0.5


def test_compress_int8_matches_jax():
    rng = np.random.default_rng(2)
    for g in (rng.normal(size=(128,)).astype(np.float32),
              rng.normal(size=(16, 9)).astype(np.float32) * 1e-3,
              np.zeros((5,), np.float32)):
        jq, js = jcompression.compress_int8(jnp.asarray(g))
        tq, tscale = compress_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(tscale.numpy(), np.asarray(js),
                                        maxulp=1)
        back = decompress_int8(tq, tscale)
        assert float((back - torch.from_numpy(g)).abs().max()) \
            <= float(tscale) * 0.51


def test_compress_tree_error_feedback():
    """Twin of the JAX drift test, and each step's payload and residual
    equal to JAX's ``compress_tree``."""
    g = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    terr = jerr = None
    total_true = np.zeros(64, np.float32)
    total_sent = torch.zeros(64)
    for i in range(50):
        gi = g * np.float32(1 + 0.01 * i)
        total_true += gi
        payload, terr, approx = compress_tree({"w": torch.from_numpy(gi)},
                                              terr)
        jpay, jerr, _ = jcompression.compress_tree({"w": jnp.asarray(gi)},
                                                   jerr)
        np.testing.assert_array_equal(payload["w"]["q"].numpy(),
                                      np.asarray(jpay["w"]["q"]))
        np.testing.assert_allclose(terr["w"].numpy(), np.asarray(jerr["w"]),
                                   atol=1e-6)
        total_sent += approx["w"]
    drift = float(np.abs(total_true - total_sent.numpy()).max())
    assert drift <= float(np.abs(g).max()) / 127 * 1.01


# ---------------------------------------------------------------------------
# build_train_step against the jitted JAX step
# ---------------------------------------------------------------------------

def _np_batches(cfg, n, batch=4, seq=16, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
        out.append({"tokens": s[:, :-1], "labels": s[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_tiny(dtype):
    """The JAX init of the TINY config (one draw for every test)."""
    jcfg = JModelConfig(**TINY_KW, dtype=dtype)
    return jcfg, jax_init(jcfg)


def _jax_masks(jp):
    """2:4 masks (group 16) on every MLP ``w_in``, ``None`` elsewhere."""
    def rule(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if "w_in" in names:
            flat = leaf.reshape(-1, leaf.shape[-1]).astype(jnp.float32)
            _, m = jpruning.n_m(flat, 2, 4, group=16)
            return m.reshape(leaf.shape).astype(leaf.dtype)
        return None
    return jax.tree_util.tree_map_with_path(rule, jp)


STEP_VARIANTS = {
    "micro2_masked": dict(microbatches=2),
    "compressed": dict(compress_grads=True),
}
#: params: STEP_ATOL plus STEP_RTOL of each leaf's largest magnitude.
#: The norm scales (largest ~1e-2) carry float32 noise of ~6e-8 after 3
#: steps; weight decay on them (JAX decays a layer stack's (L, d) scales)
#: moves them by ~7e-6, which this tolerance sees
STEP_ATOL = 1e-6
#: moments: of each leaf's largest magnitude (a gradient entry carries
#: float32 noise of ~1e-6 of its leaf's largest)
MOMENT_RTOL = 1e-4
#: under compressed grads, the share of a leaf's elements that may
#: differ more after the first step: int8 rounding is discontinuous, and
#: a gradient entry within float32 noise of a rounding boundary takes the
#: neighbouring code on one side (2 entries of 106,816); the grad norm,
#: taken after compression, moves with such codes (3e-5 relative by the
#: third step)
FLIP_SHARE = 5e-3
FLIP_NORM_RTOL = 1e-4


#: Adam's epsilon in the step comparison.  The update divides by
#: sqrt(v̂) + eps, so a gradient entry at float32's noise floor (~3e-8
#: here, against a largest entry of ~0.03) is normalized to about ±1 on
#: either side, whichever sign its noise takes, and moves its param by
#: ±lr.  At eps = 1e-3 that gain is at most 1e3 and the comparison is
#: well-conditioned; the arithmetic compared is the same.
STEP_EPS = 1e-3


@pytest.fixture(scope="module", params=list(STEP_VARIANTS))
def step_case(request):
    """Three steps of the jitted JAX step and of the port's from the
    same state, both at ``STEP_EPS``: (variant, masks, the port's
    per-step results, JAX's)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, cls in ((jtrainer, jadamw.AdamWConfig),
                         (ttrainer, AdamWConfig)):
            mp.setattr(mod, "AdamWConfig",
                       lambda cls=cls, **kw: cls(eps=STEP_EPS, **kw))
        return _run_steps(request.param)


def _run_steps(variant):
    kw = dict(steps=3, lr=1e-2, warmup=1, **STEP_VARIANTS[variant])
    masked = "masked" in variant
    jcfg, jp = _jax_tiny("float32")
    tcfg = TModelConfig(**TINY_KW, dtype="float32")
    jt, tt = jtrainer.TrainConfig(**kw), TrainConfig(**kw)
    jmasks = _jax_masks(jp) if masked else None
    if masked:
        jp = jax.tree.map(lambda p, m: p if m is None else p * m, jp, jmasks,
                          is_leaf=lambda x: x is None)
    tp = params_from_numpy(flatten(jp), "cpu")
    tmasks = params_from_numpy(flatten(jmasks), "cpu") if masked else None
    jopt = jtrainer.init_opt_state(jp, jt)
    topt = params_from_numpy(flatten(jopt), "cpu")
    batches = _np_batches(tcfg, 3)
    mesh = jax_mesh()
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstep, _, _ = jtrainer.build_train_step(
        jcfg, jt, mesh, jax.eval_shape(lambda: jp), jb0, masks=jmasks,
        donate=False)
    with mesh:
        jstep = jstep.lower(jp, jopt, jb0).compile(compiler_options=O0)
    tstep = build_train_step(tcfg, tt, masks=tmasks)
    got, want = [], []
    with mesh:
        for b in batches:
            jp, jopt, jm = jstep(jp, jopt,
                                 {k: jnp.asarray(v) for k, v in b.items()})
            tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
            want.append((params_from_numpy(flatten(jp), "cpu"),
                         params_from_numpy(flatten(jopt), "cpu"),
                         {k: float(v) for k, v in jm.items()}))
            got.append((tp, topt, {k: float(v) for k, v in tm.items()}))
    return variant, tmasks, got, want


def test_train_steps_match_jax(step_case):
    name, tmasks, got, want = step_case
    compressed = "compressed" in name
    flips = FLIP_SHARE if compressed else 0.0
    for i, ((tp, topt, tm), (jp, jopt, jm)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=FLIP_NORM_RTOL if compressed
                                   else STEP_RTOL)
        assert tm["lr"] == np.float32(jm["lr"])
        assert int(topt["step"]) == int(jopt["step"])
        if compressed and i > 0:
            # a flipped code's residual carries into the next step, and a
            # flipped entry that becomes its stack's absmax moves the
            # shared scale: after the first step the runs drift apart by
            # whole int8 steps, so only the loss and norm are compared
            continue
        assert_trees_close(tp, jp, atol=STEP_ATOL, scaled=STEP_RTOL,
                           outliers=flips)
        for k in ("mu", "nu"):
            assert_trees_close(topt[k], jopt[k], atol=1e-12,
                               scaled=MOMENT_RTOL, outliers=flips)
        if compressed:
            assert_trees_close(topt["ef"], jopt["ef"], atol=1e-6,
                               outliers=flips)
    if tmasks is not None:                     # the masked zeros held
        for p, m in zip(leaves(got[-1][0]), leaves(tmasks)):
            if m is not None:
                assert bool((p[m == 0] == 0).all())
                assert bool((p[m == 1] != 0).any())


def test_microbatches_equal_full_batch():
    cfg = dataclasses.replace(TINY, dtype="float32")
    params = TM.init_model(cfg, seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _np_batches(cfg, 1, 8)[0].items()}
    out = {}
    for n in (1, 2):
        tcfg = TrainConfig(steps=3, lr=1e-2, microbatches=n)
        out[n] = build_train_step(cfg, tcfg)(params,
                                             init_opt_state(params, tcfg), b)
    np.testing.assert_allclose(out[2][2]["loss"], out[1][2]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(out[2][2]["grad_norm"],
                               out[1][2]["grad_norm"], rtol=1e-5)
    assert_trees_close(out[2][0], out[1][0], scaled=1e-5)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_step_marks_its_parts_and_is_unchanged_by_them(n_micro):
    """``mark`` is called as each part is issued, in order, and the step
    with it returns what the step without it returns."""
    cfg = dataclasses.replace(TINY, dtype="float32")
    params = TM.init_model(cfg, seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _np_batches(cfg, 1, 8)[0].items()}
    tcfg = TrainConfig(steps=3, lr=1e-2, microbatches=n_micro)
    parts = []
    got = build_train_step(cfg, tcfg, mark=parts.append)(
        params, init_opt_state(params, tcfg), b)
    want = build_train_step(cfg, tcfg)(params, init_opt_state(params, tcfg),
                                       b)
    assert parts == ["forward", "backward"] * n_micro + ["optimizer"]
    assert all(torch.equal(x, y) for x, y in zip(leaves(got[0]),
                                                 leaves(want[0])))
    assert float(got[2]["loss"]) == float(want[2]["loss"])


# ---------------------------------------------------------------------------
# The Trainer (twins of tests/test_optim_trainer.py::TestTrainerEndToEnd)
# ---------------------------------------------------------------------------

class TestTrainerEndToEnd:
    def test_loss_drops(self):
        tr = Trainer(TINY, TrainConfig(steps=30, lr=3e-3, log_every=100),
                     DataConfig(global_batch=8, seq_len=32), device="cpu")
        tr.fit()
        first = np.mean([h["loss"] for h in tr.history[:5]])
        last = np.mean([h["loss"] for h in tr.history[-5:]])
        assert last < first - 0.2, (first, last)

    def test_restart_resumes_exactly(self, tmp_path):
        dcfg = DataConfig(global_batch=4, seq_len=16)
        t1 = TrainConfig(steps=6, checkpoint_every=3,
                         checkpoint_dir=str(tmp_path), lr=1e-3)
        p_full, o_full = Trainer(TINY, t1, dcfg, device="cpu").fit()
        assert sorted(os.listdir(tmp_path))[:2] == ["LATEST",
                                                    "step_000000003"]
        tr2 = Trainer(TINY, t1, dcfg, device="cpu")
        p2, o2, start = tr2.init_state()
        assert start == 6 and int(o2["step"]) == 6
        for a, b in zip(leaves([p_full, o_full["mu"]]), leaves([p2,
                                                                o2["mu"]])):
            assert a.dtype == b.dtype and torch.equal(a, b)

        # resumed from step 3, the run ends where the whole run ended
        os.remove(os.path.join(tmp_path, "LATEST"))
        shutil.rmtree(os.path.join(tmp_path, "step_000000006"))
        p3, _ = Trainer(TINY, t1, dcfg, device="cpu").fit()
        assert all(torch.equal(a, b) for a, b in zip(leaves(p_full),
                                                     leaves(p3)))

    def test_compressed_grads_still_learn(self):
        tr = Trainer(TINY, TrainConfig(steps=25, lr=3e-3,
                                       compress_grads=True, log_every=100),
                     DataConfig(global_batch=8, seq_len=32), device="cpu")
        tr.fit()
        assert tr.history[-1]["loss"] < tr.history[0]["loss"]

    def test_masks_survive_training(self):
        """The paper's co-design contract: pruned weights stay pruned."""
        params = TM.init_model(TINY, seed=0, device="cpu")

        def prune(node, key=None):
            if isinstance(node, dict):
                return {k: prune(v, k) for k, v in node.items()}
            if isinstance(node, list):
                return [prune(v, key) for v in node]
            if key == "w_in":
                return pruning.n_m(node.float(), 2, 4)[1].to(node.dtype)
            return None

        masks = prune(params)
        params = tree_map(lambda p, m: p if m is None else p * m, params,
                          masks)
        tcfg = TrainConfig(steps=5, lr=1e-2, log_every=100)
        dcfg = DataConfig(global_batch=4, seq_len=16)
        step_fn = build_train_step(TINY, tcfg, masks=masks)
        opt = init_opt_state(params, tcfg)
        for s in range(5):
            params, opt, _ = step_fn(params, opt,
                                     make_batch(TINY, dcfg, s, "cpu"))
        checked = 0
        for p, m in zip(leaves(params), leaves(masks)):
            if m is not None:
                assert bool((p[m == 0] == 0).all())
                assert bool((p[m == 1] != 0).any())
                checked += 1
        assert checked == TINY.n_layers


def test_retry_after_a_failure_after_the_backward(monkeypatch):
    """A transient device error raised after the backward (in the
    optimizer) is retried on the state the step started from: the run
    equals an undisturbed one bitwise.  Any other error propagates at
    once, and a transient one after ``max_retries``."""
    tcfg = TrainConfig(steps=3, lr=1e-3, max_retries=2)
    dcfg = DataConfig(global_batch=4, seq_len=16)
    clean = Trainer(TINY, tcfg, dcfg, device="cpu")
    p_clean, o_clean = clean.fit()

    real = ttrainer.adamw_update
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:              # step 1, after its backward
            raise ttrainer.TRANSIENT("injected device failure")
        return real(*a, **k)

    monkeypatch.setattr(ttrainer, "adamw_update", flaky)
    tr = Trainer(TINY, tcfg, dcfg, device="cpu")
    p, o = tr.fit()
    assert calls["n"] == 4
    assert all(torch.equal(a, b) for a, b in zip(
        leaves([p, o["mu"], o["nu"]]),
        leaves([p_clean, o_clean["mu"], o_clean["nu"]])))
    assert [h["loss"] for h in tr.history] == \
        [h["loss"] for h in clean.history]

    def broken(*a, **k):
        raise RuntimeError("not a device failure")

    monkeypatch.setattr(ttrainer, "adamw_update", broken)
    with pytest.raises(RuntimeError, match="not a device failure"):
        Trainer(TINY, tcfg, dcfg, device="cpu").fit()

    def dead(*a, **k):
        calls["n"] += 1
        raise ttrainer.TRANSIENT("down for good")

    calls["n"] = 0
    monkeypatch.setattr(ttrainer, "adamw_update", dead)
    with pytest.raises(ttrainer.TRANSIENT):
        Trainer(TINY, tcfg, dcfg, device="cpu").fit()
    assert calls["n"] == tcfg.max_retries + 1


# ---------------------------------------------------------------------------
# Checkpoints (twins of tests/test_checkpoint.py, bf16 leaves)
# ---------------------------------------------------------------------------

def ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "layers": [{"w": torch.randn((2, 2), generator=g)
                        .to(torch.bfloat16)}],
            "step": torch.tensor(seed)}


class TestCheckpoint:
    def test_roundtrip_exact(self, tmp_path):
        t = ckpt_tree(3)
        save_checkpoint(str(tmp_path), 3, t)
        got, step = restore_latest(str(tmp_path), ckpt_tree(0))
        assert step == 3
        for a, b in zip(leaves(t), leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        with open(os.path.join(tmp_path, "step_000000003",
                               "manifest.json")) as f:
            arrays = json.load(f)["arrays"]
        assert arrays["b/d"]["dtype"] == "bfloat16"
        assert arrays["layers/0/w"]["dtype"] == "bfloat16"

    def test_none_leaves_and_device(self, tmp_path):
        t = {"w": torch.ones(3), "m": None}
        save_checkpoint(str(tmp_path), 1, t)
        got, _ = restore_latest(str(tmp_path), t, device="cpu")
        assert got["m"] is None and torch.equal(got["w"], t["w"])

    def test_latest_pointer(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, ckpt_tree(1))
        save_checkpoint(str(tmp_path), 2, ckpt_tree(2))
        with open(os.path.join(tmp_path, "LATEST")) as f:
            assert f.read() == "step_000000002"

    def test_missing_dir_returns_none(self, tmp_path):
        assert restore_latest(str(tmp_path / "nothing"), ckpt_tree()) is None

    def test_digest_detects_corruption(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 1, ckpt_tree(1))
        npz = os.path.join(path, "arrays.npz")
        data = open(npz, "rb").read()
        with open(npz, "wb") as f:
            f.write(data[:-20] + b"\x00" * 20)
        with pytest.raises(Exception):
            load_checkpoint(path)

    def test_digest_mismatch_raises(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 1, ckpt_tree(1))
        mf = os.path.join(path, "manifest.json")
        with open(mf) as f:
            manifest = json.load(f)
        manifest["arrays"]["b/d"]["sha256"] = "0" * 64
        with open(mf, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(IOError, match="digest"):
            load_checkpoint(path)
        assert restore_latest(str(tmp_path), ckpt_tree()) is None

    def test_fallback_to_previous_step(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, ckpt_tree(1))
        path2 = save_checkpoint(str(tmp_path), 2, ckpt_tree(2))
        os.remove(os.path.join(path2, "arrays.npz"))
        got, step = restore_latest(str(tmp_path), ckpt_tree(0))
        assert step == 1 and torch.equal(got["a"], ckpt_tree(1)["a"])

    def test_async_save_and_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, ckpt_tree(s))
        mgr.wait()
        steps = sorted(x for x in os.listdir(tmp_path)
                       if x.startswith("step_"))
        assert steps == ["step_000000003", "step_000000004"]
        assert [t["step"] for t in mgr.timings] == [1, 2, 3, 4]
        assert all(0 <= t["stall_s"] <= t["total_s"] for t in mgr.timings)

    def test_async_save_copies_before_returning(self, tmp_path):
        """The host copy is taken in ``save``: a later in-place write to
        the tensor does not reach the checkpoint."""
        mgr = CheckpointManager(str(tmp_path), keep=1)
        t = {"w": torch.zeros(1000)}
        mgr.save(1, t)
        t["w"].fill_(1.0)
        mgr.wait()
        got, _ = restore_latest(str(tmp_path), t)
        assert float(got["w"].abs().max()) == 0.0

    def test_async_error_surfaces(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        mgr = CheckpointManager(str(blocker / "sub"), keep=1)
        mgr.save(1, ckpt_tree(1))
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()                        # raised once, then clear


# ---------------------------------------------------------------------------
# data, conversion, kernels off the training route, entry points
# ---------------------------------------------------------------------------

def test_stream_structure():
    """Each token is the transition of the one before, or (noise) its
    hashed replacement, with the noise share within 5 sigma of 0.15;
    labels are the stream shifted by one; at most 4096 active tokens."""
    cfg = dataclasses.replace(TINY, vocab_size=151936)
    b = batch_for(cfg, 64, 128, step=3, device="cpu")
    tok, lab = b["tokens"].long(), b["labels"].long()
    assert b["tokens"].dtype == torch.int32 and tok.shape == (64, 128)
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    stream = torch.cat([tok, lab[:, -1:]], 1)
    prev, nxt = stream[:, :-1], stream[:, 1:]
    rule = nxt == pipeline.transition(prev, cfg.vocab_size)
    noise = nxt == (prev * 48271 + 11) % 4096
    assert bool((rule | noise).all()) and int(stream.max()) < 4096
    n = rule.numel()
    share = float((noise & ~rule).sum()) / n
    assert abs(share - 0.15) < 5 * np.sqrt(0.15 * 0.85 / n)


def test_stream_is_a_pure_function_of_seed_step_host():
    d = DataConfig(seed=4, global_batch=4, seq_len=16)
    a = make_batch(TINY, d, 7, "cpu")
    torch.manual_seed(123)                      # the global RNG is unused
    b = make_batch(TINY, d, 7, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = make_batch(TINY, d, 8, "cpu")
    e = make_batch(TINY, dataclasses.replace(d, seed=5), 7, "cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], e["tokens"])
    h0 = make_batch(TINY, dataclasses.replace(d, n_hosts=2), 7, "cpu")
    h1 = make_batch(TINY, dataclasses.replace(d, n_hosts=2, host_id=1), 7,
                    "cpu")
    assert h0["tokens"].shape == (2, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError):
        make_batch(TINY, DataConfig(global_batch=3, n_hosts=2), 0, "cpu")


def test_stream_layouts():
    emb = dataclasses.replace(TINY, input_mode="embeds")
    b = make_batch(emb, DataConfig(global_batch=2, seq_len=8), 0, "cpu")
    assert b.keys() == {"embeds", "labels"}
    assert b["embeds"].dtype == torch.bfloat16 and \
        b["embeds"].shape == (2, 8, 64)
    ed = dataclasses.replace(TINY, is_encoder_decoder=True)
    b = make_batch(ed, DataConfig(global_batch=2, seq_len=8, src_len=5), 0,
                   "cpu")
    assert b.keys() == {"src", "tokens", "labels"}
    assert b["src"].dtype == torch.bfloat16 and b["src"].shape == (2, 5, 64)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_class_data_bit_equal_to_jax():
    for args in ((0, 64, (32, 32, 3), 10), (3, 17, (49, 10, 1), 12, 2.0, 4)):
        xj, yj = jclass_data(*args)
        xt, yt = class_data(*args)
        assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_convert_masks_and_optimizer_state():
    _, jp = _jax_tiny("bfloat16")
    masks = params_from_numpy(flatten(_jax_masks(jp)), "cpu")
    assert masks["embed"] is None and masks["layers"][1]["attn"]["wq"] is None
    assert masks["layers"][1]["mlp"]["w_in"].shape == (64, 128)
    opt = params_from_numpy(flatten(jtrainer.init_opt_state(
        jp, jtrainer.TrainConfig(compress_grads=True))), "cpu")
    assert opt.keys() == {"mu", "nu", "step", "ef"}
    assert opt["step"].dtype == torch.int32 and opt["step"].device.type == \
        "cpu"
    tp = params_from_numpy(flatten(jp), "cpu")
    for k in ("mu", "nu", "ef"):
        assert [(a, t.shape) for a, t in with_paths(opt[k])] == \
            [(a, t.shape) for a, t in with_paths(tp)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "zamba2-1.2b", "seamless-m4t-large-v2",
                                  "gemma2-27b"])
def test_training_route_reaches_no_kernel(arch, monkeypatch):
    """Every dispatch to a kernel (packs, flash, paged) raises here, and
    a training step of each family still runs: the training route is the
    plain cache-less one, whatever the device."""
    from repro_torch import configs as C

    def refuse(*a, **k):
        raise AssertionError("the training route reached a kernel")

    for name, e in dispatch.registry().items():
        if name != "dense":
            monkeypatch.setitem(dispatch._REGISTRY, name,
                                dataclasses.replace(e, run=refuse))
    monkeypatch.setattr(dispatch, "attention", refuse)
    monkeypatch.setattr(dispatch, "paged_attention", refuse)
    cfg = C._module(arch).reduced()
    tcfg = TrainConfig(steps=2, lr=1e-3)
    params = TM.init_model(cfg, seed=0, device="cpu")
    b = make_batch(cfg, DataConfig(global_batch=2, seq_len=16), 0, "cpu")
    _, _, m = build_train_step(cfg, tcfg)(params,
                                          init_opt_state(params, tcfg), b)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    from repro_torch.core.sparsity import pack_nm
    from repro_torch.kernels import flash_attention, nm_spmm
    w = pruning.n_m(torch.randn(64, 128), 2, 4, group=128)[0]
    pack = pack_nm(w, 2, 4, g=128)
    x = torch.randn(3, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        nm_spmm.nm_spmm(x, pack)
    q = torch.randn(1, 2, 4, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert nm_spmm.nm_spmm(x, pack).shape == (3, 128)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(TINY, DataConfig(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TINY, TrainConfig(), DataConfig())


def test_launch_train_cli_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "4",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path),
                       "--checkpoint-every", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("arch=qwen3-0.6b-smoke") and "device=cpu" in \
        out[0]
    report = json.loads(out[-1])
    assert report["arch"] == "qwen3-0.6b-smoke" and report["steps"] == 4
    assert set(report) == {"arch", "steps", "wall_s", "loss_first",
                           "loss_last", "loss_drop", "stragglers_flagged"}
    assert sorted(os.listdir(tmp_path)) == [
        "LATEST", "step_000000002", "step_000000004"]
