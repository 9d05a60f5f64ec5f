"""The port's training losses against the JAX package on the CPU:
``chunked_ce`` (softcap, vocab padding, several chunks) against JAX's
and the exact log-softmax, its gradients against ``jax.grad``; and
``model_loss`` / ``model_logits`` with every leaf's gradient against
``jax.value_and_grad`` for each family's reduced config at float32 — lm
(gemma's local window, softcaps, post-norms and scaled embeddings, with
qk-norm, an untied head and vocab padding; M-RoPE with embeds input),
MoE with its aux term, the zamba2 hybrid and the seamless enc-dec — from
the same JAX
init and the same numpy batches.  Remat on equals remat off.

Tolerances (float32; the two frameworks sum in other orders): loss
within 1e-5 relative, each gradient leaf within 1e-4 of that leaf's
largest magnitude, logits within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import models as JM
from repro.models import transformer as JTR
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as TTR
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import leaves, with_paths
from test_torch_model import flatten

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4                   # of each leaf's largest |g|
LOGIT_ATOL = 1e-4
B, L, SRC = 2, 24, 10              # L past the gemma config's 16-row window


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small matmuls on several CPU threads spend their time in the
    thread pool; one thread per test process is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the JAX side compiles at XLA's backend optimization level 0: half
#: the compile time on the CPU, its float32 values unchanged but for
#: rounding
O0 = {"xla_backend_optimization_level": 0}


def jax_init(cfg):
    """The JAX init of ``cfg``, compiled (see ``O0``)."""
    return jax.jit(JM.init_model, static_argnums=1).lower(
        jax.random.key(0), cfg).compile(compiler_options=O0)(
            jax.random.key(0))


def _fp32(arch, **kw):
    return (dataclasses.replace(JC._module(arch).reduced(), dtype="float32",
                                **kw),
            dataclasses.replace(TC._module(arch).reduced(), dtype="float32",
                                **kw))


#: name → (JAX config, port config) at float32
CONFIGS = {
    # gemma2's local/global layers (window 16, under L = 24), softcaps,
    # post-norms and scaled embeddings, with qwen3's qk-norm, an untied
    # head and a vocab of 1000 padded to 1024
    "gemma2_qknorm_untied": _fp32("gemma2-27b", qk_norm=True,
                                  tie_embeddings=False, vocab_size=1000),
    "mrope_embeds": _fp32("qwen2-vl-72b"),
    "moe": _fp32("qwen2-moe-a2.7b", n_layers=1, layer_kinds=(),
                 n_experts=4),
    # the reduced zamba2 cut to 2 layers: the shared block, then two
    # mamba mixers
    "hybrid": _fp32("zamba2-1.2b", n_layers=2, layer_kinds=(3, 2)),
    "encdec": _fp32("seamless-m4t-large-v2"),
}


def batch_np(cfg, seed=0):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab_size, (B, L + 1)).astype(np.int32)
    if cfg.is_encoder_decoder:
        return {"src": rng.normal(size=(B, SRC, cfg.d_model)).astype(
                    np.float32),
                "tokens": stream[:, :-1], "labels": stream[:, 1:]}
    if cfg.input_mode == "embeds":
        return {"embeds": rng.normal(size=(B, L, cfg.d_model)).astype(
                    np.float32), "labels": stream[:, 1:]}
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """(port config, port params, port batch, JAX loss, JAX grads as a
    port tree, JAX logits), the JAX side jitted once per config."""
    jcfg, tcfg = CONFIGS[request.param]
    jp = jax_init(jcfg)
    batch = batch_np(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, grads), logits = jax.jit(lambda p, b: (
        jax.value_and_grad(lambda q: JM.model_loss(q, jcfg, b))(p),
        JM.model_logits(p, jcfg, b))).lower(jp, jb).compile(
            compiler_options=O0)(jp, jb)
    return (tcfg, params_from_numpy(flatten(jp), "cpu"), to_torch(batch),
            float(loss), params_from_numpy(flatten(grads), "cpu"),
            np.asarray(logits))


def torch_loss_and_grads(params, cfg, batch):
    """(loss, the gradient tree)."""
    loss, grads = value_and_grad(
        lambda p, b: TM.model_loss(p, cfg, b), params, batch)
    return float(loss), grads


def assert_grads_close(got_tree, want_tree):
    """Leaf by leaf, matched by path (the JAX tree's dicts are sorted)."""
    got, want = dict(with_paths(got_tree)), dict(with_paths(want_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale + 1e-8,
                                   err_msg=path)


def test_model_loss_and_grads_match_jax(case):
    tcfg, tp, tb, jloss, jgrads, _ = case
    loss, grads = torch_loss_and_grads(tp, tcfg, tb)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert_grads_close(grads, jgrads)


def test_model_logits_match_jax(case):
    tcfg, tp, tb, _, _, jlogits = case
    with torch.no_grad():
        got = TM.model_logits(tp, tcfg, tb)
    assert got.dtype == torch.float32 and got.shape == jlogits.shape
    np.testing.assert_allclose(got.numpy(), jlogits, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["gemma2_qknorm_untied", "moe", "hybrid",
                                  "encdec"])
def test_remat_on_equals_off(name):
    """``cfg.remat`` recomputes each layer in the backward: the loss and
    every gradient come out bitwise the same as without it."""
    _, tcfg = CONFIGS[name]
    params = TM.init_model(tcfg, seed=1, device="cpu")
    tb = to_torch(batch_np(tcfg, seed=1))
    off = torch_loss_and_grads(params, dataclasses.replace(tcfg, remat=False),
                               tb)
    on = torch_loss_and_grads(params, dataclasses.replace(tcfg, remat=True),
                              tb)
    assert on[0] == off[0]
    assert all(torch.equal(a, b) for a, b in zip(leaves(on[1]),
                                                 leaves(off[1])))


def test_moe_aux_enters_the_loss():
    """The MoE loss is the chunked CE plus 0.01 × the summed Switch aux
    (the term the serving block drops), as in JAX."""
    jcfg, tcfg = CONFIGS["moe"]
    params = TM.init_model(tcfg, seed=2, device="cpu")
    tb = to_torch(batch_np(tcfg, seed=2))
    with torch.no_grad():
        x, aux = TTR.lm_hidden(params, tcfg, tb["tokens"])
        ce = TTR.chunked_ce(x, TTR.head(params), tb["labels"], tcfg)
        loss = TM.model_loss(params, tcfg, tb)
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss), float(ce + 0.01 * aux),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# chunked_ce (the twins of tests/test_moe_ce.py::TestChunkedCE)
# ---------------------------------------------------------------------------

def _ce_case(seed, softcap=None, vocab=500):
    kw = dict(name="t", n_layers=1, d_model=32, vocab_size=vocab, n_heads=2,
              n_kv_heads=2, d_ff=64, final_softcap=softcap, remat=False)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    table = rng.normal(size=(tcfg.vocab_padded, 32)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 8)).astype(np.int32)
    return jcfg, tcfg, x, table, labels


def _exact(x, table, labels, cfg):
    """The exact mean CE: log-softmax over the whole padded vocab, the
    padding masked."""
    logits = torch.einsum("bld,vd->blv", x, table)
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    logits = TTR.mask_vocab_padding(logits, cfg)
    return -torch.log_softmax(logits, -1).gather(
        -1, labels.long()[..., None]).mean()


@pytest.mark.parametrize("softcap", [None, 10.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("chunk", [128, 100, 64, 16384])
def test_chunked_ce_equals_jax_and_exact(chunk, softcap):
    """Several chunks (100 is not a divisor of 512: the nearest one
    below is taken), padding rows 500..511 masked."""
    jcfg, tcfg, x, table, labels = _ce_case(chunk, softcap)
    got = TTR.chunked_ce(torch.from_numpy(x), torch.from_numpy(table),
                         torch.from_numpy(labels), tcfg, chunk=chunk)
    want = JTR.chunked_ce(jnp.asarray(x), jnp.asarray(table),
                          jnp.asarray(labels), jcfg, chunk=chunk)
    exact = _exact(torch.from_numpy(x), torch.from_numpy(table),
                   torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(exact), rtol=1e-5)


@pytest.mark.parametrize("softcap", [None, 10.0], ids=["plain", "softcap"])
def test_chunked_ce_gradients_match_jax(softcap):
    """d/dx and d/dtable of the chunked CE (each chunk recomputed in the
    backward) against ``jax.grad`` of JAX's and the exact CE's
    gradients."""
    jcfg, tcfg, x, table, labels = _ce_case(7, softcap, vocab=96)
    jgx, jgt = jax.grad(lambda a, t: JTR.chunked_ce(
        a, t, jnp.asarray(labels), jcfg, chunk=32), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    gx, gt = torch.autograd.grad(TTR.chunked_ce(
        tx, tt, torch.from_numpy(labels), tcfg, chunk=32), (tx, tt))
    ex, et = torch.autograd.grad(_exact(tx, tt, torch.from_numpy(labels),
                                        tcfg), (tx, tt))
    for got, want, exact in ((gx, jgx, ex), (gt, jgt, et)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert float(gt[96:].abs().max()) == 0.0      # padding rows get nothing


@pytest.mark.parametrize("case", ["causal_window_softcap", "cross"])
def test_sdpa_key_chunks_match_jax(case, monkeypatch):
    """Past ``KV_CHUNK`` keys (4096 = 2 chunks) the cache-less attention
    walks keys in chunks with an online softmax, queries in ``Q_CHUNK``
    blocks, as JAX's ``_sdpa`` does: equal to it, and to the whole-logits
    route."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    kw = dict(name="t", n_layers=1, d_model=16, vocab_size=64, n_heads=2,
              n_kv_heads=1, d_ff=32, window_size=3000, attn_softcap=20.0)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    Lq = 4096 if case != "cross" else 8
    causal, window = (True, 3000) if case != "cross" else (False, None)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, Lq, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 4096, 1, 8)).astype(np.float32)
            for _ in range(2))
    want = JA._sdpa(jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, is_local=True)
    got = TA._sdpa(tcfg, *map(torch.from_numpy, (q, k, v)), causal=causal,
                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    monkeypatch.setattr(TA, "KV_CHUNK", 8192)      # one whole-logits pass
    ref = TA._sdpa(tcfg, *map(torch.from_numpy, (q, k, v)), causal=causal,
                   window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
