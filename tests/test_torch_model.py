"""The port's model against the JAX model on the same weights: prefill
and per-slot decode logits, monolithic and paged cache, dense and
2:4-packed projections, on the CPU at float32.

Weights come from the JAX init (+ ``pack_params``) and are carried over
with ``repro_torch.convert.params_from_numpy``; the helpers here are
shared with ``test_torch_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.core.sparsity import NMPack as JNMPack
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.models.config import ModelConfig as TModelConfig

ATOL = 1e-4                     # float32 logits; sums run in other orders

TINY = dict(name="tiny-qwen3", n_layers=2, d_model=256, vocab_size=512,
            n_heads=4, n_kv_heads=2, d_ff=512, qk_norm=True,
            dtype="float32", remat=False)
NM = dict(format="nm", n=2, m=4, block_n=128)
FORMATS = ("dense", "nm")


def jax_mesh():
    """A 1x1 mesh with Auto axes (jax 0.9 defaults to Explicit axes, which
    the JAX engine's annotations reject)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def configs(fmt):
    """(JAX config, port config) of the tiny qwen3-style model."""
    if fmt == "dense":
        return JModelConfig(**TINY), TModelConfig(**TINY)
    return (JModelConfig(**TINY, mlp_sparsity=JSparsity(**NM),
                         attn_sparsity=JSparsity(**NM)),
            TModelConfig(**TINY, mlp_sparsity=TSparsity(**NM),
                         attn_sparsity=TSparsity(**NM)))


def flatten(node):
    """The JAX param tree as nested dicts of numpy arrays (packs as
    dicts) — the input of ``params_from_numpy``."""
    if isinstance(node, JNMPack):
        return {"values": np.asarray(node.values),
                "idx": np.asarray(node.idx), "K": node.K, "N": node.N,
                "n": node.n, "m": node.m, "g": node.g}
    if isinstance(node, dict):
        return {k: flatten(v) for k, v in node.items()}
    return np.asarray(node)


def build_params(fmt):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    jcfg, tcfg = configs(fmt)
    jp = JM.init_model(jax.random.key(0), jcfg)
    if fmt != "dense":
        jp = jax_pack_params(jp, jcfg)
    return jcfg, jp, tcfg, params_from_numpy(flatten(jp), "cpu")


@pytest.fixture(scope="module", params=FORMATS)
def both(request):
    return build_params(request.param)


def identity_table(batch, max_pages):
    return np.arange(1, batch * max_pages + 1,
                     dtype=np.int32).reshape(batch, max_pages)


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_prefill_and_decode_logits_match_jax(both, page_size):
    jcfg, jp, tcfg, tp = both
    B, prompt, max_len = 2, 12, 48
    # float32 caches: with the default bf16 cache, last-bit differences
    # of the two frameworks' fp32 math flip single bf16 roundings of k/v
    # and move logits by a few 1e-4 (the engine test holds bf16 caches
    # to token equality instead)
    jcache = JM.init_cache(jcfg, B, max_len, page_size=page_size,
                           dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, B, max_len, page_size=page_size,
                           dtype=torch.float32, device="cpu")
    if page_size:
        table = identity_table(B, max_len // page_size)
        jcache = JM.set_page_table(jcache, jnp.asarray(table))
        TM.set_page_table(tcache, table)
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    jprefill = jax.jit(lambda p, t, c: JM.prefill(p, jcfg, {"tokens": t}, c))
    jdecode = jax.jit(lambda p, t, c, s: JM.decode_step(p, jcfg, t, c, s))
    jl, jcache = jprefill(jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size], -1).astype(np.int32)
    pos = np.asarray([prompt, prompt + 3], np.int32)   # slots apart
    for _ in range(4):
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.argmax(np.asarray(jl)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)
        pos = pos + 1


def test_converted_params_keep_the_packs(both):
    """Every projection of the nm config arrives as a pack; nothing else
    does."""
    jcfg, _, tcfg, tp = both
    from repro_torch.core.sparsity import NMPack
    layer = tp["layers"][0]
    projs = [layer["attn"][k] for k in ("wq", "wk", "wv", "wo")] + \
        [layer["mlp"][k] for k in ("w_in", "w_gate", "w_out")]
    packed = tcfg.mlp_sparsity.format == "nm"
    assert all(isinstance(w, NMPack) == packed for w in projs)
    assert len(tp["layers"]) == tcfg.n_layers
    assert not isinstance(tp["embed"], NMPack)
