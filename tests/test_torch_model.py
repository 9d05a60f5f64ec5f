"""The port's model against the JAX model on the same weights: prefill
and per-slot decode logits, monolithic and paged cache, dense and every
packed format (2:4, block, combined, int7 lookahead) on all seven
projections, on the CPU at float32.

Weights come from the JAX init (+ ``pack_params``) and are carried over
with ``repro_torch.convert.params_from_numpy``; the helpers here are
shared with ``test_torch_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import pack_params as jax_pack_params
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.core.sparsity import PACK_TYPES
from repro_torch.models.config import ModelConfig as TModelConfig

ATOL = 1e-4                     # float32 logits; sums run in other orders

TINY = dict(name="tiny-qwen3", n_layers=2, d_model=256, vocab_size=512,
            n_heads=4, n_kv_heads=2, d_ff=512, qk_norm=True,
            dtype="float32", remat=False)
#: each format's SparsityConfig fields, as the JAX tests declare them
SPARSE = {
    "nm": dict(format="nm", n=2, m=4, block_n=128),
    "combined": dict(format="combined", sparsity=0.5, n=2, m=4,
                     block_k=128, block_n=128),
    "block": dict(format="block", sparsity=0.5, block_k=128, block_n=128),
    "lookahead": dict(format="lookahead", sparsity=0.5),
}
NM = SPARSE["nm"]
FORMATS = ("dense", *SPARSE)
PROJECTIONS = (("attn", ("wq", "wk", "wv", "wo")),
               ("mlp", ("w_in", "w_gate", "w_out")))


def jax_mesh():
    """A 1x1 mesh with Auto axes (jax 0.9 defaults to Explicit axes, which
    the JAX engine's annotations reject)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def configs(fmt):
    """(JAX config, port config) of the tiny qwen3-style model."""
    if fmt == "dense":
        return JModelConfig(**TINY), TModelConfig(**TINY)
    sp = SPARSE[fmt]
    return (JModelConfig(**TINY, mlp_sparsity=JSparsity(**sp),
                         attn_sparsity=JSparsity(**sp)),
            TModelConfig(**TINY, mlp_sparsity=TSparsity(**sp),
                         attn_sparsity=TSparsity(**sp)))


def flatten(node):
    """The JAX param tree as nested dicts of numpy arrays (a pack as the
    dict of its fields) — the input of ``params_from_numpy``."""
    if dataclasses.is_dataclass(node):
        return {f.name: flatten(getattr(node, f.name))
                for f in dataclasses.fields(node)}
    if isinstance(node, dict):
        return {k: flatten(v) for k, v in node.items()}
    return node if isinstance(node, int) else np.asarray(node)


def zero_half_tiles(w: np.ndarray, seed: int, tile: int = 128) -> np.ndarray:
    """``w (L, K, N)`` with exactly half of each layer's ``(tile, tile)``
    tiles zeroed, chosen from ``seed``: pruning then keeps every
    non-zero tile, so a block or combined pack has tile density 0.50 and
    strips of different counts."""
    L, K, N = w.shape
    Kb, Nb = K // tile, N // tile
    rng = np.random.default_rng(seed)
    keep = np.zeros((L, Kb * Nb), bool)
    for layer in keep:
        layer[rng.permutation(Kb * Nb)[:Kb * Nb // 2]] = True
    mask = np.repeat(np.repeat(keep.reshape(L, Kb, Nb), tile, 1), tile, 2)
    return np.where(mask, w, 0).astype(w.dtype)


def build_params(fmt, zero_tiles=False):
    """(JAX config, JAX params, port config, port params on the CPU);
    ``zero_tiles`` zeroes half of every projection's tiles before
    packing (:func:`zero_half_tiles`)."""
    jcfg, tcfg = configs(fmt)
    jp = JM.init_model(jax.random.key(0), jcfg)
    if zero_tiles:
        for i, (fam, names) in enumerate(PROJECTIONS):
            for j, name in enumerate(names):
                w = np.asarray(jp["layers"][fam][name])
                jp["layers"][fam][name] = jnp.asarray(
                    zero_half_tiles(w, seed=10 * i + j))
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
    """Every projection of a packed config arrives as a pack of the JAX
    pack's class; nothing else does."""
    jcfg, jp, tcfg, tp = both
    for fam, names in PROJECTIONS:
        for name in names:
            want = type(jp["layers"][fam][name])
            for layer in tp["layers"]:
                got = layer[fam][name]
                assert isinstance(got, PACK_TYPES) == (
                    tcfg.mlp_sparsity.format != "dense")
                assert type(got).__name__ == (
                    want.__name__ if isinstance(got, PACK_TYPES)
                    else "Tensor")
    assert len(tp["layers"]) == tcfg.n_layers
    assert not isinstance(tp["embed"], PACK_TYPES)
