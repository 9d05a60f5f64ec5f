"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package on the CPU.

Bytes: the abstract params (``models.abstract_model``) and caches
(``models.abstract_cache``) at full width equal the bytes of the JAX
``eval_shape`` trees for one architecture per family, and qwen3-0.6b's
``sparse()`` packs (``sparsify_abstract`` on both sides) too.

FLOPs: the port's ``step_flops`` of a reduced prefill, a decode step (on
the monolithic and the paged cache) and a loss + grad against the JAX
``step_flops`` of the same functions.  The matmul and kernel terms are
exactly the JAX jaxpr's ``dot_general`` FLOPs (the kernels' ``cost``
counts what the JAX reference computes).  The whole counts agree within
``TOL`` = 10%: the rest is elementwise work counted at one FLOP per
element on both sides, where XLA's ``reshape``/``transpose``/``broadcast``
eqns count their elements and PyTorch's views count nothing, and where
the port's decode builds per-slot position masks that the JAX step
builds once (the largest gap at these shapes is the monolithic decode,
about 6.5%).

The JAX dry-run module itself is never imported: it sets ``XLA_FLAGS`` at
import.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import models as JM
from repro.core.sparse_linear import SparsityConfig as JSparsity
from repro.core.sparse_linear import sparsify_abstract as jsparsify
from repro.launch.analysis import _dot_flops
from repro.launch.analysis import step_flops as jstep_flops
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.core.sparse_linear import SparsityConfig as TSparsity
from repro_torch.benchmarks import roofline
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import count_step
from repro_torch.train.trainer import value_and_grad

TOL = 0.10
FAMILY_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                "seamless-m4t-large-v2", "gemma2-27b")
TINY = dict(name="tiny-flops", n_layers=2, d_model=256, vocab_size=512,
            n_heads=4, n_kv_heads=2, d_ff=512, remat=False)
NM = dict(format="nm", n=2, m=4, block_n=128)
B, L = 2, 128


def jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_param_and_cache_bytes_equal_jax(arch):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    src = 128 if jcfg.is_encoder_decoder else None
    jp = jax.eval_shape(lambda: JM.init_model(jax.random.key(0), jcfg))
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 128, src_len=src))
    assert dryrun.tree_bytes(TM.abstract_model(tcfg)) == jax_bytes(jp)
    assert dryrun.tree_bytes(TM.abstract_cache(tcfg, 2, 128, src_len=src)) \
        == jax_bytes(jc)


def test_sparse_param_bytes_equal_jax():
    jcfg = JC._module("qwen3-0.6b").sparse()
    tcfg = TC._module("qwen3-0.6b").sparse()
    jp = jsparsify(jax.eval_shape(
        lambda: JM.init_model(jax.random.key(0), jcfg)), jcfg)
    tp = TM.abstract_model(tcfg, packed=True)
    assert dryrun.tree_bytes(tp) == jax_bytes(jp)
    assert dryrun.tree_bytes(tp) < dryrun.tree_bytes(
        TM.abstract_model(tcfg))


def jax_dots(fn, *args) -> float:
    def walk(jaxpr):
        total = 0.0
        for eqn in getattr(jaxpr, "jaxpr", jaxpr).eqns:
            if eqn.primitive.name == "dot_general":
                total += _dot_flops(eqn)
            elif eqn.primitive.name == "scan":
                total += eqn.params["length"] * walk(eqn.params["jaxpr"])
            else:
                for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                    if k in eqn.params:
                        total += walk(eqn.params[k])
                        break
        return total
    return walk(jax.make_jaxpr(fn)(*args))


def tiny(sparse: bool):
    extra = {"mlp_sparsity": NM} if sparse else {}
    jcfg = JModelConfig(**TINY, **{k: JSparsity(**v)
                                   for k, v in extra.items()})
    tcfg = TM.ModelConfig(**TINY, **{k: TSparsity(**v)
                                     for k, v in extra.items()})
    jp = jax.eval_shape(lambda: JM.init_model(jax.random.key(0), jcfg))
    if sparse:
        jp = jsparsify(jp, jcfg)
    return jcfg, jp, tcfg, TM.abstract_model(tcfg, packed=sparse)


def meta_int(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def assert_counts(count, jfn, *jargs):
    """Matmul + kernel terms exactly the JAX dots; totals within TOL."""
    want_total = jstep_flops(jfn, *jargs)
    want_dots = jax_dots(jfn, *jargs)
    assert count.matmul_flops + sum(count.kernel_flops.values()) \
        == want_dots
    assert abs(count.flops - want_total) <= TOL * want_total, \
        (count.flops, want_total)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "nm"])
def test_prefill_flops_match_jax(sparse):
    """The prompt fills the cache (the JAX prefill attends every cache
    row, the flash kernel the prompt's)."""
    jcfg, jp, tcfg, tp = tiny(sparse)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, L))
    toks = jax.ShapeDtypeStruct((B, L), jnp.int32)
    count = count_step(lambda p, b, c: TM.prefill(p, tcfg, b, c), tp,
                       {"tokens": meta_int(B, L)},
                       TM.abstract_cache(tcfg, B, L))
    assert count.kernel_calls["flash_attention"] == TINY["n_layers"]
    if sparse:
        assert count.kernel_calls["nm_spmm"] == 3 * TINY["n_layers"]
    assert_counts(count, lambda p, b, c: JM.prefill(p, jcfg, b, c), jp,
                  {"tokens": toks}, jcache)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "nm"])
@pytest.mark.parametrize("page_size", [0, 16], ids=["mono", "paged"])
def test_decode_flops_match_jax(sparse, page_size):
    jcfg, jp, tcfg, tp = tiny(sparse)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, L,
                                                  page_size=page_size))
    tcache = TM.abstract_cache(tcfg, B, L, page_size=page_size)
    count = count_step(lambda p, t, c, q: TM.decode_step(p, tcfg, t, c, q),
                       tp, meta_int(B), tcache, meta_int(B))
    if page_size:
        assert count.kernel_calls["paged_attention"] == TINY["n_layers"]
    # the inputs, packs included, are alive from the start
    assert count.entry_bytes == dryrun.tree_bytes(tp) + \
        dryrun.tree_bytes(tcache) + 2 * B * 4
    assert_counts(count, lambda p, t, c, q: JM.decode_step(p, jcfg, t, c, q),
                  jp, jax.ShapeDtypeStruct((B,), jnp.int32), jcache,
                  jax.ShapeDtypeStruct((), jnp.int32))


def test_loss_and_grad_flops_match_jax():
    jcfg, jp, tcfg, tp = tiny(False)
    toks = jax.ShapeDtypeStruct((B, L // 2), jnp.int32)
    count = count_step(
        lambda p, b: value_and_grad(
            lambda p, b: TM.model_loss(p, tcfg, b), p, b), tp,
        {"tokens": meta_int(B, L // 2), "labels": meta_int(B, L // 2)})
    assert not count.kernel_flops          # training reaches no kernel
    assert_counts(count, jax.grad(lambda p, b: JM.model_loss(p, jcfg, b)),
                  jp, {"tokens": toks, "labels": toks})


def test_cells_are_the_jax_cells():
    assert {k: dataclasses.asdict(v) for k, v in TC.CELLS.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.CELLS.items()}
    for arch in TC.list_archs():
        assert [c.name for c in TC.cells_for(TC.get(arch))] == \
            [c.name for c in JC.cells_for(JC.get(arch))], arch


def test_cell_record_and_rerun_skip(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-0.6b", "--cell", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    path = tmp_path / "singlepod" / "qwen3-0.6b__decode_32k.json"
    rec = json.loads(path.read_text())
    cfg = TC.get("qwen3-0.6b")
    assert rec["ok"] and rec["kind"] == "decode" and rec["chips"] == 1
    assert rec["param_bytes_global"] == dryrun.tree_bytes(
        TM.abstract_model(cfg))
    assert rec["cache_bytes_global"] == dryrun.tree_bytes(
        TM.abstract_cache(cfg, 128, 32768))
    mem = rec["memory"]
    assert mem["peak_live_bytes"] >= mem["entry_bytes"] >= \
        rec["param_bytes_global"] + rec["cache_bytes_global"]
    rl = rec["roofline"]
    assert rl["dominant"] == "memory" and rec["fits"] is False
    assert rl["t_memory_s"] == rec["hbm_traffic_pd"] / dryrun.HBM_BW
    assert rl["model_flops"] == 2 * cfg.active_param_count() * 128
    assert 0 < rl["useful_flop_ratio"] <= 1
    terms = rec["flops_terms"]
    assert rec["flops_global"] == pytest.approx(
        terms["matmul"] + terms["other"] + sum(terms["kernels"].values()))
    capsys.readouterr()
    assert dryrun.run_all(str(tmp_path), 60, archs=["qwen3-0.6b"],
                          cells=["decode_32k"]) == 0
    assert "[skip]" in capsys.readouterr().out
    # the roofline table reads the record back
    data = roofline.run(str(tmp_path))
    (row,) = data["rows"]
    assert (row["arch"], row["cell"], row["dominant"], row["fits"]) == \
        ("qwen3-0.6b", "decode_32k", "memory", False)
    assert row["t_mem_ms"] == pytest.approx(rl["t_memory_s"] * 1e3)
    roofline.main(data)
    assert "qwen3-0.6b,decode_32k,singlepod,1," in capsys.readouterr().out
    assert roofline.matrix(str(tmp_path)).splitlines()[2].startswith(
        "| qwen3-0.6b | — | — | ")


def test_one_card_only():
    with pytest.raises(NotImplementedError, match="item 13"):
        dryrun.main(["--arch", "qwen3-0.6b", "--cell", "decode_32k",
                     "--multi-pod"])
    with pytest.raises(NotImplementedError, match="item 13"):
        dryrun.build_cell("qwen3-0.6b", "decode_32k", profile="dp")
    with pytest.raises(ValueError, match="long_500k"):
        dryrun.build_cell("qwen3-0.6b", "long_500k")
