"""The port's serving benchmark (``repro_torch.benchmarks.bench_serving``)
against the JAX package's (``benchmarks/bench_serving.py``), on the CPU
at the smoke sizes (``REPRO_BENCH_SMOKE=1``, both modules reloaded under
it).

Two of the bench's cells run through both benches' own serve functions
on the same weights (the JAX bench's ``_model``, packed by the JAX
package and carried over by ``convert.params_from_numpy``) and the same
request lists: the ``nm`` grid cell at 1 and 8 slots, chunked
(``_serve_chunked``) and per-token (``_serve_per_token``), and the
``het-paged`` cell (the heterogeneous 16–512-token mix on the paged
cache, every bucket visited in the warm-up).  What a serve counts must
be equal: tokens, host syncs, KV bytes, peak pages in use, admission
waits and the prefix counters (the bench's ``eos_token=-1`` makes every
request run its budget, so the counts do not hang on bf16 ties).  The
``mixed-priority-preempt`` cell's two serves (priority 1 and 0) must
count the same tokens, preemptions and admission waits.  The port's
``run()`` must give the JAX rows minus the ``sharded-*`` ones, in order,
its ``crash-restore`` row one restart and every token of the mix.  One
JAX engine per served cell.
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from test_torch_model import flatten, jax_mesh

#: what ``_serve_chunked`` counts, in both benches' result dicts
COUNTS = ("tokens", "syncs", "kv_bytes", "peak_used_bytes",
          "admission_waits", "prefix_hits", "shared_pages", "cow_copies")
LEFT_OUT = ("sharded-",)


@pytest.fixture(scope="module")
def benches():
    """(JAX bench, port bench), both imported under the smoke sizes; the
    modules are reloaded without them afterwards."""
    import benchmarks.bench_serving as jbench
    import repro_torch.benchmarks.bench_serving as tbench
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_BENCH_SMOKE", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield importlib.reload(jbench), importlib.reload(tbench)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
        importlib.reload(jbench)
        importlib.reload(tbench)


@pytest.fixture(scope="module")
def models(benches):
    """``models(fmt)`` → (JAX config, JAX params, port config, the JAX
    params carried to the port) of the bench's ``fmt`` model, built once
    per format."""
    jbench, tbench = benches
    built = {}

    def get(fmt):
        if fmt not in built:
            with jax_mesh():
                jcfg, jparams = jbench._model(fmt)
            built[fmt] = (jcfg, jparams, tbench._model(fmt, "cpu")[0],
                          params_from_numpy(flatten(jparams), "cpu"))
        return built[fmt]
    return get


def test_bench_configs_match_jax(benches, models):
    """The port's ``_model`` configs are the JAX bench's, field by field
    (head dim 16, the MLP's sparsity), and its constants are the JAX
    bench's smoke sizes."""
    jbench, tbench = benches
    assert tbench.SMOKE and jbench.SMOKE
    for name in ("MAX_NEW", "DECODE_CHUNK", "PROMPT_PAD", "MAX_LEN", "SLOTS",
                 "VOCAB", "HET_LENS", "HET_MAX_NEW", "HET_CHUNK", "SPEC_KS",
                 "SH_HEADS", "SH_MAX_NEW", "SH_ROUNDS"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    assert tbench._het_pool_pages() == jbench._het_pool_pages()
    for fmt in jbench.SPARSITY:
        jsp, tsp = jbench.SPARSITY[fmt], tbench.SPARSITY[fmt]
        assert (jsp is None and tsp is None) or \
            dataclasses.asdict(tsp) == dataclasses.asdict(jsp)
    for fmt in ("dense", "nm"):             # the models the cells serve
        jcfg, _, tcfg, _ = models(fmt)
        for field in ("name", "n_layers", "d_model", "vocab_size", "n_heads",
                      "n_kv_heads", "d_ff", "head_dim", "dtype"):
            assert getattr(tcfg, field) == getattr(jcfg, field), field
        assert dataclasses.asdict(tcfg.mlp_sparsity) == \
            dataclasses.asdict(jcfg.mlp_sparsity)
        assert tcfg.head_dim == 16


@pytest.fixture(scope="module")
def nm_cell(benches, models):
    jbench, tbench = benches
    jcfg, jparams, tcfg, tparams = models("nm")
    out = {}
    for slots in jbench.SLOTS:
        reqs = jbench._requests(np.random.default_rng(0), 2 * slots)
        out[slots] = (
            jbench._serve_chunked(jcfg, jax_mesh(), jparams, slots, reqs),
            tbench._serve_chunked(tcfg, tparams, slots, reqs,
                                  device="cpu"),
            jbench._serve_per_token(jcfg, jax_mesh(), jparams, slots, reqs),
            tbench._serve_per_token(tcfg, tparams, slots, reqs, "cpu"))
    return out


@pytest.mark.parametrize("slots", [1, 8])
def test_nm_cell_matches_jax(nm_cell, slots):
    """Chunked: the counts; per-token: the tokens, one sync each (of
    every slot's token block) and equal to the chunked serve's."""
    jc, tc, jp, tp = nm_cell[slots]
    for key in COUNTS:
        assert tc[key] == jc[key], key
    assert tp["tokens"] == jp["tokens"] == tc["tokens"]
    assert tp["syncs"] * slots >= tp["tokens"]


def test_het_paged_cell_matches_jax(benches, models):
    jbench, tbench = benches
    jcfg, jparams, tcfg, tparams = models("dense")
    rng = np.random.default_rng(1)
    reqs = [rng.integers(1, jbench.VOCAB, size=L).astype(np.int32)
            for L in jbench.HET_LENS]
    jscfg = dataclasses.replace(jbench._het_scfg(),
                                num_pages=jbench._het_pool_pages())
    tscfg = dataclasses.replace(tbench._het_scfg(),
                                num_pages=tbench._het_pool_pages())
    want = jbench._serve_chunked(jcfg, jax_mesh(), jparams,
                                 jbench.HET_SLOTS, reqs, scfg=jscfg,
                                 warm_all=True)
    got = tbench._serve_chunked(tcfg, tparams, tbench.HET_SLOTS, reqs,
                                scfg=tscfg, warm_all=True, device="cpu")
    for key in COUNTS:
        assert got[key] == want[key], key
    assert got["peak_used_bytes"] > 0 and got["tokens"] == \
        len(reqs) * jbench.HET_MAX_NEW


@pytest.mark.parametrize("priority", [1, 0], ids=["preempt", "wait"])
def test_mixed_priority_cell_matches_jax(benches, models, priority):
    """The mixed-priority row's serve at priority 1 (a batch slot is
    preempted for each interactive arrival) and 0 (they wait): the same
    prompts, config and arrival ticks count the same on both sides."""
    jbench, tbench = benches
    jcfg, jparams, tcfg, tparams = models("dense")
    for name in ("PR_SLOTS", "PR_BATCH", "PR_BATCH_LEN", "PR_INTER_LEN",
                 "PR_BATCH_NEW", "PR_INTER_NEW", "PR_INTER_N", "PR_GAP"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    batch, inter = tbench._preempt_prompts()
    scfg = tbench._preempt_scfg()
    jscfg = jbench.ServeConfig(**dataclasses.asdict(scfg))
    want = jbench._preempt_serve(jcfg, jax_mesh(), jparams, jscfg, batch,
                                 inter, priority)
    got = tbench._preempt_serve(tcfg, tparams, scfg, batch, inter,
                                priority, "cpu")
    for key in ("tokens", "preemptions", "admission_waits"):
        assert got[key] == want[key], key
    assert got["tokens"] == jbench.PR_BATCH * jbench.PR_BATCH_NEW + \
        jbench.PR_INTER_N * jbench.PR_INTER_NEW
    assert (got["preemptions"] > 0) == (priority > 0)
    assert got["syncs"] == got["chunks"] > 0


def jax_rows(jbench):
    """The (config, slots) rows the JAX bench's ``run()`` gives on one
    device, from its constants."""
    rows = [(fmt, s) for fmt in jbench.SPARSITY for s in jbench.SLOTS]
    rows += [("het-mono", jbench.HET_SLOTS), ("het-paged", jbench.HET_SLOTS)]
    rows += [(f"spec-k{k}", jbench.HET_SLOTS) for k in jbench.SPEC_KS]
    rows += [("spec-k4-pack", jbench.HET_SLOTS)]
    rows += [(f"shared-sys-{h}", jbench.SH_SLOTS) for h in jbench.SH_HEADS]
    rows += [("mixed-priority-preempt", jbench.PR_SLOTS),
             ("crash-restore", jbench.HET_SLOTS)]
    rows += [(f"sharded-d{d}", jbench.SD_SLOTS) for d in jbench.SD_DEVICES
             if d <= jax.device_count()]
    return rows


def test_run_rows_are_the_jax_rows_but_unported(benches, capsys):
    """``run()`` on the CPU: the JAX rows minus ``sharded-*``, in order;
    ``main`` names the left-out group with its ROADMAP item and prints
    the mixed-priority and crash-restore rows; the chunked and per-token
    rows count equal tokens; the supervised serve restarts once and
    delivers every token of the mix."""
    jbench, tbench = benches
    out = tbench.run(device="cpu")
    got = [(r["config"], r["slots"]) for r in out["rows"]]
    assert got == [r for r in jax_rows(jbench)
                   if not r[0].startswith(LEFT_OUT)]
    for r in out["rows"][:2 * len(jbench.SPARSITY)]:
        assert r["tokens"] == r["ref_tokens"] > 0
    tbench.main(out)
    printed = capsys.readouterr().out
    for row in ("mixed-priority-preempt,", "crash-restore,"):
        assert any(line.startswith(row) for line in printed.splitlines())
    crash = next(r for r in out["rows"] if r["config"] == "crash-restore")
    assert crash["restarts"] == 1
    assert crash["tokens"] == len(tbench.HET_LENS) * tbench.HET_MAX_NEW
    assert crash["journal_tok_per_s"] > 0 and crash["recovery_ms"] > 0
    assert all(r["syncs"] == r["chunks"] for r in out["rows"])
    for prefix, item in (("sharded-", "item 13"),):
        assert any(line.startswith(f"# not ported: {prefix}") and item in
                   line for line in printed.splitlines()), prefix
