"""The port's paper-figure benchmarks (``repro_torch.benchmarks``) against
the JAX package's ``benchmarks/``: the Fig. 8 and Fig. 9 rows and the
Table III byte counts are equal; the Fig. 10 rows are equal for DS-CNN
over all three configurations (the whole grid is a CLI run, ~99 s of JAX
host time); the kernel bench runs its plain versions at the smoke size,
each row's product equal to the densified pack's."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import bench_csa_models as jcsa  # noqa: E402
from benchmarks import bench_resources as jres  # noqa: E402
from benchmarks import bench_sssa as jsssa  # noqa: E402
from benchmarks import bench_ussa as jussa  # noqa: E402
from repro_torch.benchmarks import (bench_csa_models, bench_kernels,  # noqa
                                    bench_resources, bench_sssa, bench_ussa,
                                    run)
from repro_torch.configs.tinyml import FIG10_CONFIGS, PAPER_MODELS  # noqa
from repro_torch.kernels import dispatch  # noqa: E402


def test_fig8_rows_equal_jax(capsys):
    got, want = bench_ussa.run(), jussa.run()
    assert got["rows"] == want["rows"]
    assert got["worst_rel"] == want["worst_rel"]
    bench_ussa.main(got)
    assert "(PASS)" in capsys.readouterr().out


def test_fig9_rows_equal_jax(capsys):
    got, want = bench_sssa.run(), jsssa.run()
    assert got["rows"] == want["rows"]
    bench_sssa.main(got)
    assert "Section IV-E): PASS" in capsys.readouterr().out


def test_fig10_dscnn_rows_equal_jax(monkeypatch, capsys):
    monkeypatch.setattr(jcsa, "PAPER_MODELS",
                        {"dscnn": PAPER_MODELS["dscnn"]})
    want = jcsa.run()
    got = bench_csa_models.run(models=["dscnn"])
    assert len(got["rows"]) == len(FIG10_CONFIGS) == 3
    assert got == want
    bench_csa_models.main(got)
    out = capsys.readouterr().out
    assert out.splitlines()[2].startswith("dscnn,0.5,0.5,")


def test_fig10_masks_equal_jax_on_a_large_model():
    """ResNet-56's masks at the largest point: every layer equal."""
    layers, masks = bench_csa_models.masks_for("resnet56", 0.6, 0.6)
    jlayers, jmasks = jcsa.masks_for("resnet56", 0.6, 0.6)
    assert [s.shape for s in layers] == [s.shape for s in jlayers]
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)


def test_table3_rows_equal_jax(capsys):
    """Every column but ``smem_bytes`` on the JAX bench's own weight;
    without a card ``smem_bytes`` is ``None`` (the JAX bench's VMEM
    column has no counterpart there)."""
    w = np.array(jax.random.normal(jax.random.key(0), (jres.K, jres.N)),
                 np.float32)
    got = bench_resources.run(torch.from_numpy(w))["rows"]
    want = jres.run()["rows"]
    assert [r["format"] for r in got] == [r["format"] for r in want]
    for g, j in zip(got, want):
        for key in ("values_bytes", "metadata_bytes", "meta_pct_of_values",
                    "flop_fraction"):
            assert g[key] == j[key], (g["format"], key)
        assert g["smem_bytes"] is None
    bench_resources.main({"rows": got})
    out = capsys.readouterr().out
    assert out.count(": PASS") == 2 and "FAIL" not in out


def test_kernel_bench_rows_on_the_cpu():
    out = bench_kernels.run(device="cpu")
    rows = out["rows"]
    assert out["shape"] == bench_kernels.SMOKE_SHAPE
    assert [r["kernel"] for r in rows] == [
        "dense", "block_skip(x=0.5)", "block_skip(x=0.75)", "nm(2:4)",
        "nm(1:4)", "combined(0.5,2:4)", "lookahead(int7)"]
    assert [r["dispatched"] for r in rows] == [
        "dense", "bsr_matmul", "bsr_matmul", "nm_spmm", "nm_spmm",
        "csa_matmul", "lookahead_decode"]
    # random weights: block pruning empties no (128, 128) tile
    assert all(r["tile_density"] == 1.0 for r in rows)
    assert [r["flop_frac"] for r in rows] == [1.0, 0.5, 0.25, 0.5, 0.25,
                                              0.25, 1.0]


def test_kernel_bench_products_equal_the_densified_packs():
    M, K, N = bench_kernels.SMOKE_SHAPE
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    w = rng.normal(size=(K, N)).astype(np.float32)
    for label, weight, _ in bench_kernels.packs(w, torch.float32, "cpu"):
        got = dispatch.sparse_matmul(x, weight)
        want = x @ bench_kernels.densify(weight).float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                                   msg=label)


def test_kernel_bench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_kernels.run()


def test_run_cli_writes_json(tmp_path, capsys):
    path = tmp_path / "bench.json"
    rc = run.main(["--sections", "fig8_ussa,fig9_sssa,kernels",
                   "--device", "cpu", "--json", str(path)])
    assert rc == 0
    record = json.loads(path.read_text())
    assert sorted(record["sections"]) == ["fig8_ussa", "fig9_sssa",
                                          "kernels"]
    assert all(e["ok"] for e in record["sections"].values())
    assert "3/3 benchmark sections passed" in capsys.readouterr().out
    assert run.main(["--sections", "nope"]) == 2
