"""The port's perf-trend gate (``repro_torch.benchmarks.perf_trend``): the
twins of ``tests/test_perf_trend.py``'s 14 cases, each asserting what the
JAX case asserts and that the port's ``compare`` (or ``main``'s exit
code) equals the JAX one's on the same records; then the port's own
(kernel, dtype) rows."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import perf_trend as jtrend  # noqa: E402
from repro_torch.benchmarks import perf_trend as ttrend  # noqa: E402


def record(serving_rows=None, kernel_rows=None):
    sections = {}
    if serving_rows is not None:
        sections["serving"] = {"data": {"rows": serving_rows}}
    if kernel_rows is not None:
        sections["kernels"] = {"data": {"rows": kernel_rows}}
    return {"sections": sections}


def srow(config, slots, tps, **kw):
    return {"config": config, "slots": slots, "tok_per_s": tps, **kw}


#: name → (baseline, current, regressions expected, (metric of the first
#: regression or a substring some report line holds) or None)
COMPARE = {
    "new_row_in_current_does_not_block": (
        record([srow("dense", 8, 100.0)]),
        record([srow("dense", 8, 101.0), srow("het-paged", 8, 500.0)]),
        0, "new row"),
    "row_only_in_baseline_does_not_block": (
        record([srow("dense", 8, 100.0), srow("retired", 8, 50.0)]),
        record([srow("dense", 8, 99.0)]), 0, "absent from current"),
    "row_missing_metric_is_skipped": (
        record([srow("dense", 8, 100.0)]),
        record([{"config": "dense", "slots": 8},
                {"config": "x", "slots": 1, "tok_per_s": "n/a"}]), 0, None),
    "section_missing_entirely": (
        record([srow("dense", 8, 100.0)],
               [{"kernel": "nm_spmm", "us": 10.0}]),
        record(kernel_rows=[{"kernel": "nm_spmm", "us": 9.0}]), 0, None),
    "new_metric_on_old_row_does_not_block": (
        record([srow("dense", 8, 100.0)]),
        record([srow("dense", 8, 99.0, ttft_p95_ms=12.0)]), 0,
        "new metric"),
    "ttft_regression_blocks": (
        record([srow("dense", 8, 100.0, ttft_p95_ms=10.0)]),
        record([srow("dense", 8, 100.0, ttft_p95_ms=20.0)]), 1,
        "ttft_p95_ms"),
    "ttft_improvement_passes": (
        record([srow("dense", 8, 100.0, ttft_p95_ms=20.0)]),
        record([srow("dense", 8, 100.0, ttft_p95_ms=5.0)]), 0, None),
    "ttft_p50_not_gated": (
        record([srow("dense", 8, 100.0, ttft_p50_ms=1.0, ttft_p95_ms=10.0)]),
        record([srow("dense", 8, 100.0, ttft_p50_ms=50.0,
                     ttft_p95_ms=10.0)]), 0, None),
    "regression_detected": (
        record([srow("dense", 8, 100.0)]), record([srow("dense", 8, 50.0)]),
        1, "REGRESSION"),
    "kernel_us_higher_is_worse": (
        record(kernel_rows=[{"kernel": "nm_spmm", "us": 10.0}]),
        record(kernel_rows=[{"kernel": "nm_spmm", "us": 20.0}]), 1, "us"),
    "within_threshold_passes": (
        record([srow("dense", 8, 100.0)]), record([srow("dense", 8, 80.0)]),
        0, None),
}


@pytest.mark.parametrize("name", COMPARE)
def test_compare_matches_jax(name):
    base, cur, n_reg, mark = COMPARE[name]
    lines, regressions = ttrend.compare(base, cur, 0.30)
    assert (lines, regressions) == jtrend.compare(base, cur, 0.30)
    assert len(regressions) == n_reg
    if mark is not None and n_reg:
        assert regressions[0][2] == mark or any(mark in ln for ln in lines)
    elif mark is not None:
        assert any(mark in ln for ln in lines)


#: name → (baseline rows or None for a missing file, current rows, exit)
MAIN = {
    "missing_baseline_passes": (None, [srow("d", 8, 1.0)], 0),
    "regression_fails": ([srow("d", 8, 100.0)], [srow("d", 8, 10.0)], 1),
    "first_run_of_new_bench_passes": (
        [srow("d", 8, 100.0)],
        [srow("d", 8, 100.0), srow("het-paged", 8, 1.0)], 0),
}


@pytest.mark.parametrize("name", MAIN)
def test_main_exit_codes_match_jax(name, tmp_path):
    base_rows, cur_rows, code = MAIN[name]
    base, cur = tmp_path / "b.json", tmp_path / "c.json"
    if base_rows is not None:
        base.write_text(json.dumps(record(serving_rows=base_rows)))
    cur.write_text(json.dumps(record(serving_rows=cur_rows)))
    argv = ["--baseline", str(base), "--current", str(cur)]
    assert ttrend.main(argv) == jtrend.main(argv) == code


def test_port_kernel_rows_key_on_dtype():
    """The port's bench times each kernel in float32 and bfloat16: each
    dtype is its own row, and a regression in one is not hidden by the
    other."""
    rows = [{"kernel": "nm(2:4)", "dtype": "float32", "us": 10.0},
            {"kernel": "nm(2:4)", "dtype": "bfloat16", "us": 4.0}]
    slower = [dict(rows[0]), dict(rows[1], us=8.0)]
    _, regressions = ttrend.compare(record(kernel_rows=rows),
                                    record(kernel_rows=slower), 0.30)
    assert [r[:3] for r in regressions] == [
        ("kernels", ("nm(2:4)", "bfloat16"), "us")]
