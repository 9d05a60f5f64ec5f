"""The port's autotune rows (``kernels/autotune.py``, ``kernels.dispatch``)
on the CPU: the twins of ``tests/test_dispatch.py::TestAutotuneCache``
(the JSON round trip, a hit skipping the sweep, ``select`` reading the
cached plan, and the corrupt-file rules), ``select`` on a hit and on a
miss, the keys the wrappers look up equal to ``dispatch``'s, the
candidate plans of each kernel, and ``benchmarks.warm_autotune`` on the
plain versions.  Sweeps that time the kernels need the card
(``tests/test_torch_gpu.py``)."""

import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import pruning, sparsity
from repro_torch.kernels import autotune, dispatch, tiling
from repro_torch.kernels import bsr_matmul as bsr_mod
from repro_torch.kernels import csa_matmul as csa_mod
from repro_torch.kernels import lookahead_decode as la_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels.paged_attention import PagedKV

BF16 = torch.bfloat16


def rand(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.fixture(scope="module")
def packs():
    w = rand(1, (256, 128))
    out = {}
    wp, _ = pruning.n_m(w, 2, 4, group=128)
    out["nm"] = sparsity.pack_nm(wp, 2, 4, g=128)
    wb, _ = pruning.block_semi_structured(w, 0.5, block=128)
    out["block"] = sparsity.pack_block_sparse(wb, 128, 128)
    wc, _ = pruning.combined_nm(w, 0.5, 2, 4, group=128, block=128)
    out["combined"] = sparsity.pack_combined(wc, 2, 4, 128, 128)
    wl, _ = pruning.block_semi_structured(w, 0.5, block=4)
    out["lookahead"] = sparsity.LookaheadPack.from_float(wl)
    return out


@pytest.fixture()
def isolated_cache(tmp_path):
    cache = dispatch.AutotuneCache(str(tmp_path / "autotune.json"))
    old = dispatch.set_autotune_cache(cache)
    yield cache
    dispatch.set_autotune_cache(old)


def nm_key(M, pack, arch=dispatch.ARCH, dtype=None):
    desc = dispatch.SparsityDescriptor.of(pack, nominal=True)
    if dtype is not None:
        import dataclasses
        desc = dataclasses.replace(desc, dtype=dtype)
    return dispatch.cache_key("nm_spmm", M, desc, arch)


class TestAutotuneCache:
    def test_roundtrip_through_json(self, packs, isolated_cache):
        x = rand(10, (64, 256))
        cands = nm_mod.candidates(64, 256, 128, BF16)[:2]
        best = dispatch.tune(x, packs["nm"], candidates=cands, reps=1)
        assert best in cands
        # persisted: a fresh cache object reads the same decision back
        key = nm_key(64, packs["nm"], "ref")
        stored = dispatch.AutotuneCache(isolated_cache.path).get(key)
        assert stored is not None and autotune.plan_of(stored) == best
        assert "us" in stored and stored["skipped"] == 0
        with open(isolated_cache.path) as f:
            assert set(json.load(f)) == {key}

    def test_cache_hit_skips_sweep(self, packs, isolated_cache):
        x = rand(11, (64, 256))
        isolated_cache.put(nm_key(64, packs["nm"], "ref"),
                           {"bm": 64, "us": 1.0})
        # a candidate that would fail if it ran proves no sweep happens
        assert dispatch.tune(x, packs["nm"], candidates=[{"bm": -1}]) \
            == {"bm": 64}

    def test_select_uses_cached_plan(self, packs, isolated_cache):
        plan = dict(nm_mod.candidates(64, 256, 128, BF16)[-1])
        isolated_cache.put(nm_key(64, packs["nm"], dtype="bfloat16"),
                           {**plan, "us": 2.0})
        d = dispatch.select(packs["nm"], M=64, device="cuda", dtype=BF16)
        assert d.plan == plan and d.blocks == plan and d.reason == "cached"

    def test_corrupt_file_starts_empty(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        with pytest.warns(RuntimeWarning):
            cache = dispatch.AutotuneCache(str(p))
            assert len(cache) == 0
        cache.put("k", {"bm": 128})
        assert dispatch.AutotuneCache(str(p)).get("k") == {"bm": 128}

    def test_truncated_json_warns_once_and_rebuilds(self, tmp_path):
        p = tmp_path / "autotune.json"
        p.write_text('{"k1": {"bm": 64, "us": 1.0}, "k2": {"bm"')
        with pytest.warns(RuntimeWarning, match="autotune cache"):
            cache = dispatch.AutotuneCache(str(p))
            assert cache.get("k1") is None
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # no second warning
            assert cache.get("k2") is None
            cache.put("k3", {"bm": 128})
        assert dispatch.AutotuneCache(str(p)).get("k3") == {"bm": 128}
        assert json.load(open(p)) == {"k3": {"bm": 128}}

    def test_wrong_shape_payload_salvages_dict_entries(self, tmp_path):
        p = tmp_path / "autotune.json"
        p.write_text('{"good": {"bm": 64}, "bad": 3}')
        cache = dispatch.AutotuneCache(str(p))
        with pytest.warns(RuntimeWarning):    # load is lazy: first read
            assert cache.get("good") == {"bm": 64}
        assert cache.get("bad") is None
        p.write_text('[1, 2, 3]')               # valid JSON, wrong shape
        with pytest.warns(RuntimeWarning):
            assert dispatch.AutotuneCache(str(p)).get("x") is None


def test_default_path_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    assert autotune.default_path() == str(tmp_path / "a.json")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert autotune.default_path().endswith(
        "/.cache/repro_torch/autotune.json")


@pytest.mark.parametrize("fmt", ["nm", "block", "combined", "lookahead"])
def test_select_on_miss_takes_the_rule_and_on_hit_the_cache(
        packs, isolated_cache, fmt):
    pack = packs[fmt]
    entry = dispatch._entry_for(
        dispatch.SparsityDescriptor.of(pack, nominal=True).kind)
    rule = entry.module.plan(*dispatch._plan_args(entry, 8, pack, BF16))
    miss = dispatch.select(pack, M=8, device="cuda", dtype=BF16)
    assert (miss.reason, miss.plan, miss.mode) == ("tiling rule", rule,
                                                   "kernel")
    assert len(isolated_cache) == 0                # no sweep on a miss
    cands = entry.module.candidates(*dispatch._plan_args(entry, 8, pack,
                                                         BF16))
    assert cands[0] == rule and len(cands) == len(
        {json.dumps(c, sort_keys=True) for c in cands})
    isolated_cache.put(miss.key, {**cands[-1], "us": 1.0})
    hit = dispatch.select(pack, M=8, device="cuda", dtype=BF16)
    assert (hit.reason, hit.plan, hit.key) == ("cached", cands[-1], miss.key)
    assert dispatch.select(pack, M=8).plan == {}     # the CPU: no plan
    # plan rows take the pack's own dtype (float32 here: the fma route)
    dt = dispatch._x_dtype(pack)
    rows = dispatch.plan_params({"w": pack}, 8, "meta", with_plans=True)
    rule = entry.module.plan(*dispatch._plan_args(entry, 8, pack, dt))
    assert (rows[0]["source"], rows[0]["plan"]) == (
        ("cache", cands[-1]) if dt == BF16 else ("rule", rule))
    isolated_cache.put(dispatch._weight_key(entry, 8, pack, dt,
                                            dispatch.ARCH),
                       {**rule, "us": 1.0})
    rows = dispatch.plan_params({"w": pack}, 8, "meta", with_plans=True)
    assert (rows[0]["source"], rows[0]["plan"]) == ("cache", rule)


def test_wrapper_keys_equal_dispatch_keys(packs, isolated_cache):
    """The key a wrapper looks up on the card (``autotune.lookup`` with its
    own fields) is the one ``dispatch`` writes."""
    M, dt = 8, "bfloat16"
    p = packs["nm"]
    assert autotune.key("nm_spmm", M, p.K, p.N, dt, nm_mod.pattern(
        p.n, p.m, p.g)) == dispatch._weight_key(
        dispatch._REGISTRY["nm_spmm"], M, p, BF16, dispatch.ARCH)
    p = packs["block"]
    assert autotune.key("bsr_matmul", M, p.K, p.N, dt, bsr_mod.pattern(
        p.K, p.bk, p.bn, p.max_nnz)) == dispatch._weight_key(
        dispatch._REGISTRY["bsr_matmul"], M, p, BF16, dispatch.ARCH)
    p = packs["combined"]
    assert autotune.key("csa_matmul", M, p.K, p.N, dt, csa_mod.pattern(
        p.K, p.bk, p.bn, p.max_nnz, p.n, p.m)) == dispatch._weight_key(
        dispatch._REGISTRY["csa_matmul"], M, p, BF16, dispatch.ARCH)
    p = packs["lookahead"]
    assert autotune.key("lookahead_decode", M, p.K, p.N, dt, "lookahead") \
        == dispatch._weight_key(dispatch._REGISTRY["lookahead_decode"], M,
                                p, BF16, dispatch.ARCH)


def test_resolve_counts_hits_and_memo_sees_puts(isolated_cache):
    autotune.hits.clear()
    rule = {"route": "mma", "bm": 8}
    args = ("nm_spmm", 8, 256, 128, "bfloat16", "2:4g128")
    assert autotune.resolve(*args, lambda: rule) is rule
    key = autotune.key(*args)
    isolated_cache.put(key, {"route": "mma", "bm": 32, "grid": [4, 1],
                             "us": 1.0})
    got = autotune.resolve(*args, lambda: rule)
    assert got == {"route": "mma", "bm": 32, "grid": (4, 1)}
    assert autotune.hits == {key: 1}
    assert autotune.resolve(*args, lambda: rule, {"bm": 64}) == {"bm": 64}
    assert autotune.hits == {key: 1}        # a sweep's plan is no hit


def test_candidates_are_built_instances():
    for M in (1, 8, 24, 64, 512):
        for c in tiling.mma_candidates(M, 1024, 3072, 8, (128, 64, 32)):
            assert c["bm"] in tiling.MMA_ROWS and c["bn"] in tiling.WIDTHS
            assert 8 % c["split"] == 0
        assert {c["bm"] for c in nm_mod.candidates(M, 1024, 3072, BF16)} == \
            {b for b in tiling.MMA_ROWS if b < M} | {
                next((b for b in tiling.MMA_ROWS if b >= M), 64)}
    assert la_mod.candidates(8, 1024, 1024, torch.float32) == \
        [la_mod.plan(8, 1024, 1024, torch.float32)]
    paged = tiling.paged_candidates(8, 16, 8, 1, 32, 128, (BF16, BF16))
    assert paged[0] == tiling.paged_plan(8, 16, 8, 1, 32, 128, (BF16, BF16))
    assert {(c["warps"], c["split"]) for c in paged} == {
        (w, s) for w in tiling.PAGED_WARPS for s in tiling.SPLITS}


def test_paged_keys_cover_the_geometry(isolated_cache):
    pool = torch.zeros((9, 16, 2, 64))
    kv = PagedKV(pool, pool, torch.arange(1, 9, dtype=torch.int32
                                          ).reshape(2, 4),
                 torch.full((2,), 40, dtype=torch.int32))
    q = rand(3, (2, 4, 64))
    plan = dispatch.tune(q, kv, reps=1, window=32)
    key = dispatch.paged_key(2, 4, 2, 1, 4, 64, (torch.float32,) * 2, 16,
                             32, "ref")
    assert isolated_cache.get(key)["skipped"] == 0
    assert plan == tiling.paged_plan(2, 4, 2, 1, 4, 64, (torch.float32,) * 2,
                                     16)
    assert key == "paged_attention|M2|K64|N64|float32|" \
        "paged16x4H4Hk2Q1w32|ref"


def test_warm_autotune_on_the_plain_versions(isolated_cache):
    """The warmer's flow on the CPU: every serving key of the bench's nm
    and combined models and its paged views gets a ``ref`` row, none
    skipped; a second run finds them all cached."""
    from repro_torch.benchmarks import bench_serving as BS
    from repro_torch.benchmarks import warm_autotune as W
    paged = [dict(H=4, Hk=2, D=16, page_size=16, views=[8], window=None)]
    out = W.run(slots=2, prompt_pad=16, reps=1, device="cpu", paged=paged)
    ms = W.serving_ms(2, 16, wave=False)
    assert 2 * 16 not in ms
    n_packs = sum(len(W.layer_packs(BS._model(f, "cpu")[1]))
                  for f in W.FORMATS)
    assert len(out["entries"]) == n_packs * len(ms) + 1 + len(W.SPEC_KS)
    assert all(e["key"].endswith("|ref") and e["skipped"] == 0
               and not e["cached"] for e in out["entries"])
    assert len(isolated_cache) == len(out["entries"])
    again = W.run(slots=2, prompt_pad=16, reps=1, device="cpu", paged=paged)
    assert all(e["cached"] for e in again["entries"])
    with pytest.raises(NotImplementedError, match="item 13"):
        W.run(device="cpu", device_counts=(2,))
    assert W.paged_views(BS._het_scfg()) == [8, 16, 24, 32, 36]
