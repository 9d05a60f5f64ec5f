"""Serving-engine benchmark of the port: end-to-end tokens/s and latency
of the chunked engine against the per-token loop, the paged-vs-monolithic
KV cache, speculation and prefix sharing.

The twin of the JAX package's ``benchmarks/bench_serving.py``: the same
constants (shrunk the same way under ``REPRO_BENCH_SMOKE=1``), models
(d_model 64 over 4 heads, D = 16, MLPs packed 2:4 at g = 64 or combined
in 64 x 64 tiles), request mixes and rows, served by the port's
``Engine`` on one device (``device="cuda"``, the default: the
hand-written kernels at these geometries).  Rows:

  * ``dense``/``nm``/``combined`` × slots {1, 8}: the chunked engine
    (``tok_per_s``, per-token ``p50_ms``/``p95_ms`` from the chunk wall
    times, TTFT percentiles, ``syncs``) against ``ref_tok_per_s``, the
    seed loop: a whole-wave prefill, then one decode step and one
    device→host fetch per token (``loops.build_prefill_step`` /
    ``build_decode_step``); ``chunks``, ``ref_tokens`` and
    ``ref_syncs`` beside the JAX bench's columns hold the serves to the
    one-fetch-per-chunk contract and to each other;
  * ``het-mono``/``het-paged``: a short-heavy 16–512-token prompt mix on
    8 slots, monolithic (every prompt padded to 512) against paged
    (16-row pages, 64-row prompt buckets, a demand-sized pool):
    ``kv_mb``, ``peak_used_mb``, ``kv_ratio``, ``speedup_vs_mono``;
  * ``spec-k{2,4,8}`` (self draft) and ``spec-k4-pack`` (the 2:4 pack
    drafting for the dense model) on the same mix, against het-paged;
  * ``shared-sys-{64,256}``: 8 slots of prompts led by a pinned head
    (``register_prefix``) against the unshared engine serving the same
    full prompts: ``ttft_speedup``, ``kv_ratio``, the prefix counters;
  * ``mixed-priority-preempt``: long batch requests fill the page pool
    while short interactive ones arrive mid-serve, at priority 1 (a
    batch slot is preempted and resumes warm) against priority 0 (they
    wait for a batch slot to drain): interactive TTFT both ways,
    ``preemptions``, ``ttft_p95_speedup``; ``syncs`` and ``chunks`` of
    the preempting serve beside the JAX bench's columns;
  * ``crash-restore``: the het-paged mix with and without the
    write-ahead journal (``journal_tok_per_s``, ``journal_overhead_pct``,
    the median of three interleaved pairs), then served under the
    ``Supervisor`` with a crash pinned to ``CRASH_TICK``: end-to-end
    ``tok_per_s`` through the kill and restore, ``restarts`` and the
    recovery's timings; ``syncs`` and ``chunks`` of the restored engine
    beside the JAX bench's columns.  Reported, not gated.

Left out until its module is ported (``NOT_PORTED``, printed by
:func:`main`): the ``sharded-*`` rows (ROADMAP queue 1 item 13).

Times are host wall clock around the engine's own calls, which fetch
their results (one sync per chunk), so the device has finished when
they are read; a key's first chunks are eager and its capture lands in
the warm-up where the warm-up visits it.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import models as MZ
from repro_torch.core.sparse_linear import SparsityConfig, pack_params
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (ChaosConfig, ChaosMonkey, Engine,
                                 ServeConfig, Supervisor, build_decode_step,
                                 build_prefill_step, sample_token_slots)

SMOKE = os.environ.get("REPRO_BENCH_SMOKE", "") == "1"

D_MODEL, D_FF, N_LAYERS = (64, 128, 2)
MAX_NEW = 16 if SMOKE else 64
DECODE_CHUNK = 8 if SMOKE else 16
PROMPT_PAD = 16
MAX_LEN = PROMPT_PAD + MAX_NEW + DECODE_CHUNK + 2
SLOTS = (1, 8)
VOCAB = 256

SPARSITY = {
    "dense": None,
    "nm": SparsityConfig(format="nm", n=2, m=4, block_n=64),
    "combined": SparsityConfig(format="combined", sparsity=0.5, n=2, m=4,
                               block_k=64, block_n=64),
}

# --- heterogeneous-length scenario (paged vs monolithic KV cache) ----------
HET_SLOTS = 8
HET_PAGE = 16                       # KV rows per page
HET_PAD = 512                       # monolithic uniform prompt pad
HET_BUCKET = 64                     # paged per-request prompt bucket
HET_MAX_NEW = 8 if SMOKE else 32
HET_CHUNK = 8 if SMOKE else 16
HET_MAX_LEN = HET_PAD + 2 * HET_MAX_NEW
HET_LENS = ([16, 32, 64, 96, 128, 256, 384, 512] if SMOKE else
            [16, 24, 32, 48, 64, 64, 96, 128, 160, 256, 384, 512])

SPEC_KS = (2, 4) if SMOKE else (2, 4, 8)

# --- shared-system-prompt scenario (prefix cache over paged) ---------------
SH_SLOTS = 8
SH_HEADS = (64, 256)                # shared head lengths (pages: 4 / 16)
SH_SUFFIX = 16                      # per-request distinct tail
SH_MAX_NEW = 8 if SMOKE else 32
SH_CHUNK = 2                        # short chunks: TTFT ≈ prefill cost
SH_ROUNDS = 2 if SMOKE else 4       # single-wave rounds averaged into
SH_REQS = SH_SLOTS * SH_ROUNDS      # the TTFT percentiles

#: the JAX bench's rows the port leaves out, with the item that ports them
NOT_PORTED = {
    "sharded-d*": "ROADMAP queue 1 item 13 (tensor parallelism)",
}


def _het_scfg() -> ServeConfig:
    """The paged heterogeneous config sans pool size (set below)."""
    return ServeConfig(
        slots=HET_SLOTS, max_len=HET_MAX_LEN, prompt_pad=HET_PAD,
        max_new_tokens=HET_MAX_NEW, decode_chunk=HET_CHUNK,
        temperature=0.0, eos_token=-1, page_size=HET_PAGE,
        prompt_buckets=HET_BUCKET, page_view_chunk=8)


def _het_pool_pages() -> int:
    """Demand-sized pool: the worst-case pages of any HET_SLOTS requests
    live at once, through the engine's own admission math."""
    scfg = _het_scfg()
    need = sorted((scfg.request_pages(L, HET_MAX_NEW) for L in HET_LENS),
                  reverse=True)
    return sum(need[:HET_SLOTS])


def _model(fmt: str, device="cuda"):
    scfg = SPARSITY[fmt]
    cfg = ModelConfig(name=f"bench-{fmt}", n_layers=N_LAYERS,
                      d_model=D_MODEL, vocab_size=VOCAB, n_heads=4,
                      n_kv_heads=2, d_ff=D_FF, remat=False,
                      mlp_sparsity=scfg or SparsityConfig())
    params = MZ.init_model(cfg, seed=0, device=device)
    if scfg is not None:
        params = pack_params(params, cfg)
    return cfg, params


def _requests(rng, n):
    return [rng.integers(1, VOCAB, size=int(rng.integers(4, PROMPT_PAD + 1))
                         ).astype(np.int32) for _ in range(n)]


def _serve_chunked(cfg, params, slots, requests, scfg=None, warm_all=False,
                   max_new=None, prefix_tokens=None, warm_requests=None,
                   rounds=1, device="cuda"):
    scfg = scfg or ServeConfig(
        slots=slots, max_len=MAX_LEN, prompt_pad=PROMPT_PAD,
        max_new_tokens=MAX_NEW, decode_chunk=DECODE_CHUNK,
        temperature=0.0, eos_token=-1)
    server = Engine(cfg, scfg, params, device=device)
    handle = (server.register_prefix(prefix_tokens)
              if prefix_tokens is not None else None)
    if warm_all:
        # the heterogeneous mix: visit every prompt and view bucket so the
        # timed run meets no new key
        for p in (warm_requests if warm_requests is not None else requests):
            server.submit(p, max_new=max_new, prefix=handle)
    else:
        server.submit(requests[0][: scfg.prompt_pad],
                      max_new=scfg.decode_chunk + 1)
    server.run()                                    # warm-up
    server.finished.clear()
    server.reset_stats()
    # rounds > 1 drains between equal-sized submit batches: every batch is
    # a fresh single wave, so TTFT percentiles average over rounds
    per_round = -(-len(requests) // rounds)
    t0 = time.perf_counter()
    done = []
    for i in range(rounds):
        for p in requests[i * per_round:(i + 1) * per_round]:
            server.submit(p, max_new=max_new, prefix=handle)
        done.extend(server.run())
    wall = time.perf_counter() - t0
    stats = server.stats()
    toks = sum(len(r.out) for r in done)
    per_tok_ms = np.concatenate([
        np.full(n, s / n * 1e3)
        for s, n in zip(stats.chunk_s, stats.chunk_tokens) if n]) \
        if stats.chunk_tokens else np.zeros(1)
    page_bytes_used = 0
    if scfg.paged:
        # per-page bytes across layers ≈ pool bytes / (pool + null pages)
        page_bytes_used = int(
            stats.cache_bytes * stats.peak_pages / (scfg.pool_pages + 1))
    ttft_ms = np.asarray([r.ttft_s for r in done
                          if r.ttft_s is not None]) * 1e3
    if ttft_ms.size == 0:
        ttft_ms = np.zeros(1)
    return {"tokens": toks, "tok_per_s": toks / wall,
            "p50_ms": float(np.percentile(per_tok_ms, 50)),
            "p95_ms": float(np.percentile(per_tok_ms, 95)),
            "ttft_p50_ms": float(np.percentile(ttft_ms, 50)),
            "ttft_p95_ms": float(np.percentile(ttft_ms, 95)),
            "syncs": stats.sync_count, "chunks": len(stats.chunk_s),
            "wall_s": wall,
            "kv_bytes": stats.cache_bytes,
            "peak_used_bytes": page_bytes_used,
            "peak_pages": stats.peak_pages,
            "admission_waits": stats.admission_waits,
            "acceptance_rate": stats.acceptance_rate,
            "prefix_hits": stats.prefix_hits,
            "shared_pages": stats.shared_pages,
            "cow_copies": stats.cow_copies}


def _serve_per_token(cfg, params, slots, requests, device="cuda"):
    """The seed engine's hot path: whole-wave prefill, one shared position,
    one device→host fetch of the sampled tokens per generated token."""
    device = torch.device(device)
    scfg = ServeConfig(slots=slots, max_len=MAX_LEN, prompt_pad=PROMPT_PAD,
                       max_new_tokens=MAX_NEW, temperature=0.0, eos_token=-1)
    prefill = build_prefill_step(cfg, scfg)
    decode = build_decode_step(cfg, scfg)
    syncs = 0

    def run_waves(reqs):
        nonlocal syncs
        toks = 0
        queue = list(reqs)
        while queue:
            active, queue = queue[:slots], queue[slots:]
            prompts = np.zeros((slots, PROMPT_PAD), np.int32)
            for i, p in enumerate(active):
                L = min(len(p), PROMPT_PAD)
                prompts[i, PROMPT_PAD - L:] = p[-L:]
            cache = MZ.init_cache(cfg, slots, MAX_LEN, device=device)
            logits, cache = prefill(
                params, {"tokens": torch.from_numpy(prompts).to(device)},
                cache)
            tok = sample_token_slots(logits[:, :cfg.vocab_size], None, None)
            pos = PROMPT_PAD
            for t in range(MAX_NEW):
                tok.cpu()                           # the per-token sync
                syncs += 1
                toks += len(active)
                if t == MAX_NEW - 1 or pos + 1 >= MAX_LEN:
                    break
                logits, cache = decode(params, tok, cache, pos)
                tok = sample_token_slots(logits[:, :cfg.vocab_size], None, None)
                pos += 1
        return toks

    run_waves(requests[:1])                         # warm-up
    syncs = 0
    t0 = time.perf_counter()
    toks = run_waves(requests)
    wall = time.perf_counter() - t0
    return {"tokens": toks, "tok_per_s": toks / wall, "wall_s": wall,
            "syncs": syncs}


def _het_scenario(device) -> list:
    """Paged vs monolithic serving of the heterogeneous prompt mix."""
    cfg, params = _model("dense", device)
    rng = np.random.default_rng(1)
    requests = [rng.integers(1, VOCAB, size=L).astype(np.int32)
                for L in HET_LENS]
    paged_scfg = dataclasses.replace(_het_scfg(),
                                     num_pages=_het_pool_pages())
    mono_scfg = dataclasses.replace(paged_scfg, page_size=0, num_pages=0,
                                    prompt_buckets=0)
    mono = _serve_chunked(cfg, params, HET_SLOTS, requests, scfg=mono_scfg,
                          warm_all=True, device=device)
    paged = _serve_chunked(cfg, params, HET_SLOTS, requests,
                           scfg=paged_scfg, warm_all=True, device=device)
    mb = 1.0 / (1024 * 1024)
    return [
        {"config": "het-mono", "slots": HET_SLOTS,
         "tokens": mono["tokens"],
         "tok_per_s": round(mono["tok_per_s"], 1),
         "p50_ms": round(mono["p50_ms"], 3),
         "p95_ms": round(mono["p95_ms"], 3),
         "ttft_p50_ms": round(mono["ttft_p50_ms"], 3),
         "ttft_p95_ms": round(mono["ttft_p95_ms"], 3),
         "syncs": mono["syncs"], "chunks": mono["chunks"],
         "kv_mb": round(mono["kv_bytes"] * mb, 3)},
        {"config": "het-paged", "slots": HET_SLOTS,
         "tokens": paged["tokens"],
         "tok_per_s": round(paged["tok_per_s"], 1),
         "p50_ms": round(paged["p50_ms"], 3),
         "p95_ms": round(paged["p95_ms"], 3),
         "ttft_p50_ms": round(paged["ttft_p50_ms"], 3),
         "ttft_p95_ms": round(paged["ttft_p95_ms"], 3),
         "syncs": paged["syncs"], "chunks": paged["chunks"],
         "kv_mb": round(paged["kv_bytes"] * mb, 3),
         "peak_used_mb": round(paged["peak_used_bytes"] * mb, 3),
         "kv_ratio": round(mono["kv_bytes"] / paged["kv_bytes"], 2),
         "speedup_vs_mono": round(paged["tok_per_s"]
                                  / max(mono["tok_per_s"], 1e-9), 2),
         "admission_waits": paged["admission_waits"]},
    ]


def _shared_scenario(device) -> list:
    """Prefix-shared vs unshared paged serving of a shared-system-prompt
    workload: the same page pool, prompts and budgets, on a larger model
    than the grid's so prefill work (what sharing saves) dominates."""
    cfg = ModelConfig(name="bench-shared", n_layers=4, d_model=256,
                      vocab_size=VOCAB, n_heads=4, n_kv_heads=2,
                      d_ff=512, remat=False)
    params = MZ.init_model(cfg, seed=0, device=device)
    rng = np.random.default_rng(2)
    rows = []
    for head_len in SH_HEADS:
        head = rng.integers(1, VOCAB, size=head_len).astype(np.int32)

        def suffixes(tag0, n):
            out = []
            for i in range(n):
                s = rng.integers(1, VOCAB, size=SH_SUFFIX).astype(np.int32)
                s[0] = tag0 + i             # unique first token: no
                out.append(s)               # cross-request tail sharing
            return out
        warm = suffixes(1, SH_SLOTS)
        timed = suffixes(1 + SH_SLOTS, SH_REQS)
        total = head_len + SH_SUFFIX
        base = ServeConfig(
            slots=SH_SLOTS, max_len=total + 2 * SH_MAX_NEW,
            prompt_pad=total, max_new_tokens=SH_MAX_NEW,
            decode_chunk=SH_CHUNK, temperature=0.0, eos_token=-1,
            page_size=HET_PAGE, page_view_chunk=8)
        pool = SH_SLOTS * base.request_pages(total, SH_MAX_NEW)
        un_scfg = dataclasses.replace(base, num_pages=pool)
        sh_scfg = dataclasses.replace(un_scfg, prefix_cache=True,
                                      prefix_cache_pages=1)
        un = _serve_chunked(
            cfg, params, SH_SLOTS,
            [np.concatenate([head, s]) for s in timed], scfg=un_scfg,
            warm_all=True, max_new=SH_MAX_NEW, rounds=SH_ROUNDS,
            warm_requests=[np.concatenate([head, s]) for s in warm],
            device=device)
        sh = _serve_chunked(
            cfg, params, SH_SLOTS, timed, scfg=sh_scfg, warm_all=True,
            max_new=SH_MAX_NEW, prefix_tokens=head, warm_requests=warm,
            rounds=SH_ROUNDS, device=device)
        mb = 1.0 / (1024 * 1024)
        rows.append({
            "config": f"shared-sys-{head_len}", "slots": SH_SLOTS,
            "tokens": sh["tokens"],
            "tok_per_s": round(sh["tok_per_s"], 1),
            "p50_ms": round(sh["p50_ms"], 3),
            "p95_ms": round(sh["p95_ms"], 3),
            "ttft_p50_ms": round(sh["ttft_p50_ms"], 3),
            "ttft_p95_ms": round(sh["ttft_p95_ms"], 3),
            "syncs": sh["syncs"], "chunks": sh["chunks"],
            "prefix_hits": sh["prefix_hits"],
            "shared_pages": sh["shared_pages"],
            "cow_copies": sh["cow_copies"],
            "kv_alloc_mb": round(sh["peak_used_bytes"] * mb, 3),
            "base_tok_per_s": round(un["tok_per_s"], 1),
            "base_ttft_p50_ms": round(un["ttft_p50_ms"], 3),
            "base_kv_alloc_mb": round(un["peak_used_bytes"] * mb, 3),
            "ttft_speedup": round(un["ttft_p50_ms"]
                                  / max(sh["ttft_p50_ms"], 1e-9), 2),
            "kv_ratio": round(un["peak_used_bytes"]
                              / max(sh["peak_used_bytes"], 1), 2),
            "admission_waits": sh["admission_waits"]})
    return rows


def _spec_scenario(paged_tok_per_s: float, device) -> list:
    """Speculative serving of the heterogeneous mix vs the paged
    baseline: ``spec-k{K}`` rows self-draft, ``spec-k4-pack`` drafts with
    the nm-packed weights against the dense verifier."""
    rng = np.random.default_rng(1)
    requests = [rng.integers(1, VOCAB, size=L).astype(np.int32)
                for L in HET_LENS]
    pool = dataclasses.replace(_het_scfg(), num_pages=_het_pool_pages())

    def spec_serve(cfg, params, k, draft):
        # decode_chunk counts verify steps: scaled down so tokens per host
        # sync stay about the baseline's
        chunk = max(1, -(-HET_CHUNK // (k + 1)))
        scfg = dataclasses.replace(pool, spec_k=k, spec_draft=draft,
                                   decode_chunk=chunk)
        out = _serve_chunked(cfg, params, HET_SLOTS, requests, scfg=scfg,
                             warm_all=True, device=device)
        return {"slots": HET_SLOTS, "tokens": out["tokens"],
                "tok_per_s": round(out["tok_per_s"], 1),
                "acceptance_rate": round(out["acceptance_rate"], 3),
                "p50_ms": round(out["p50_ms"], 3),
                "p95_ms": round(out["p95_ms"], 3),
                "ttft_p50_ms": round(out["ttft_p50_ms"], 3),
                "ttft_p95_ms": round(out["ttft_p95_ms"], 3),
                "syncs": out["syncs"], "chunks": out["chunks"],
                "speedup_vs_paged": round(
                    out["tok_per_s"] / max(paged_tok_per_s, 1e-9), 2)}

    cfg, params = _model("dense", device)
    rows = [{"config": f"spec-k{k}", **spec_serve(cfg, params, k, "self")}
            for k in SPEC_KS]
    # a real sparse draft: dense verify weights, the nm pack of the same
    # weights drafting (spec_draft="pack" packs per the model config)
    dense_cfg = ModelConfig(
        name="bench-spec-nm", n_layers=N_LAYERS, d_model=D_MODEL,
        vocab_size=VOCAB, n_heads=4, n_kv_heads=2, d_ff=D_FF, remat=False,
        mlp_sparsity=SPARSITY["nm"])
    dense_params = MZ.init_model(dense_cfg, seed=0, device=device)
    rows.append({"config": "spec-k4-pack",
                 **spec_serve(dense_cfg, dense_params, 4, "pack")})
    return rows


# --- mixed-priority scenario (preemption vs admission wait) ----------------
# a pool saturated by low-priority batch requests while short interactive
# requests arrive mid-serve: with priority the scheduler preempts a batch
# slot (retired; the warm re-admission resumes the suffix), without it
# the interactive request waits for a batch slot to drain.
PR_SLOTS = 6                        # slot headroom: arrivals block on
PR_BATCH = 4                        # *pages*, not slots, so preemption
PR_BATCH_LEN = 256                  # (not slot-wait) is what's measured
PR_INTER_LEN = 32                   # interactive prompt tokens
PR_BATCH_NEW = 16 if SMOKE else 48
PR_INTER_NEW = 4
PR_INTER_N = 3                      # interactive arrivals, spaced out
PR_GAP = 2                          # scheduler ticks between arrivals


def _preempt_serve(cfg, params, scfg, batch, inter, priority,
                   device="cuda") -> dict:
    """Serve the batch requests and the interactive arrivals (every
    ``PR_GAP`` ticks, at ``priority``) twice on one engine: a warm pass
    that visits every geometry the timed one will (greedy, fixed arrival
    ticks: the same schedule), then the timed pass."""
    eng = Engine(cfg, scfg, params, device=device)

    def one_pass():
        t0 = time.perf_counter()
        for p in batch:
            eng.submit(p, max_new=PR_BATCH_NEW)
        ih, tick = [], 0
        while eng.queue or eng.num_live or len(ih) < len(inter):
            if tick and tick % PR_GAP == 0 and len(ih) < len(inter):
                ih.append(eng.submit(inter[len(ih)], max_new=PR_INTER_NEW,
                                     priority=priority))
            eng.step()
            tick += 1
        return ih, time.perf_counter() - t0

    one_pass()
    eng.finished.clear()
    eng.reset_stats()
    ih, wall = one_pass()
    stats = eng.stats()
    toks = sum(len(r.out) for r in eng.finished)
    ttft = np.asarray([h.ttft_s for h in ih if h.ttft_s is not None]) * 1e3
    if ttft.size == 0:
        ttft = np.zeros(1)
    return {"tokens": toks, "tok_per_s": toks / wall,
            "inter_ttft_p50_ms": float(np.percentile(ttft, 50)),
            "inter_ttft_p95_ms": float(np.percentile(ttft, 95)),
            "preemptions": stats.preemptions,
            "admission_waits": stats.admission_waits,
            "syncs": stats.sync_count, "chunks": len(stats.chunk_s),
            "prefills": stats.prefills, "prefix_hits": stats.prefix_hits}


def _preempt_prompts() -> tuple:
    """(batch prompts, interactive prompts) of the mixed-priority row."""
    rng = np.random.default_rng(3)
    batch = [rng.integers(1, VOCAB, size=PR_BATCH_LEN).astype(np.int32)
             for _ in range(PR_BATCH)]
    inter = [rng.integers(1, VOCAB, size=PR_INTER_LEN).astype(np.int32)
             for _ in range(PR_INTER_N)]
    return batch, inter


def _preempt_scfg() -> ServeConfig:
    """The row's paged config, its pool sized to exactly the batch
    saturation: an interactive arrival finds a free slot but no pages
    until a batch request retires (admission wait) or is preempted."""
    base = ServeConfig(
        slots=PR_SLOTS, max_len=PR_BATCH_LEN + 2 * PR_BATCH_NEW,
        prompt_pad=PR_BATCH_LEN, max_new_tokens=PR_BATCH_NEW,
        decode_chunk=4, temperature=0.0, eos_token=-1,
        page_size=HET_PAGE, prompt_buckets=HET_BUCKET, page_view_chunk=8)
    pool = PR_BATCH * base.request_pages(PR_BATCH_LEN, PR_BATCH_NEW)
    return dataclasses.replace(base, num_pages=pool)


def _preempt_scenario(device) -> list:
    cfg, params = _model("dense", device)
    batch, inter = _preempt_prompts()
    scfg = _preempt_scfg()
    pre = _preempt_serve(cfg, params, scfg, batch, inter, 1, device)
    wait = _preempt_serve(cfg, params, scfg, batch, inter, 0, device)
    return [{
        "config": "mixed-priority-preempt", "slots": PR_SLOTS,
        "tokens": pre["tokens"],
        "tok_per_s": round(pre["tok_per_s"], 1),
        "inter_ttft_p50_ms": round(pre["inter_ttft_p50_ms"], 3),
        "inter_ttft_p95_ms": round(pre["inter_ttft_p95_ms"], 3),
        "preemptions": pre["preemptions"],
        "syncs": pre["syncs"], "chunks": pre["chunks"],
        "base_tok_per_s": round(wait["tok_per_s"], 1),
        "base_inter_ttft_p50_ms": round(wait["inter_ttft_p50_ms"], 3),
        "base_inter_ttft_p95_ms": round(wait["inter_ttft_p95_ms"], 3),
        "base_admission_waits": wait["admission_waits"],
        "ttft_p95_speedup": round(
            wait["inter_ttft_p95_ms"]
            / max(pre["inter_ttft_p95_ms"], 1e-9), 2)}]


# --- crash-restore scenario (journal overhead + recovery latency) ----------
CRASH_TICK = 2                      # monkey ticks before the injected kill


def _crash_restore_scenario(device) -> list:
    """The heterogeneous mix served three ways: plain paged (re-timed in
    this process), paged with the journal, and supervised with a crash
    at ``CRASH_TICK`` (a quarter of the decode chunk, so the kill lands
    mid-stream), snapshots every 4 ticks bounding the replay."""
    import shutil
    import tempfile
    import warnings

    cfg, params = _model("dense", device)
    rng = np.random.default_rng(1)
    requests = [rng.integers(1, VOCAB, size=L).astype(np.int32)
                for L in HET_LENS]
    paged_scfg = dataclasses.replace(_het_scfg(),
                                     num_pages=_het_pool_pages())
    tmp = tempfile.mkdtemp(prefix="bench_crash_")
    try:
        # only the journal differs; three rounds per serve and three
        # interleaved pairs (their median overhead), as in the JAX bench
        reqs3 = requests * 3
        pairs = []
        for i in range(3):
            base = _serve_chunked(cfg, params, HET_SLOTS, reqs3,
                                  scfg=paged_scfg, warm_all=True,
                                  warm_requests=requests, rounds=3,
                                  device=device)
            jr_scfg = dataclasses.replace(
                paged_scfg, journal_path=os.path.join(tmp, f"wal{i}.jsonl"))
            jr = _serve_chunked(cfg, params, HET_SLOTS, reqs3, scfg=jr_scfg,
                                warm_all=True, warm_requests=requests,
                                rounds=3, device=device)
            pairs.append((base["tok_per_s"], jr["tok_per_s"]))
        overhead = float(np.median(
            [(b - j) / max(b, 1e-9) * 100.0 for b, j in pairs]))
        jr_tps = float(np.median([j for _, j in pairs]))

        sup_scfg = dataclasses.replace(paged_scfg,
                                       decode_chunk=max(2, HET_CHUNK // 4))
        sup = Supervisor(cfg, sup_scfg, params, device=device,
                         journal_path=os.path.join(tmp, "sup_wal.jsonl"),
                         snapshot_dir=os.path.join(tmp, "snap"),
                         snapshot_every=4)
        ChaosMonkey(sup.engine, ChaosConfig(
            seed=0, rate=0.0, crash_tick=CRASH_TICK)).attach()
        for p in requests:
            sup.submit(p, max_new=HET_MAX_NEW)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            done = sup.run()
        wall = time.perf_counter() - t0
        toks = sum(len(r.out) for r in done)
        rec = sup.last_recovery
        st = sup.stats()
        return [{
            "config": "crash-restore", "slots": HET_SLOTS, "tokens": toks,
            "tok_per_s": round(toks / wall, 1),
            "syncs": st.sync_count, "chunks": len(st.chunk_s),
            "restarts": sup.restarts,
            "recovery_ms": round(rec.get("total_ms", 0.0), 1),
            "load_ms": round(rec.get("load_ms", 0.0), 1),
            "replay_ms": round(rec.get("replay_ms", 0.0), 1),
            "journal_tok_per_s": round(jr_tps, 1),
            "journal_overhead_pct": round(overhead, 2)}]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(device="cuda") -> dict:
    from repro_torch.kernels.dispatch import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for fmt in SPARSITY:
        cfg, params = _model(fmt, device)
        for slots in SLOTS:
            requests = _requests(rng, 2 * slots)
            chunked = _serve_chunked(cfg, params, slots, requests,
                                     device=device)
            ref = _serve_per_token(cfg, params, slots, requests, device)
            rows.append({
                "config": fmt, "slots": slots,
                "tokens": chunked["tokens"],
                "tok_per_s": round(chunked["tok_per_s"], 1),
                "p50_ms": round(chunked["p50_ms"], 3),
                "p95_ms": round(chunked["p95_ms"], 3),
                "ttft_p50_ms": round(chunked["ttft_p50_ms"], 3),
                "ttft_p95_ms": round(chunked["ttft_p95_ms"], 3),
                "syncs": chunked["syncs"], "chunks": chunked["chunks"],
                "ref_tokens": ref["tokens"],
                "ref_syncs": ref["syncs"],
                "ref_tok_per_s": round(ref["tok_per_s"], 1),
                "speedup": round(chunked["tok_per_s"]
                                 / max(ref["tok_per_s"], 1e-9), 2),
            })
    het_rows = _het_scenario(device)
    rows.extend(het_rows)
    paged_tps = next(r["tok_per_s"] for r in het_rows
                     if r["config"] == "het-paged")
    rows.extend(_spec_scenario(paged_tps, device))
    rows.extend(_shared_scenario(device))
    rows.extend(_preempt_scenario(device))
    rows.extend(_crash_restore_scenario(device))
    return {"rows": rows, "decode_chunk": DECODE_CHUNK, "max_new": MAX_NEW,
            "het": {"lens": HET_LENS, "page_size": HET_PAGE,
                    "max_len": HET_MAX_LEN, "pool_pages": _het_pool_pages(),
                    "max_new": HET_MAX_NEW},
            "spec_ks": list(SPEC_KS),
            "shared": {"heads": list(SH_HEADS), "suffix": SH_SUFFIX,
                       "requests": SH_REQS, "max_new": SH_MAX_NEW,
                       "page_size": HET_PAGE},
            "preempt": {"slots": PR_SLOTS, "batch_len": PR_BATCH_LEN,
                        "batch_new": PR_BATCH_NEW,
                        "inter_len": PR_INTER_LEN,
                        "inter_new": PR_INTER_NEW,
                        "interactive": PR_INTER_N},
            "crash": {"crash_tick": CRASH_TICK, "snapshot_every": 4,
                      "max_new": HET_MAX_NEW},
            "not_ported": dict(NOT_PORTED),
            "device": str(device)}


def main(out=None) -> None:
    if out is None:
        out = run()
    print(f"# serving bench — chunked loop (decode_chunk="
          f"{out['decode_chunk']}) vs per-token loop, on "
          f"{out['device']}")
    print("config,slots,tokens,tok_per_s,p50_ms,p95_ms,ttft_p50_ms,"
          "ttft_p95_ms,syncs,ref_tok_per_s,speedup")
    for r in out["rows"]:
        if r["config"].startswith(("het-", "spec-", "shared-", "mixed-",
                                   "crash-")):
            continue
        print(f"{r['config']},{r['slots']},{r['tokens']},"
              f"{r['tok_per_s']},{r['p50_ms']},{r['p95_ms']},"
              f"{r['ttft_p50_ms']},{r['ttft_p95_ms']},{r['syncs']},"
              f"{r['ref_tok_per_s']},{r['speedup']}")
    het = [r for r in out["rows"] if r["config"].startswith("het-")]
    if het:
        h = out.get("het", {})
        print(f"# heterogeneous prompts {min(h.get('lens', [0]))}–"
              f"{max(h.get('lens', [0]))} on {HET_SLOTS} slots — paged "
              f"(page_size={h.get('page_size')}, pool="
              f"{h.get('pool_pages')} pages) vs monolithic "
              f"(max_len={h.get('max_len')})")
        print("config,slots,tokens,tok_per_s,p50_ms,p95_ms,ttft_p50_ms,"
              "ttft_p95_ms,syncs,kv_mb,peak_used_mb,kv_ratio,"
              "speedup_vs_mono,admission_waits")
        for r in het:
            print(f"{r['config']},{r['slots']},{r['tokens']},"
                  f"{r['tok_per_s']},{r['p50_ms']},{r['p95_ms']},"
                  f"{r['ttft_p50_ms']},{r['ttft_p95_ms']},"
                  f"{r['syncs']},{r['kv_mb']},{r.get('peak_used_mb', '')},"
                  f"{r.get('kv_ratio', '')},{r.get('speedup_vs_mono', '')},"
                  f"{r.get('admission_waits', '')}")
    shared = [r for r in out["rows"] if r["config"].startswith("shared-")]
    if shared:
        sh = out.get("shared", {})
        print(f"# shared-system-prompt serving on {SH_SLOTS} slots — "
              f"pinned head (register_prefix) + {sh.get('suffix')}-token "
              f"distinct tails, vs the unshared paged engine "
              f"(page_size={sh.get('page_size')})")
        print("config,slots,tokens,tok_per_s,ttft_p50_ms,ttft_p95_ms,"
              "syncs,prefix_hits,shared_pages,cow_copies,kv_alloc_mb,"
              "base_tok_per_s,base_ttft_p50_ms,base_kv_alloc_mb,"
              "ttft_speedup,kv_ratio,admission_waits")
        for r in shared:
            print(f"{r['config']},{r['slots']},{r['tokens']},"
                  f"{r['tok_per_s']},{r['ttft_p50_ms']},"
                  f"{r['ttft_p95_ms']},{r['syncs']},{r['prefix_hits']},"
                  f"{r['shared_pages']},{r['cow_copies']},"
                  f"{r['kv_alloc_mb']},{r['base_tok_per_s']},"
                  f"{r['base_ttft_p50_ms']},{r['base_kv_alloc_mb']},"
                  f"{r['ttft_speedup']},{r['kv_ratio']},"
                  f"{r['admission_waits']}")
    spec = [r for r in out["rows"] if r["config"].startswith("spec-")]
    if spec:
        print("# speculative serving on the heterogeneous mix — k drafts "
              "(self or nm-packed) + one dense block verify per step, vs "
              "het-paged")
        print("config,slots,tokens,tok_per_s,acceptance_rate,p50_ms,"
              "p95_ms,ttft_p50_ms,ttft_p95_ms,syncs,speedup_vs_paged")
        for r in spec:
            print(f"{r['config']},{r['slots']},{r['tokens']},"
                  f"{r['tok_per_s']},{r['acceptance_rate']},"
                  f"{r['p50_ms']},{r['p95_ms']},{r['ttft_p50_ms']},"
                  f"{r['ttft_p95_ms']},{r['syncs']},"
                  f"{r['speedup_vs_paged']}")
    mixed = [r for r in out["rows"] if r["config"].startswith("mixed-")]
    if mixed:
        pr = out.get("preempt", {})
        print(f"# mixed-priority serving on {pr.get('slots')} slots — "
              f"{pr.get('batch_len')}-token batch requests saturate the "
              f"pool, {pr.get('interactive')} interactive arrivals "
              f"mid-run: priority preemption vs admission wait")
        print("config,slots,tokens,tok_per_s,inter_ttft_p50_ms,"
              "inter_ttft_p95_ms,preemptions,base_tok_per_s,"
              "base_inter_ttft_p50_ms,base_inter_ttft_p95_ms,"
              "base_admission_waits,ttft_p95_speedup")
        for r in mixed:
            print(f"{r['config']},{r['slots']},{r['tokens']},"
                  f"{r['tok_per_s']},{r['inter_ttft_p50_ms']},"
                  f"{r['inter_ttft_p95_ms']},{r['preemptions']},"
                  f"{r['base_tok_per_s']},{r['base_inter_ttft_p50_ms']},"
                  f"{r['base_inter_ttft_p95_ms']},"
                  f"{r['base_admission_waits']},{r['ttft_p95_speedup']}")
    crash = [r for r in out["rows"] if r["config"].startswith("crash-")]
    if crash:
        cr = out.get("crash", {})
        print(f"# crash-restore on the heterogeneous mix — journal overhead "
              f"against het-paged, plus a supervised kill at tick "
              f"{cr.get('crash_tick')} restored from snapshot and journal")
        print("config,slots,tokens,tok_per_s,restarts,recovery_ms,"
              "load_ms,replay_ms,journal_tok_per_s,journal_overhead_pct")
        for r in crash:
            print(f"{r['config']},{r['slots']},{r['tokens']},"
                  f"{r['tok_per_s']},{r['restarts']},{r['recovery_ms']},"
                  f"{r['load_ms']},{r['replay_ms']},"
                  f"{r['journal_tok_per_s']},{r['journal_overhead_pct']}")
    for rows, why in out.get("not_ported", {}).items():
        print(f"# not ported: {rows} rows ({why})")


if __name__ == "__main__":
    main()
