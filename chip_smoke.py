#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU — the quickest proof that the port starts on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build the six CUDA kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel), print the build seconds and each
     compiled kernel's registers and spills from the ``ptxas`` report;
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes in bfloat16 (rtol 2e-2 / atol 1e-2, the bf16
     tolerance of ``tests/test_kernels.py``; the four matmul kernels
     at M = 1, 5, 8, 17, 128 and 200 rows, each call's launch plan
     printed; the strip kernels' empty strip must come back zero and
     two calls bitwise equal; flash attention also with a suffix, a
     window with softcap and in fp32, paged attention also as a Q = 4
     verify block and with fp32 q, its dead slot exactly zero and two
     calls bitwise equal, each attention call's plan printed), and time
     the kernel, the plain version and one library call computing the
     same function (a yardstick only — the port never calls it) as device
     time from CUDA-graph replay, beside the least time the card could
     take (bytes at 3.35 TB/s, bf16 operations at 989 TFLOP/s, whichever
     is larger) and the kernel's eager time (host launch cost included).
     The block
     and combined packs have exactly half of each weight's (128, 128)
     tiles zeroed, one empty strip and padding slots; the lookahead
     kernel also reproduces integer weights bit-exactly;
  4. serve qwen3-0.6b at full width, 28 layers, bf16, random weights from
     a seed, through ``Engine`` over the paged KV cache, once per pack
     format on all seven projections: ``sparse()`` (2:4, g=128) and
     ``combined`` with 16 requests of 16–128 tokens and 64 new tokens
     each, ``block`` and ``lookahead`` with 8 requests and 32 tokens.
     Before packing, exactly half of each projection's tiles are zeroed
     (not for ``sparse()``), so block and combined packs have tile
     density 0.50.  Every request must reach its budget, ``sync_count``
     must equal the number of decode chunks, the kernels of the format's
     path must launch (counts set to 0 just before each serve, read just
     after) and no other format's matmul kernel may; each scheduler
     tick (admission, prefill and chunk) and each decode chunk is timed
     on the host clock.  After the 2:4 and the combined serve, one more
     decode chunk under ``torch.profiler``: the card's busy share of the
     wall time and the kernels that fill it;
  5. each format's model cut to 2 layers at float32: greedy tokens on
     the card against the port's CPU path; a token may differ only where
     the CPU logits' top-2 gap is under 1e-2 (the gaps are printed).

The line before the last is a JSON object with every kernel's launches,
error and times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
RTOL, ATOL = 2e-2, 1e-2            # bf16 tolerance of tests/test_kernels.py
GAP_TOL = 1e-2                     # phase 5: a CPU/GPU token split needs a
#                                    CPU top-2 logit gap below this
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` issued eagerly from Python (CUDA
    events, warmed): the device time or the host's launch time, whichever
    is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def device_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in
    one CUDA graph and replayed, so the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, 3) / reps
    del graph
    return ms


def timings(kernel, plain, library, copies: int) -> dict:
    """Per-call device ms of the kernel, its plain version and the library
    yardstick (each ``fn`` makes ``copies`` calls), plus the kernel's
    eager per-call ms."""
    return dict(ms=device_ms(kernel) / copies,
                plain_ms=device_ms(plain, reps=3) / copies,
                library_ms=device_ms(library) / copies,
                eager_ms=cuda_ms(kernel) / copies)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err "
            f"{err.max().item():.3e}, {int(bad.sum())} elements outside "
            f"rtol={RTOL} atol={ATOL})")
    return err.max().item()


def ptxas_table(report: str) -> list:
    """(kernel, registers, spill line) of each function in an
    ``nvcc -Xptxas -v`` report, the names demangled where ``c++filt``
    is on the PATH."""
    rows, fn, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[-1]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append([fn, int(m.group(1)), spills])
            fn = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60)
        for r, name in zip(rows, names.stdout.splitlines()):
            r[0] = name.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
    return rows


# --- phase 3: each kernel against its plain version -------------------------

def qwen3_projections(cfg):
    """(name, K, N) of the seven projections of one qwen3 layer."""
    d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("w_in", d, ff), ("w_gate", d, ff), ("w_out", ff, d)]


SWEEP_M = (1, 5, 8, 17, 128, 200)   # decode, ragged and prefill rows
TIMED_M = (8, 128)                  # decode at 8 slots; a 128-token prompt


def log_plans(name: str, M: int, plans) -> None:
    """The bf16 launch plan (``kernels.*.plan``) of each ``(projection,
    plan)``."""
    parts = [f"{proj} {p['route']} bm{p['bm']} bn{p['bn']} "
             f"split{p['split']} steps{p['steps_per_block']} grid{p['grid']}"
             for proj, p in plans]
    log(f"[plan] {name} M={M}: " + "; ".join(parts))


def check_nm_spmm(cfg, dev, copies: int = 4) -> dict:
    """All seven projection geometries at every M of ``SWEEP_M`` against
    the plain version; timed at ``TIMED_M`` per layer: ``copies`` layers
    of distinct packs, so the weights stream from HBM as they do through
    28 layers."""
    from repro_torch.core import pruning, sparsity
    from repro_torch.kernels import nm_spmm as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in qwen3_projections(cfg):
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / k ** 0.5).to(torch.bfloat16)
            pw, _ = pruning.n_m(w, 2, 4, group=128)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=128))
            dense.append(pw)
    err, rows = 0.0, {}
    for M in SWEEP_M:
        log_plans("nm_spmm", M, [(proj, K.plan(M, k, n, torch.bfloat16))
                                 for proj, k, n in qwen3_projections(cfg)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in qwen3_projections(cfg)}
        err_m = max(check_close(f"nm_spmm M={M} K={p.K} N={p.N}",
                                K.nm_spmm(xs[p.K], p),
                                ref.nm_spmm_ref(xs[p.K], p))
                    for p in packs[:7])
        log(f"[kernels] nm_spmm M={M}: max abs err {err_m:.3e} against "
            "the plain version")
        err = max(err, err_m)
        if M not in TIMED_M:
            continue
        nbytes = flops = 0.0
        for p in packs[:7]:
            nbytes += (M * p.K + p.Kc * p.N + M * p.N) * 2 + p.idx.numel() * 4
            flops += 2.0 * M * p.Kc * p.N
        b, by = bound_ms(nbytes, flops)
        rows[M] = dict(
            **timings(lambda: [K.nm_spmm(xs[p.K], p) for p in packs],
                      lambda: [ref.nm_spmm_ref(xs[p.K], p) for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] nm_spmm  one layer's 7 projections at M={M}: "
            f"{json.dumps(rows[M])}")
    return dict(name="nm_spmm", source="src/repro_torch/csrc/nm_spmm.cu",
                replaces="src/repro/kernels/nm_spmm.py:68",
                max_abs_err=err, **rows[8])


def log_attn_plan(name: str, what: str, plan: dict) -> None:
    log(f"[plan] {name} {what}: " + " ".join(
        f"{k}={v}" for k, v in plan.items()))


def check_paged_attention(cfg, dev, copies: int = 12) -> dict:
    """Decode attention at B = 8 slots over a 256-page pool of 16-row
    pages, a 32-page (512-row) view, held against the plain version: mixed
    lens with one dead slot (its row must be exactly zero, two calls
    bitwise equal), a Q = 4 verify block and fp32 q.  Timed over
    ``copies`` pools, so the live rows (5.7 MB a pool) stream from HBM
    rather than the 50 MB L2, as one layer's do in a decode step: at the
    mixed lens (the kernel's row) and at the serve's own lens, 129..192."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels import ref
    B, H, Hk, D, ps, P, mp = 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        16, 257, 32
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED)
    ptab = torch.from_numpy(np.stack([rng.permutation(np.arange(1, P))[:mp]
                                      for _ in range(B)]).astype(np.int32))
    ptab = ptab.to(dev)
    pools = [tuple(torch.randn((P, ps, Hk, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(2))
             for _ in range(copies)]
    kp, vp = pools[0]
    cases = {"mixed": [0, 1, 17, 64, 130, 256, 400, 512],
             "serve": sorted(rng.integers(129, 193, size=B).tolist())}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    err, rows = 0.0, {}
    for what, lens_l in cases.items():
        lens_np = np.asarray(lens_l, np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        for Q in ((4, 1) if what == "mixed" else (1,)):   # time Q = 1
            shape = (B, H, D) if Q == 1 else (B, Q, H, D)
            q = torch.randn(shape, generator=gen, device=dev) \
                .to(torch.bfloat16)
            log_attn_plan("paged_attention", f"bf16 B={B} Q={Q} lens={what}",
                          K.plan(B, H, Hk, Q, mp, D, (q.dtype, kp.dtype), ps))
            got = K.paged_attention(q, kp, vp, ptab, lens)
            err = max(err, check_close(
                f"paged_attention Q={Q} lens={lens_l}", got,
                ref.paged_attention_ref(q, kp, vp, ptab, lens)))
            if not torch.equal(got, K.paged_attention(q, kp, vp, ptab, lens)):
                raise AssertionError("paged_attention: two calls differ")
            if lens_l[0] == 0 and (got[0] != 0).any():
                raise AssertionError("paged_attention: the lens == 0 row "
                                     "is not zero")
        # the library yardstick: SDPA over the gathered (B, H, L, D) view
        views = [[t[ptab.long()].reshape(B, mp * ps, Hk, D).transpose(1, 2)
                  .repeat_interleave(H // Hk, dim=1).contiguous()
                  for t in kv] for kv in pools]
        mask = (torch.arange(mp * ps, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        live = int(lens_np.sum())
        pages = int(sum(-(-int(n) // ps) for n in lens_np))
        nbytes = 2 * B * H * D * 2 + live * Hk * D * 2 * 2 + pages * 4 + B * 4
        b, by = bound_ms(nbytes, 4.0 * H * D * live)
        rows[what] = dict(
            **timings(lambda: [K.paged_attention(q, k, v, ptab, lens)
                               for k, v in pools],
                      lambda: [ref.paged_attention_ref(q, k, v, ptab, lens)
                               for k, v in pools],
                      lambda: [sdpa(q[:, :, None], k, v, attn_mask=mask)
                               for k, v in views], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] paged_attention B={B} lens={lens_l}: "
            f"{json.dumps(rows[what])}")
    q32 = torch.randn((B, H, D), generator=gen, device=dev)
    log_attn_plan("paged_attention", f"fp32 q, bf16 pools, B={B} Q=1",
                  K.plan(B, H, Hk, 1, mp, D, (q32.dtype, kp.dtype), ps))
    err32 = check_close("paged_attention fp32 q",
                        K.paged_attention(q32, kp, vp, ptab, lens),
                        ref.paged_attention_ref(q32, kp, vp, ptab, lens))
    log(f"[kernels] paged_attention max abs err {err:.3e} (bf16, Q = 1 and "
        f"4), {err32:.3e} (fp32 q) against the plain version; the lens == 0 "
        "row zero; two calls bitwise equal")
    return dict(name="paged_attention",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:107",
                max_abs_err=err, **rows["mixed"])


def check_flash_attention(cfg, dev) -> dict:
    """Prefill attention of one prompt, timed at L = 128 and a ragged 200;
    checked, not timed: a suffix (37 queries over 200 keys), a window
    with softcap, and fp32."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def qkv(Lq, Lk, dtype=torch.bfloat16):
        return [torch.randn((1, h, n, D), generator=gen, device=dev).to(dtype)
                for h, n in ((H, Lq), (Hk, Lk), (Hk, Lk))]

    err, rows = 0.0, {}
    for L in (128, 200):
        q, k, v = qkv(L, L)
        log_attn_plan("flash_attention", f"bf16 B=1 H={H} Hk={Hk} L={L}",
                      K.plan(1, H, Hk, L, L, D, q.dtype))
        err = max(err, check_close(
            f"flash_attention L={L}", K.flash_attention(q, k, v),
            ref.mha_ref(q.float(), k.float(), v.float())))
        kr, vr = (t.repeat_interleave(H // Hk, dim=1) for t in (k, v))
        pairs = L * (L + 1) / 2
        b, by = bound_ms((2 * H + 2 * Hk) * L * D * 2, 4.0 * H * D * pairs)
        rows[L] = dict(
            **timings(lambda: K.flash_attention(q, k, v),
                      lambda: ref.mha_ref(q, k, v),
                      lambda: sdpa(q, kr, vr, is_causal=True), 1),
            bound_ms=b, bound_by=by)
        log(f"[kernels] flash_attention B=1 H={H} Hk={Hk} L={L}: "
            f"{json.dumps(rows[L])}")
    for what, (Lq, Lk, kw) in {
            "suffix Lq=37 Lk=200": (37, 200, {}),
            "window 64 softcap 30 L=200": (200, 200,
                                           dict(window=64, softcap=30.0))
    }.items():
        q, k, v = qkv(Lq, Lk)
        err = max(err, check_close(
            f"flash_attention {what}", K.flash_attention(q, k, v, **kw),
            ref.mha_ref(q.float(), k.float(), v.float(), **kw)))
    q, k, v = qkv(128, 128, torch.float32)
    log_attn_plan("flash_attention", f"fp32 B=1 H={H} Hk={Hk} L=128",
                  K.plan(1, H, Hk, 128, 128, D, q.dtype))
    err32 = check_close("flash_attention fp32", K.flash_attention(q, k, v),
                        ref.mha_ref(q, k, v))
    log(f"[kernels] flash_attention max abs err {err:.3e} (bf16: L = 128, "
        f"200, suffix, window + softcap), {err32:.3e} (fp32) against the "
        "plain version")
    return dict(name="flash_attention",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:97",
                max_abs_err=err, **rows[128])


FORMATS = {   # the other pack formats, as the JAX tests declare them
    "combined": dict(format="combined", sparsity=0.5, n=2, m=4,
                     block_k=128, block_n=128),
    "block": dict(format="block", sparsity=0.5, block_k=128, block_n=128),
    "lookahead": dict(format="lookahead", sparsity=0.5),
}
TILE = 128


def zero_half_tiles(w: torch.Tensor, rng, empty_strip: bool = False
                    ) -> torch.Tensor:
    """``w`` with exactly half of its ``(128, 128)`` tiles zeroed, chosen
    by ``rng``; with ``empty_strip`` the first N-strip's tiles are among
    them, so a block pack has a strip with ``counts == 0``."""
    K, N = w.shape
    Kb, Nb = K // TILE, N // TILE
    zero = np.zeros(Kb * Nb, bool)
    if empty_strip:
        zero[np.arange(Kb * Nb) % Nb == 0] = True
    if zero.sum() > Kb * Nb // 2:
        raise ValueError(f"one strip of {w.shape} is more than half its "
                         "tiles")
    rest = np.flatnonzero(~zero)
    zero[rng.permutation(rest)[:Kb * Nb // 2 - int(zero.sum())]] = True
    keep = torch.from_numpy(~zero.reshape(Kb, Nb)).to(w.device)
    return w * keep.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)


def pack_strip(w: torch.Tensor, fmt: str):
    """The pruned ``w`` and its ``fmt`` (block or combined) pack of
    (128, 128) tiles, padded one slot past the largest strip count."""
    from repro_torch.core import pruning, sparsity
    if fmt == "block":
        pw, _ = pruning.block_semi_structured(w, 0.5, block=TILE)
        p = sparsity.pack_block_sparse(pw, TILE, TILE)
        return pw, sparsity.pack_block_sparse(pw, TILE, TILE,
                                              pad_to=p.max_nnz + 1)
    pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=TILE, block=TILE)
    p = sparsity.pack_combined(pw, 2, 4, TILE, TILE)
    return pw, sparsity.pack_combined(pw, 2, 4, TILE, TILE,
                                      pad_to=p.max_nnz + 1)


def strip_packs(cfg, dev, fmt: str, copies: int, seed: int):
    """``copies`` layers of seven tile-zeroed projections (the first strip
    empty) packed in ``fmt`` by ``pack_strip``; with the pruned dense
    weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in qwen3_projections(cfg):
            w = zero_half_tiles((torch.randn((k, n), generator=gen,
                                             device=dev) / k ** 0.5)
                                .to(torch.bfloat16), rng, empty_strip=True)
            pw, p = pack_strip(w, fmt)
            counts = p.counts.tolist()
            assert counts[0] == 0 and max(counts) < p.max_nnz
            assert p.density == 0.5, p.density
            packs.append(p)
            dense.append(pw)
    return packs, dense


def check_strip_kernel(cfg, dev, fmt: str, copies: int) -> dict:
    """``bsr_matmul`` (block) or ``csa_matmul`` (combined) on one layer's
    seven tile-zeroed projections at every M of ``SWEEP_M``: held against
    the plain version, the empty first strip must come back zero and two
    calls bitwise equal; timed at ``TIMED_M`` over ``copies`` layers of
    distinct packs so the kept tiles stream from HBM."""
    from repro_torch.kernels import bsr_matmul, csa_matmul, ref
    if fmt == "block":
        name, mod, plain = "bsr_matmul", bsr_matmul, ref.bsr_matmul_ref
    else:
        name, mod, plain = "csa_matmul", csa_matmul, ref.csa_matmul_ref
    kernel = getattr(mod, name)
    packs, dense = strip_packs(cfg, dev, fmt, copies, SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    err, rows = 0.0, {}
    for M in SWEEP_M:
        log_plans(name, M, [
            (proj, mod.plan(M, p.K, p.N, torch.bfloat16, p.max_nnz))
            for (proj, _, _), p in zip(qwen3_projections(cfg), packs)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in qwen3_projections(cfg)}
        err_m = 0.0
        for p in packs[:7]:
            what = f"{name} M={M} K={p.K} N={p.N}"
            got = kernel(xs[p.K], p)
            if not torch.equal(got, kernel(xs[p.K], p)):
                raise AssertionError(f"{what}: two calls differ")
            if (got[:, :p.bn] != 0).any():
                raise AssertionError(f"{what}: the empty strip is not zero")
            err_m = max(err_m, check_close(what, got, plain(xs[p.K], p)))
        log(f"[kernels] {name} M={M}: max abs err {err_m:.3e} against the "
            "plain version; empty strip zero; two calls bitwise equal")
        err = max(err, err_m)
        if M not in TIMED_M:
            continue
        nbytes = flops = 0.0
        for p in packs[:7]:
            rows_kept = int(p.counts.sum()) * p.values.shape[2]
            nbytes += (M * p.K + rows_kept * p.bn + M * p.N) * 2 \
                + (int(p.counts.sum()) + p.counts.numel()) * 4
            if fmt == "combined":
                nbytes += rows_kept * 4                       # gidx
            flops += 2.0 * M * rows_kept * p.bn
        b, by = bound_ms(nbytes, flops)
        rows[M] = dict(
            **timings(lambda: [kernel(xs[p.K], p) for p in packs],
                      lambda: [plain(xs[p.K], p) for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] {name} one layer's 7 projections at M={M}, tile "
            f"density 0.50: {json.dumps(rows[M])}")
    return dict(name=name, source=f"src/repro_torch/csrc/{name}.cu",
                replaces={"bsr_matmul": "src/repro/kernels/bsr_matmul.py:63",
                          "csa_matmul": "src/repro/kernels/csa_matmul.py:56"
                          }[name],
                max_abs_err=err, **rows[8])


def check_lookahead(cfg, dev, copies: int = 4) -> dict:
    """``lookahead_matmul`` on one layer's seven projections (pruned at
    block 4 after zeroing half of each weight's tiles) at every M of
    ``SWEEP_M``, timed at ``TIMED_M`` over ``copies`` layers; then the
    bit-exact check of ``tests/test_kernels.py::test_lookahead_int7_exact``
    on the card."""
    from repro_torch.core import encoding, pruning, sparsity
    from repro_torch.kernels import lookahead_decode as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    packs, dense = [], []
    for _ in range(copies):
        for _, k, n in qwen3_projections(cfg):
            w = zero_half_tiles((torch.randn((k, n), generator=gen,
                                             device=dev) / k ** 0.5)
                                .to(torch.bfloat16), rng)
            pw, _ = pruning.block_semi_structured(w, 0.5, block=4)
            p = sparsity.LookaheadPack.from_float(pw)
            packs.append(p)
            dense.append(p.decode().to(torch.bfloat16))
    err, rows = 0.0, {}
    for M in SWEEP_M:
        log_plans("lookahead_matmul", M,
                  [(proj, K.plan(M, k, n, torch.bfloat16))
                   for proj, k, n in qwen3_projections(cfg)])
        xs = {k: torch.randn((M, k), generator=gen, device=dev)
              .to(torch.bfloat16) for _, k, _ in qwen3_projections(cfg)}
        err_m = max(check_close(f"lookahead_matmul M={M} K={p.K} N={p.N}",
                                K.lookahead_matmul(xs[p.K], p),
                                ref.lookahead_matmul_ref(xs[p.K], p))
                    for p in packs[:7])
        log(f"[kernels] lookahead_matmul M={M}: max abs err {err_m:.3e} "
            "against the plain version")
        err = max(err, err_m)
        if M not in TIMED_M:
            continue
        nbytes = flops = 0.0
        for p in packs[:7]:
            nbytes += (M * p.K + M * p.N) * 2 + p.K * p.N + p.N * 4
            flops += 2.0 * M * p.K * p.N
        b, by = bound_ms(nbytes, flops)
        rows[M] = dict(
            **timings(lambda: [K.lookahead_matmul(xs[p.K], p)
                               for p in packs],
                      lambda: [ref.lookahead_matmul_ref(xs[p.K], p)
                               for p in packs],
                      lambda: [torch.matmul(xs[w.shape[0]], w)
                               for w in dense], copies),
            bound_ms=b, bound_by=by)
        log(f"[kernels] lookahead_matmul one layer's 7 projections at "
            f"M={M}: {json.dumps(rows[M])}")
    ints = torch.from_numpy(rng.integers(-64, 64, size=(1024, 1024))
                            .astype(np.int8))
    exact = sparsity.LookaheadPack(
        enc=encoding.encode_weight_matrix(ints).to(dev),
        scale=torch.ones((1, 1024), device=dev), K=1024, N=1024)
    eye = torch.eye(1024, device=dev, dtype=torch.bfloat16)
    if K.plan(1024, 1024, 1024, eye.dtype)["route"] != "mma":
        raise AssertionError("bf16 x must take the tensor-core route")
    out = K.lookahead_matmul(eye, exact)
    if not torch.equal(out.float().cpu(), ints.float()):
        raise AssertionError("lookahead_matmul is not bit-exact on integer "
                             "weights")
    log("[kernels] lookahead_matmul reproduces 1024x1024 int7 weights "
        "bit-exactly on the tensor-core route (identity x, scale 1)")
    return dict(name="lookahead_matmul",
                source="src/repro_torch/csrc/lookahead_decode.cu",
                replaces="src/repro/kernels/lookahead_decode.py:62",
                max_abs_err=err, **rows[8])


# --- phases 4 and 5 --------------------------------------------------------

def sparse_model(cfg, dev, seed, zero_tiles: bool = False):
    """Random params from ``seed``, packed per ``cfg``; ``zero_tiles``
    first zeroes exactly half of each projection's tiles."""
    from repro_torch import models
    from repro_torch.core.sparse_linear import pack_params
    params = models.init_model(cfg, seed=seed, device=dev)
    if zero_tiles:
        rng = np.random.default_rng(seed)
        for layer in params["layers"]:
            for fam, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("mlp", ("w_in", "w_gate", "w_out"))):
                for name in names:
                    layer[fam][name] = zero_half_tiles(layer[fam][name], rng)
    return pack_params(params, cfg)


def pack_summary(params) -> str:
    """Tile density of the block/combined packs, or the share of zero
    4-blocks the lookahead skip bits encode."""
    from repro_torch.core import encoding
    from repro_torch.core.sparsity import LookaheadPack
    weights = [w for layer in params["layers"] for fam in layer.values()
               for w in fam.values()]
    looks = [w for w in weights if isinstance(w, LookaheadPack)]
    strips = [w for w in weights if hasattr(w, "counts")]
    if looks:
        zero = sum(int(encoding.block_is_zero(encoding.decode_values(
            p.enc).T).sum()) for p in looks)
        blocks = sum(p.K * p.N // 4 for p in looks)
        return f"zero 4-block share {zero / blocks:.4f}"
    if strips:
        kept = sum(int(p.counts.sum()) for p in strips)
        tiles = sum((p.K // p.bk) * (p.N // p.bn) for p in strips)
        return f"tile density {kept / tiles:.4f}"
    return "no tile skipping"


def serve_full_width(cfg, dev, counters, path, *, requests: int = 16,
                     max_new: int = 64, zero_tiles: bool = False,
                     profile: bool = True) -> dict:
    """Serve ``requests`` random prompts of 16–128 tokens through the
    paged Engine; ``path`` names the kernels that must launch, every
    other module of ``counters`` must not."""
    from repro_torch.serving import Engine, ServeConfig
    fmt = cfg.mlp_sparsity.format
    t0 = time.perf_counter()
    params = sparse_model(cfg, dev, SEED, zero_tiles=zero_tiles)
    torch.cuda.synchronize()
    log(f"[serve {fmt}] {cfg.name} {cfg.n_layers} layers "
        f"d_model={cfg.d_model} {cfg.dtype}: random init + pack in "
        f"{time.perf_counter() - t0:.1f} s, {pack_summary(params)}")
    scfg = ServeConfig(slots=8, max_len=512, prompt_pad=128, page_size=16,
                       decode_chunk=16, max_new_tokens=max_new, eos_token=-1)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 129, size=requests)]
    eng = Engine(cfg, scfg, params, device=dev)
    for mod in counters:
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p) for p in prompts]
    step_s = []                  # whole ticks: admission + prefill + chunk
    while eng.num_queued or eng.num_live:
        if len(step_s) > 4 * requests:
            raise AssertionError("the serve does not drain")
        t1 = time.perf_counter()
        eng.step()
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches
                for mod in counters}
    st = eng.stats()
    outs = [h.tokens for h in handles]
    if not all(h.status.value == "done" and len(o) == scfg.max_new_tokens
               for h, o in zip(handles, outs)):
        raise AssertionError("a request did not finish with its budget: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a token outside the vocabulary")
    if st.sync_count != len(st.chunk_s):
        raise AssertionError(f"sync_count {st.sync_count} != "
                             f"{len(st.chunk_s)} chunks")
    if any((launches[name] > 0) != (name in path) for name in launches):
        raise AssertionError(f"{fmt}: the kernels of {sorted(path)} must "
                             f"launch and no other: {launches}")
    ntok = sum(len(o) for o in outs)
    ttft = sorted(eng.ttfts_s())
    report = {
        "requests": len(handles), "tokens": ntok,
        "tok_per_s": ntok / wall, "wall_s": wall,
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "decode_ms_per_step": 1e3 * sum(st.chunk_s)
        / (len(st.chunk_s) * scfg.decode_chunk),
        "step_ms": [round(1e3 * t, 1) for t in step_s],
        "chunk_ms": [round(1e3 * t, 1) for t in st.chunk_s],
        "chunks": len(st.chunk_s), "sync_count": st.sync_count,
        "prefills": st.prefills, "peak_pages": st.peak_pages,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"[serve {fmt}] {json.dumps(report)}")
    log(f"[serve {fmt}] first request's tokens: {outs[0][:16]}")
    if profile:
        profile_decode_chunk(eng, prompts)
    return launches


def profile_decode_chunk(eng, prompts) -> None:
    """torch.profiler over one decode chunk with every slot live: the
    card's busy share of the chunk's wall time and the kernels that fill
    it.  Runs after the launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.scfg.slots]:
        eng.submit(p)
    eng.step()                                 # admission + a first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_ops += 1
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ")[:100]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] one decode chunk of {eng.scfg.decode_chunk} steps: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({busy / wall_us:.3f} of the wall), {n_ops} device operations")
    for name, us in top:
        log(f"[profile]   {us / 1e3:9.3f} ms  {name}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def cpu_greedy(params, cfg, prompt, max_new, prompt_pad, max_len):
    """1-token-at-a-time greedy decode on the port's CPU path; returns the
    tokens and each step's top-2 logit gap."""
    from repro_torch import models
    tokens = np.zeros((1, prompt_pad), np.int32)
    tokens[0, prompt_pad - len(prompt):] = prompt
    cache = models.init_cache(cfg, 1, max_len, device="cpu")
    logits, cache = models.prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens)}, cache)
    out, gaps, pos = [], [], prompt_pad
    for t in range(max_new):
        lg = logits[0, :cfg.vocab_size]
        top = lg.topk(2).values
        gaps.append(float(top[0] - top[1]))
        out.append(int(lg.argmax()))
        if t == max_new - 1:
            break
        logits, cache = models.decode_step(
            params, cfg, torch.tensor([out[-1]], dtype=torch.int32), cache,
            torch.tensor([pos], dtype=torch.int32))
        pos += 1
    return out, gaps


def card_vs_cpu(cfg, dev, zero_tiles: bool = False) -> None:
    from repro_torch.serving import Engine, ServeConfig
    fmt = cfg.mlp_sparsity.format
    params = sparse_model(cfg, dev, SEED + 1, zero_tiles=zero_tiles)
    scfg = ServeConfig(slots=4, max_len=160, prompt_pad=32, page_size=16,
                       decode_chunk=8, max_new_tokens=16, eos_token=-1)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in (5, 17, 26, 32)]
    gpu = Engine(cfg, scfg, params, device=dev).generate(prompts)
    cpu_params = _to(params, "cpu")
    for i, (p, got) in enumerate(zip(prompts, gpu)):
        want, gaps = cpu_greedy(cpu_params, cfg, p, scfg.max_new_tokens,
                                scfg.prompt_pad, scfg.max_len)
        split = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        log(f"[fidelity {fmt}] request {i}: {len(got)} tokens, first "
            f"split at {split}, min CPU top-2 gap {min(gaps):.3e}"
            + ("" if split is None else f", gap there {gaps[split]:.3e}"))
        if len(got) != len(want) or (split is not None
                                     and gaps[split] >= GAP_TOL):
            raise AssertionError(f"{fmt} request {i}: card {got} vs CPU "
                                 f"{want}")


def with_format(cfg, fmt: str):
    """``cfg`` with all seven projections in pack format ``fmt``."""
    from repro_torch.core.sparse_linear import SparsityConfig
    sp = SparsityConfig(**FORMATS[fmt])
    return dataclasses.replace(cfg, mlp_sparsity=sp, attn_sparsity=sp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import qwen3_0_6b
        from repro_torch.kernels import _build
        from repro_torch.kernels import bsr_matmul, csa_matmul, \
            flash_attention, lookahead_decode, nm_spmm, paged_attention
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run this "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(nvidia_smi())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    seconds = {}

    def timed(phase: str, t0: float) -> None:
        seconds[phase] = time.perf_counter() - t0
        log(f"[phase] {phase}: {seconds[phase]:.1f} s")

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for fn, regs, spills in ptxas_table(rep):
            log(f"[build] {name}: {fn}: {regs} registers, {spills}")
    timed("2 build", t0)

    t0 = time.perf_counter()
    cfg = qwen3_0_6b.sparse()
    rows = [check_nm_spmm(cfg, dev), check_paged_attention(cfg, dev),
            check_flash_attention(cfg, dev),
            check_strip_kernel(cfg, dev, "combined", copies=8),
            check_strip_kernel(cfg, dev, "block", copies=4),
            check_lookahead(cfg, dev)]
    timed("3 kernels", t0)

    # each format's serve: (kernel module, kernel name, requests, tokens,
    # profiled); the paged and flash kernels run on every path
    counters = (nm_spmm, paged_attention, flash_attention, csa_matmul,
                bsr_matmul, lookahead_decode)
    attention = {"paged_attention", "flash_attention"}
    serves = {"combined": ("csa_matmul", "csa_matmul", 16, 64, True),
              "block": ("bsr_matmul", "bsr_matmul", 8, 32, False),
              "lookahead": ("lookahead_decode", "lookahead_matmul", 8, 32,
                            False)}
    t0 = time.perf_counter()
    launches = serve_full_width(cfg, dev, counters, {"nm_spmm"} | attention)
    timed("4 serve nm", t0)
    for fmt, (module, kernel, requests, max_new, profile) in serves.items():
        t0 = time.perf_counter()
        got = serve_full_width(with_format(qwen3_0_6b.config(), fmt), dev,
                               counters, {module} | attention,
                               requests=requests, max_new=max_new,
                               zero_tiles=True, profile=profile)
        launches[kernel] = got[module]
        timed(f"4 serve {fmt}", t0)

    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=2, layer_kinds=(),
                                dtype="float32")
    card_vs_cpu(small, dev)
    for fmt in serves:
        card_vs_cpu(with_format(small, fmt), dev, zero_tiles=True)
    timed("5 fidelity", t0)

    kernels = [dict(name=r["name"], route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[r["name"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for r in rows]
    log(f"[phase] seconds {json.dumps(seconds)}")
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
