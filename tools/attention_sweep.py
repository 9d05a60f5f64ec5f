#!/usr/bin/env python3
"""Time every tile of ``flash_attention``'s and every split of
``paged_attention``'s tensor-core route on one NVIDIA GPU, against SDPA.

    python3 tools/attention_sweep.py [flash] [paged] [d160]  # default: both

``flash``: one prompt of qwen3-0.6b's attention (B 1, 16 query heads over
8 kv heads of 128) at L = 128 and 200 (the prefill of ``chip_smoke.py``)
and 512, for every (query rows per block, keys per tile) the kernel is
built for.  ``paged``: a decode step at B = 8 slots over a 32-page view
of 16-row pages, at ``chip_smoke.py``'s mixed lens (0..512), at the
serve's own lens (129..192) and as verify blocks of Q = 4 and Q = 16 (two
row tiles of 16 query rows), for every (warps per block, blocks per
cluster).  Each shape is held against its
plain version first, then timed as device microseconds per call from
CUDA-graph replay over enough distinct inputs (q/k/v, or page pools) to
stream at least ``STREAM_BYTES`` from HBM rather than the 50 MB L2
(``chip_smoke.device_ms``), beside one SDPA call on the same inputs
(``torch.nn.functional.scaled_dot_product_attention``, the KV heads
repeated; for paged, over the gathered view with the lens mask).  The
plans in ``kernels/tiling.py`` (``flash_plan``, ``paged_plan``) were
chosen from this table; each plan is printed beside the fastest.
``d160`` sweeps stablelm-12b's attention instead (32 query heads over 8
kv heads of 160), where the plans take the rules chosen at D = 128.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref, tiling  # noqa: E402

STREAM_BYTES = 128 << 20     # > 2.5x the H100's 50 MB L2
H, HK, D = 16, 8, 128        # qwen3-0.6b attention (d160: stablelm-12b's)
PS, POOL, VIEW, SLOTS = 16, 257, 32, 8
SDPA = torch.nn.functional.scaled_dot_product_attention


@contextlib.contextmanager
def forced(mod, plan: dict):
    """``mod.plan`` returns ``plan`` inside the block."""
    saved = mod.plan
    mod.plan = lambda *a: plan
    try:
        yield
    finally:
        mod.plan = saved


def report(what: str, plan: dict, mine: float, sdpa: float, rows) -> None:
    rows.sort()
    keys = [k for k in ("bq", "bk", "warps", "split") if k in plan]
    C.log(f"[sweep] {what}: SDPA {sdpa:.2f} us, plan "
          + " ".join(f"{k}{plan[k]}" for k in keys) + f" {mine:.2f} us; "
          "fastest: " + ", ".join(f"{name} {us:.2f}" for us, name in rows[:4]))
    C.log(f"[sweep-all] {what}: " + ", ".join(f"{name} {us:.2f}"
                                               for us, name in rows))


def sweep_flash(dev, gen) -> None:
    for L in (128, 200, 512):
        n = max(8, -(-STREAM_BYTES // ((H + 2 * HK) * L * D * 2)))
        qkv = [tuple(torch.randn((1, h, L, D), generator=gen, device=dev)
                     .to(torch.bfloat16) for h in (H, HK, HK))
               for _ in range(n)]
        rep = [(q, k.repeat_interleave(H // HK, 1),
                v.repeat_interleave(H // HK, 1)) for q, k, v in qkv]
        sdpa = C.device_ms(lambda: [SDPA(q, k, v, is_causal=True)
                                    for q, k, v in rep]) / n * 1e3
        q, k, v = qkv[0]
        want = ref.mha_ref(q.float(), k.float(), v.float())
        rows = []
        for bq in tiling.FLASH_BQ:
            for bk in tiling.FLASH_BK:
                name = f"bq{bq} bk{bk}"
                with forced(FA, dict(route="mma", bq=bq, bk=bk)):
                    C.check_close(f"flash L={L} {name}",
                                  FA.flash_attention(q, k, v), want)
                    us = C.device_ms(lambda: [FA.flash_attention(*t)
                                              for t in qkv]) / n * 1e3
                rows.append((us, name))
        mine = C.device_ms(lambda: [FA.flash_attention(*t)
                                    for t in qkv]) / n * 1e3
        report(f"flash B=1 H={H} Hk={HK} L={L} ({n} inputs)",
               FA.plan(1, H, HK, L, L, D, torch.bfloat16), mine, sdpa, rows)


def paged_inputs(dev, gen, lens_np, Q: int):
    """Pools enough to stream ``STREAM_BYTES`` of live rows, one page
    table, lens, and q (B, H, D) or (B, Q, H, D)."""
    live = int(lens_np.sum()) * HK * D * 2 * 2
    n = max(8, -(-STREAM_BYTES // live))
    rng = np.random.default_rng(0)
    ptab = torch.from_numpy(np.stack([
        rng.permutation(np.arange(1, POOL))[:VIEW] for _ in range(SLOTS)
    ]).astype(np.int32)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    shape = (SLOTS, H, D) if Q == 1 else (SLOTS, Q, H, D)
    q = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    pools = [tuple(torch.randn((POOL, PS, HK, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(2)) for _ in range(n)]
    return q, pools, ptab, lens


def sweep_paged(dev, gen) -> None:
    rng = np.random.default_rng(1)
    cases = {"phase-3 lens 0..512": (np.asarray(
                 [0, 1, 17, 64, 130, 256, 400, 512], np.int32), 1),
             "serve lens 129..192": (np.sort(rng.integers(
                 129, 193, size=SLOTS)).astype(np.int32), 1),
             "Q=4 block, lens 0..512": (np.asarray(
                 [0, 1, 17, 64, 130, 256, 400, 512], np.int32), 4),
             "Q=16 block, lens 0..512": (np.asarray(
                 [0, 1, 17, 64, 130, 256, 400, 512], np.int32), 16)}
    for what, (lens_np, Q) in cases.items():
        q, pools, ptab, lens = paged_inputs(dev, gen, lens_np, Q)
        n = len(pools)
        L = VIEW * PS
        qs = q if Q > 1 else q[:, None]
        mask = (torch.arange(L, device=dev)[None, None, :]
                < (lens[:, None] - (Q - 1 - torch.arange(Q, device=dev)))
                [:, :, None])[:, None]                      # (B, 1, Q, L)
        views = [[t[ptab.long()].reshape(SLOTS, L, HK, D).transpose(1, 2)
                  .repeat_interleave(H // HK, dim=1).contiguous()
                  for t in kv] for kv in pools]
        sdpa = C.device_ms(lambda: [SDPA(qs.transpose(1, 2), k, v,
                                         attn_mask=mask)
                                    for k, v in views]) / n * 1e3
        kp, vp = pools[0]
        want = ref.paged_attention_ref(q, kp, vp, ptab, lens)
        rows = []
        for warps in tiling.PAGED_WARPS:
            for split in tiling.SPLITS:
                name = f"warps{warps} split{split}"
                ring = tiling.paged_ring(VIEW * PS // 16, warps * split)
                with forced(PA, dict(route="mma", warps=warps, split=split,
                                     ring=ring)):
                    C.check_close(f"paged {what} {name}",
                                  PA.paged_attention(q, kp, vp, ptab, lens),
                                  want)
                    us = C.device_ms(lambda: [
                        PA.paged_attention(q, k, v, ptab, lens)
                        for k, v in pools]) / n * 1e3
                rows.append((us, name))
        mine = C.device_ms(lambda: [PA.paged_attention(q, k, v, ptab, lens)
                                    for k, v in pools]) / n * 1e3
        report(f"paged B={SLOTS} {what} lens={lens_np.tolist()} ({n} pools)",
               PA.plan(SLOTS, H, HK, Q, VIEW, D,
                       (torch.bfloat16, torch.bfloat16), PS),
               mine, sdpa, rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_sweep: no CUDA device", file=sys.stderr)
        return 2
    global H, HK, D
    args = sys.argv[1:]
    if "d160" in args:
        H, HK, D = 32, 8, 160
    names = [a for a in args if a != "d160"] or ["flash", "paged"]
    if not set(names) <= {"flash", "paged"}:
        print("attention_sweep: kernels are flash, paged (and the option "
              "d160)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    gen = torch.Generator(device=dev).manual_seed(0)
    if "flash" in names:
        sweep_flash(dev, gen)
    if "paged" in names:
        sweep_paged(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
