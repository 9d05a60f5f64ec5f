#!/usr/bin/env python3
"""Time every tile shape and K-split of the tensor-core route of
``nm_spmm``, ``lookahead_matmul``, ``bsr_matmul`` and ``csa_matmul`` on
one NVIDIA GPU.

    python3 tools/mma_tile_sweep.py [kernel ...]    # default: all four

For each distinct projection shape of a qwen3-0.6b layer and M = 8
(decode) and 128 (prefill), times every (bm, bn, split) that the
kernels are built for and that fits the contraction, each held
against its plain version first, beside one ``torch.matmul`` (cuBLAS)
on the dense bf16 weight.  The strip kernels run on packs with half of
each weight's (128, 128) tiles zeroed, an empty strip and a padding
slot (``chip_smoke.pack_strip``), whose ``max_nnz`` differs from copy
to copy: a forced (bm, bn, split) takes each pack's own stages per
block, and the plan's time is that of each pack's own plan.  Device microseconds per call from CUDA-graph replay
over enough distinct weights to hold ``STREAM_BYTES`` (at least 8), so
they stream from HBM as 28 layers do rather than sit in the 50 MB L2
(``chip_smoke.device_ms``).  The plans in
``kernels/tiling.py`` were chosen from this table; each kernel's plan is
printed beside the fastest.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.core import pruning, sparsity  # noqa: E402
from repro_torch.kernels import bsr_matmul as BSR  # noqa: E402
from repro_torch.kernels import csa_matmul as CSA  # noqa: E402
from repro_torch.kernels import lookahead_decode as LA  # noqa: E402
from repro_torch.kernels import nm_spmm as NM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = {"wq": (1024, 2048), "wk": (1024, 1024), "wo": (2048, 1024),
          "w_in": (1024, 3072), "w_out": (3072, 1024)}
STREAM_BYTES = 128 << 20     # > 2.5x the H100's 50 MB L2
KERNELS = {"nm_spmm": (NM, NM.nm_spmm, ref.nm_spmm_ref),
           "lookahead_matmul": (LA, LA.lookahead_matmul,
                                ref.lookahead_matmul_ref),
           "bsr_matmul": (BSR, BSR.bsr_matmul, ref.bsr_matmul_ref),
           "csa_matmul": (CSA, CSA.csa_matmul, ref.csa_matmul_ref)}
STRIPS = {"bsr_matmul": "block", "csa_matmul": "combined"}


def copies(k: int, n: int) -> int:
    """Distinct weights of one (k, n) shape that hold ``STREAM_BYTES`` of
    kept bf16 values at the sparsest format (a quarter of the dense)."""
    return max(8, -(-STREAM_BYTES // (k * n // 2)))


def weights(kernel: str, k: int, n: int, gen, rng, dev):
    packs, dense = [], []
    for _ in range(copies(k, n)):
        w = (torch.randn((k, n), generator=gen, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        if kernel == "nm_spmm":
            pw, _ = pruning.n_m(w, 2, 4, group=128)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=128))
            dense.append(pw)
        elif kernel in STRIPS:
            w = C.zero_half_tiles(w, rng, empty_strip=True)
            pw, p = C.pack_strip(w, STRIPS[kernel])
            packs.append(p)
            dense.append(pw)
        else:
            p = sparsity.LookaheadPack.from_float(w)
            packs.append(p)
            dense.append(p.decode().to(torch.bfloat16))
    return packs, dense


def stages(kernel: str, k: int) -> int:
    """Stages of the contraction of ``nm_spmm`` and ``lookahead_matmul``."""
    return k // 2 // NM.KS if kernel == "nm_spmm" else k // LA.KS


def forced(kernel: str, shape: dict):
    """A stand-in for ``kernel``'s ``plan`` that returns ``shape``; for a
    strip kernel with the stages per block its pack needs."""
    if kernel not in STRIPS:
        return lambda *a: shape
    rows = 128 if kernel == "bsr_matmul" else 64      # value rows per tile

    def plan(M, K, N, dtype, max_nnz, *a):
        return dict(shape, steps_per_block=-(-(max_nnz * rows // BSR.KS)
                                             // shape["split"]))
    return plan


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(KERNELS)
    if not set(names) <= set(KERNELS):
        print(f"mma_tile_sweep: kernels are {sorted(KERNELS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    for kname in names:
        mod, fn, plain = KERNELS[kname]
        plan = mod.plan
        strip = kname in STRIPS
        for sname, (k, n) in SHAPES.items():
            packs, dense = weights(kname, k, n, gen, rng, dev)
            steps = "/".join(sorted({str(p.max_nnz) for p in packs})) \
                if strip else stages(kname, k)
            for M in (8, 128):
                x = torch.randn((M, k), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                lib = C.device_ms(lambda: [torch.matmul(x, w)
                                           for w in dense]) / len(dense)
                want = plain(x, packs[0])
                rows = []
                for bm in ((8, 32) if M <= 8 else (32, 64)):
                    for bn in ((32, 64, 128) if strip else (64, 128)):
                        for split in (1, 2, 4, 8):
                            if not strip and steps % split:
                                continue
                            shape = dict(route="mma", bm=bm, bn=bn,
                                         split=split, ks=64)
                            if not strip:
                                shape["steps_per_block"] = steps // split
                            mod.plan = forced(kname, shape)
                            try:
                                C.check_close(f"{kname} {shape}",
                                              fn(x, packs[0]), want)
                                ms = C.device_ms(lambda: [
                                    fn(x, p) for p in packs]) / len(packs)
                            finally:
                                mod.plan = plan
                            rows.append((ms, bm, bn, split))
                rows.sort()
                mine = C.device_ms(lambda: [fn(x, p) for p in packs]) \
                    / len(packs)
                chosen = sorted({(q["bm"], q["bn"], q["split"]) for q in (
                    mod.plan(M, k, n, torch.bfloat16, p.max_nnz) if strip
                    else mod.plan(M, k, n, torch.bfloat16) for p in packs)})
                C.log(f"[sweep] {kname} {sname} M={M} "
                      f"{'max_nnz' if strip else 'steps'}={steps}: cuBLAS "
                      f"{lib * 1e3:.2f} us, plan "
                      + "/".join(f"bm{a} bn{b} split{c}" for a, b, c in chosen)
                      + f" {mine * 1e3:.2f} us; fastest: "
                      + ", ".join(f"bm{bm} bn{bn} split{s} {ms * 1e3:.2f}"
                                  for ms, bm, bn, s in rows[:4]))
                C.log(f"[sweep-all] {kname} {sname} M={M}: " + ", ".join(
                    f"bm{bm} bn{bn} split{s} {ms * 1e3:.2f}"
                    for ms, bm, bn, s in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
