#!/usr/bin/env python3
"""Time every tile shape and K-split of the tensor-core route of
``nm_spmm`` and ``lookahead_matmul`` on one NVIDIA GPU.

    python3 tools/mma_tile_sweep.py

For each distinct projection shape of a qwen3-0.6b layer and M = 8
(decode) and 128 (prefill), times every (bm, bn, split) that the
kernels are built for and that divides the contraction, each held
against its plain version first, beside one ``torch.matmul`` (cuBLAS)
on the dense bf16 weight.  Device microseconds per call from CUDA-graph
replay over 8 distinct weights (``chip_smoke.device_ms``).  The plan in
``kernels/tiling.py`` was chosen from this table; its choice is printed
beside the fastest.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.core import pruning, sparsity  # noqa: E402
from repro_torch.kernels import lookahead_decode as LA  # noqa: E402
from repro_torch.kernels import nm_spmm as NM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = {"wq": (1024, 2048), "wk": (1024, 1024), "wo": (2048, 1024),
          "w_in": (1024, 3072), "w_out": (3072, 1024)}
COPIES = 8


def weights(kernel: str, k: int, n: int, gen, dev):
    packs, dense = [], []
    for _ in range(COPIES):
        w = (torch.randn((k, n), generator=gen, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        if kernel == "nm_spmm":
            pw, _ = pruning.n_m(w, 2, 4, group=128)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=128))
            dense.append(pw)
        else:
            p = sparsity.LookaheadPack.from_float(w)
            packs.append(p)
            dense.append(p.decode().to(torch.bfloat16))
    return packs, dense


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {"nm_spmm": (NM, NM.nm_spmm, ref.nm_spmm_ref),
               "lookahead_matmul": (LA, LA.lookahead_matmul,
                                    ref.lookahead_matmul_ref)}
    for kname, (mod, fn, plain) in kernels.items():
        planned = mod.plan
        for sname, (k, n) in SHAPES.items():
            packs, dense = weights(kname, k, n, gen, dev)
            steps = k // 2 // NM.KS if kname == "nm_spmm" else k // LA.KS
            for M in (8, 128):
                x = torch.randn((M, k), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                lib = C.device_ms(lambda: [torch.matmul(x, w)
                                           for w in dense]) / COPIES
                want = plain(x, packs[0])
                rows = []
                for bm in ((8, 32) if M <= 8 else (32, 64)):
                    for bn in (64, 128):
                        for split in (1, 2, 4, 8):
                            if steps % split:
                                continue
                            shape = dict(route="mma", bm=bm, bn=bn,
                                         split=split)
                            mod.plan = lambda *a, shape=shape: shape
                            try:
                                C.check_close(f"{kname} {shape}",
                                              fn(x, packs[0]), want)
                                ms = C.device_ms(lambda: [
                                    fn(x, p) for p in packs]) / COPIES
                            finally:
                                mod.plan = planned
                            rows.append((ms, bm, bn, split))
                rows.sort()
                p = planned(M, k, n, torch.bfloat16)
                mine = next(r[0] for r in rows
                            if r[1:] == (p["bm"], p["bn"], p["split"]))
                C.log(f"[sweep] {kname} {sname} M={M}: cuBLAS "
                      f"{lib * 1e3:.2f} us, plan bm{p['bm']} bn{p['bn']} "
                      f"split{p['split']} {mine * 1e3:.2f} us; fastest: "
                      + ", ".join(f"bm{bm} bn{bn} split{s} {ms * 1e3:.2f}"
                                  for ms, bm, bn, s in rows[:4]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
