#!/usr/bin/env python3
"""What bounds ``nm_spmm``'s tensor-core route: time it with one part
removed at a time, on one NVIDIA GPU.

    python3 tools/mma_ablation.py

Builds four copies of ``csrc/nm_spmm.cu`` beside the real one (into
``build/ablation/``), each with one part cut out by a textual edit:
``noload`` issues no asynchronous copies (the ring holds stale data;
source columns are masked to stay in bounds), ``nocompute`` skips the
MMA loop, ``noreduce`` skips the cluster reduction and the store.  The
outputs of the copies are wrong by design; only their times mean
anything.  Each runs the launch plan of ``kernels/nm_spmm.py::plan``
at the qwen3-0.6b shapes, M = 8 and 128, timed as device microseconds
per call from CUDA-graph replay over 8 distinct weights, beside one
``torch.matmul`` (cuBLAS) on the dense bf16 weight.  The edits are
anchored on the source text and fail loudly when it changes.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.core import pruning, sparsity  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import nm_spmm as NM  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
REDUCE = ("  cluster_reduce_store<TL>(red, reinterpret_cast<float*>(smem + recv),"
          " out,\n                           nullptr, M, N, m0, n0);")
EDITS = {
    "full": [],
    "noload": [("    if (s < steps) load(s, s);", "    ;"),
               ("      load((step + slots - 1) % slots, step + slots - 1);",
                "      ;"),
               ("        src[j] = (r >> ns) * m + is[r];",
                "        src[j] = (r >> ns) * m + (is[r] & 3);")],
    "nocompute": [("    for (int kk = 0; kk < KS / 16; ++kk) {",
                   "    for (int kk = 0; kk < 0; ++kk) {")],
    "noreduce": [(REDUCE, '  asm volatile("barrier.cluster.wait.aligned;" '
                          '::: "memory");\n'
                          "  if (red[threadIdx.x] == 12345.f) out[0] = bf16();")],
}
SHAPES = {"wk": (1024, 1024), "w_in": (1024, 3072), "w_out": (3072, 1024)}
COPIES = 8


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    for h in ("common.cuh", "tensor_core.cuh"):
        (OUT / h).write_text((CSRC / h).read_text())
    base = (CSRC / "nm_spmm.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: anchor not found: {old!r}")
            src = src.replace(old, new)
        (OUT / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        f = ctypes.CDLL(str(OUT / f"{name}.so")).nm_spmm_mma_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_ablation: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    fns = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    for sname, (k, n) in SHAPES.items():
        packs = []
        for _ in range(COPIES):
            w = (torch.randn((k, n), generator=gen, device=dev)
                 / k ** 0.5).to(torch.bfloat16)
            pw, _ = pruning.n_m(w, 2, 4, group=128)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=128))
        dense = [p.densify() for p in packs]
        for M in (8, 128):
            x = torch.randn((M, k), generator=gen, device=dev) \
                .to(torch.bfloat16)
            out = torch.empty((M, n), dtype=torch.bfloat16, device=dev)
            p = NM.plan(M, k, n, torch.bfloat16)
            lib = C.device_ms(lambda: [torch.matmul(x, w)
                                       for w in dense]) / COPIES
            times = []
            for name, f in fns.items():
                def run(f=f):
                    for q in packs:
                        err = f(x.data_ptr(), q.values.data_ptr(),
                                q.idx.data_ptr(), out.data_ptr(), M, k, n, 2,
                                4, 128, p["bm"], p["bn"], p["split"],
                                torch.cuda.current_stream().cuda_stream)
                        _build.check(err, name)
                run()
                torch.cuda.synchronize()
                times.append(f"{name} {C.device_ms(run) / COPIES * 1e3:.2f}")
            C.log(f"[ablation] nm_spmm {sname} M={M} bm{p['bm']} "
                  f"bn{p['bn']} split{p['split']}: cuBLAS {lib * 1e3:.2f} "
                  "us; " + ", ".join(times) + " us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
