#!/usr/bin/env python3
"""What bounds the tensor-core route of ``nm_spmm``, ``bsr_matmul`` and
``csa_matmul``: time each with one part removed at a time, on one NVIDIA
GPU.

    python3 tools/mma_ablation.py [kernel ...]    # default: all three

Builds four copies of the kernel's source beside the real one (into
``build/ablation/``), each with one part cut out by a textual edit of
``csrc/nm_spmm.cu`` or, for the strip kernels, ``csrc/strip_spmm.cuh``:
``noload`` issues no asynchronous copies (the ring holds stale data;
gathered source columns are masked to stay in bounds), ``nocompute``
skips the MMA loop, ``noreduce`` skips the cluster reduction and the
store.  The outputs of the copies are wrong by design; only their times
mean anything.  Each copy runs through the kernel's own wrapper and
launch plan (``kernels/*.py::plan``) at the qwen3-0.6b shapes, M = 8 and
128, timed as device microseconds per call from CUDA-graph replay over
enough distinct weights to stream from HBM (``mma_tile_sweep.copies``),
beside one ``torch.matmul`` (cuBLAS) on the dense bf16 weight.  The
strip kernels run on packs with half of each weight's (128, 128) tiles
zeroed, an empty strip and a padding slot (``chip_smoke.pack_strip``).
The edits are anchored on the source text and fail loudly when it
changes.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from repro_torch.core import pruning, sparsity  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bsr_matmul as BSR  # noqa: E402
from repro_torch.kernels import csa_matmul as CSA  # noqa: E402
from repro_torch.kernels import nm_spmm as NM  # noqa: E402
from tools.mma_tile_sweep import copies  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
HEADERS = ("common.cuh", "tensor_core.cuh", "strip_spmm.cuh")
REDUCE = ("  cluster_reduce_store<TL>(red, reinterpret_cast<float*>(smem + recv),"
          " out,\n                           nullptr, M, N, m0, n0);")
NO_REDUCE = ('  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n'
             "  if (red[threadIdx.x] == 12345.f) out[0] = bf16();")
NO_COMPUTE = [("    for (int kk = 0; kk < KS / 16; ++kk) {",
               "    for (int kk = 0; kk < 0; ++kk) {")]
# (file the edits touch, {variant: [(anchor, replacement)]})
EDITS = {
    "nm": ("nm_spmm.cu", {
        "noload": [("    if (s < steps) load(s, s);", "    ;"),
                   ("      load((step + slots - 1) % slots, step + slots - 1);",
                    "      ;"),
                   ("        src[j] = (r >> ns) * m + is[r];",
                    "        src[j] = (r >> ns) * m + (is[r] & 3);")],
        "nocompute": NO_COMPUTE,
        "noreduce": [(REDUCE, NO_REDUCE)]}),
    "strip": ("strip_spmm.cuh", {
        "noload": [("    if (s < mine) load(s, s);", "    ;"),
                   ("    if (i + slots - 1 < mine) load((i + slots - 1) % slots,"
                    " i + slots - 1);", "    ;"),
                   ("          src[e] = is[kk * 16 + 2 * t4 + (e & 1) + (e >> 1)"
                    " * 8];", "          src[e] = is[kk * 16 + 2 * t4 + (e & 1)"
                    " + (e >> 1) * 8] & 63;")],
        "nocompute": NO_COMPUTE,
        "noreduce": [(REDUCE, NO_REDUCE)]}),
}
# kernel: (wrapper module, wrapper, source, edit family, pack format)
KERNELS = {"nm_spmm": (NM, NM.nm_spmm, "nm_spmm", "nm", None),
           "bsr_matmul": (BSR, BSR.bsr_matmul, "bsr_matmul", "strip",
                          "block"),
           "csa_matmul": (CSA, CSA.csa_matmul, "csa_matmul", "strip",
                          "combined")}
VARIANTS = ("full", "noload", "nocompute", "noreduce")
SHAPES = {"wk": (1024, 1024), "w_in": (1024, 3072), "w_out": (3072, 1024)}


def build(kernel: str) -> dict:
    """``{variant: (mma, fma)}`` launch functions of each edited copy."""
    mod, _, source, family, _ = KERNELS[kernel]
    target, edits = EDITS[family]
    procs = {}
    for name in VARIANTS:
        out = OUT / kernel / name
        out.mkdir(parents=True, exist_ok=True)
        for f in (*HEADERS, f"{source}.cu"):
            text = (CSRC / f).read_text()
            if f == target:
                for old, new in edits.get(name, []):
                    if old not in text:
                        raise SystemExit(f"{kernel} {name}: anchor not "
                                         f"found: {old!r}")
                    text = text.replace(old, new)
            (out / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
             str(out / f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    real = mod._fns()
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{kernel} {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / kernel / name / "lib.so"))
        pair = []
        for f in real:
            g = getattr(lib, f.__name__)
            g.argtypes, g.restype = f.argtypes, f.restype
            pair.append(g)
        fns[name] = tuple(pair)
    return fns


def weights(kernel: str, k: int, n: int, gen, rng, dev):
    packs, dense = [], []
    fmt = KERNELS[kernel][4]
    for _ in range(copies(k, n)):
        w = (torch.randn((k, n), generator=gen, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        if fmt is None:
            pw, _ = pruning.n_m(w, 2, 4, group=128)
            packs.append(sparsity.pack_nm(pw, 2, 4, g=128))
        else:
            pw, p = C.pack_strip(C.zero_half_tiles(w, rng, empty_strip=True),
                                 fmt)
            packs.append(p)
        dense.append(pw)
    return packs, dense


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(KERNELS)
    if not set(names) <= set(KERNELS):
        print(f"mma_ablation: kernels are {sorted(KERNELS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    for kernel in names:
        mod, fn, _, _, _ = KERNELS[kernel]
        fns = build(kernel)
        real = mod._fns
        for sname, (k, n) in SHAPES.items():
            packs, dense = weights(kernel, k, n, gen, rng, dev)
            for M in (8, 128):
                x = torch.randn((M, k), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                if kernel == "nm_spmm":
                    p = mod.plan(M, k, n, torch.bfloat16)
                else:
                    p = mod.plan(M, k, n, torch.bfloat16,
                                 packs[0].max_nnz)
                lib = C.device_ms(lambda: [torch.matmul(x, w)
                                           for w in dense]) / len(dense)
                times = []
                for name, pair in fns.items():
                    mod._fns = lambda pair=pair: pair
                    try:
                        ms = C.device_ms(lambda: [fn(x, q) for q in packs])
                    finally:
                        mod._fns = real
                    times.append(f"{name} {ms / len(packs) * 1e3:.2f}")
                C.log(f"[ablation] {kernel} {sname} M={M} bm{p['bm']} "
                      f"bn{p['bn']} split{p['split']}: cuBLAS "
                      f"{lib * 1e3:.2f} us; " + ", ".join(times) + " us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
