#!/usr/bin/env python3
"""Where the time of ``flash_attention``'s and ``paged_attention``'s
tensor-core route goes: time each with one part removed at a time, on one
NVIDIA GPU.

    python3 tools/attention_ablation.py [flash] [paged]    # default: both

Builds copies of ``csrc/flash_attention.cu`` and ``csrc/paged_attention.cu``
beside the real ones (into ``build/ablation/``), each with one part cut
out by a textual edit: ``noload`` issues no asynchronous K/V copies (the
ring holds stale data), ``nomma`` drops every ``mma.sync`` (S stays zero,
so the softmax still runs, and P V adds nothing), ``nomerge`` (paged only)
skips the block's and the cluster's merge and the store, keeping the
cluster barriers,
``nowalk`` walks no KV tile or chunk at all (what is left is the launch,
the query and page-table loads, the barriers and the store).  The
outputs of the copies are wrong by design; only their times mean anything.
Each copy runs through the kernel's own wrapper and launch plan at the
shapes of ``tools/attention_sweep.py`` (flash L = 128 and 200; paged at
the mixed and the serve's lens), timed as device microseconds per call
from CUDA-graph replay over inputs that stream from HBM, beside SDPA.
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
from repro_torch.kernels import _build  # noqa: E402
from tools import attention_sweep as S  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
HEADERS = ("common.cuh", "tensor_core.cuh")
NO_MMA = [('#include "tensor_core.cuh"\n',
           '#include "tensor_core.cuh"\n#define mma_bf16(...) ((void)0)\n')]
EDITS = {
    "flash": ("flash_attention", {
        "noload": [("    if (s < ntiles) load(s, s);", "    ;"),
                   ("    if (i + STAGES - 1 < ntiles) load((i + STAGES - 1) "
                    "% STAGES, i + STAGES - 1);", "    ;")],
        "nomma": NO_MMA,
        "nowalk": [("  const int ntiles = k_end > t0 * BK ? (k_end - t0 * BK"
                    " + BK - 1) / BK : 0;", "  const int ntiles = 0;")]}),
    "paged": ("paged_attention", {
        "noload": [("    load(s, s);\n", ""),
                   ("      load(issued % ring, issued);\n", "")],
        "nomma": NO_MMA,
        "nomerge": [("  for (int u = threadIdx.x; u < units; u += THREADS) {",
                     "  for (int u = units; u < units; ++u) {"),
                    ("  for (int i = threadIdx.x; i < share; i += THREADS) {",
                     "  for (int i = share; i < share; ++i) {")],
        "nowalk": [("  const int mine = nch > part ? (nch - part + V - 1) / V"
                    " : 0;", "  const int mine = 0;")]}),
}
MODULES = {"flash": S.FA, "paged": S.PA}


def build(kernel: str) -> dict:
    """``{variant: (mma, fma)}`` launch functions of each edited copy."""
    source, edits = EDITS[kernel]
    procs = {}
    for name in ("full", *edits):
        out = OUT / kernel / name
        out.mkdir(parents=True, exist_ok=True)
        for f in (*HEADERS, f"{source}.cu"):
            text = (CSRC / f).read_text()
            if f == f"{source}.cu":
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
    real = MODULES[kernel]._fns()
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


def ablate(kernel: str, what: str, run, n: int, sdpa_us: float,
           fns: dict) -> None:
    mod = MODULES[kernel]
    real = mod._fns
    times = []
    for name, pair in fns.items():
        mod._fns = lambda pair=pair: pair
        try:
            times.append(f"{name} {C.device_ms(run) / n * 1e3:.2f}")
        finally:
            mod._fns = real
    C.log(f"[ablation] {kernel} {what}: SDPA {sdpa_us:.2f} us; "
          + ", ".join(times) + " us")


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or ["flash", "paged"]
    if not set(names) <= set(EDITS):
        print("attention_ablation: kernels are flash, paged", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    C.log(C.nvidia_smi())
    gen = torch.Generator(device=dev).manual_seed(0)
    if "flash" in names:
        fns = build("flash")
        for L in (128, 200):
            n = -(-S.STREAM_BYTES // ((S.H + 2 * S.HK) * L * S.D * 2))
            qkv = [tuple(torch.randn((1, h, L, S.D), generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for h in (S.H, S.HK, S.HK)) for _ in range(n)]
            rep = [(q, k.repeat_interleave(S.H // S.HK, 1),
                    v.repeat_interleave(S.H // S.HK, 1)) for q, k, v in qkv]
            sdpa = C.device_ms(lambda: [S.SDPA(q, k, v, is_causal=True)
                                        for q, k, v in rep]) / n * 1e3
            p = S.FA.plan(1, S.H, S.HK, L, L, S.D, torch.bfloat16)
            ablate("flash", f"L={L} bq{p['bq']} bk{p['bk']}",
                   lambda: [S.FA.flash_attention(*t) for t in qkv], n, sdpa,
                   fns)
    if "paged" in names:
        fns = build("paged")
        rng = np.random.default_rng(1)
        for what, lens_np in (
                ("mixed lens 0..512", np.asarray(
                    [0, 1, 17, 64, 130, 256, 400, 512], np.int32)),
                ("serve lens 129..192", np.sort(rng.integers(
                    129, 193, size=S.SLOTS)).astype(np.int32))):
            q, pools, ptab, lens = S.paged_inputs(dev, gen, lens_np, 1)
            n, L = len(pools), S.VIEW * S.PS
            mask = (torch.arange(L, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            views = [[t[ptab.long()].reshape(S.SLOTS, L, S.HK, S.D)
                      .transpose(1, 2).repeat_interleave(S.H // S.HK, dim=1)
                      .contiguous() for t in kv] for kv in pools]
            sdpa = C.device_ms(lambda: [S.SDPA(q[:, :, None], k, v,
                                               attn_mask=mask)
                                        for k, v in views]) / n * 1e3
            p = S.PA.plan(S.SLOTS, S.H, S.HK, 1, S.VIEW, S.D,
                          (torch.bfloat16, torch.bfloat16), S.PS)
            ablate("paged", f"{what} warps{p['warps']} split{p['split']} "
                   f"ring{p['ring']}",
                   lambda: [S.PA.paged_attention(q, k, v, ptab, lens)
                            for k, v in pools], n, sdpa, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
