"""Kernel micro-benchmark: ``x (M, K) @ w (K, N)`` through
``kernels.dispatch.sparse_matmul`` for every pack format, on the card.

The twin of the JAX package's ``benchmarks/bench_kernels.py``: the same
data (numpy seed 0), the same pruning and the same rows — dense,
``block_skip`` at block sparsity 0.5 and 0.75, ``nm`` 2:4 and 1:4,
``combined(0.5, 2:4)`` and ``lookahead(int7)`` from block-4 pruning.
On the card (``device="cuda"``) it runs the hand-written kernels at the
JAX bench's shape (256, 2048, 2048) in float32 (the FMA routes, as the
JAX bench's dtype) and in bfloat16 (the tensor-core routes); each row is
timed with CUDA events twice — ``us``, the mean of ``REPS`` calls issued
eagerly from Python after a warm-up (what a caller sees, the wrapper's
host cost included), and ``device_us``, the same calls replayed from a
CUDA graph (the device's time) — with the weight (8–16 MB) in the 50 MB
L2 between calls, and held against the kernel's plain version
(``kernels/ref.py``).  On the CPU it runs the
plain versions at the JAX bench's smoke size (64, 256, 256) and times
them on the host clock — CPU times, not device times.

Each row names the kernel the dispatcher chose, its launch plan and the
weight's tile density: the fraction of (128, 128) tiles that hold a
non-zero.  Block pruning on i.i.d. random weights never empties a tile
(ROADMAP queue 3), so the block rows read 1.00, as the JAX bench's do.
``flop_fraction`` is the nominal share the JAX bench credits each format;
the H100 bound of a row counts what its data needs (every tile of a
density-1.00 block pack), its bytes at 3.35 TB/s or its products at
989 TFLOP/s (bf16) or 67 TFLOP/s (fp32), whichever is longer.
"""

from __future__ import annotations

import functools
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import encoding, pruning, sparsity
from repro_torch.core.sparsity import (BlockSparsePack, CombinedPack,
                                       LookaheadPack, NMPack)
from repro_torch.kernels import (bsr_matmul, csa_matmul, dispatch,
                                 lookahead_decode, nm_spmm)

SHAPE = (256, 2048, 2048)            # the JAX bench's shape
SMOKE_SHAPE = (64, 256, 256)         # its REPRO_BENCH_SMOKE shape
REPS = 20
TILE = 128                           # tile of the density column
RTOL, ATOL = 2e-2, 1e-2              # chip_smoke.py's kernel tolerance
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # fp32 outside the tensor cores



def packs(w: np.ndarray, dtype: torch.dtype, device) -> List[tuple]:
    """``(label, weight, flop_fraction)`` of each row, pruned in float32
    numpy as the JAX bench prunes, packed from the pruned weight cast to
    ``dtype`` on ``device`` (the lookahead pack keeps int8 bytes and a
    float32 scale)."""
    wt = torch.from_numpy(w)

    def on(t):
        return t.to(device=device, dtype=dtype)

    rows: List[tuple] = [("dense", on(wt), 1.0)]
    for s in (0.5, 0.75):
        wp, _ = pruning.block_semi_structured(wt, s, block=128)
        rows.append((f"block_skip(x={s})",
                     sparsity.pack_block_sparse(on(wp), 128, 128), 1 - s))
    for n, m in ((2, 4), (1, 4)):
        wp, _ = pruning.n_m(wt, n, m, group=128)
        rows.append((f"nm({n}:{m})", sparsity.pack_nm(on(wp), n, m, g=128),
                     n / m))
    wp, _ = pruning.combined_nm(wt, 0.5, 2, 4, group=128, block=128)
    rows.append(("combined(0.5,2:4)",
                 sparsity.pack_combined(on(wp), 2, 4, 128, 128), 0.25))
    wp, _ = pruning.block_semi_structured(wt, 0.5, block=4)
    rows.append(("lookahead(int7)",
                 LookaheadPack.from_float(wp).to(device), 1.0))
    return rows


def entry(weight: Any) -> dispatch.KernelEntry:
    """The dispatcher's registry entry for ``weight``: the kernel's name,
    and ``run(x, weight, "ref")`` for its plain version."""
    kind = dispatch.SparsityDescriptor.of(weight).kind
    return next(e for e in dispatch.registry().values() if e.kind == kind)


def densify(weight: Any) -> torch.Tensor:
    if isinstance(weight, LookaheadPack):
        return weight.decode()
    return weight if isinstance(weight, torch.Tensor) else weight.densify()


def tile_density(weight: Any) -> float:
    """Fraction of the ``(TILE, TILE)`` tiles of the dense weight that hold
    a non-zero."""
    zero = encoding.tile_zero_map(densify(weight).float().cpu(), TILE, TILE)
    return 1.0 - float(zero.float().mean())


def plan_of(M: int, x: torch.Tensor, weight: Any) -> str:
    """The launch plan the kernel's wrapper takes for this call."""
    if isinstance(weight, torch.Tensor):
        return "torch.matmul"
    K, N, dt = weight.K, weight.N, x.dtype
    if isinstance(weight, NMPack):
        p = nm_spmm.plan(M, K, N, dt, weight.n, weight.m, weight.g)
    elif isinstance(weight, BlockSparsePack):
        p = bsr_matmul.plan(M, K, N, dt, weight.max_nnz, weight.bk,
                            weight.bn)
    elif isinstance(weight, CombinedPack):
        p = csa_matmul.plan(M, K, N, dt, weight.max_nnz, weight.bk,
                            weight.bn, weight.n, weight.m)
    else:
        p = lookahead_decode.plan(M, K, N, dt)
    return " ".join(f"{k}{v}" for k, v in p.items()
                    if k not in ("grid", "route")) + f" {p['route']}"


def weight_bytes(weight: Any) -> int:
    if isinstance(weight, torch.Tensor):
        return weight.numel() * weight.element_size()
    return sparsity.values_bytes(weight) + sparsity.metadata_bytes(weight) \
        + (weight.scale.numel() * 4 if isinstance(weight, LookaheadPack)
           else 0)


def work_fraction(weight: Any) -> float:
    """The share of the dense products this pack's data needs: the kept
    tiles (tile density) and the kept n of m rows inside them."""
    if isinstance(weight, NMPack):
        return weight.n / weight.m
    if isinstance(weight, BlockSparsePack):
        return weight.density
    if isinstance(weight, CombinedPack):
        return weight.density * weight.n / weight.m
    return 1.0


def bound_us(x: torch.Tensor, weight: Any, N: int):
    """The least time an H100 could take for the call: x, the weight's
    bytes and the output moved once over HBM, or the products this data
    needs at the dtype's peak rate, whichever is longer; with what bounds
    it."""
    M, K = x.shape
    nbytes = (M * K + M * N) * x.element_size() + weight_bytes(weight)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N * work_fraction(weight) / PEAK_FLOPS[x.dtype]
    return max(t_bytes, t_ops) * 1e6, \
        "bytes" if t_bytes >= t_ops else "operations"


def _time_us(fn, cuda: bool) -> float:
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS * 1e3


def _graph_us(fn) -> float:
    """Device µs per call: ``REPS`` calls captured in one CUDA graph and
    replayed, so the host's cost of issuing them drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS * 1e3


def _max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all() or \
            (err > ATOL + RTOL * want.abs()).any():
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3e})")
    return err.max().item()


def run(device="cuda", dtypes: Optional[Sequence[torch.dtype]] = None
        ) -> dict:
    """Every row at every dtype: ``us`` per call, ``speedup`` against the
    dense row of the same dtype, the FLOP fraction, effective GFLOP/s,
    tile density, kernel and plan; on the card also the max abs error
    against the plain version, ``device_us`` with its speedup and the
    H100 bound (``None`` on the CPU, where the plain version is what
    runs)."""
    device = dispatch.resolve_device(device)
    cuda = device.type == "cuda"
    M, K, N = SHAPE if cuda else SMOKE_SHAPE
    if dtypes is None:
        dtypes = (torch.float32, torch.bfloat16) if cuda else \
            (torch.float32,)
    rng = np.random.default_rng(0)          # x first, then w, as in JAX
    x32 = rng.normal(size=(M, K)).astype(np.float32)
    w32 = rng.normal(size=(K, N)).astype(np.float32)
    dense_flops = 2.0 * M * K * N
    rows = []
    for dtype in dtypes:
        x = torch.from_numpy(x32).to(device=device, dtype=dtype)
        for label, weight, frac in packs(w32, dtype, device):
            kernel = entry(weight)
            name = kernel.name
            err = None
            if cuda and name != "dense":
                err = _max_err(dispatch.sparse_matmul(x, weight),
                               kernel.run(x, weight, "ref"),
                               f"{label} {dtype}")
            call = functools.partial(dispatch.sparse_matmul, x, weight)
            us = _time_us(call, cuda)
            dev_us = _graph_us(call) if cuda else None
            if name == "dense":
                t_dense, t_dense_dev = us, dev_us
            bound, by = bound_us(x, weight, N) if cuda else (None, None)
            rows.append({
                "kernel": label, "dtype": str(dtype).split(".")[-1],
                "dispatched": name,
                "plan": plan_of(M, x, weight) if cuda or name == "dense"
                else "plain version",
                "us": us, "flop_frac": frac, "speedup": t_dense / us,
                "device_us": dev_us,
                "device_speedup": t_dense_dev / dev_us if cuda else None,
                "gflops": dense_flops * frac / (us * 1e-6) / 1e9,
                "tile_density": tile_density(weight), "max_abs_err": err,
                "bound_us": bound, "bound_by": by})
    return {"rows": rows, "shape": (M, K, N), "device": str(device),
            "device_name": torch.cuda.get_device_name(device) if cuda
            else "cpu"}


def main(out=None) -> None:
    if out is None:
        out = run()
    M, K, N = out["shape"]
    clock = "device µs (CUDA events)" if out["device"].startswith("cuda") \
        else "host µs on the CPU (plain versions)"
    print(f"# kernel micro-bench — x({M},{K}) @ w({K},{N}) through "
          f"dispatch.sparse_matmul on {out['device_name']}; {clock}")
    print("kernel,dtype,dispatched,plan,us_per_call,flop_fraction,"
          "speedup_vs_dense,gflops,tile_density,max_abs_err,device_us,"
          "device_speedup_vs_dense,h100_bound_us")
    for r in out["rows"]:
        err = "-" if r["max_abs_err"] is None else f"{r['max_abs_err']:.2e}"
        dev = "-,-" if r["device_us"] is None else \
            f"{r['device_us']:.1f},{r['device_speedup']:.2f}"
        bound = "-" if r["bound_us"] is None else \
            f"{r['bound_us']:.2f} ({r['bound_by']})"
        print(f"{r['kernel']},{r['dtype']},{r['dispatched']},{r['plan']},"
              f"{r['us']:.1f},{r['flop_frac']:.2f},{r['speedup']:.2f},"
              f"{r['gflops']:.1f},{r['tile_density']:.2f},{err},{dev},"
              f"{bound}")


if __name__ == "__main__":
    main()
