"""USSA analogue: the N:M compressed-K matmul, hand-written for Hopper.

``nm_spmm(x, pack)`` computes ``x (M, K) @ pack (K, N)`` where ``pack``
keeps ``n`` of every ``m`` weights along K (positions shared over ``g``
output columns).  On a CUDA tensor it launches ``csrc/nm_spmm.cu`` (the
port of ``repro/kernels/nm_spmm.py``; the source's head says what bounds
it and how it is laid out): bfloat16 x runs on the tensor cores, float32
x on CUDA-core FMAs, as :func:`plan` says.  On a CPU tensor it runs the
plain version ``ref.nm_spmm_ref``.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import _build, ref, tiling

KS = 64                      # compressed rows per stage of the mma route
FMA_BN = 32                  # widest column slice of the fma route

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, dtype: torch.dtype, n: int = 2, m: int = 4,
         g: int = 128) -> dict:
    """The launch plan of ``x (M, K) @ pack (K, N)``: the route by dtype
    (``"mma"`` for bfloat16, ``"fma"`` for float32), then its tiles.

    The mma route's column tile divides ``g``, so a block's columns share
    one list of source rows; raises for geometry neither route takes."""
    if K % m:
        raise ValueError(f"K={K} is not a multiple of m={m}")
    if dtype == torch.float32:
        if g % FMA_BN:
            raise ValueError(f"the fma route needs g % {FMA_BN} == 0, "
                             f"got g={g}")
        return tiling.fma_tiles(M, N, narrow=4)
    if dtype != torch.bfloat16:
        raise TypeError(f"nm_spmm takes float32 or bfloat16, got {dtype}")
    Kc = K // m * n
    if KS % n or (KS * m // n) % 8 or K % 8 or Kc % KS:
        raise ValueError(f"the mma route needs {KS} % n == 0, "
                         f"({KS}*m/n) % 8 == 0, K % 8 == 0 and "
                         f"K*n/m % {KS} == 0; got n={n}, m={m}, K={K}")
    widths = [w for w in tiling.WIDTHS if g % w == 0 and N % w == 0]
    return tiling.mma_tiles(M, K, N, Kc // KS, widths)


@functools.cache
def _fns():
    lib = _build.load("nm_spmm")
    mma, fma = lib.nm_spmm_mma_launch, lib.nm_spmm_fma_launch
    for f in (mma, fma):
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_int] * (3 if f is mma else 2) + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return mma, fma


def nm_spmm(x: torch.Tensor, pack: NMPack) -> torch.Tensor:
    """``x (M, K) @ pack (K, N) -> (M, N)`` in ``x.dtype``, fp32
    accumulation."""
    global launches
    if x.device.type == "cpu":
        return ref.nm_spmm_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"nm_spmm: unsupported device {x.device}")
    M, K = x.shape
    if K != pack.K:
        raise ValueError(f"x K={K} != pack K={pack.K}")
    if pack.values.dtype != x.dtype:
        raise TypeError(f"nm_spmm takes x and values of one dtype, got "
                        f"{x.dtype} and {pack.values.dtype}")
    if pack.idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {pack.idx.dtype}")
    for name, t in (("x", x), ("values", pack.values), ("idx", pack.idx)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if pack.values.shape != (pack.Kc, pack.N) or \
            pack.idx.shape != (pack.Kc, pack.N // pack.g):
        raise ValueError("pack arrays do not match its geometry")
    p = plan(M, K, pack.N, x.dtype, pack.n, pack.m, pack.g)
    if pack.values.data_ptr() % 16 or (p["route"] == "mma"
                                       and x.data_ptr() % 16):
        raise ValueError("values (and bf16 x) must be 16-byte aligned")
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    mma, fma = _fns()
    args = (x.data_ptr(), pack.values.data_ptr(), pack.idx.data_ptr(),
            out.data_ptr(), M, K, pack.N, pack.n, pack.m, pack.g)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p["route"] == "mma":
        err = mma(*args, p["bm"], p["bn"], p["split"], stream)
    else:
        err = fma(*args, p["mt"], p["bn"], stream)
    _build.check(err, "nm_spmm")
    launches += 1
    return out
