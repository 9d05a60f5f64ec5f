"""CSA analogue: the combined block-skip × N:M matmul, hand-written for
Hopper.

``csa_matmul(x, pack)`` computes ``x (M, K) @ pack (K, N)`` for a
:class:`CombinedPack`: per N-strip it walks the ``counts[j]`` non-zero
K-tiles and, inside each, only the ``bkc = bk·n/m`` rows ``gidx`` keeps.
On a CUDA tensor it launches ``csrc/csa_matmul.cu`` (the port of
``repro/kernels/csa_matmul.py``; the source's head says what bounds it
and how it is laid out): bfloat16 x runs on the tensor cores, float32 x
on CUDA-core FMAs, as :func:`plan` says.  On a CPU tensor it runs the
plain version ``ref.csa_matmul_ref``.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import CombinedPack
from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr_matmul import check_strip_pack, strip_plan

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, dtype: torch.dtype, max_nnz: int,
         bk: int = 128, bn: int = 128, n: int = 2, m: int = 4) -> dict:
    """The launch plan of ``x (M, K) @ pack (K, N)`` for a combined pack
    of ``(bk, bn)`` tiles, ``max_nnz`` slots per strip and ``n:m`` rows
    kept inside each; a kept tile's ``bk·n/m`` rows are stages of 64 on
    the mma route, each gathering from the tile's ``bk`` x columns."""
    if bk * n % m:
        raise ValueError(f"bk={bk} keeps no whole number of {n}:{m} rows")
    return strip_plan(M, K, N, dtype, bk, bn, max_nnz, bk * n // m,
                      gather=True)


def smem_bytes(M: int, K: int, N: int, max_nnz: int, bk: int = 128,
               bn: int = 128, n: int = 2, m: int = 4) -> int:
    """The dynamic shared memory per block that the bfloat16 launcher
    passes for ``x (M, K) @ pack (K, N)`` under :func:`plan`, as the
    compiled library computes it."""
    p = plan(M, K, N, torch.bfloat16, max_nnz, bk, bn, n, m)
    return _build.smem_bytes("csa_matmul", "csa_matmul_mma_smem_bytes", bk,
                             max_nnz, p["bm"], p["bn"], p["steps_per_block"])


@functools.cache
def _fns():
    lib = _build.load("csa_matmul")
    mma, fma = lib.csa_matmul_mma_launch, lib.csa_matmul_fma_launch
    mma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + \
        [ctypes.c_void_p]
    fma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    mma.restype = fma.restype = ctypes.c_int
    return mma, fma


def csa_matmul(x: torch.Tensor, pack: CombinedPack) -> torch.Tensor:
    """``x (M, K) @ pack (K, N) -> (M, N)`` in ``x.dtype``, fp32
    accumulation."""
    global launches
    if x.device.type == "cpu":
        return ref.csa_matmul_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"csa_matmul: unsupported device {x.device}")
    Nb = pack.N // pack.bn
    check_strip_pack(x, pack, pack.bkc,
                     {"gidx": (Nb, pack.max_nnz, pack.bkc)})
    M, K = x.shape
    p = plan(M, K, pack.N, x.dtype, pack.max_nnz, pack.bk, pack.bn, pack.n,
             pack.m)
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    mma, fma = _fns()
    args = (x.data_ptr(), pack.values.data_ptr(), pack.gidx.data_ptr(),
            pack.indices.data_ptr(), pack.counts.data_ptr(), out.data_ptr(),
            M, K, pack.N, pack.bk, pack.bn, pack.bkc, pack.max_nnz)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p["route"] == "mma":
        err = mma(*args, p["bm"], p["bn"], p["split"], p["steps_per_block"],
                  stream)
    else:
        err = fma(*args, stream)
    _build.check(err, "csa_matmul")
    launches += 1
    return out
