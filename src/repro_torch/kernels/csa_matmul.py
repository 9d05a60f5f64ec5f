"""CSA analogue: the combined block-skip × N:M matmul, hand-written for
Hopper.

``csa_matmul(x, pack)`` computes ``x (M, K) @ pack (K, N)`` for a
:class:`CombinedPack`: per N-strip it walks the ``counts[j]`` non-zero
K-tiles and, inside each, only the ``bkc = bk·n/m`` rows ``gidx`` keeps.
On a CUDA tensor it launches ``csrc/csa_matmul.cu`` (the port of
``repro/kernels/csa_matmul.py``; the source's head says what bounds it
and how it is laid out): bfloat16 x runs on the tensor cores, float32 x
on CUDA-core FMAs, as :func:`plan` says, or the plan the autotune cache
holds for the call (``kernels/autotune.py``).  On a CPU tensor it runs the
plain version ``ref.csa_matmul_ref``, and on ``meta`` tensors it only
gives the output's shape and reports :func:`cost` (the dry run's route).
There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch

from repro_torch.core.sparsity import CombinedPack
from repro_torch.kernels import _build, autotune, ref
from repro_torch.kernels.bsr_matmul import (KS, check_strip_pack,
                                            slot_density, strip_candidates,
                                            strip_plan)

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0
#: Calls of the plain version on the card in the kernel's place, under
#: ``dispatch.plain_versions`` (a degraded engine), since the same reset.
plain_launches = 0
#: Those of them on the mma route's half stage (``plan``'s ``ks`` = 32).
half_launches = 0


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, dtype: torch.dtype, max_nnz: int,
         bk: int = 128, bn: int = 128, n: int = 2, m: int = 4) -> dict:
    """The launch plan of ``x (M, K) @ pack (K, N)`` for a combined pack
    of ``(bk, bn)`` tiles, ``max_nnz`` slots per strip and ``n:m`` rows
    kept inside each; a kept tile's ``bk·n/m`` rows are stages of 64 on
    the mma route (one half stage of 32 at ``bk = 64``), each gathering
    from the tile's ``bk`` x columns."""
    if bk * n % m:
        raise ValueError(f"bk={bk} keeps no whole number of {n}:{m} rows")
    return strip_plan(M, K, N, dtype, bk, bn, max_nnz, bk * n // m,
                      gather=True)


def candidates(M: int, K: int, N: int, dtype: torch.dtype, max_nnz: int,
               bk: int = 128, bn: int = 128, n: int = 2, m: int = 4
               ) -> List[dict]:
    """Every plan the built instances take for this call, :func:`plan`'s
    first: what ``dispatch.tune`` sweeps."""
    return strip_candidates(plan(M, K, N, dtype, max_nnz, bk, bn, n, m), M,
                            K, N, bk, bn, max_nnz, bk * n // m, gather=True)


def pattern(K: int, bk: int, bn: int, max_nnz: int, n: int, m: int) -> str:
    """The autotune key's pattern, at the slot density."""
    return f"csa{bk}x{bn}d{slot_density(K, bk, max_nnz):.2f}+{n}:{m}"


def cost(M: int, K: int, N: int, dtype: torch.dtype, max_nnz: int,
         bk: int = 128, bn: int = 128, n: int = 2, m: int = 4,
         nnz: Optional[int] = None) -> dict:
    """FLOPs and HBM bytes of one call over ``nnz`` kept tiles (default
    every slot, ``N / bn * max_nnz``: what the JAX ``csa_matmul_ref``
    counts; the card's data count is ``counts.sum()``): ``2 M bkc bn`` per
    tile of ``bkc = bk n / m`` kept rows, and x, the kept rows, their
    positions, the tile indices and the counts read once, the output
    written once."""
    Nb, bkc = N // bn, bk * n // m
    tiles = Nb * max_nnz if nnz is None else nnz
    return {"flops": 2.0 * M * tiles * bkc * bn,
            "bytes": (M * K + M * N + tiles * bkc * bn) * dtype.itemsize
            + (tiles * bkc + tiles + Nb) * 4}


def smem_bytes(M: int, K: int, N: int, max_nnz: int, bk: int = 128,
               bn: int = 128, n: int = 2, m: int = 4) -> int:
    """The dynamic shared memory per block that the bfloat16 launcher
    passes for ``x (M, K) @ pack (K, N)`` under :func:`plan`, as the
    compiled library computes it."""
    p = plan(M, K, N, torch.bfloat16, max_nnz, bk, bn, n, m)
    return _build.smem_bytes("csa_matmul", "csa_matmul_mma_smem_bytes", bk,
                             max_nnz, p["bm"], p["bn"], p["steps_per_block"],
                             p["ks"])


@functools.cache
def _fns():
    lib = _build.load("csa_matmul")
    mma, fma = lib.csa_matmul_mma_launch, lib.csa_matmul_fma_launch
    mma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p]
    fma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    mma.restype = fma.restype = ctypes.c_int
    return mma, fma


def csa_matmul(x: torch.Tensor, pack: CombinedPack,
               use_plan: Optional[dict] = None) -> torch.Tensor:
    """``x (M, K) @ pack (K, N) -> (M, N)`` in ``x.dtype``, fp32
    accumulation; ``use_plan`` launches that plan (a sweep's candidate)
    instead of the cached or the rule's."""
    global launches, half_launches
    _build.refuse_grad("csa_matmul", x, pack.values)
    if x.device.type == "cpu":
        return ref.csa_matmul_ref(x, pack)
    if x.device.type == "meta":
        M = x.shape[0]
        return _build.on_meta(
            "csa_matmul", cost(M, pack.K, pack.N, x.dtype, pack.max_nnz,
                               pack.bk, pack.bn, pack.n, pack.m),
            lambda: x.new_empty((M, pack.N)), x, pack.values, pack.gidx,
            pack.indices, pack.counts)
    if x.device.type != "cuda":
        raise ValueError(f"csa_matmul: unsupported device {x.device}")
    Nb = pack.N // pack.bn
    check_strip_pack(x, pack, pack.bkc,
                     {"gidx": (Nb, pack.max_nnz, pack.bkc)})
    M, K = x.shape
    p = autotune.resolve(
        "csa_matmul", M, K, pack.N, autotune.dtype_name(x.dtype),
        pattern(K, pack.bk, pack.bn, pack.max_nnz, pack.n, pack.m),
        lambda: plan(M, K, pack.N, x.dtype, pack.max_nnz, pack.bk, pack.bn,
                     pack.n, pack.m), use_plan)
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
                  p["ks"], stream)
    else:
        err = fma(*args, stream)
    _build.check(err, "csa_matmul")
    launches += 1
    if p["route"] == "mma" and p["ks"] < KS:
        half_launches += 1
    return out
