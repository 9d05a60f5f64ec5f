"""USSA analogue: the N:M compressed-K matmul, hand-written for Hopper.

``nm_spmm(x, pack)`` computes ``x (M, K) @ pack (K, N)`` where ``pack``
keeps ``n`` of every ``m`` weights along K (positions shared over ``g``
output columns).  On a CUDA tensor it launches ``csrc/nm_spmm.cu`` (the
port of ``repro/kernels/nm_spmm.py``; the source's head says what bounds
it and how it is laid out); on a CPU tensor it runs the plain version
``ref.nm_spmm_ref``.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 32                      # columns per block: must divide g

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.cache
def _fn():
    f = _build.load("nm_spmm").nm_spmm_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


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
    if x.dtype not in DTYPES or pack.values.dtype != x.dtype:
        raise TypeError(f"nm_spmm takes float32/bfloat16 x and values of the "
                        f"same dtype, got {x.dtype} and {pack.values.dtype}")
    if pack.idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {pack.idx.dtype}")
    for name, t in (("x", x), ("values", pack.values), ("idx", pack.idx)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if pack.values.shape != (pack.Kc, pack.N) or \
            pack.idx.shape != (pack.Kc, pack.N // pack.g):
        raise ValueError("pack arrays do not match its geometry")
    if pack.g % BN or K % pack.m:
        raise ValueError(f"kernel needs g % {BN} == 0 and K % m == 0, got "
                         f"g={pack.g}, K={K}, m={pack.m}")
    if pack.values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned")
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _fn()(x.data_ptr(), pack.values.data_ptr(), pack.idx.data_ptr(),
                out.data_ptr(), M, K, pack.N, pack.n, pack.m, pack.g,
                DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nm_spmm")
    launches += 1
    return out
