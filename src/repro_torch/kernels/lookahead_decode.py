"""The faithful int7 path: the lookahead-encoded matmul, hand-written for
Hopper.

``lookahead_matmul(x, pack)`` computes ``x (M, K) @ decode(pack)`` for a
:class:`LookaheadPack`, whose int8 bytes ``[sign, b5..b0, skip]`` carry
the INT7 weights and the lookahead skip bits.  On a CUDA tensor it
launches ``csrc/lookahead_decode.cu`` (the port of
``repro/kernels/lookahead_decode.py``; the source's head says what bounds
it and how it is laid out), which decodes the bytes in registers and
applies the per-column scale once at the end: bfloat16 x runs on the
tensor cores, float32 x on CUDA-core FMAs, as :func:`plan` says.  On a
CPU tensor it runs the plain version ``ref.lookahead_matmul_ref``.
There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import LookaheadPack
from repro_torch.kernels import _build, ref, tiling

KS = 128                     # K rows per stage of the mma route
FMA_BN = 32                  # widest column slice of the fma route

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, dtype: torch.dtype) -> dict:
    """The launch plan of ``x (M, K) @ decode(pack) (K, N)``: the route by
    dtype (``"mma"`` for bfloat16, ``"fma"`` for float32), then its tiles;
    raises for geometry neither route takes."""
    if N % FMA_BN:
        raise ValueError(f"lookahead_matmul needs N % {FMA_BN} == 0, got "
                         f"N={N}")
    if dtype == torch.float32:
        return tiling.fma_tiles(M, N, narrow=8)
    if dtype != torch.bfloat16:
        raise TypeError(f"lookahead_matmul takes float32 or bfloat16 x, got "
                        f"{dtype}")
    if K % KS:
        raise ValueError(f"the mma route needs K % {KS} == 0, got K={K}")
    widths = [w for w in tiling.WIDTHS if N % w == 0]
    return tiling.mma_tiles(M, K, N, K // KS, widths)


@functools.cache
def _fns():
    lib = _build.load("lookahead_decode")
    mma, fma = lib.lookahead_mma_launch, lib.lookahead_fma_launch
    mma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fma.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    mma.restype = fma.restype = ctypes.c_int
    return mma, fma


def lookahead_matmul(x: torch.Tensor, pack: LookaheadPack) -> torch.Tensor:
    """``x (M, K) @ decode(pack) (K, N) -> (M, N)`` in ``x.dtype``, fp32
    accumulation."""
    global launches
    if x.device.type == "cpu":
        return ref.lookahead_matmul_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"lookahead_matmul: unsupported device {x.device}")
    M, K = x.shape
    if K != pack.K:
        raise ValueError(f"x K={K} != pack K={pack.K}")
    if pack.enc.dtype != torch.int8 or pack.scale.dtype != torch.float32:
        raise TypeError(f"enc must be int8 and scale float32, got "
                        f"{pack.enc.dtype} and {pack.scale.dtype}")
    if tuple(pack.enc.shape) != (pack.K, pack.N) or \
            tuple(pack.scale.shape) != (1, pack.N):
        raise ValueError("pack arrays do not match its geometry")
    for name, t in (("x", x), ("enc", pack.enc), ("scale", pack.scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    p = plan(M, K, pack.N, x.dtype)
    if p["route"] == "mma":
        if any(t.data_ptr() % 16 for t in (x, pack.enc, pack.scale)):
            raise ValueError("bf16 x, enc and scale must be 16-byte aligned")
    elif pack.enc.data_ptr() % 8:
        raise ValueError("enc must be 8-byte aligned")
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    mma, fma = _fns()
    args = (x.data_ptr(), pack.enc.data_ptr(), pack.scale.data_ptr(),
            out.data_ptr(), M, K, pack.N)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p["route"] == "mma":
        err = mma(*args, p["bm"], p["bn"], p["split"], stream)
    else:
        err = fma(*args, p["mt"], p["bn"], stream)
    _build.check(err, "lookahead_matmul")
    launches += 1
    return out
