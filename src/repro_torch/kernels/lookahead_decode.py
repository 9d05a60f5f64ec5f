"""The faithful int7 path: the lookahead-encoded matmul, hand-written for
Hopper.

``lookahead_matmul(x, pack)`` computes ``x (M, K) @ decode(pack)`` for a
:class:`LookaheadPack`, whose int8 bytes ``[sign, b5..b0, skip]`` carry
the INT7 weights and the lookahead skip bits.  On a CUDA tensor it
launches ``csrc/lookahead_decode.cu`` (the port of
``repro/kernels/lookahead_decode.py``; the source's head says what bounds
it and how it is laid out), which decodes the bytes in registers and
applies the per-column scale once at the end; on a CPU tensor it runs the
plain version ``ref.lookahead_matmul_ref``.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import LookaheadPack
from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 32                      # widest column slice of a block: divides N

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.cache
def _fn():
    f = _build.load("lookahead_decode").lookahead_matmul_launch
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


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
    if x.dtype not in DTYPES:
        raise TypeError(f"lookahead_matmul takes float32/bfloat16 x, got "
                        f"{x.dtype}")
    if pack.enc.dtype != torch.int8 or pack.scale.dtype != torch.float32:
        raise TypeError(f"enc must be int8 and scale float32, got "
                        f"{pack.enc.dtype} and {pack.scale.dtype}")
    if tuple(pack.enc.shape) != (pack.K, pack.N) or \
            tuple(pack.scale.shape) != (1, pack.N):
        raise ValueError("pack arrays do not match its geometry")
    for name, t in (("x", x), ("enc", pack.enc), ("scale", pack.scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if pack.N % BN:
        raise ValueError(f"kernel needs N % {BN} == 0, got N={pack.N}")
    if pack.enc.data_ptr() % 8:
        raise ValueError("enc must be 8-byte aligned")
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _fn()(x.data_ptr(), pack.enc.data_ptr(), pack.scale.data_ptr(),
                out.data_ptr(), M, K, pack.N, DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lookahead_matmul")
    launches += 1
    return out
