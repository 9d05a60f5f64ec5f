"""Fused causal attention (flash-style), hand-written for Hopper.

``flash_attention(q, k, v)`` — ``q (B, H, Lq, D)``, ``k/v (B, Hk, Lk,
D)`` — with causal masking, sliding windows, tanh soft-capping, GQA and
the suffix offset ``Lk - Lq``.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (the port of
``repro/kernels/flash_attention.py``; the source's head says what bounds
it and how it is laid out): bfloat16 at D = 64 or 128 runs on the tensor
cores, float32 (and bfloat16 at D = 32 or 256) on CUDA-core FMAs, as
:func:`plan` says.  On a CPU tensor it runs the plain version
``ref.mha_ref``.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref, tiling

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


#: ``plan(B, H, Hk, Lq, Lk, D, dtype)``: route, tile and grid of a call.
plan = tiling.flash_plan


@functools.cache
def _fns():
    lib = _build.load("flash_attention")
    mma, fma = lib.flash_attention_mma_launch, lib.flash_attention_fma_launch
    for f in (mma, fma):
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_float]
                      + [ctypes.c_int] * (2 if f is mma else 1)
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return mma, fma


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``q (B, H, Lq, D), k/v (B, Hk, Lk, D) -> (B, H, Lq, D)``; queries
    are the last ``Lq`` positions of the keys.  Rows with no key in
    reach give zeros on the card."""
    global launches
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Lq, D = q.shape
    Bk, Hk, Lk, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    p = plan(B, H, Hk, Lq, Lk, D, q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    s = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    mma, fma = _fns()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hk, Lq, Lk, D, int(causal), window or -1, softcap or 0.0, s)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if p["route"] == "mma":
        err = mma(*args, p["bq"], p["bk"], stream)
    else:
        err = fma(*args, DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
