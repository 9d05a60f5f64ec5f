"""Paged attention, hand-written for Hopper — decode against a paged KV
cache.

``paged_attention(q, k_pool, v_pool, ptab, lens)`` attends each
sequence's decode query (or ``(Q, H, D)`` verify block) to the rows of
its pages: page ``j`` of sequence ``b`` lives in pool page ``ptab[b, j]``
and ``lens[b]`` rows are valid.  On a CUDA tensor it launches
``csrc/paged_attention.cu`` (the port of
``repro/kernels/paged_attention.py``; the source's head says what bounds
it and how it is laid out), which walks only the pages a sequence owns
and never materializes the gathered view: bfloat16 q and pools at D = 64,
128 or 160 run on the tensor cores (split over a thread-block cluster),
float32 q (and bfloat16 at D = 16, 32 or 256) on CUDA-core FMAs, as
:func:`plan` says; both take a ``(B, Q, H, D)`` verify block of any ``Q``,
a sliding ``window`` and a tanh ``softcap`` of the logits (gemma's local
layers and attention softcap).
On a CPU tensor it runs the plain version ``ref.paged_attention_ref``.
There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref, tiling

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0
#: Of those, the launches with a ``(B, Q, H, D)`` block of Q > 1 queries
#: (the speculative verify).
block_launches = 0
#: Of those, the launches on the tensor-core route.
mma_launches = 0
#: Of those, the launches with a sliding window (a local layer's decode).
window_launches = 0


class PagedKV(NamedTuple):
    """A paged KV view: ``k/v (P, ps, Hk, D)`` page pools, ``ptab (B,
    max_pages) int32`` page tables, ``lens (B,) int32`` valid KV rows."""
    k: torch.Tensor
    v: torch.Tensor
    ptab: torch.Tensor
    lens: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_pages(self) -> int:
        return self.ptab.shape[1]

    @property
    def head_dim(self) -> int:
        return self.k.shape[3]


#: ``plan(B, H, Hk, Q, n_pages, D, (q dtype, pool dtype), page_size)``:
#: route, split and grid of a call.
plan = tiling.paged_plan


@functools.cache
def _fns():
    lib = _build.load("paged_attention")
    mma, fma = lib.paged_attention_mma_launch, lib.paged_attention_fma_launch
    head = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float])
    mma.argtypes = head + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fma.argtypes = head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    for f in (mma, fma):
        f.restype = ctypes.c_int
    return mma, fma


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, ptab: torch.Tensor,
                    lens: torch.Tensor,
                    scale: Optional[float] = None, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """``q (B, H, D)`` or ``(B, Q, H, D)`` × pools ``(P, ps, Hk, D)`` ×
    ``ptab (B, np)`` → the shape of ``q``.

    A ``(B, Q, H, D)`` block's query ``i`` sits at position ``qpos = lens
    - Q + i`` and sees the keys up to it and before the view's end (``np
    * ps`` rows), as the gathered view of the plain version does; with a
    ``window``, only the keys after ``qpos - window``.  ``softcap`` caps
    the scaled logits as ``tanh(s / softcap) * softcap`` before the
    mask.  ``ptab``
    may be a column slice of a wider table (rows need not be contiguous,
    columns must be).  Rows with no key in reach (``lens == 0``) give
    zeros.  Both routes take any ``Q``: the ``Q * H / Hk`` query rows of
    a kv head run in row tiles of 16 (tensor cores) or 8 (FMA) rows
    (:func:`plan`).
    """
    global launches, block_launches, mma_launches, window_launches
    _build.refuse_grad("paged_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, ptab, lens, scale,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() not in (3, 4):
        raise ValueError(f"kernel takes q (B, H, D) or (B, Q, H, D), got "
                         f"{tuple(q.shape)}")
    B, Q, H, D = q.shape if q.dim() == 4 else (q.shape[0], 1, *q.shape[1:])
    P, ps, Hk, Dk = k_pool.shape
    if D != Dk or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"k and v pools differ: {k_pool.dtype} and "
                        f"{v_pool.dtype}")
    if ptab.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("ptab and lens must be int32")
    if ptab.dim() != 2 or ptab.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"ptab {tuple(ptab.shape)} / lens "
                         f"{tuple(lens.shape)} do not match B={B}")
    p = plan(B, H, Hk, Q, ptab.shape[1], D, (q.dtype, k_pool.dtype), ps)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("lens", lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if p["route"] == "mma" and any(t.data_ptr() % 16
                                   for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    if ptab.device != q.device or ptab.stride(1) != 1:
        raise ValueError(f"ptab must lie on {q.device} with unit column "
                         "stride")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    s = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    mma, fma = _fns()
    ptrs = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptab.data_ptr(), lens.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (*ptrs, B, Q, H, Hk, D, ps, ptab.shape[1], ptab.stride(0), s,
            window or -1, softcap or 0.0)
    if p["route"] == "mma":
        err = mma(*args, p["warps"], p["split"], p["ring"], stream)
    else:
        err = fma(*args, DTYPES[q.dtype], DTYPES[k_pool.dtype], stream)
    _build.check(err, "paged_attention")
    launches += 1
    if Q > 1:
        block_launches += 1
    if p["route"] == "mma":
        mma_launches += 1
    if window is not None:
        window_launches += 1
    return out
