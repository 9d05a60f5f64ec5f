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
The plan may also come from the autotune cache (``kernels/autotune.py``,
keyed by B, H, Hk, Q, the view's pages, D, the dtypes and the window).
On a CPU tensor it runs the plain version ``ref.paged_attention_ref``,
and on ``meta`` tensors it only gives the output's shape and reports
:func:`cost` (the dry run's route).  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, autotune, ref, tiling

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0
#: Calls of the plain version on the card in the kernel's place, under
#: ``dispatch.plain_versions`` (a degraded engine), since the same reset.
plain_launches = 0
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
#: ``candidates(...)`` with ``plan``'s arguments: every plan the built
#: instances take, the rule's first (what ``dispatch.tune`` sweeps).
candidates = tiling.paged_candidates


def key_fields(B: int, H: int, Hk: int, Q: int, n_pages: int, D: int,
               dtypes, page_size: int, window: Optional[int]) -> tuple:
    """``(M, K, N, dtype, pattern)`` of the call's autotune key: B rows, the
    view's ``n_pages * page_size`` keys, D, the q (and pool, where it
    differs) dtype, and the page shape, heads, queries and window."""
    qn, kvn = (autotune.dtype_name(t) for t in dtypes)
    return (B, n_pages * page_size, D, qn if qn == kvn else f"{qn}/{kvn}",
            f"paged{page_size}x{n_pages}H{H}Hk{Hk}Q{Q}w{window or 0}")


def cost(B: int, H: int, Hk: int, Q: int, n_pages: int, D: int, dtypes,
         page_size: int = 16, pairs: Optional[float] = None,
         rows: Optional[int] = None, pages: Optional[int] = None) -> dict:
    """FLOPs and HBM bytes of one call: ``4 D`` per (query, key) pair of
    each head, over ``pairs`` pairs in all (default every query over the
    whole view, ``B Q n_pages page_size``: what the JAX
    ``paged_attention_ref`` counts), and q read and the output written
    once, the ``rows`` pool rows of K and V the call reads (default every
    view row, ``B n_pages page_size``), their ``pages`` table entries
    (default ``B n_pages``) and the lengths."""
    view = n_pages * page_size
    pairs = B * Q * view if pairs is None else pairs
    rows = B * view if rows is None else rows
    pages = B * n_pages if pages is None else pages
    q_es, kv_es = (t.itemsize for t in dtypes)
    return {"flops": 4.0 * H * D * pairs,
            "bytes": 2 * B * Q * H * D * q_es + 2 * rows * Hk * D * kv_es
            + pages * 4 + B * 4}


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
                    softcap: Optional[float] = None,
                    use_plan: Optional[dict] = None) -> torch.Tensor:
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
    (:func:`plan`).  ``use_plan`` launches that plan (a sweep's
    candidate) instead of the cached or the rule's.
    """
    global launches, block_launches, mma_launches, window_launches
    _build.refuse_grad("paged_attention", q, k_pool, v_pool)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, ptab, lens, scale,
                                       window=window, softcap=softcap)
    if q.device.type == "meta":
        B, Q, H, D = q.shape if q.dim() == 4 else \
            (q.shape[0], 1, *q.shape[1:])
        return _build.on_meta(
            "paged_attention", cost(B, H, k_pool.shape[2], Q, ptab.shape[1],
                                    D, (q.dtype, k_pool.dtype),
                                    k_pool.shape[1]),
            lambda: torch.empty_like(q), q, k_pool, v_pool, ptab, lens)
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
    p = autotune.resolve("paged_attention", *key_fields(
        B, H, Hk, Q, ptab.shape[1], D, (q.dtype, k_pool.dtype), ps, window),
        lambda: p, use_plan)
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
