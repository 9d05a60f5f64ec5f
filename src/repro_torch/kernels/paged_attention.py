"""Paged attention, hand-written for Hopper — decode against a paged KV
cache.

``paged_attention(q, k_pool, v_pool, ptab, lens)`` attends each
sequence's decode query to the rows of its pages: page ``j`` of sequence
``b`` lives in pool page ``ptab[b, j]`` and ``lens[b]`` rows are valid.
On a CUDA tensor it launches ``csrc/paged_attention.cu`` (the port of
``repro/kernels/paged_attention.py``), which walks only the pages a
sequence owns and never materializes the gathered view; on a CPU tensor
it runs the plain version ``ref.paged_attention_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, pool dtype) pairs the kernel is built for
PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float32, torch.bfloat16)}
HEAD_DIMS = (32, 64, 128, 256)
GMAX = 8

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


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


@functools.cache
def _fn():
    f = _build.load("paged_attention").paged_attention_launch
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, ptab: torch.Tensor,
                    lens: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``q (B, H, D) × pools (P, ps, Hk, D) × ptab (B, np) → (B, H, D)``.

    ``ptab`` may be a column slice of a wider table (rows need not be
    contiguous, columns must be); ``lens`` is clamped to ``np * ps``
    rows.  Rows with ``lens == 0`` give zeros.  The CPU path also takes
    the ``(B, Q, H, D)`` decode block of the plain version; the kernel
    takes one query per sequence.
    """
    global launches
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, ptab, lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"kernel takes q (B, H, D), got {tuple(q.shape)}")
    B, H, D = q.shape
    P, ps, Hk, Dk = k_pool.shape
    if D != Dk or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if H % Hk or H // Hk > GMAX or D not in HEAD_DIMS:
        raise ValueError(f"kernel needs H % Hk == 0, H/Hk <= {GMAX} and D in "
                         f"{HEAD_DIMS}; got H={H}, Hk={Hk}, D={D}")
    if (q.dtype, k_pool.dtype) not in PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} pools={k_pool.dtype}")
    if ptab.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("ptab and lens must be int32")
    if ptab.dim() != 2 or ptab.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"ptab {tuple(ptab.shape)} / lens "
                         f"{tuple(lens.shape)} do not match B={B}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("lens", lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if ptab.device != q.device or ptab.stride(1) != 1:
        raise ValueError(f"ptab must lie on {q.device} with unit column "
                         "stride")
    s = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                ptab.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, Hk, D,
                ps, ptab.shape[1], ptab.stride(0), s, DTYPES[q.dtype],
                DTYPES[k_pool.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    launches += 1
    return out
