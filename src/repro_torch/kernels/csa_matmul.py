"""CSA analogue: the combined block-skip × N:M matmul, hand-written for
Hopper.

``csa_matmul(x, pack)`` computes ``x (M, K) @ pack (K, N)`` for a
:class:`CombinedPack`: per N-strip it walks the ``counts[j]`` non-zero
K-tiles and, inside each, only the ``bkc = bk·n/m`` rows ``gidx`` keeps.
On a CUDA tensor it launches ``csrc/csa_matmul.cu`` (the port of
``repro/kernels/csa_matmul.py``; the source's head says what bounds it
and how it is laid out); on a CPU tensor it runs the plain version
``ref.csa_matmul_ref``.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import CombinedPack
from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr_matmul import DTYPES, check_strip_pack

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.cache
def _fn():
    f = _build.load("csa_matmul").csa_matmul_launch
    f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


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
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _fn()(x.data_ptr(), pack.values.data_ptr(), pack.gidx.data_ptr(),
                pack.indices.data_ptr(), pack.counts.data_ptr(),
                out.data_ptr(), M, K, pack.N, pack.bk, pack.bn, pack.bkc,
                pack.max_nnz, DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "csa_matmul")
    launches += 1
    return out
