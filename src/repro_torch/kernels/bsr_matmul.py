"""SSSA analogue: the block-skip matmul, hand-written for Hopper.

``bsr_matmul(x, pack)`` computes ``x (M, K) @ pack (K, N)`` over the
non-zero ``(bk, bn)`` tiles a :class:`BlockSparsePack` lists per N-strip.
On a CUDA tensor it launches ``csrc/bsr_matmul.cu`` (the port of
``repro/kernels/bsr_matmul.py``; the source's head says what bounds it
and how it is laid out), which walks each strip's ``counts[j]`` tiles and
never reads a padding slot; on a CPU tensor it runs the plain version
``ref.bsr_matmul_ref``.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import BlockSparsePack
from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 32                      # widest column slice of a block: divides bn
SMEM_ROWS = 48 * 1024        # source rows a block can hold in shared memory

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


@functools.cache
def _fn():
    f = _build.load("bsr_matmul").bsr_matmul_launch
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def check_strip_pack(x: torch.Tensor, pack, rows: int, metadata) -> None:
    """The checks the strip kernels (``bsr_matmul``, ``csa_matmul``) share:
    dtype, device, contiguity, geometry and alignment of ``x`` and a pack
    whose kept tiles hold ``rows`` value rows each."""
    M, K = x.shape
    name = type(pack).__name__
    if K != pack.K:
        raise ValueError(f"x K={K} != pack K={pack.K}")
    if x.dtype not in DTYPES or pack.values.dtype != x.dtype:
        raise TypeError(f"{name}: float32/bfloat16 x and values of the same "
                        f"dtype, got {x.dtype} and {pack.values.dtype}")
    Nb = pack.N // pack.bn
    shapes = {"values": (Nb, pack.max_nnz, rows, pack.bn),
              "indices": (Nb, pack.max_nnz), "counts": (Nb,), **metadata}
    for field, shape in shapes.items():
        t = getattr(pack, field)
        if field != "values" and t.dtype != torch.int32:
            raise TypeError(f"{name}.{field} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}.{field} has shape {tuple(t.shape)}, "
                             f"its geometry says {shape}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}.{field} must be contiguous on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if pack.bn % BN or K % pack.bk or pack.N % pack.bn:
        raise ValueError(f"kernel needs bn % {BN} == 0 and tiles dividing "
                         f"(K, N), got bk={pack.bk}, bn={pack.bn}, "
                         f"K={K}, N={pack.N}")
    if pack.max_nnz * rows > SMEM_ROWS:
        raise ValueError(f"a strip of {pack.max_nnz} x {rows} rows exceeds "
                         "the kernel's shared-memory row list")
    if pack.values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned")


def bsr_matmul(x: torch.Tensor, pack: BlockSparsePack) -> torch.Tensor:
    """``x (M, K) @ pack (K, N) -> (M, N)`` in ``x.dtype``, fp32
    accumulation."""
    global launches
    if x.device.type == "cpu":
        return ref.bsr_matmul_ref(x, pack)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul: unsupported device {x.device}")
    check_strip_pack(x, pack, pack.bk, {})
    M, K = x.shape
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _fn()(x.data_ptr(), pack.values.data_ptr(), pack.indices.data_ptr(),
                pack.counts.data_ptr(), out.data_ptr(), M, K, pack.N,
                pack.bk, pack.bn, pack.max_nnz, DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bsr_matmul")
    launches += 1
    return out
