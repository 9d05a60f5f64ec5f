"""SSSA analogue: the block-skip matmul, hand-written for Hopper.

``bsr_matmul(x, pack)`` computes ``x (M, K) @ pack (K, N)`` over the
non-zero ``(bk, bn)`` tiles a :class:`BlockSparsePack` lists per N-strip.
On a CUDA tensor it launches ``csrc/bsr_matmul.cu`` (the port of
``repro/kernels/bsr_matmul.py``; the source's head says what bounds it
and how it is laid out), which walks each strip's ``counts[j]`` tiles and
never reads a padding slot: bfloat16 x runs on the tensor cores, float32
x on CUDA-core FMAs, as :func:`plan` says.  On a CPU tensor it runs the
plain version ``ref.bsr_matmul_ref``.  There is no fallback between them.

``check_strip_pack`` and ``strip_plan`` are shared with ``csa_matmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sparsity import BlockSparsePack
from repro_torch.kernels import _build, ref, tiling

KS = 64                      # kept rows per stage of the mma route
FMA_BN = 32                  # widest column slice of the fma route
SMEM_ROWS = 48 * 1024        # source rows the fma route holds per strip

#: Launches of the CUDA kernel since the count was last set to 0.
launches = 0


def strip_plan(M: int, K: int, N: int, dtype: torch.dtype, bk: int,
               bn: int, max_nnz: int, rows: int, gather: bool) -> dict:
    """The launch plan of a strip kernel on ``x (M, K)`` and a pack of
    ``(bk, bn)`` tiles, ``max_nnz`` slots per strip, ``rows`` value rows
    per kept tile (``gather``: picked from the tile's ``bk`` rows through
    ``gidx``): the route by dtype (``"mma"`` for bfloat16, ``"fma"`` for
    float32), then its tiles.  The mma route's column tile is as wide as
    a stage's x window (64 columns, or the gathered tile's ``bk``) where
    ``bn`` allows: the sweep (``tools/mma_tile_sweep.py``) found 64 the
    fastest for a block pack and 128 for a combined one at decode.  Only
    integers of the pack are read, never a device tensor.  Raises for
    geometry neither route takes."""
    if K % bk or N % bn or bn % FMA_BN or max_nnz < 1:
        raise ValueError(f"the strip kernels need bn % {FMA_BN} == 0, "
                         f"tiles dividing (K, N) and max_nnz >= 1; got "
                         f"bk={bk}, bn={bn}, K={K}, N={N}, "
                         f"max_nnz={max_nnz}")
    if dtype == torch.float32:
        if max_nnz * rows > SMEM_ROWS:
            raise ValueError(f"a strip of {max_nnz} x {rows} rows exceeds "
                             "the fma route's shared-memory row list")
        return tiling.fma_tiles(M, N, narrow=4)
    if dtype != torch.bfloat16:
        raise TypeError(f"the strip kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if rows % KS or bk % 8 or K % 8:
        raise ValueError(f"the mma route needs {rows} rows per tile to be "
                         f"a multiple of {KS}, bk % 8 == 0 and K % 8 == 0; "
                         f"got bk={bk}, K={K}")
    window = bk if gather else KS
    widths = [w for w in tiling.WIDTHS if bn % w == 0 and w <= window]
    return tiling.mma_tiles(M, K, N, max_nnz * rows // KS, widths,
                            ceil=True)


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, dtype: torch.dtype, max_nnz: int,
         bk: int = 128, bn: int = 128) -> dict:
    """The launch plan of ``x (M, K) @ pack (K, N)`` for a block pack of
    ``(bk, bn)`` tiles and ``max_nnz`` slots per strip; a 128-row tile is
    two stages of the mma route."""
    return strip_plan(M, K, N, dtype, bk, bn, max_nnz, bk, gather=False)


@functools.cache
def _fns():
    lib = _build.load("bsr_matmul")
    mma, fma = lib.bsr_matmul_mma_launch, lib.bsr_matmul_fma_launch
    mma.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fma.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    mma.restype = fma.restype = ctypes.c_int
    return mma, fma


def check_strip_pack(x: torch.Tensor, pack, rows: int, metadata) -> None:
    """The checks the strip kernels (``bsr_matmul``, ``csa_matmul``) share:
    dtype, device, contiguity, shapes and alignment of ``x`` and a pack
    whose kept tiles hold ``rows`` value rows each.  The geometry is
    ``strip_plan``'s to check."""
    M, K = x.shape
    name = type(pack).__name__
    if K != pack.K:
        raise ValueError(f"x K={K} != pack K={pack.K}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            pack.values.dtype != x.dtype:
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
    if pack.values.data_ptr() % 16 or (x.dtype == torch.bfloat16
                                       and x.data_ptr() % 16):
        raise ValueError("values (and bf16 x) must be 16-byte aligned")


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
    p = plan(M, K, pack.N, x.dtype, pack.max_nnz, pack.bk, pack.bn)
    out = torch.empty((M, pack.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    mma, fma = _fns()
    args = (x.data_ptr(), pack.values.data_ptr(), pack.indices.data_ptr(),
            pack.counts.data_ptr(), out.data_ptr(), M, K, pack.N, pack.bk,
            pack.bn, pack.max_nnz)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if p["route"] == "mma":
        err = mma(*args, p["bm"], p["bn"], p["split"], p["steps_per_block"],
                  stream)
    else:
        err = fma(*args, stream)
    _build.check(err, "bsr_matmul")
    launches += 1
    return out
