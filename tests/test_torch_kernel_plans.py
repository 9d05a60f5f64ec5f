"""The launch plans of ``nm_spmm``, ``lookahead_matmul``, ``bsr_matmul``
and ``csa_matmul``: pure Python, so they are checked here over the seven
qwen3-0.6b projections and ragged M, for both routes, without a card.
The strip kernels' plans depend on ``max_nnz``; each is checked at
``K/256 + 1`` slots (a tile density just over 0.5) and ``K/128`` (every
tile kept, or a pack padded to ``Kb`` slots)."""

import pytest
import torch

from repro_torch.kernels import bsr_matmul as bsr_mod
from repro_torch.kernels import csa_matmul as csa_mod
from repro_torch.kernels import lookahead_decode as lookahead_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels import tiling

# the seven projections of one qwen3-0.6b layer, (K, N)
QWEN3 = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
         "wo": (2048, 1024), "w_in": (1024, 3072), "w_gate": (1024, 3072),
         "w_out": (3072, 1024)}
MS = [1, 3, 5, 8, 9, 16, 77, 128, 200, 256]
N_, M_, G = 2, 4, 128            # the 2:4, g = 128 packs of every config


KERNELS = ["nm_spmm", "lookahead_matmul", "bsr_matmul", "csa_matmul"]
STRIPS = ("bsr_matmul", "csa_matmul")
TILE = 128                       # the (bk, bn) tiles of every strip pack


def plans(kernel, M, K, N, dtype):
    """``(plan, depth, rows per stage)`` of each case of ``kernel`` at one
    shape: ``depth`` is the contraction in rows the stages must cover
    (a strip's kept rows at ``max_nnz`` slots for the strip kernels)."""
    if kernel == "nm_spmm":
        return [(nm_mod.plan(M, K, N, dtype, N_, M_, G), K // M_ * N_,
                 nm_mod.KS)]
    if kernel == "lookahead_matmul":
        return [(lookahead_mod.plan(M, K, N, dtype), K, lookahead_mod.KS)]
    cases = []
    for max_nnz in (K // 256 + 1, K // TILE):
        if kernel == "bsr_matmul":
            p, rows = bsr_mod.plan(M, K, N, dtype, max_nnz), TILE
        else:
            p, rows = csa_mod.plan(M, K, N, dtype, max_nnz), TILE * N_ // M_
        cases.append((p, max_nnz * rows, bsr_mod.KS))
    return cases


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_mma_tiles_cover_the_output(kernel, M):
    """bf16: the tiles cover (M, N) exactly once, the K-slices cover the
    contraction exactly (a strip's stages: by fewer than ``split``), each
    cluster is a portable one, a ``nm_spmm`` column tile lies inside one g
    group and a strip kernel's inside one strip."""
    for K, N in QWEN3.values():
        for p, depth, ks in plans(kernel, M, K, N, torch.bfloat16):
            assert p["route"] == "mma" and p["bm"] in (8, 32, 64) and \
                p["bn"] in tiling.WIDTHS
            gx, gy = p["grid"]
            assert gx % p["split"] == 0 and gx // p["split"] * p["bn"] == N
            assert (gy - 1) * p["bm"] < M <= gy * p["bm"]
            covered = p["split"] * p["steps_per_block"] * ks
            if kernel in STRIPS:
                # as wide as a stage's x window: 64 columns, or the
                # gathered tile's 128
                assert p["bn"] == (64 if kernel == "bsr_matmul" else TILE)
                assert depth <= covered < depth + p["split"] * ks
                # fewer than half of the longest strip's ranks idle
                assert p["split"] * ks < 2 * depth
            else:
                assert covered == depth
            assert p["split"] <= tiling.MAX_SPLIT
            assert p["bm"] * p["bn"] // 4 % p["split"] == 0  # reduce shares
            if kernel == "nm_spmm":
                assert G % p["bn"] == 0
            splits = [s for s in (1, 2, 4, tiling.MAX_SPLIT)
                      if (s * ks < 2 * depth if kernel in STRIPS
                          else depth // ks % s == 0)]
            if M <= 8 and kernel in STRIPS:
                assert p["bm"] == 8 and p["split"] == splits[-1]
            elif M <= 8:
                # the smallest split that fills the card, else the largest
                assert p["bm"] == 8
                reaching = [s for s in splits
                            if gx // p["split"] * s >= tiling.TARGET_BLOCKS]
                assert p["split"] == (reaching or splits[-1:])[0]
            else:
                # one wave of at most two blocks per SM
                assert p["split"] in splits
                assert gx * gy <= tiling.MAX_BLOCKS or p["split"] == 1
                assert p["bm"] == 64 or K <= 2048


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_fp32_takes_the_fma_route(kernel, M):
    for K, N in QWEN3.values():
        for p, _, _ in plans(kernel, M, K, N, torch.float32):
            assert p["route"] == "fma"
            gx, gy = p["grid"]
            assert gx * p["bn"] == N and \
                (gy - 1) * p["mt"] < M <= gy * p["mt"]
            if kernel == "nm_spmm":
                assert G % p["bn"] == 0
            if kernel in STRIPS:
                assert TILE % p["bn"] == 0
            assert p["mt"] == (8 if M > 8 else min(t for t in (1, 2, 4, 8)
                                                   if t >= M))


@pytest.mark.parametrize("kernel", KERNELS)
def test_plans_refuse_what_the_kernels_cannot_take(kernel):
    if kernel in STRIPS:
        mod = bsr_mod if kernel == "bsr_matmul" else csa_mod
        with pytest.raises(TypeError):
            mod.plan(8, 1024, 256, torch.float16, 4)
        with pytest.raises(ValueError):      # K % bk != 0
            mod.plan(8, 1000, 256, torch.bfloat16, 4)
        with pytest.raises(ValueError):      # bn % 32 != 0
            mod.plan(8, 1024, 240, torch.bfloat16, 4, bn=48)
        with pytest.raises(ValueError):      # no slot per strip
            mod.plan(8, 1024, 256, torch.float32, 0)
        if kernel == "bsr_matmul":
            with pytest.raises(ValueError):  # a 32-row tile is no stage
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=32)
            assert mod.plan(8, 1024, 256, torch.float32, 4, bk=32)[
                "route"] == "fma"
        else:
            with pytest.raises(ValueError):  # 2:4 of 64 rows: 32 kept
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=64)
            with pytest.raises(ValueError):  # 3:4 of 2 rows
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=2, n=3, m=4)
    elif kernel == "nm_spmm":
        with pytest.raises(ValueError):      # Kc = 48, not whole stages
            nm_mod.plan(8, 96, 256, torch.bfloat16)
        with pytest.raises(ValueError):      # 32 % 3 != 0
            nm_mod.plan(8, 1024, 256, torch.bfloat16, n=3, m=4)
        with pytest.raises(TypeError):
            nm_mod.plan(8, 1024, 256, torch.float16)
    else:
        with pytest.raises(ValueError):      # K % 64 != 0
            lookahead_mod.plan(8, 96, 256, torch.bfloat16)
        with pytest.raises(ValueError):      # N % 32 != 0
            lookahead_mod.plan(8, 1024, 48, torch.float32)
        with pytest.raises(TypeError):
            lookahead_mod.plan(8, 1024, 256, torch.float16)
