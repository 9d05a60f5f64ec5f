"""The launch plans of ``nm_spmm`` and ``lookahead_matmul``: pure Python,
so they are checked here over the seven qwen3-0.6b projections and
ragged M, for both routes, without a card."""

import pytest
import torch

from repro_torch.kernels import lookahead_decode as lookahead_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels import tiling

# the seven projections of one qwen3-0.6b layer, (K, N)
QWEN3 = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
         "wo": (2048, 1024), "w_in": (1024, 3072), "w_gate": (1024, 3072),
         "w_out": (3072, 1024)}
MS = [1, 3, 5, 8, 9, 16, 77, 128, 200, 256]
N_, M_, G = 2, 4, 128            # the 2:4, g = 128 packs of every config


def plans(kernel, M, K, N, dtype):
    if kernel == "nm_spmm":
        return nm_mod.plan(M, K, N, dtype, N_, M_, G), K // M_ * N_, \
            nm_mod.KS
    return lookahead_mod.plan(M, K, N, dtype), K, lookahead_mod.KS


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kernel", ["nm_spmm", "lookahead_matmul"])
def test_mma_tiles_cover_the_output(kernel, M):
    """bf16: the tiles cover (M, N) exactly once, the K-slices cover the
    contraction exactly, each cluster is a portable one, and a
    ``nm_spmm`` column tile lies inside one g group."""
    for K, N in QWEN3.values():
        p, depth, ks = plans(kernel, M, K, N, torch.bfloat16)
        assert p["route"] == "mma" and p["bm"] in (8, 32, 64) and \
            p["bn"] in tiling.WIDTHS
        gx, gy = p["grid"]
        assert gx % p["split"] == 0 and gx // p["split"] * p["bn"] == N
        assert (gy - 1) * p["bm"] < M <= gy * p["bm"]
        assert p["split"] * p["steps_per_block"] * ks == depth
        assert p["split"] <= tiling.MAX_SPLIT
        assert p["bm"] * p["bn"] // 4 % p["split"] == 0  # reduce shares
        if kernel == "nm_spmm":
            assert G % p["bn"] == 0
        if M <= 8:
            # the smallest split that fills the card, else the largest
            assert p["bm"] == 8
            divisors = [s for s in (1, 2, 4, tiling.MAX_SPLIT)
                        if depth // ks % s == 0]
            reaching = [s for s in divisors
                        if gx // p["split"] * s >= tiling.TARGET_BLOCKS]
            assert p["split"] == (reaching or divisors[-1:])[0]
        else:
            # one wave of at most two blocks per SM
            assert gx * gy <= tiling.MAX_BLOCKS or p["split"] == 1
            assert p["bm"] == 64 or K <= 2048


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("kernel", ["nm_spmm", "lookahead_matmul"])
def test_fp32_takes_the_fma_route(kernel, M):
    for K, N in QWEN3.values():
        p, _, _ = plans(kernel, M, K, N, torch.float32)
        assert p["route"] == "fma"
        gx, gy = p["grid"]
        assert gx * p["bn"] == N and (gy - 1) * p["mt"] < M <= gy * p["mt"]
        if kernel == "nm_spmm":
            assert G % p["bn"] == 0
        assert p["mt"] == (8 if M > 8 else min(t for t in (1, 2, 4, 8)
                                               if t >= M))


@pytest.mark.parametrize("kernel", ["nm_spmm", "lookahead_matmul"])
def test_plans_refuse_what_the_kernels_cannot_take(kernel):
    if kernel == "nm_spmm":
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
