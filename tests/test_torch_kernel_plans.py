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
            with pytest.raises(ValueError):  # a 16-row tile is no stage
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=16)
            assert mod.plan(8, 1024, 256, torch.float32, 4, bk=16)[
                "route"] == "fma"
            # a 32-row tile is one half stage (x window of 32 columns)
            p = mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=32)
            assert p["ks"] == bsr_mod.HALF_KS and p["bn"] == 32
        else:
            with pytest.raises(ValueError):  # 2:4 of 32 rows: 16 kept
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=32)
            with pytest.raises(ValueError):  # 3:4 of 2 rows
                mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=2, n=3, m=4)
            # 2:4 of 64 rows keeps 32: one half stage (the serving
            # bench's combined packs, bk = bn = 64)
            p = mod.plan(8, 1024, 256, torch.bfloat16, 4, bk=64, bn=64)
            assert p["route"] == "mma" and p["ks"] == bsr_mod.HALF_KS
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


# --- attention: flash_plan and paged_plan -----------------------------------

H, HK, D = 16, 8, 128            # qwen3-0.6b attention
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("hd", [64, 128, 160])
@pytest.mark.parametrize("L", [1, 16, 63, 128, 200, 333, 512])
def test_flash_plan_bf16_takes_the_tensor_cores(L, hd):
    """bf16 at D = 64, 128 or 160: a tile the kernel is built for whose
    rows cover the prompt exactly once; the qwen3 prefill (L = 128, 200)
    takes 64 rows by 32 keys."""
    p = tiling.flash_plan(1, H, HK, L, L, hd, BF16)
    assert p["route"] == "mma"
    assert p["bq"] in tiling.FLASH_BQ and p["bk"] in tiling.FLASH_BK
    assert p["warps"] == p["bq"] // 16
    gx, gy = p["grid"]
    assert gx == H and (gy - 1) * p["bq"] < L <= gy * p["bq"]
    if L in (128, 200):
        assert (p["bq"], p["bk"]) == (64, 32)
    assert p["bk"] == (32 if L <= tiling.FLASH_SHORT_KEYS else 64)


@pytest.mark.parametrize("hd", tiling.HEAD_DIMS)
def test_flash_plan_fp32_and_other_head_dims_take_fma(hd):
    assert tiling.flash_plan(1, H, HK, 128, 128, hd, FP32)["route"] == "fma"
    route = tiling.flash_plan(1, H, HK, 128, 128, hd, BF16)["route"]
    assert route == ("mma" if hd in tiling.MMA_HEAD_DIMS else "fma")


def test_flash_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):          # no kernel for D = 96
        tiling.flash_plan(1, H, HK, 128, 128, 96, BF16)
    with pytest.raises(ValueError):          # GQA needs H % Hk == 0
        tiling.flash_plan(1, 12, 8, 128, 128, D, BF16)
    with pytest.raises(TypeError):
        tiling.flash_plan(1, H, HK, 128, 128, D, torch.float16)


#: (warps, split) of the qwen3 decode step by Q: the same 16 parts, as
#: 2 warps x 8 blocks for the verify block (17% faster there in
#: tools/attention_sweep.py)
QWEN3_PAGED = {1: (4, 4), 4: (2, 8)}


@pytest.mark.parametrize("Q,rows", [(1, 2), (4, 8)])
def test_paged_plan_qwen3_decode(Q, rows):
    """The decode step of chip_smoke.py: 8 slots, 8 kv heads, a 32-page
    view of 16-row pages; Q = 4 is the verify block."""
    p = tiling.paged_plan(8, H, HK, Q, 32, D, (BF16, BF16), 16)
    warps, split = QWEN3_PAGED[Q]
    assert p == dict(route="mma", warps=warps, split=split, ring=2,
                     rows=rows, grid=(8 * HK * split,))


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("n_pages,ps", [(1, 16), (8, 16), (32, 16),
                                        (256, 16), (6, 32), (9, 8)])
@pytest.mark.parametrize("Q", [1, 2, 4, 8])
def test_paged_plan_covers_the_view(Q, n_pages, ps, B):
    """Every chunk of the view has a part; a part's ring holds 2 to 4
    chunks and all of its chunks where it walks at most 4; the cluster is
    a portable one and the grid one wave."""
    p = tiling.paged_plan(B, H, HK, Q, n_pages, D, (BF16, BF16), ps)
    chunks = -(-n_pages * ps // tiling.PAGED_CHUNK)
    parts = p["warps"] * p["split"]
    per_part = -(-chunks // parts)
    assert p["route"] == "mma" and p["rows"] == Q * H // HK
    assert p["warps"] in tiling.PAGED_WARPS and p["split"] in tiling.SPLITS
    assert p["grid"] == (B * HK * p["split"],)
    assert 2 <= p["ring"] <= 4 and p["ring"] >= min(per_part, 4)
    assert B * HK * parts <= tiling.PAGED_MAX_WARPS or p["split"] == 1
    if B * HK * parts < tiling.PAGED_MAX_WARPS // 2:   # not capped
        assert per_part <= tiling.PAGED_CHUNKS_PER_PART or \
            p["split"] == tiling.MAX_SPLIT


def test_paged_plan_fp32_and_other_head_dims_take_fma():
    for dtypes in ((FP32, FP32), (FP32, BF16)):
        assert tiling.paged_plan(8, H, HK, 1, 32, D, dtypes)["route"] == "fma"
    for hd in (32, 256):
        assert tiling.paged_plan(8, H, HK, 1, 32, hd, (BF16, BF16))[
            "route"] == "fma"


def test_paged_plan_takes_more_rows_than_one_tile():
    """Q * G = 32 query rows per kv head (a Q = 16 block): two row tiles
    of 16 on the tensor cores, each its own cluster of ``split`` blocks."""
    p = tiling.paged_plan(8, H, HK, 16, 32, D, (BF16, BF16), 16)
    assert p["route"] == "mma" and p["rows"] == 32
    assert p["grid"] == (2 * 8 * HK * p["split"],)
    assert 2 * 8 * HK * p["split"] * p["warps"] <= tiling.PAGED_MAX_WARPS


@pytest.mark.parametrize("Q", [2, 4, 16])
def test_paged_plan_fma_takes_a_verify_block(Q):
    """fp32 q takes a (B, Q, H, D) block on the fma route: one block per
    8 of the Q * G query rows of each (sequence, kv head)."""
    p = tiling.paged_plan(8, H, HK, Q, 32, D, (FP32, BF16), 16)
    assert p == dict(route="fma", warps=8, split=1, rows=Q * H // HK,
                     grid=(8, HK, -(-Q * H // HK // 8)))


def test_paged_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):          # no kernel for D = 96
        tiling.paged_plan(8, H, HK, 1, 32, 96, (BF16, BF16))
    with pytest.raises(TypeError):           # bf16 q over fp32 pools
        tiling.paged_plan(8, H, HK, 1, 32, D, (BF16, FP32))
    with pytest.raises(TypeError):
        tiling.paged_plan(8, H, HK, 1, 32, D, (torch.float16, BF16))


#: stablelm-12b's attention: 32 query heads over 8 kv heads of 160
SH, SHK, SD = 32, 8, 160


@pytest.mark.parametrize("L", [128, 200])
def test_flash_plan_stablelm_d160(L):
    """The stablelm prefill: bf16 takes the tensor cores with the qwen3
    tile (64 rows by 32 keys), fp32 the FMA kernel; D = 96 still has no
    kernel."""
    p = tiling.flash_plan(1, SH, SHK, L, L, SD, BF16)
    assert p == dict(route="mma", bq=64, bk=32, warps=4,
                     grid=(SH, -(-L // 64)))
    assert tiling.flash_plan(1, SH, SHK, L, L, SD, FP32) == dict(
        route="fma", bq=tiling.FLASH_FMA_BQ, bk=32, grid=(SH, -(-L // 16)))
    with pytest.raises(ValueError):
        tiling.flash_plan(1, SH, SHK, L, L, 96, BF16)


@pytest.mark.parametrize("Q,rows,warps,split,ring", [
    (1, 4, 4, 4, 2), (4, 16, 2, 8, 2), (16, 64, 2, 2, 4)])
def test_paged_plan_stablelm_d160(Q, rows, warps, split, ring):
    """The stablelm decode step (8 slots, a 32-page view of 16-row pages,
    G = 4): bf16 takes the tensor cores, a Q = 4 verify block is one row
    tile of 16 rows, a Q = 16 block four, capped to one wave; fp32 q (over
    fp32 or bf16 pools) takes the FMA kernel; D = 96 still raises."""
    p = tiling.paged_plan(8, SH, SHK, Q, 32, SD, (BF16, BF16), 16)
    tiles = -(-rows // tiling.PAGED_ROWS)
    assert p == dict(route="mma", warps=warps, split=split, ring=ring,
                     rows=rows, grid=(tiles * 8 * SHK * split,))
    assert tiles * 8 * SHK * split * warps <= tiling.PAGED_MAX_WARPS
    for dtypes in ((FP32, FP32), (FP32, BF16)):
        assert tiling.paged_plan(8, SH, SHK, Q, 32, SD, dtypes, 16) == dict(
            route="fma", warps=8, split=1, rows=rows,
            grid=(8, SHK, -(-rows // tiling.PAGED_FMA_ROWS)))
    with pytest.raises(ValueError):
        tiling.paged_plan(8, SH, SHK, Q, 32, 96, (BF16, BF16), 16)


def test_paged_split_never_depends_on_lens():
    """The plan takes the view's page count, not the lengths (read on the
    card inside the kernel), so the host never reads them: the wrapper
    passes ``ptab.shape[1]`` and nothing derived from ``lens``."""
    import inspect

    from repro_torch.kernels import paged_attention as paged_mod
    assert "lens" not in inspect.signature(tiling.paged_plan).parameters
    src = inspect.getsource(paged_mod.paged_attention)
    call = src[src.index("p = plan("):]
    call = call[:call.index(")\n") + 1]
    assert "lens" not in call and "ptab.shape[1]" in call


# --- the serving bench's small geometries ------------------------------------
# its models: d_model 64 over 4 heads (D = 16) and 2 kv heads, MLPs 64 <->
# 128 packed 2:4 at g = 64 (nm) or in 64 x 64 combined tiles; decode at 1
# or 8 slots, prefill of 16-row prompts, wave prefills of 8 x 16 rows

@pytest.mark.parametrize("M", [1, 8, 16, 128])
@pytest.mark.parametrize("K,N,ks", [(64, 128, 32), (128, 64, 64)])
def test_nm_plan_takes_the_bench_mlp(K, N, ks, M):
    """``w_in``/``w_gate`` (K = 64: 32 kept rows) take the half stage,
    ``w_out`` (K = 128: 64 kept rows) the full one; one g = 64 group's
    column tile; the stages cover the kept rows exactly."""
    p = nm_mod.plan(M, K, N, BF16, 2, 4, 64)
    assert p["route"] == "mma" and p["ks"] == ks and 64 % p["bn"] == 0
    assert p["split"] * p["steps_per_block"] * ks == K // 2
    assert nm_mod.plan(M, K, N, FP32, 2, 4, 64)["route"] == "fma"


@pytest.mark.parametrize("M", [1, 8, 16, 128])
@pytest.mark.parametrize("K,N,max_nnz", [(64, 128, 1), (128, 64, 2)])
def test_csa_plan_takes_the_bench_mlp(K, N, max_nnz, M):
    """64 x 64 combined tiles keep 32 rows each: one half stage a tile,
    a column tile no wider than the 64-column gathered window."""
    p = csa_mod.plan(M, K, N, BF16, max_nnz, 64, 64)
    assert p["route"] == "mma" and p["ks"] == bsr_mod.HALF_KS
    assert p["bn"] in (32, 64)
    covered = p["split"] * p["steps_per_block"] * p["ks"]
    assert max_nnz * 32 <= covered < max_nnz * 32 + p["split"] * p["ks"]
    assert csa_mod.plan(M, K, N, FP32, max_nnz, 64, 64)["route"] == "fma"


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_attention_plans_take_head_dim_16(dtype):
    """D = 16 (the bench's and the streaming demo's heads) is built on the
    FMA routes of both kernels, in bf16 as in fp32; D = 8 still raises."""
    assert 16 in tiling.HEAD_DIMS and 16 not in tiling.MMA_HEAD_DIMS
    for L in (16, 128, 512):
        p = tiling.flash_plan(8, 4, 2, L, L, 16, dtype)
        assert p == dict(route="fma", bq=tiling.FLASH_FMA_BQ, bk=32,
                         grid=(8 * 4, -(-L // tiling.FLASH_FMA_BQ)))
    for Q in (1, 3, 5):
        p = tiling.paged_plan(8, 4, 2, Q, 36, 16, (dtype, dtype), 16)
        assert p == dict(route="fma", warps=8, split=1, rows=2 * Q,
                         grid=(8, 2, -(-2 * Q // tiling.PAGED_FMA_ROWS)))
    with pytest.raises(ValueError):
        tiling.flash_plan(8, 4, 2, 16, 16, 8, dtype)
