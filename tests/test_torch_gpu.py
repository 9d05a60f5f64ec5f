"""The port's CUDA kernels against their plain versions on the card, in
bfloat16 at rtol 2e-2 / atol 1e-2 (the bf16 tolerance of
``tests/test_kernels.py``), plus a short paged Engine run per format and
the decode chunk as captured CUDA graphs against the eager body.

Marked ``gpu``; without a CUDA device each test skips.  This file
imports neither ``jax`` nor ``repro``, so it also runs on a machine with
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import encoding, pruning, sparsity
from repro_torch.kernels import bsr_matmul as bsr_mod
from repro_torch.kernels import csa_matmul as csa_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import lookahead_decode as lookahead_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref, tiling

RTOL, ATOL = 2e-2, 1e-2
CUDA = torch.device("cuda")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels built for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randn(seed, shape, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=shape).astype(np.float32)).to(
        dev, torch.bfloat16)


def close(got, want):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,K,N,dtype", [
    (1, 1024, 1024, torch.bfloat16), (2, 1024, 2048, torch.bfloat16),
    (3, 2048, 1024, torch.bfloat16), (8, 1024, 3072, torch.bfloat16),
    (130, 3072, 1024, torch.bfloat16), (5, 1024, 1024, torch.float32)])
def test_nm_spmm_kernel(cuda, M, K, N, dtype):
    w, _ = pruning.n_m((randn(0, (K, N), cuda) / K ** 0.5).to(dtype), 2, 4,
                       group=128)
    pack = sparsity.pack_nm(w, 2, 4, g=128)
    x = randn(1, (M, K), cuda).to(dtype)
    before = nm_mod.launches
    got = nm_mod.nm_spmm(x, pack)
    torch.cuda.synchronize()
    assert nm_mod.launches == before + 1
    close(got, ref.nm_spmm_ref(x, pack))
    close(got, (x.float() @ w.float()))


def tile_zeroed(seed, K, N, dev, dtype=torch.bfloat16, tile=128):
    """Random ``(K, N)`` weights with half of the ``(tile, tile)`` tiles
    zeroed and the last strip emptied: a ``counts == 0`` strip and
    strips of different counts."""
    rng = np.random.default_rng(seed)
    Kb, Nb = K // tile, N // tile
    keep = np.zeros(Kb * Nb, bool)
    keep[rng.permutation(Kb * Nb)[:Kb * Nb // 2]] = True
    keep = keep.reshape(Kb, Nb)
    keep[:, -1] = False
    mask = np.kron(keep, np.ones((tile, tile), bool))
    w = rng.normal(size=(K, N)).astype(np.float32) / K ** 0.5
    return torch.from_numpy(w * mask).to(dev, dtype)


BF16 = torch.bfloat16
STRIP_CASES = [(1, 1024, 1024, BF16), (3, 1024, 2048, BF16),
               (8, 3072, 1024, BF16), (130, 1024, 3072, BF16),
               (5, 1024, 1024, torch.float32)]


@pytest.mark.parametrize("M,K,N,dtype", STRIP_CASES)
@pytest.mark.parametrize("fmt", ["block", "combined"])
def test_strip_kernels(cuda, fmt, M, K, N, dtype):
    w = tile_zeroed(M, K, N, cuda, dtype)
    pad = K // 128 + 1                         # more slots than any count
    if fmt == "block":
        pw, _ = pruning.block_semi_structured(w, 0.5, block=128)
        pack = sparsity.pack_block_sparse(pw, 128, 128, pad_to=pad)
        mod, kernel, plain = bsr_mod, bsr_mod.bsr_matmul, ref.bsr_matmul_ref
    else:
        pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=128, block=128)
        pack = sparsity.pack_combined(pw, 2, 4, 128, 128, pad_to=pad)
        mod, kernel, plain = csa_mod, csa_mod.csa_matmul, ref.csa_matmul_ref
    counts = pack.counts.tolist()
    assert counts[-1] == 0 and max(counts) < pack.max_nnz
    x = randn(1, (M, K), cuda).to(dtype)
    before = mod.launches
    got = kernel(x, pack)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    close(got, plain(x, pack))
    close(got, x.float() @ pw.float())
    assert (got[:, -128:] == 0).all()


@pytest.mark.parametrize("M,K,N,dtype", STRIP_CASES)
def test_lookahead_kernel(cuda, M, K, N, dtype):
    pw, _ = pruning.block_semi_structured(tile_zeroed(M, K, N, cuda, dtype),
                                          0.5, block=4)
    pack = sparsity.LookaheadPack.from_float(pw)
    x = randn(2, (M, K), cuda).to(dtype)
    before = lookahead_mod.launches
    got = lookahead_mod.lookahead_matmul(x, pack)
    torch.cuda.synchronize()
    assert lookahead_mod.launches == before + 1
    close(got, ref.lookahead_matmul_ref(x, pack))
    close(got, (x.float() @ pack.decode()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lookahead_kernel_is_bit_exact(cuda, dtype):
    """Identity x, integer weights in [-64, 63], scale 1: the kernel
    returns the weights exactly, on the tensor-core route (bf16) as on
    the FMA route (fp32)."""
    w = np.random.default_rng(8).integers(-64, 64, size=(256, 128)).astype(
        np.int8)
    enc = encoding.encode_weight_matrix(torch.from_numpy(w)).to(cuda)
    pack = sparsity.LookaheadPack(
        enc=enc, scale=torch.ones((1, 128), device=cuda), K=256, N=128)
    assert lookahead_mod.plan(256, 256, 128, dtype)["route"] == \
        ("mma" if dtype == torch.bfloat16 else "fma")
    before = lookahead_mod.launches
    out = lookahead_mod.lookahead_matmul(
        torch.eye(256, device=cuda, dtype=dtype), pack)
    torch.cuda.synchronize()
    assert lookahead_mod.launches == before + 1
    assert torch.equal(out.float().cpu(), torch.from_numpy(w).float())


# the seven projections of one qwen3-0.6b layer, (K, N)
QWEN3 = {"wq": (1024, 2048), "wk": (1024, 1024), "wv": (1024, 1024),
         "wo": (2048, 1024), "w_in": (1024, 3072), "w_gate": (1024, 3072),
         "w_out": (3072, 1024)}
RAGGED_M = [1, 5, 8, 17, 130, 200]


def qwen3_weight(name, dtype, dev):
    K, N = QWEN3[name]
    seed = sorted(QWEN3).index(name)
    return (randn(seed, (K, N), dev).float() / K ** 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", RAGGED_M)
@pytest.mark.parametrize("proj", sorted(QWEN3))
def test_nm_spmm_ragged_m(cuda, proj, M, dtype):
    """Every tile edge of both routes: ragged M on each projection."""
    w, _ = pruning.n_m(qwen3_weight(proj, dtype, cuda), 2, 4, group=128)
    pack = sparsity.pack_nm(w, 2, 4, g=128)
    x = randn(100 + M, (M, pack.K), cuda).to(dtype)
    before = nm_mod.launches
    got = nm_mod.nm_spmm(x, pack)
    torch.cuda.synchronize()
    assert nm_mod.launches == before + 1
    close(got, ref.nm_spmm_ref(x, pack))


@pytest.mark.parametrize("M", [5, 130])
@pytest.mark.parametrize("g,N", [(32, 96), (64, 192)])
def test_nm_spmm_narrow_tiles(cuda, g, N, M):
    """Column groups narrower than 128 take the 32- and 64-column tiles."""
    w, _ = pruning.n_m((randn(3, (1024, N), cuda).float() / 32).to(BF16), 2,
                       4, group=g)
    pack = sparsity.pack_nm(w, 2, 4, g=g)
    assert nm_mod.plan(M, 1024, N, BF16, 2, 4, g)["bn"] == g
    x = randn(4, (M, 1024), cuda)
    close(nm_mod.nm_spmm(x, pack), ref.nm_spmm_ref(x, pack))


@pytest.mark.parametrize("M", [5, 130])
@pytest.mark.parametrize("N", [96, 192])
def test_lookahead_narrow_tiles(cuda, N, M):
    """Widths that are no multiple of 128 take the narrower tiles."""
    pack = sparsity.LookaheadPack.from_float(
        randn(5, (1024, N), cuda).float() / 32)
    assert lookahead_mod.plan(M, 1024, N, BF16)["bn"] == N // 3
    x = randn(6, (M, 1024), cuda)
    close(lookahead_mod.lookahead_matmul(x, pack),
          ref.lookahead_matmul_ref(x, pack))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", RAGGED_M)
@pytest.mark.parametrize("proj", sorted(QWEN3))
def test_lookahead_ragged_m(cuda, proj, M, dtype):
    pw, _ = pruning.block_semi_structured(qwen3_weight(proj, dtype, cuda),
                                          0.5, block=4)
    pack = sparsity.LookaheadPack.from_float(pw)
    x = randn(200 + M, (M, pack.K), cuda).to(dtype)
    before = lookahead_mod.launches
    got = lookahead_mod.lookahead_matmul(x, pack)
    torch.cuda.synchronize()
    assert lookahead_mod.launches == before + 1
    close(got, ref.lookahead_matmul_ref(x, pack))


STRIP_KERNELS = {"block": (bsr_mod, bsr_mod.bsr_matmul, ref.bsr_matmul_ref),
                 "combined": (csa_mod, csa_mod.csa_matmul,
                              ref.csa_matmul_ref)}


def strip_pack(fmt, w, pad=None):
    """The pruned weight and its block or combined pack of (128, 128)
    tiles, padded to ``pad`` slots per strip (default: the largest
    count)."""
    if fmt == "block":
        pw, _ = pruning.block_semi_structured(w, 0.5, block=128)
        return pw, sparsity.pack_block_sparse(pw, 128, 128, pad_to=pad)
    pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=128, block=128)
    return pw, sparsity.pack_combined(pw, 2, 4, 128, 128, pad_to=pad)


def run_strip(fmt, x, pack):
    """One launch of the format's kernel, on the route its plan names."""
    mod, kernel, _ = STRIP_KERNELS[fmt]
    M, K = x.shape
    assert mod.plan(M, K, pack.N, x.dtype, pack.max_nnz)["route"] == \
        ("mma" if x.dtype == BF16 else "fma")
    before = mod.launches
    got = kernel(x, pack)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", RAGGED_M)
@pytest.mark.parametrize("proj", sorted(QWEN3))
@pytest.mark.parametrize("fmt", ["block", "combined"])
def test_strip_kernels_ragged_m(cuda, fmt, proj, M, dtype):
    """Every tile edge of both routes on each projection, on a pack padded
    to ``Kb`` slots per strip as converted JAX packs are (the largest
    layer's ``max_nnz``); the emptied last strip comes back zero."""
    K, N = QWEN3[proj]
    w = tile_zeroed(sorted(QWEN3).index(proj), K, N, cuda, dtype)
    pw, pack = strip_pack(fmt, w, pad=K // 128)
    assert pack.counts.tolist()[-1] == 0
    x = randn(300 + M, (M, K), cuda).to(dtype)
    got = run_strip(fmt, x, pack)
    close(got, STRIP_KERNELS[fmt][2](x, pack))
    close(got, x.float() @ pw.float())
    assert (got[:, -128:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [5, 130])
@pytest.mark.parametrize("fmt", ["block", "combined"])
def test_strip_kernels_edge_strips(cuda, fmt, M, dtype):
    """Strip 0 keeps every tile (``counts == max_nnz``, no padding slot),
    strip 1 one tile, strip 2 none (it must come back zero); two calls
    give bitwise equal results."""
    K, N, tile = 2048, 1024, 128
    rng = np.random.default_rng(9)
    Kb = K // tile
    keep = rng.random((Kb, N // tile)) < 0.4
    keep[:, 0] = True
    keep[:, 1:3] = False
    keep[rng.integers(Kb), 1] = True
    w = rng.normal(size=(K, N)).astype(np.float32) / K ** 0.5
    w = torch.from_numpy(w * np.kron(keep, np.ones((tile, tile))))
    pw, pack = strip_pack(fmt, w.to(cuda, dtype))
    assert pack.counts.tolist()[:3] == [Kb, 1, 0] and pack.max_nnz == Kb
    x = randn(400 + M, (M, K), cuda).to(dtype)
    got = run_strip(fmt, x, pack)
    assert torch.equal(got, run_strip(fmt, x, pack))
    close(got, STRIP_KERNELS[fmt][2](x, pack))
    close(got, x.float() @ pw.float())
    assert (got[:, 2 * tile:3 * tile] == 0).all()


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel(cuda, q_dtype):
    B, H, Hk, D, ps, P, mp = 5, 16, 8, 128, 16, 40, 8
    rng = np.random.default_rng(2)
    q = randn(3, (B, H, D), cuda).to(q_dtype)
    kp, vp = randn(4, (P, ps, Hk, D), cuda), randn(5, (P, ps, Hk, D), cuda)
    ptab = torch.from_numpy(rng.integers(1, P, size=(B, 2 * mp)).astype(
        np.int32)).to(cuda)[:, :mp]                 # a column slice
    lens = torch.tensor([0, 5, 16, 100, 128], dtype=torch.int32, device=cuda)
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens)
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("L,kw", [(128, {}), (200, {}),
                                  (96, {"window": 32, "softcap": 30.0})])
def test_flash_attention_kernel(cuda, L, kw):
    q, k, v = (randn(s, (1, h, L, 128), cuda)
               for s, h in ((6, 16), (7, 8), (8, 8)))
    got = flash_mod.flash_attention(q, k, v, **kw)
    close(got, ref.mha_ref(q.float(), k.float(), v.float(), **kw))


# --- the bf16 attention routes (tensor cores) --------------------------------

def flash_inputs(seed, Lq, Lk, H=16, Hk=8, D=128, dtype=torch.bfloat16):
    return (randn(seed, (1, H, Lq, D), CUDA).to(dtype),
            randn(seed + 1, (1, Hk, Lk, D), CUDA).to(dtype),
            randn(seed + 2, (1, Hk, Lk, D), CUDA).to(dtype))


def run_flash(q, k, v, route, **kw):
    p = flash_mod.plan(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                       q.shape[3], q.dtype)
    assert p["route"] == route
    before = flash_mod.launches
    got = flash_mod.flash_attention(q, k, v, **kw)
    assert flash_mod.launches == before + 1
    close(got, ref.mha_ref(q.float(), k.float(), v.float(), **kw))
    return got


@pytest.mark.parametrize("L", [1, 16, 63, 128, 200, 333])
def test_flash_attention_mma(cuda, L):
    run_flash(*flash_inputs(20 + L, L, L), "mma")


@pytest.mark.parametrize("Lq,Lk,H,Hk,D,kw", [
    (37, 200, 16, 8, 128, {}),                                  # suffix
    (200, 200, 16, 8, 128, {"window": 48, "softcap": 30.0}),
    (50, 300, 16, 8, 128, {"window": 64}),                      # both
    (96, 96, 8, 8, 128, {}), (96, 96, 8, 4, 128, {}),           # G = 1, 2
    (96, 96, 16, 4, 128, {"softcap": 20.0}),                    # G = 4
    (150, 150, 16, 8, 64, {}),                                  # D = 64
    (40, 100, 16, 8, 128, {"causal": False}),
])
def test_flash_attention_mma_semantics(cuda, Lq, Lk, H, Hk, D, kw):
    run_flash(*flash_inputs(30, Lq, Lk, H, Hk, D), "mma", **kw)


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("bq", [16, 32, 64])
def test_flash_attention_every_tile(cuda, monkeypatch, bq, bk):
    monkeypatch.setattr(flash_mod, "plan",
                        lambda *a: dict(route="mma", bq=bq, bk=bk))
    q, k, v = flash_inputs(40, 130, 130)
    got = flash_mod.flash_attention(q, k, v, window=70)
    close(got, ref.mha_ref(q.float(), k.float(), v.float(), window=70))


@pytest.mark.parametrize("D", [32, 128, 256])
def test_flash_attention_fma_route(cuda, D):
    dtype = torch.float32 if D == 128 else torch.bfloat16
    run_flash(*flash_inputs(50, 70, 70, D=D, dtype=dtype), "fma")


def paged_inputs(seed, B, Q, H=16, Hk=8, D=128, ps=16, P=40, mp=8,
                 lens=None, q_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    shape = (B, H, D) if Q == 1 else (B, Q, H, D)
    q = randn(seed, shape, CUDA).to(q_dtype)
    kp, vp = (randn(seed + i, (P, ps, Hk, D), CUDA) for i in (1, 2))
    ptab = torch.from_numpy(rng.integers(1, P, size=(B, 2 * mp)).astype(
        np.int32)).to(CUDA)[:, 3:3 + mp]       # a column slice
    if lens is None:
        lens = rng.integers(0, mp * ps + 1, size=B)
    lens = torch.tensor(lens, dtype=torch.int32, device=CUDA)
    return q, kp, vp, ptab, lens


def run_paged(q, kp, vp, ptab, lens, route, **kw):
    Q = 1 if q.dim() == 3 else q.shape[1]
    p = paged_mod.plan(q.shape[0], q.shape[-2], kp.shape[2], Q,
                       ptab.shape[1], q.shape[-1], (q.dtype, kp.dtype),
                       kp.shape[1])
    assert p["route"] == route
    before = paged_mod.launches
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens, **kw)
    assert paged_mod.launches == before + 1
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens, **kw))
    return got


def test_paged_attention_mma_lens(cuda):
    """lens 0, 1, 15, 16, 17 and the full view (and past it, clamped)
    over a column-sliced page table; a dead row is exactly zero and two
    calls are bitwise equal."""
    args = paged_inputs(60, 7, 1, lens=[0, 1, 15, 16, 17, 128, 200])
    got = run_paged(*args, "mma")
    assert (got[0] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


@pytest.mark.parametrize("Q", [2, 4, 8])
def test_paged_attention_verify_block(cuda, Q):
    """A (B, Q, H, D) block, G = 2: query i sees lens - (Q - 1 - i) keys;
    rows that see none are zero."""
    args = paged_inputs(70 + Q, 6, Q, lens=[0, 1, Q - 1, 16, 77, 128])
    got = run_paged(*args, "mma")
    assert (got[0] == 0).all() and (got[1, :Q - 1] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_paged_attention_every_split(cuda, monkeypatch, warps, split):
    monkeypatch.setattr(paged_mod, "plan", lambda *a: dict(
        route="mma", warps=warps, split=split,
        ring=tiling.paged_ring(12, warps * split)))   # 6 pages of 32 rows
    q, kp, vp, ptab, lens = paged_inputs(80, 5, 4, H=16, Hk=4, D=64, ps=32,
                                         mp=6, lens=[0, 3, 40, 150, 192])
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens)
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens))
    assert (got[0] == 0).all()


def test_paged_attention_fma_route(cuda):
    run_paged(*paged_inputs(90, 5, 1, D=256, lens=[0, 5, 16, 100, 128]),
              "fma")
    run_paged(*paged_inputs(91, 5, 1, q_dtype=torch.float32), "fma")


#: gemma's paged decode: (what, H, Hk, D, q dtype, route) — gemma2's heads
#: with its softcap of 50 on the tensor cores (and with fp32 q on the FMA
#: route), gemma3's D = 256 over one kv head (bf16 takes the FMA route)
GEMMA_PAGED = [("gemma2", 32, 16, 128, torch.bfloat16, "mma", 50.0),
               ("gemma2-fp32q", 32, 16, 128, torch.float32, "fma", 50.0),
               ("gemma3", 4, 1, 256, torch.bfloat16, "fma", None)]


@pytest.mark.parametrize("window", [1, 16, 40, 100])
@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("what,H,Hk,D,dtype,route,softcap", GEMMA_PAGED,
                         ids=[g[0] for g in GEMMA_PAGED])
def test_paged_attention_window_softcap(cuda, what, H, Hk, D, dtype, route,
                                        softcap, Q, window):
    """A sliding window (and gemma2's softcap) on both routes, one query
    or a Q = 4 verify block, lens past the window so the mask bites
    (and lens past the view, clamped); rows that see no key are zero and
    the call counts as a window launch."""
    args = paged_inputs(100 + Q + window, 7, Q, H=H, Hk=Hk, D=D,
                        q_dtype=dtype, lens=[0, 1, 17, 64, 101, 128, 150])
    before = paged_mod.window_launches
    got = run_paged(*args, route, window=window, softcap=softcap)
    assert paged_mod.window_launches == before + 1
    assert (got[0] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(
        *args, window=window, softcap=softcap))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_paged_attention_window_every_split(cuda, monkeypatch, warps, split):
    """Under a window the parts of every (warps, split) start at the
    first chunk the tile's lowest query reaches."""
    monkeypatch.setattr(paged_mod, "plan", lambda *a: dict(
        route="mma", warps=warps, split=split,
        ring=tiling.paged_ring(16, warps * split)))
    q, kp, vp, ptab, lens = paged_inputs(110, 5, 4, H=32, Hk=16, mp=16,
                                         lens=[3, 40, 97, 200, 256])
    for window in (5, 33, 120):
        got = paged_mod.paged_attention(q, kp, vp, ptab, lens,
                                        window=window, softcap=50.0)
        close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens,
                                           window=window, softcap=50.0))


def test_paged_attention_softcap_alone(cuda):
    """A softcap without a window moves the output (the scores of
    random q and k reach past the cap) and is no window launch."""
    args = paged_inputs(120, 4, 1, lens=[5, 60, 100, 128])
    q = args[0] * 8                       # logits well past a cap of 5
    before = paged_mod.window_launches
    got = run_paged(q, *args[1:], "mma", softcap=5.0)
    assert paged_mod.window_launches == before
    assert (got.float() - paged_mod.paged_attention(q, *args[1:]).float()
            ).abs().max() > 0.05


@pytest.mark.parametrize("H,Hk", [(16, 8), (16, 2)])
@pytest.mark.parametrize("Q", [2, 4, 16])
def test_paged_attention_fma_verify_block(cuda, Q, H, Hk):
    """fp32 q as a (B, Q, H, D) block on the fma route, one block per 8
    query rows (Q * G = 4 to 128): query i sees lens - (Q - 1 - i) keys,
    past the view's end too; rows that see none are zero."""
    args = paged_inputs(95 + Q, 6, Q, H=H, Hk=Hk, q_dtype=torch.float32,
                        lens=[0, 1, Q - 1, 16, 77, 140])
    got = run_paged(*args, "fma")
    assert (got[0] == 0).all() and (got[1, :Q - 1] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


@pytest.mark.parametrize("Q", [9, 16])
def test_paged_attention_row_tiles(cuda, Q):
    """bf16 blocks of Q * G = 18 and 32 query rows (G = 2): two row tiles
    of the m16 tile on the tensor cores, each with its own walk."""
    args = paged_inputs(110 + Q, 6, Q, lens=[0, 1, Q - 1, 16, 77, 128])
    p = paged_mod.plan(6, 16, 8, Q, 8, 128, (BF16, BF16), 16)
    assert p["grid"] == (2 * 6 * 8 * p["split"],)
    got = run_paged(*args, "mma")
    assert (got[0] == 0).all() and (got[1, :Q - 1] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


# --- D = 160: stablelm-12b's 32 query heads over 8 kv heads of 160 ----------

D160 = dict(H=32, Hk=8, D=160)


@pytest.mark.parametrize("Lq,Lk,kw", [
    (1, 1, {}), (63, 63, {}), (128, 128, {}), (200, 200, {}), (333, 333, {}),
    (37, 200, {}), (200, 200, {"window": 48, "softcap": 30.0})])
def test_flash_attention_d160_mma(cuda, Lq, Lk, kw):
    run_flash(*flash_inputs(120, Lq, Lk, **D160), "mma", **kw)


@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("bq", [16, 32, 64])
def test_flash_attention_d160_every_tile(cuda, monkeypatch, bq, bk):
    monkeypatch.setattr(flash_mod, "plan",
                        lambda *a: dict(route="mma", bq=bq, bk=bk))
    q, k, v = flash_inputs(130, 150, 150, **D160)
    got = flash_mod.flash_attention(q, k, v, window=70)
    close(got, ref.mha_ref(q.float(), k.float(), v.float(), window=70))


@pytest.mark.parametrize("L", [70, 200])
def test_flash_attention_d160_fma(cuda, L):
    run_flash(*flash_inputs(140, L, L, dtype=torch.float32, **D160), "fma")


@pytest.mark.parametrize("Q", [1, 4, 16])
def test_paged_attention_d160_mma(cuda, Q):
    """G = 4: one query per slot (4 rows), a Q = 4 verify block (one full
    row tile) and Q = 16 (four row tiles); dead rows zero, two calls
    bitwise equal."""
    args = paged_inputs(150 + Q, 6, Q, lens=[0, 1, Q - 1 or 1, 16, 77, 200],
                        **D160)
    got = run_paged(*args, "mma")
    assert (got[0] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_paged_attention_d160_every_split(cuda, monkeypatch, warps, split):
    monkeypatch.setattr(paged_mod, "plan", lambda *a: dict(
        route="mma", warps=warps, split=split,
        ring=tiling.paged_ring(8, warps * split)))    # 8 pages of 16 rows
    q, kp, vp, ptab, lens = paged_inputs(160, 5, 4, lens=[0, 3, 40, 100, 128],
                                         **D160)
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens)
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens))
    assert (got[0] == 0).all()


@pytest.mark.parametrize("pools", ["bf16", "fp32"])
@pytest.mark.parametrize("Q", [1, 4])
def test_paged_attention_d160_fma(cuda, Q, pools):
    q, kp, vp, ptab, lens = paged_inputs(
        170 + Q, 6, Q, q_dtype=torch.float32, lens=[0, 1, 16, 77, 128, 140],
        **D160)
    if pools == "fp32":
        kp, vp = kp.float(), vp.float()
    got = run_paged(q, kp, vp, ptab, lens, "fma")
    assert (got[0] == 0).all()


# --- G = 8: qwen2-vl-72b's 64 query heads over 8 kv heads of 128 ------------

G8 = dict(H=64, Hk=8, D=128)


@pytest.mark.parametrize("Lq,Lk,kw", [
    (1, 1, {}), (63, 63, {}), (128, 128, {}), (200, 200, {}), (37, 200, {}),
    (200, 200, {"window": 48, "softcap": 30.0})])
def test_flash_attention_g8_mma(cuda, Lq, Lk, kw):
    run_flash(*flash_inputs(180, Lq, Lk, **G8), "mma", **kw)


@pytest.mark.parametrize("Q", [1, 2, 4, 16])
def test_paged_attention_g8_mma(cuda, Q):
    """G = 8: one query per slot (8 rows, half an m16 tile), Q = 2 (one
    full tile), Q = 4 (two row tiles) and Q = 16 (eight); dead rows
    zero, two calls bitwise equal."""
    args = paged_inputs(190 + Q, 6, Q, lens=[0, 1, Q - 1 or 1, 16, 77, 200],
                        **G8)
    got = run_paged(*args, "mma")
    assert (got[0] == 0).all()
    assert torch.equal(got, paged_mod.paged_attention(*args))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_paged_attention_g8_every_split(cuda, monkeypatch, warps, split):
    monkeypatch.setattr(paged_mod, "plan", lambda *a: dict(
        route="mma", warps=warps, split=split,
        ring=tiling.paged_ring(8, warps * split)))    # 8 pages of 16 rows
    q, kp, vp, ptab, lens = paged_inputs(200, 5, 1, lens=[0, 3, 40, 100, 128],
                                         **G8)
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens)
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens))
    assert (got[0] == 0).all()


def test_attention_unsupported_shapes_raise(cuda):
    """A bf16 call no route takes raises rather than falling back."""
    q, kp, vp, ptab, lens = paged_inputs(92, 2, 4, lens=[5, 9])
    with pytest.raises(TypeError):           # bf16 q over fp32 pools
        paged_mod.paged_attention(q, kp.float(), vp.float(), ptab, lens)
    with pytest.raises(ValueError):          # no paged kernel for D = 96
        paged_mod.paged_attention(*paged_inputs(93, 2, 2, D=96, lens=[5, 9]))
    with pytest.raises(ValueError):          # no kernel for D = 96
        flash_mod.flash_attention(*flash_inputs(94, 8, 8, D=96))


FORMATS = {
    "nm": (dict(format="nm", n=2, m=4, block_n=128), nm_mod),
    "combined": (dict(format="combined", sparsity=0.5, n=2, m=4,
                      block_k=128, block_n=128), csa_mod),
    "block": (dict(format="block", sparsity=0.5, block_k=128, block_n=128),
              bsr_mod),
    "lookahead": (dict(format="lookahead", sparsity=0.5), lookahead_mod),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_paged_engine_runs_the_kernels(cuda, fmt):
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.core.sparse_linear import SparsityConfig, pack_params
    from repro_torch.serving import Engine, ServeConfig
    fields, mod = FORMATS[fmt]
    sp = SparsityConfig(**fields)
    cfg = dataclasses.replace(qwen3_0_6b.config(), n_layers=2,
                              layer_kinds=(), mlp_sparsity=sp,
                              attn_sparsity=sp)
    params = pack_params(models.init_model(cfg, seed=0, device=cuda), cfg)
    eng = Engine(cfg, ServeConfig(slots=2, max_len=96, prompt_pad=32,
                                  page_size=16, decode_chunk=4,
                                  max_new_tokens=6, eos_token=-1), params,
                 device=cuda)
    mods = (mod, paged_mod, flash_mod)
    counts = [m.launches for m in mods]
    outs = eng.generate([[1, 2, 3], list(range(5, 40))])
    assert [len(o) for o in outs] == [6, 6]
    assert all(m.launches > c for m, c in zip(mods, counts))
    assert eng.sync_count == len(eng.stats().chunk_s)


def test_prefix_serve_equals_the_cpu(cuda):
    """A prefix-sharing serve on the card (2-layer qwen3-0.6b, nm, fp32):
    a pinned head, two requests led by it, a repeat (full match) and a
    divergence inside a page give the CPU port's tokens and counts, with
    the flash kernel run on the suffixes."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.core.sparse_linear import pack_params
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(qwen3_0_6b.sparse(), n_layers=2,
                              layer_kinds=(), dtype="float32")
    params = pack_params(models.init_model(cfg, seed=0, device=cuda), cfg)
    scfg = ServeConfig(slots=2, max_len=96, prompt_pad=64, page_size=16,
                       prompt_buckets=16, decode_chunk=4, max_new_tokens=6,
                       eos_token=-1, prefix_cache=True)
    rng = np.random.default_rng(0)
    head = rng.integers(1, cfg.vocab_size, 32).astype(np.int32)
    tails = [rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
             for _ in range(3)]

    def serve(dev, p):
        eng = Engine(cfg, scfg, p, device=dev)
        h = eng.register_prefix(head)
        hs = [eng.submit(t, prefix=h) for t in tails[:2]]
        hs.append(eng.submit(np.concatenate([head, tails[0]])))
        hs.append(eng.submit(np.concatenate([head[:20], tails[2][:12]])))
        eng.run()
        st = eng.stats()
        return ([x.tokens for x in hs],
                (st.prefix_hits, st.shared_pages, st.cow_copies))

    before = flash_mod.suffix_launches
    card = serve(cuda, params)
    assert flash_mod.suffix_launches - before == 4 * cfg.n_layers
    cpu = serve("cpu", {k: _to_cpu(v) for k, v in params.items()})
    assert card == cpu
    assert card[1] == (4, 7, 2)


# --- the decode chunk as captured CUDA graphs --------------------------------

#: views of 2, 4, ... pages of 8 rows: a 24-token serve crosses two view
#: buckets, each seen by several chunks (the first eager, then a capture
#: and replays)
GRAPH_SERVE = dict(slots=4, max_len=96, prompt_pad=32, page_size=8,
                   page_view_chunk=2, decode_chunk=4, max_new_tokens=24,
                   eos_token=-1)
GRAPH_PROMPTS = [[3, 1, 4, 1, 5], list(range(7, 40)), [2, 7, 1, 8, 2, 8],
                 list(range(50, 70)), [9] * 11, list(range(100, 131))]
COUNTERS = (nm_mod, csa_mod, bsr_mod, lookahead_mod, paged_mod, flash_mod)


def _graph_model(cuda, fmt="nm", dtype="float32", **kw):
    """(config, ServeConfig, params) of the 2-layer qwen3 the graph tests
    serve at ``GRAPH_SERVE``."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.core.sparse_linear import SparsityConfig, pack_params
    from repro_torch.serving import ServeConfig
    sp = SparsityConfig(**FORMATS[fmt][0])
    cfg = dataclasses.replace(qwen3_0_6b.config(), n_layers=2,
                              layer_kinds=(), dtype=dtype, mlp_sparsity=sp,
                              attn_sparsity=sp)
    params = pack_params(models.init_model(cfg, seed=0, device=cuda), cfg)
    return cfg, ServeConfig(**dict(GRAPH_SERVE, **kw)), params


def _graph_engine(cuda, fmt="nm", dtype="float32", **kw):
    from repro_torch.serving import Engine
    cfg, scfg, params = _graph_model(cuda, fmt, dtype, **kw)
    return lambda: Engine(cfg, scfg, params, device=cuda)


def _serve(eng, prompts=GRAPH_PROMPTS):
    """Serve ``prompts``: (tokens per request, sync_count, launches per
    kernel module, stats), the counts of this serve only."""
    eng.reset_stats()
    before = [m.launches for m in COUNTERS]
    handles = [eng.submit(p) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    launches = {m.__name__: m.launches - n for m, n in zip(COUNTERS, before)}
    st = eng.stats()
    return [h.tokens for h in handles], st.sync_count, launches, st


def _check_graph_runs(st, seen):
    """Each chunk of ``st.chunk_runs`` ran as the rule says — a key's
    first chunk ever eagerly, its second as a capture, every later one as
    a replay — and the captures recorded are those chunks' keys.
    ``seen`` counts chunks per key across serves (updated)."""
    captured = []
    for key, how in st.chunk_runs:
        n = seen.get(key, 0)
        assert how == ("eager", "capture", "replay")[min(n, 2)], (key, n)
        seen[key] = n + 1
        if how == "capture":
            captured.append(key)
    assert [tuple(c["key"]) for c in st.graph_captures] == captured
    return captured


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["nm", "combined"])
def test_graph_serve_equals_eager(cuda, fmt, dtype):
    """A serve through the captured chunk graphs gives the eager serve's
    tokens, ``sync_count`` and launches per kernel exactly; each key is
    captured once (at its second chunk) and replayed after, also in a
    second serve on the warm engine."""
    make = _graph_engine(cuda, fmt, dtype)
    eager = make()
    eager._backend._graphs = False
    want = _serve(eager)
    assert {how for _, how in want[3].chunk_runs} == {"eager"}
    graph, seen = make(), {}
    cold = _serve(graph)
    assert cold[:3] == want[:3]
    assert len(_check_graph_runs(cold[3], seen)) >= 2
    warm = _serve(graph)
    assert warm[:3] == want[:3]
    _check_graph_runs(warm[3], seen)
    chunks = graph._backend._chunks.values()
    assert sum(c.graph is not None for c in chunks) == \
        sum(n > 1 for n in seen.values())


def test_sampled_graph_chunks_advance_the_generator(cuda):
    """Sampled chunks run as graphs with the engine's generator
    registered: successive replays draw different noise (the generator's
    state moves at every replay), and an engine built with the same seed
    repeats its tokens."""
    make = _graph_engine(cuda, temperature=0.9, seed=5)
    eng = make()
    handles = [eng.submit(p) for p in GRAPH_PROMPTS]
    states, hows = [], []
    while eng.num_queued or eng.num_live:
        eng.step()
        states.append(eng._gen.get_state().clone())
        hows.append(eng.stats().chunk_runs[-1])
    assert all(key[1] for key, _ in hows)        # every chunk sampled
    replays = [i for i, (_, how) in enumerate(hows) if how == "replay"]
    assert len(replays) >= 2
    for i in replays:
        assert not torch.equal(states[i], states[i - 1]), i
    first = [h.tokens for h in handles]
    again = make()
    assert again.generate(GRAPH_PROMPTS) == first
    eager = make()
    eager._backend._graphs = False
    assert eager.generate(GRAPH_PROMPTS) == first
    other = _graph_engine(cuda, temperature=0.9, seed=6)()
    assert other.generate(GRAPH_PROMPTS) != first


@pytest.mark.parametrize("draft,temperature", [("self", 0.0),
                                               ("pack", 0.0),
                                               ("self", 0.9)])
def test_spec_graph_serve_equals_eager(cuda, draft, temperature):
    """Speculative serves (2-layer qwen3-0.6b nm, fp32, spec_k = 3) as
    captured chunk graphs give the eager serve's tokens, ``sync_count``,
    drafted and accepted counts and launches per kernel (verify blocks
    included) exactly, cold and warm; the pack draft runs nm_spmm on
    dense verify weights, a self draft accepts (nearly) everything."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.core.sparse_linear import pack_params
    from repro_torch.serving import Engine, ServeConfig
    cfg = dataclasses.replace(qwen3_0_6b.sparse(), n_layers=2,
                              layer_kinds=(), dtype="float32")
    params = models.init_model(cfg, seed=0, device=cuda)
    if draft == "self":
        params = pack_params(params, cfg)
    scfg = ServeConfig(**dict(GRAPH_SERVE, spec_k=3, spec_draft=draft,
                              temperature=temperature, seed=5))

    def run(graphs):
        eng = Engine(cfg, scfg, params, device=cuda)
        eng._backend._graphs = graphs
        out, hows = [], set()
        for _ in range(2):
            blocks = paged_mod.block_launches
            tokens, syncs, launches, st = _serve(eng)
            out.append((tokens, syncs, launches, st.drafted, st.accepted,
                        paged_mod.block_launches - blocks))
            hows |= {how for _, how in st.chunk_runs}
        return out, hows

    eager, _ = run(False)
    graph, hows = run(True)
    assert graph == eager
    assert {"eager", "capture"} <= hows
    tokens, syncs, launches, drafted, accepted, blocks = graph[0]
    steps = syncs * scfg.decode_chunk
    assert blocks == cfg.n_layers * steps                # one verify a step
    assert launches["repro_torch.kernels.paged_attention"] == \
        cfg.n_layers * steps * (scfg.spec_k + 1)
    if draft == "pack":
        assert launches["repro_torch.kernels.nm_spmm"] == \
            7 * cfg.n_layers * steps * scfg.spec_k
    else:
        assert accepted / drafted > 0.9
    assert all(len(t) == 24 for t in tokens)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.to("cpu")


# --- the paper layer's shapes and routes -------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 8, 130, 256])
def test_nm_spmm_one_of_four(cuda, M, dtype):
    """1:4 packs (a quarter of K kept) on both routes."""
    K = N = 2048
    w, _ = pruning.n_m((randn(2, (K, N), cuda) / K ** 0.5).to(dtype), 1, 4,
                       group=128)
    pack = sparsity.pack_nm(w, 1, 4, g=128)
    x = randn(3, (M, K), cuda).to(dtype)
    route = "mma" if dtype == torch.bfloat16 else "fma"
    assert nm_mod.plan(M, K, N, dtype, 1, 4, 128)["route"] == route
    before = nm_mod.launches
    got = nm_mod.nm_spmm(x, pack)
    torch.cuda.synchronize()
    assert nm_mod.launches == before + 1
    close(got, ref.nm_spmm_ref(x, pack))
    close(got, x.float() @ w.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bench_kernels_shape(cuda, dtype):
    """Every pack of ``benchmarks/bench_kernels`` at its (256, 2048, 2048)
    shape through ``dispatch.sparse_matmul``: one launch of its kernel,
    equal to the plain version."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import dispatch
    M, K, N = bench_kernels.SHAPE
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        cuda, dtype)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mods = {sparsity.NMPack: nm_mod, sparsity.BlockSparsePack: bsr_mod,
            sparsity.CombinedPack: csa_mod,
            sparsity.LookaheadPack: lookahead_mod}
    for label, weight, _ in bench_kernels.packs(w, dtype, cuda):
        if isinstance(weight, torch.Tensor):
            continue
        mod = mods[type(weight)]
        before = mod.launches
        got = dispatch.sparse_matmul(x, weight)
        torch.cuda.synchronize()
        assert mod.launches == before + 1, label
        close(got, bench_kernels.entry(weight).run(x, weight, "ref"))


def test_smem_bytes_from_the_libraries(cuda):
    """Table III's ``smem_bytes`` column comes from the built libraries:
    one positive size per format, within an SM's 227 KB."""
    from repro_torch.benchmarks import bench_resources
    rows = bench_resources.run()["rows"]
    sizes = {r["format"]: r["smem_bytes"] for r in rows}
    assert sizes.pop("dense") is None
    assert all(0 < v <= 232448 for v in sizes.values()), sizes


def test_capture_that_syncs_raises(cuda, monkeypatch):
    """A chunk whose capture meets a host sync (a matmul wrapper patched
    to call ``.item()``) raises; the failed chunk is not run eagerly
    instead."""
    from repro_torch.kernels import dispatch
    real = dispatch.nm_spmm

    def syncing(x, pack):
        x.sum().item()
        return real(x, pack)

    eng = _graph_engine(cuda)()
    monkeypatch.setattr(dispatch, "nm_spmm", syncing)
    eng.submit(GRAPH_PROMPTS[0])
    with pytest.raises(RuntimeError):
        eng.run()
    st = eng.stats()
    assert [how for _, how in st.chunk_runs] == ["eager"]
    assert st.graph_captures == [] and st.sync_count == 1
    assert all(c.graph is None for c in eng._backend._chunks.values())


# --- the MoE family --------------------------------------------------------

def _moe_config(arch, dtype, layers=2):
    """``arch``'s ``sparse()`` cut to ``layers``: published widths, 2:4
    experts."""
    import dataclasses
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return dataclasses.replace(mod.sparse(), n_layers=layers,
                               layer_kinds=(), dtype=dtype)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "dbrx_132b"])
def test_moe_sorted_matches_the_cpu_path(cuda, arch):
    """One fp32 MoE layer of packed experts at published widths, 8 decode
    rows (C = 1 or 3, routes dropped) and a 128-row prompt: the card
    (nm_spmm's FMA route) against the same function on the CPU."""
    from repro_torch import models
    from repro_torch.models import moe
    cfg = _moe_config(arch, "float32", layers=1)
    layer = models.init_model(cfg, seed=1, device=cuda,
                              packed=True)["layers"][0]["moe"]
    cpu = {k: ([w.to("cpu") for w in v] if isinstance(v, list) else
               {n: w.to("cpu") for n, w in v.items()}
               if isinstance(v, dict) else v.to("cpu"))
           for k, v in layer.items()}
    g = torch.Generator(device=cuda).manual_seed(2)
    for shape in ((8, 1, cfg.d_model), (1, 128, cfg.d_model)):
        x = torch.randn(shape, generator=g, device=cuda)
        before = nm_mod.launches
        got, _ = moe.moe_sorted(layer, cfg, x)
        assert nm_mod.launches - before == 3 * cfg.n_experts + (
            3 if cfg.n_shared_experts else 0)
        want, _ = moe.moe_sorted(cpu, cfg, x.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "dbrx_132b"])
def test_moe_graph_serve_equals_eager(cuda, arch):
    """A 2-layer bf16 MoE model at published widths through the captured
    chunk graphs gives the eager serve's tokens, ``sync_count`` and
    launches; nm_spmm launches 3 E (+ 3 shared) times per layer and
    forward."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    cfg = _moe_config(arch, "bfloat16")
    params = models.init_model(cfg, seed=0, device=cuda, packed=True)
    scfg = ServeConfig(**GRAPH_SERVE)
    eager = Engine(cfg, scfg, params, device=cuda)
    eager._backend._graphs = False
    want = _serve(eager)
    graph, seen = Engine(cfg, scfg, params, device=cuda), {}
    cold = _serve(graph)
    assert cold[:3] == want[:3]
    assert len(_check_graph_runs(cold[3], seen)) >= 2
    st = want[3]
    steps = len(st.chunk_s) * scfg.decode_chunk
    per = 3 * cfg.n_experts + (3 if cfg.n_shared_experts else 0)
    assert want[2][nm_mod.__name__] == per * cfg.n_layers * (
        st.prefills + steps)


# --- the SSM/hybrid family ---------------------------------------------------

def _zamba_config(dtype, layers=4):
    """zamba2-1.2b's ``sparse()`` cut to its first ``layers`` layers
    (``zamba_kinds(38, 6)[:4]``: the shared block runs before layer 3):
    published widths, 2:4 ``out_proj`` and shared MLP."""
    import dataclasses

    from repro_torch.configs import zamba2_1_2b
    cfg = zamba2_1_2b.sparse()
    return dataclasses.replace(cfg, n_layers=layers,
                               layer_kinds=cfg.layer_kinds[:layers],
                               dtype=dtype)


def _recurrent_ptrs(eng):
    from repro_torch import models
    return [t.data_ptr() for t in
            models.cache_leaves(models.recurrent_state(eng._cache))]


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_hybrid_graph_serve_equals_eager(cuda, page_size):
    """A 4-layer bf16 zamba2 at published widths through the captured
    chunk graphs gives the eager serve's tokens, ``sync_count`` and
    launches, cold and warm; the recurrent state keeps its addresses
    across both serves; nm_spmm launches 4 + 3 times per forward, flash
    once per prefill and paged once per decode step (the one shared
    slot)."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    cfg = _zamba_config("bfloat16")
    params = models.init_model(cfg, seed=0, device=cuda, packed=True)
    scfg = ServeConfig(**dict(GRAPH_SERVE, page_size=page_size))
    eager = Engine(cfg, scfg, params, device=cuda)
    eager._backend._graphs = False
    want = _serve(eager)
    graph, seen = Engine(cfg, scfg, params, device=cuda), {}
    cold = _serve(graph)
    ptrs = _recurrent_ptrs(graph)
    assert cold[:3] == want[:3]
    assert len(_check_graph_runs(cold[3], seen)) >= 1
    warm = _serve(graph)
    assert warm[:3] == want[:3]
    assert _recurrent_ptrs(graph) == ptrs
    st = want[3]
    steps = len(st.chunk_s) * scfg.decode_chunk
    # one flash launch per prefill call (a monolithic wave is one call
    # for all its slots)
    calls = want[2][flash_mod.__name__]
    assert calls == st.prefills if page_size else 0 < calls < st.prefills
    assert want[2][nm_mod.__name__] == (cfg.n_layers + 3) * (calls + steps)
    assert want[2][paged_mod.__name__] == (steps if page_size else 0)
    assert all(len(t) == 24 for t in want[0])


def test_hybrid_garbage_draft_rollback_equals_the_plain_loop(cuda):
    """zamba2 at 4 layers in fp32, speculative with a draft from another
    seed (rejected almost always: every step rolls the recurrent state
    back): the tokens equal the plain loop's, and the graph serve equals
    the eager one (tokens, syncs, drafted, accepted, launches)."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    cfg = _zamba_config("float32")
    params = models.init_model(cfg, seed=0, device=cuda, packed=True)
    garbage = models.init_model(cfg, seed=42, device=cuda, packed=True)
    want = _serve(Engine(cfg, ServeConfig(**GRAPH_SERVE), params,
                         device=cuda))[0]
    spec = ServeConfig(**dict(GRAPH_SERVE, spec_k=3))
    runs = []
    for graphs in (False, True):
        eng = Engine(cfg, spec, params, draft_params=garbage, device=cuda)
        eng._backend._graphs = graphs
        tokens, syncs, launches, st = _serve(eng)
        runs.append((tokens, syncs, launches, st.drafted, st.accepted))
        assert tokens == want
        assert st.accepted < 0.5 * st.drafted
    assert runs[0] == runs[1]


# --- the enc-dec family (seamless-m4t-large-v2) ------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Lq,Lk", [(8, 6), (128, 512), (300, 300), (37, 200)])
def test_flash_attention_non_causal_d64_g1(cuda, Lq, Lk, dtype):
    """Non-causal flash at seamless's heads (16 over 16, D = 64): more
    queries than keys (a negative suffix offset), fewer (the prompt's
    cross-attention over the source) and as many (the encoder); bf16 on
    the tensor-core route, fp32 on the FMA route."""
    run_flash(*flash_inputs(40 + Lq, Lq, Lk, 16, 16, 64, dtype),
              "mma" if dtype == torch.bfloat16 else "fma", causal=False)


def _seamless_config(dtype, layers=2):
    """seamless-m4t-large-v2's ``sparse()`` at published widths, cut to
    ``layers`` encoder and decoder layers: 2:4 MLPs, dense attention."""
    import dataclasses

    from repro_torch.configs import seamless_m4t_large_v2
    return dataclasses.replace(seamless_m4t_large_v2.sparse(),
                               n_layers=layers, n_encoder_layers=layers,
                               layer_kinds=(), dtype=dtype)


@pytest.mark.parametrize("page_size", [0, 8], ids=["mono", "paged"])
def test_encdec_graph_serve_equals_eager(cuda, page_size):
    """A 2 + 2-layer bf16 seamless at published widths through the
    captured chunk graphs gives the eager serve's tokens, ``sync_count``
    and launches, cold and warm; the cross K/V keep their addresses.
    Per prefill call flash launches once per encoder layer and twice per
    decoder layer (self and cross), nm_spmm twice per layer of both
    stacks; per decode step nm_spmm twice per decoder layer and paged
    once (paged layout)."""
    from repro_torch import models
    from repro_torch.serving import Engine, ServeConfig
    cfg = _seamless_config("bfloat16")
    params = models.init_model(cfg, seed=0, device=cuda, packed=True)
    scfg = ServeConfig(**dict(GRAPH_SERVE, page_size=page_size))
    eager = Engine(cfg, scfg, params, device=cuda)
    eager._backend._graphs = False
    want = _serve(eager)
    graph, seen = Engine(cfg, scfg, params, device=cuda), {}
    cold = _serve(graph)
    ptrs = [t.data_ptr() for t in models.cache_leaves(graph._cache["cross"])]
    assert cold[:3] == want[:3]
    assert len(_check_graph_runs(cold[3], seen)) >= 1
    warm = _serve(graph)
    assert warm[:3] == want[:3]
    assert [t.data_ptr() for t in
            models.cache_leaves(graph._cache["cross"])] == ptrs
    st = want[3]
    steps = len(st.chunk_s) * scfg.decode_chunk
    per_call = cfg.n_encoder_layers + 2 * cfg.n_layers
    calls, rest = divmod(want[2][flash_mod.__name__], per_call)
    assert rest == 0
    assert calls == st.prefills if page_size else 0 < calls < st.prefills
    assert want[2][nm_mod.__name__] == \
        2 * (cfg.n_encoder_layers + cfg.n_layers) * calls \
        + 2 * cfg.n_layers * steps
    assert want[2][paged_mod.__name__] == \
        (cfg.n_layers * steps if page_size else 0)
    assert all(len(t) == 24 for t in want[0])


# --- training on the card (the cache-less route: no kernel, no backward) ---

TRAIN_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "zamba2-1.2b",
               "seamless-m4t-large-v2", "gemma2-27b")
KERNEL_MODS = (nm_mod, paged_mod, flash_mod, csa_mod, bsr_mod, lookahead_mod)


def _fp32_reduced(arch):
    import dataclasses
    from repro_torch import configs as C
    return dataclasses.replace(C._module(arch).reduced(), dtype="float32")


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def test_make_batch_on_the_card_equals_the_cpu(cuda):
    from repro_torch.data import DataConfig, make_batch
    for arch in ("qwen3-0.6b", "seamless-m4t-large-v2", "qwen2-vl-72b"):
        cfg = _fp32_reduced(arch)
        d = DataConfig(global_batch=4, seq_len=32)
        a, b = make_batch(cfg, d, 11, "cpu"), make_batch(cfg, d, 11, cuda)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].device.type == "cuda" and torch.equal(a[k],
                                                              b[k].cpu())


#: Adam's epsilon in the step comparison, as in tests/test_torch_train.py:
#: at 1e-8 the first step moves an entry by lr·g/(|g| + 1e-8), about ±lr
#: whatever |g|, so an entry whose gradient is float32 noise moves either
#: way; at 1e-3 the step's gain is at most 1e3 and the comparison holds
STEP_EPS = 1e-3


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_equals_the_cpu(cuda, arch, monkeypatch):
    """Loss and every gradient leaf of a reduced config in fp32 (TF32
    off) on the card against the CPU path, then one train step (Adam at
    ``STEP_EPS``); none of the six kernels launches."""
    import functools

    from repro_torch import models
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, build_train_step, \
        init_opt_state
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import leaves
    cfg = _fp32_reduced(arch)
    params = models.init_model(cfg, seed=0, device="cpu")
    d = DataConfig(global_batch=2, seq_len=24)
    batch = make_batch(cfg, d, 0, "cpu")

    def loss_fn(p, b):
        return models.model_loss(p, cfg, b)

    before = [m.launches for m in KERNEL_MODS]
    l_cpu, g_cpu = value_and_grad(loss_fn, params, batch)
    l_gpu, g_gpu = value_and_grad(loss_fn, _to(params, cuda),
                                  make_batch(cfg, d, 0, cuda))
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-5, atol=0)
    for a, b in zip(leaves(g_gpu), leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-8)
    tcfg = TrainConfig(steps=3, lr=1e-3)
    monkeypatch.setattr(trainer_mod, "AdamWConfig",
                        functools.partial(AdamWConfig, eps=STEP_EPS))
    step = build_train_step(cfg, tcfg)
    p_cpu, o_cpu, m_cpu = step(params, init_opt_state(params, tcfg), batch)
    gp = _to(params, cuda)
    p_gpu, o_gpu, m_gpu = step(gp, init_opt_state(gp, tcfg),
                               make_batch(cfg, d, 0, cuda))
    torch.cuda.synchronize()
    assert [m.launches for m in KERNEL_MODS] == before
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-5,
                                   atol=0)
    for a, b in zip(leaves(o_gpu["mu"]), leaves(o_cpu["mu"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-12)
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()) + 1e-6)


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    w, _ = pruning.n_m(randn(0, (1024, 1024), cuda), 2, 4, group=128)
    pack = sparsity.pack_nm(w, 2, 4, g=128)
    x = randn(1, (8, 1024), cuda).requires_grad_()
    before = nm_mod.launches
    with pytest.raises(RuntimeError, match="no backward"):
        nm_mod.nm_spmm(x, pack)
    assert nm_mod.launches == before
    with torch.no_grad():
        close(nm_mod.nm_spmm(x, pack), ref.nm_spmm_ref(x.detach(), pack))


# --- the small geometries of the serving bench's models ----------------------
# d_model 64 over 4 heads (D = 16), MLPs of 64 <-> 128 packed 2:4 at g = 64
# (K = 64 keeps 32 rows: one half stage) or combined at bk = bn = 64 (32
# kept rows a tile)

@pytest.mark.parametrize("M", [1, 8, 16, 128])
@pytest.mark.parametrize("K,N", [(64, 128), (64, 64), (192, 128)])
def test_nm_spmm_half_stage(cuda, K, N, M):
    p = nm_mod.plan(M, K, N, BF16, 2, 4, 64)
    assert p["route"] == "mma" and p["ks"] == nm_mod.HALF_KS
    w, _ = pruning.n_m(randn(K, (K, N), cuda) / K ** 0.5, 2, 4, group=64)
    pack = sparsity.pack_nm(w, 2, 4, g=64)
    x = randn(M, (M, K), cuda)
    before = nm_mod.launches
    got = nm_mod.nm_spmm(x, pack)
    torch.cuda.synchronize()
    assert nm_mod.launches == before + 1
    close(got, ref.nm_spmm_ref(x, pack))
    close(got, x.float() @ w.float())


@pytest.mark.parametrize("M", [1, 8, 16, 128])
@pytest.mark.parametrize("K,N", [(64, 128), (128, 64), (256, 128)])
@pytest.mark.parametrize("fmt", ["block", "combined"])
def test_strip_kernels_half_stage(cuda, fmt, K, N, M):
    """A combined pack of 64 x 64 tiles keeps 32 rows a tile, a block pack
    of 32 x 64 tiles 32: one half stage each; pruning zeroes about half
    the tiles."""
    bk = 64 if fmt == "combined" else 32
    w = randn(K + M, (K, N), cuda) / K ** 0.5
    if fmt == "block":
        pw, _ = pruning.block_semi_structured(w, 0.5, block=bk)
        pack = sparsity.pack_block_sparse(pw, bk, 64)
        mod, kernel, plain = bsr_mod, bsr_mod.bsr_matmul, ref.bsr_matmul_ref
        p = bsr_mod.plan(M, K, N, BF16, pack.max_nnz, bk, 64)
    else:
        pw, _ = pruning.combined_nm(w, 0.5, 2, 4, group=64, block=64)
        pack = sparsity.pack_combined(pw, 2, 4, 64, 64)
        mod, kernel, plain = csa_mod, csa_mod.csa_matmul, ref.csa_matmul_ref
        p = csa_mod.plan(M, K, N, BF16, pack.max_nnz, 64, 64)
    assert p["route"] == "mma" and p["ks"] == bsr_mod.HALF_KS
    x = randn(M + 1, (M, K), cuda)
    before = mod.launches
    got = kernel(x, pack)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert torch.equal(got, kernel(x, pack))
    close(got, plain(x, pack))
    close(got, x.float() @ pw.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Lq,Lk,kw", [(16, 16, {}), (100, 100, {}),
                                      (37, 90, {}), (64, 64, {"window": 20}),
                                      (48, 48, {"causal": False})])
def test_flash_attention_d16(cuda, Lq, Lk, kw, dtype):
    run_flash(*flash_inputs(110 + Lq, Lq, Lk, H=4, Hk=2, D=16, dtype=dtype),
              "fma", **kw)


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Q", [1, 4])
def test_paged_attention_d16(cuda, Q, q_dtype):
    """The bench's heads (4 over 2, D = 16) on 16-row pages, lens from 0
    past the view's end; a dead row is exactly zero."""
    args = paged_inputs(120 + Q, 6, Q, H=4, Hk=2, D=16, lens=[0, 4, 16, 17,
                                                             100, 200],
                        q_dtype=q_dtype)
    got = run_paged(*args, "fma")
    assert (got[0] == 0).all()


@pytest.mark.parametrize("fmt,kernel", [("nm", nm_mod), ("combined", csa_mod)])
def test_bench_models_serve_through_the_kernels(cuda, fmt, kernel):
    """The serving bench's packed model (D = 16, MLPs 64 <-> 128 at g or
    tiles of 64) served paged on the card: its MLP kernel, flash and
    paged attention all launch, and every request runs its budget."""
    from repro_torch.benchmarks import bench_serving
    from repro_torch.serving import Engine, ServeConfig
    cfg, params = bench_serving._model(fmt, cuda)
    scfg = ServeConfig(slots=4, max_len=64, prompt_pad=16, max_new_tokens=8,
                       decode_chunk=4, eos_token=-1, page_size=16)
    mods = (kernel, flash_mod, paged_mod)
    before = [m.launches for m in mods]
    rng = np.random.default_rng(0)
    outs = Engine(cfg, scfg, params, device=cuda).generate(
        [rng.integers(1, cfg.vocab_size, size=n) for n in (3, 9, 16, 12, 5)])
    assert [len(o) for o in outs] == [8] * 5
    assert all(m.launches > b for m, b in zip(mods, before))


# --- autotune rows and the dry run --------------------------------------------

@pytest.fixture
def fresh_cache(tmp_path):
    from repro_torch.kernels import dispatch
    cache = dispatch.AutotuneCache(str(tmp_path / "autotune.json"))
    old = dispatch.set_autotune_cache(cache)
    yield cache
    dispatch.set_autotune_cache(old)


@pytest.mark.parametrize("fmt", ["nm", "combined", "block", "lookahead"])
@pytest.mark.parametrize("M", [8, 64])
def test_tune_sweeps_every_candidate_on_the_card(cuda, fresh_cache, fmt, M):
    """Every candidate plan launches (none skipped), the winner is
    persisted with its time and the rule's, and the wrapper then runs the
    cached plan (counted in ``autotune.hits``) within the bf16 tolerance
    of the plain version."""
    from repro_torch.kernels import autotune, dispatch
    K, N = 1024, 1024
    w = (randn(0, (K, N), cuda) / K ** 0.5)
    if fmt == "nm":
        pack = sparsity.pack_nm(pruning.n_m(w, 2, 4, group=128)[0], 2, 4,
                                g=128)
    elif fmt == "lookahead":
        pack = sparsity.LookaheadPack.from_float(
            pruning.block_semi_structured(w.float(), 0.5, block=4)[0]
        ).to(cuda)
    else:
        blk = pruning.block_semi_structured(w, 0.5, block=128)[0]
        pack = sparsity.pack_block_sparse(blk, 128, 128) if fmt == "block" \
            else sparsity.pack_combined(pruning.combined_nm(
                w, 0.5, 2, 4, group=128, block=128)[0], 2, 4, 128, 128)
    x = randn(1, (M, K), cuda)
    before = dispatch.skipped
    plan = dispatch.tune(x, pack, reps=3)
    assert dispatch.skipped == before
    d = dispatch.select(pack, M=M, device=cuda, dtype=torch.bfloat16)
    entry = fresh_cache.get(d.key)
    assert d.reason == "cached" and d.plan == plan
    assert entry["skipped"] == 0 and entry["us"] <= entry["rule_us"]
    autotune.hits.clear()
    got = dispatch.sparse_matmul(x, pack)
    assert autotune.hits == {d.key: 1}
    close(got, dispatch.registry()[d.kernel].run(x, pack, "ref"))


def test_tune_refuses_inside_a_capture(cuda, fresh_cache):
    from repro_torch.kernels import dispatch
    pack = sparsity.pack_nm(pruning.n_m(randn(0, (256, 256), cuda), 2, 4,
                                        group=128)[0], 2, 4, g=128)
    x = randn(1, (8, 256), cuda)
    nm_mod.nm_spmm(x, pack)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            dispatch.tune(x, pack)
    assert len(fresh_cache) == 0


def test_paged_tune_and_cached_plan(cuda, fresh_cache):
    from repro_torch.kernels import autotune, dispatch
    B, H, Hk, D, ps, n_pages = 4, 16, 8, 128, 16, 8
    pool_k = randn(2, (B * n_pages + 1, ps, Hk, D), cuda)
    pool_v = randn(3, (B * n_pages + 1, ps, Hk, D), cuda)
    ptab = torch.arange(1, B * n_pages + 1, dtype=torch.int32,
                        device=cuda).reshape(B, n_pages)
    lens = torch.tensor([5, 40, 77, 128], dtype=torch.int32, device=cuda)
    kv = paged_mod.PagedKV(pool_k, pool_v, ptab, lens)
    q = randn(4, (B, H, D), cuda)
    before = dispatch.skipped
    plan = dispatch.tune(q, kv, reps=3)
    assert dispatch.skipped == before
    key = dispatch.paged_key(B, H, Hk, 1, n_pages, D, (torch.bfloat16,) * 2,
                             ps)
    assert autotune.plan_of(fresh_cache.get(key)) == plan
    autotune.hits.clear()
    close(dispatch.paged_attention(q, kv),
          ref.paged_attention_ref(q, pool_k, pool_v, ptab, lens))
    assert autotune.hits == {key: 1}


def test_cached_plans_serve_the_same_tokens(cuda, fresh_cache):
    """The bench's nm model warmed with ``warm_autotune`` serves under its
    cached plans (every cached key it reaches is a hit) and gives the
    tiling rule's tokens (its bf16 logits may split only at near ties, so
    the check is the shared prefix's length)."""
    from repro_torch.benchmarks import bench_serving, warm_autotune
    from repro_torch.kernels import autotune
    from repro_torch.serving import Engine, ServeConfig
    cfg, params = bench_serving._model("nm", cuda)
    scfg = ServeConfig(slots=4, max_len=64, prompt_pad=16, max_new_tokens=8,
                       decode_chunk=4, eos_token=-1, page_size=16)
    prompts = [np.arange(1, n + 1) for n in (3, 9, 16, 12)]
    rule = Engine(cfg, scfg, params, device=cuda).generate(prompts)
    out = warm_autotune.run(
        slots=4, prompt_pad=16, reps=2, device=cuda,
        models={"nm": (cfg, params)},
        paged=[dict(H=4, Hk=2, D=16, page_size=16,
                    views=warm_autotune.paged_views(scfg), window=None)])
    assert all(e["skipped"] == 0 for e in out["entries"])
    autotune.hits.clear()
    cached = Engine(cfg, scfg, params, device=cuda).generate(prompts)
    assert autotune.hits and set(autotune.hits) <= set(fresh_cache.keys())
    assert [len(o) for o in cached] == [8] * 4
    assert sum(a == b for a, b in zip(rule, cached)) >= 3


def test_dry_run_bytes_equal_the_card(cuda):
    """The serve dry run's param and cache bytes equal what the card
    allocates for the same model and cache."""
    from repro_torch import configs as C
    from repro_torch import models as MZ
    from repro_torch.launch.dryrun import tree_bytes
    cfg = C.get_reduced("qwen3-0.6b")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = MZ.init_model(cfg, seed=0, device=cuda)
    mid = torch.cuda.memory_allocated()
    cache = MZ.init_cache(cfg, 4, 128, page_size=16, num_pages=32,
                          device=cuda)
    end = torch.cuda.memory_allocated()
    assert tree_bytes(MZ.abstract_model(cfg)) == tree_bytes(params)
    assert tree_bytes(MZ.abstract_cache(cfg, 4, 128, page_size=16,
                                        num_pages=32)) == tree_bytes(cache)
    # the allocator rounds each tensor up to 512 bytes
    n_p, n_c = (sum(1 for _ in _tensors(t)) for t in (params, cache))
    assert 0 <= (mid - base) - tree_bytes(params) < 512 * n_p
    assert 0 <= (end - mid) - tree_bytes(cache) < 512 * n_c


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)


# --- the fault layer on the card ---------------------------------------------

def test_chaos_degraded_engine_runs_the_plain_versions_and_recovers(cuda):
    """One kernel fault on a warm engine (every key captured): the chunk
    is retried on the plain versions and the engine stays degraded for
    ``degraded_recover_chunks`` clean chunks, in which no kernel launches
    and the plain versions' launches are counted; then the kernels launch
    again and each chunk replays its key's graph, with no new capture.
    The tokens (fp32) are the clean serve's; a second engine in the same
    process is not degraded."""
    import warnings

    from repro_torch.serving import ChaosConfig, ChaosMonkey
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (an H100)")
    make = _graph_engine(cuda, degraded_recover_chunks=2)
    eng, other = make(), make()
    _serve(eng)
    want = _serve(eng)
    assert not want[3].graph_captures          # every key warm
    eng.reset_stats()
    for m in COUNTERS:
        m.plain_launches = 0
    handles = [eng.submit(p) for p in GRAPH_PROMPTS]
    mk = ChaosMonkey(eng, ChaosConfig(seed=0, rate=0.0,
                                      kernel_rate=1.0)).attach()
    hows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng.step()
        mk.detach()
        assert eng.degraded and not other.degraded
        while eng.num_queued or eng.num_live:
            was = eng.degraded
            before = [(m.launches, m.plain_launches) for m in COUNTERS]
            eng.step()
            torch.cuda.synchronize()
            moved = [(m.launches - a, m.plain_launches - b)
                     for m, (a, b) in zip(COUNTERS, before)]
            how = eng.stats().chunk_runs[-1][1]
            hows.append(how)
            kernels, plain = (sum(x[j] for x in moved) for j in (0, 1))
            if was:
                assert how == "plain" and kernels == 0 and plain > 0
            else:
                assert how == "replay" and kernels > 0 and plain == 0
    st = eng.stats()
    assert st.kernel_failures == 1 and st.degraded_recoveries == 1
    assert "plain" in hows and "replay" in hows
    assert not st.graph_captures and not eng.degraded
    assert [h.tokens for h in handles] == want[0]
    eng.audit()


# --- the journal and the supervisor on the card ------------------------------

def _hopper():
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (an H100)")


def _engine_allocated():
    """``memory_allocated()`` with cuBLAS's per-stream workspaces released
    (each engine's capture stream keeps one for the process's life); only
    when no captured graph will replay again."""
    import gc
    gc.collect()                    # what earlier work left in cycles
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def test_supervised_crash_with_graphs_frees_the_dead_engine(cuda, tmp_path):
    """A crash mid-serve under the supervisor, every chunk a captured
    graph: the tokens are the uninterrupted serve's, each request's
    streamed indices run 0..n-1 once each, no capture is live when
    ``step()`` dies, the teardown frees at least the dead engine's cache
    before the fresh engine allocates, and after the restored serve
    ``memory_allocated`` is within 1% of the uninterrupted engine's."""
    import gc
    import warnings

    from repro_torch.serving import (ChaosConfig, ChaosMonkey, Engine,
                                     Supervisor)
    _hopper()
    cfg, scfg, params = _graph_model(cuda)
    eng = Engine(cfg, scfg, params, device=cuda)
    want = _serve(eng)
    plain, cache = _engine_allocated(), eng.stats().cache_bytes
    del eng
    gc.collect()
    sup = Supervisor(cfg, scfg, params, device=cuda,
                     journal_path=str(tmp_path / "j.jsonl"),
                     snapshot_dir=str(tmp_path / "snap"), snapshot_every=2)
    ChaosMonkey(sup.engine, ChaosConfig(seed=7, rate=0.0,
                                        crash_tick=3)).attach()
    torn, teardown = [], sup._teardown

    def measured(old):
        teardown(old)
        torn.append(torch.cuda.memory_allocated())

    sup._teardown = measured
    handles = [sup.submit(p) for p in GRAPH_PROMPTS]
    events, freed = [], None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(h.done for h in handles):
            torch.cuda.synchronize()
            restarts, level = sup.restarts, torch.cuda.memory_allocated()
            events += sup.step()
            if sup.restarts != restarts:
                assert not torch.cuda.is_current_stream_capturing()
                freed = level - torn[-1]
    end = _engine_allocated()
    assert sup.restarts == 1 and sup.stats().restarts == 1
    assert [h.tokens for h in handles] == want[0]
    for h in handles:
        assert [e.index for e in events if e.uid == h.uid] == \
            list(range(len(h.tokens)))
    assert freed is not None and freed >= cache > 0
    assert abs(end - plain) <= 0.01 * plain
    assert sup.engine.stats().graph_captures      # new graphs, captured anew
    sup.audit()


def test_restored_engine_capture_does_not_trip_the_watchdog(cuda, tmp_path,
                                                           monkeypatch):
    """Every graph capture made 0.5 s slower than a 250 ms watchdog (far
    above a 2-layer step): a crash mid-serve restarts the engine once,
    the fresh engine warms up and captures its keys' graphs again, each
    capture step outlasts the watchdog, and none trips it."""
    import time
    import warnings

    from repro_torch.serving import (ChaosConfig, ChaosMonkey, Engine,
                                     Supervisor, loops)
    _hopper()
    cfg, scfg, params = _graph_model(cuda)
    want = _serve(Engine(cfg, scfg, params, device=cuda))[0]
    capture = loops.DecodeChunk._capture

    def slow(self, *args):
        time.sleep(0.5)
        capture(self, *args)

    monkeypatch.setattr(loops.DecodeChunk, "_capture", slow)
    sup = Supervisor(cfg, scfg, params, device=cuda,
                     journal_path=str(tmp_path / "j.jsonl"),
                     watchdog_ms=250.0)
    ChaosMonkey(sup.engine, ChaosConfig(seed=0, rate=0.0,
                                        crash_tick=4)).attach()
    handles = [sup.submit(p) for p in GRAPH_PROMPTS]
    slow_captures = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        while not all(h.done for h in handles):
            restarted, n = sup.restarts, len(sup.engine.stats().chunk_runs)
            t0 = time.perf_counter()
            sup.step()
            ms = (time.perf_counter() - t0) * 1e3
            runs = sup.engine.stats().chunk_runs[n:]
            if restarted and any(how == "capture" for _, how in runs):
                slow_captures += ms > sup.watchdog_ms
    assert sup.restarts == 1
    hows = [how for _, how in sup.engine.stats().chunk_runs]
    assert hows[0] == "eager" and slow_captures >= 1
    assert [h.tokens for h in handles] == want
