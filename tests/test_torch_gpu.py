"""The port's CUDA kernels against their plain versions on the card, in
bfloat16 at rtol 2e-2 / atol 1e-2 (the bf16 tolerance of
``tests/test_kernels.py``), plus a short paged Engine run per format.

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


def run_paged(q, kp, vp, ptab, lens, route):
    Q = 1 if q.dim() == 3 else q.shape[1]
    p = paged_mod.plan(q.shape[0], q.shape[-2], kp.shape[2], Q,
                       ptab.shape[1], q.shape[-1], (q.dtype, kp.dtype),
                       kp.shape[1])
    assert p["route"] == route
    before = paged_mod.launches
    got = paged_mod.paged_attention(q, kp, vp, ptab, lens)
    assert paged_mod.launches == before + 1
    close(got, ref.paged_attention_ref(q, kp, vp, ptab, lens))
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


def test_attention_unsupported_shapes_raise(cuda):
    """A bf16 call no route takes raises rather than falling back."""
    with pytest.raises(ValueError):          # Q * G = 32 > 16 rows
        paged_mod.paged_attention(*paged_inputs(92, 2, 16, lens=[5, 9]))
    with pytest.raises(ValueError):          # fp32 takes Q = 1 only
        paged_mod.paged_attention(*paged_inputs(
            93, 2, 2, lens=[5, 9], q_dtype=torch.float32))
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
