"""The port's CUDA kernels against their plain versions on the card, in
bfloat16 at rtol 2e-2 / atol 1e-2 (the bf16 tolerance of
``tests/test_kernels.py``), plus a short paged Engine run.

Marked ``gpu``; without a CUDA device each test skips.  This file
imports neither ``jax`` nor ``repro``, so it also runs on a machine with
only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pruning, sparsity
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels import ref

RTOL, ATOL = 2e-2, 1e-2

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


def test_paged_engine_runs_the_kernels(cuda):
    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.core.sparse_linear import pack_params
    from repro_torch.serving import Engine, ServeConfig
    import dataclasses
    cfg = dataclasses.replace(qwen3_0_6b.sparse(), n_layers=2,
                              layer_kinds=())
    params = pack_params(models.init_model(cfg, seed=0, device=cuda), cfg)
    eng = Engine(cfg, ServeConfig(slots=2, max_len=96, prompt_pad=32,
                                  page_size=16, decode_chunk=4,
                                  max_new_tokens=6, eos_token=-1), params,
                 device=cuda)
    counts = [m.launches for m in (nm_mod, paged_mod, flash_mod)]
    outs = eng.generate([[1, 2, 3], list(range(5, 40))])
    assert [len(o) for o in outs] == [6, 6]
    assert all(m.launches > c for m, c in
               zip((nm_mod, paged_mod, flash_mod), counts))
    assert eng.sync_count == len(eng.stats().chunk_s)
