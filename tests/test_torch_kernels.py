"""The port's kernels against the JAX kernels on the same inputs.

On the CPU a wrapper runs its plain version, so these hold the plain
versions against the Pallas kernels (interpret mode) and the JAX
oracles at float32: rtol 2e-5 / atol 1e-4, the tolerance of
``tests/test_kernels.py``.  ``test_torch_gpu.py`` holds the CUDA kernels
against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.core import sparsity as jsparsity
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.nm_spmm import nm_spmm as jnm_spmm
from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.kernels import paged_attention as paged_mod

RTOL, ATOL = 2e-5, 1e-4


def rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def nm_case(seed, K=256, N=256):
    """A 2:4 g=128 pack built by the JAX packer, and the port's copy."""
    wp, _ = jpruning.n_m(jnp.asarray(rand(seed, (K, N))), 2, 4, group=128)
    jp = jsparsity.pack_nm(wp, 2, 4, g=128)
    tp = NMPack(values=torch.from_numpy(np.array(jp.values)),
                idx=torch.from_numpy(np.array(jp.idx)),
                K=K, N=N, n=2, m=4, g=128)
    return jp, tp


@pytest.mark.parametrize("M", [1, 3, 8, 17, 130])
def test_nm_spmm_plain_matches_jax(M):
    jp, tp = nm_case(0)
    x = rand(1, (M, 256))
    before = nm_mod.launches
    got = nm_mod.nm_spmm(torch.from_numpy(x), tp)
    assert nm_mod.launches == before         # the CPU path launches nothing
    close(got, jref.nm_spmm_ref(jnp.asarray(x), jp))
    close(got, jnm_spmm(jnp.asarray(x), jp, bm=M, bkc=128, interpret=True))
    close(got, x @ np.asarray(jp.densify()))


PAGED = dict(B=3, ps=8, Hk=2, H=4, D=32, P=10, mp=3)


def paged_case(seed, lens, Q=None, **kw):
    """Arrays of a paged decode case; ``Q`` queries per sequence give the
    ``(B, Q, H, D)`` block of the plain version."""
    c = dict(PAGED, **kw)
    rng = np.random.default_rng(seed)
    qshape = (c["B"], c["H"], c["D"]) if Q is None else \
        (c["B"], Q, c["H"], c["D"])
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(c["P"], c["ps"], c["Hk"], c["D"])).astype(np.float32)
    vp = rng.normal(size=(c["P"], c["ps"], c["Hk"], c["D"])).astype(np.float32)
    ptab = rng.integers(1, c["P"], size=(c["B"], c["mp"])).astype(np.int32)
    return q, kp, vp, ptab, np.asarray(lens, np.int32)


@pytest.mark.parametrize("Q", [None, 3], ids=["decode", "block"])
def test_paged_attention_plain_matches_jax(Q):
    # a dead slot, a partial last page, a full view; the block case gives
    # each of its Q queries its own causal length
    arrays = paged_case(2, [0, 13, 24], Q=Q)
    before = paged_mod.launches
    got = paged_mod.paged_attention(*map(torch.from_numpy, arrays))
    assert paged_mod.launches == before
    j = [jnp.asarray(a) for a in arrays]
    close(got, jref.paged_attention_ref(*j))
    close(got, jpaged(*j, interpret=True))
    assert (got[0] == 0).all()                 # dead slot → zeros


FLASH = {
    "causal": dict(B=2, H=4, Hk=4, Lq=64, Lk=64, kw={}),
    "gqa": dict(B=1, H=4, Hk=2, Lq=64, Lk=64, kw={}),
    "window": dict(B=1, H=2, Hk=2, Lq=64, Lk=64, kw=dict(window=16)),
    "softcap": dict(B=1, H=2, Hk=1, Lq=64, Lk=64, kw=dict(softcap=5.0)),
    "suffix": dict(B=1, H=2, Hk=2, Lq=32, Lk=96, kw={}),
}


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_plain_matches_jax(case):
    c = FLASH[case]
    q = rand(3, (c["B"], c["H"], c["Lq"], 32))
    k = rand(4, (c["B"], c["Hk"], c["Lk"], 32))
    v = rand(5, (c["B"], c["Hk"], c["Lk"], 32))
    before = flash_mod.launches
    got = flash_mod.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    **c["kw"])
    assert flash_mod.launches == before
    j = [jnp.asarray(a) for a in (q, k, v)]
    close(got, jref.mha_ref(*j, **c["kw"]))
    close(got, jflash(*j, **c["kw"], bq=32, bk=32, interpret=True))


def test_dispatch_mode_follows_the_device():
    assert dispatch.resolve_mode(torch.device("cuda")) == "kernel"
    assert dispatch.resolve_mode(torch.device("cuda", 0)) == "kernel"
    assert dispatch.resolve_mode(torch.device("cpu")) == "ref"
    # meta takes the wrappers' shape-only route (the dry run's)
    assert dispatch.resolve_mode(torch.device("meta")) == "meta"
    with pytest.raises(ValueError):
        dispatch.resolve_mode(torch.device("mps"))
    _, tp = nm_case(6)
    params = {"layers": [{"mlp": {"w_in": tp}}]}
    plan = dispatch.plan_params(params, M=8, device="cuda")
    assert plan == [{"param": "layers/0/mlp/w_in", "M": 8,
                     "kernel": "nm_spmm", "mode": "kernel",
                     "pattern": "2:4g128"}]
    assert dispatch.plan_params(params, 8, "cpu")[0]["mode"] == "ref"


def test_kernel_entries_call_the_wrappers(monkeypatch):
    """In ``kernel`` mode dispatch calls the kernel wrappers — which on a
    CUDA tensor launch or raise — never the plain versions."""
    calls = []
    monkeypatch.setattr(dispatch, "nm_spmm",
                        lambda x, p: calls.append("nm") or x)
    monkeypatch.setattr(dispatch, "_paged_attention",
                        lambda *a, **k: calls.append(("paged", k)) or a[0])
    monkeypatch.setattr(dispatch, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    monkeypatch.setattr(dispatch, "resolve_mode", lambda device: "kernel")
    for name in ("nm_spmm", "paged_attention", "dense"):
        assert name in dispatch.registry()
    _, tp = nm_case(7)
    x = torch.zeros((2, 256))
    dispatch.sparse_matmul(x, tp)
    q = torch.zeros((1, 2, 32))
    dispatch.paged_attention(q, paged_mod.PagedKV(q, q, q, q), window=4,
                             softcap=2.0)
    dispatch.attention(q, q, q)
    assert calls == ["nm", ("paged", dict(window=4, softcap=2.0)), "flash"]


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import models
    from repro_torch.configs import qwen3_0_6b
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.init_model(qwen3_0_6b.reduced())

