"""The plain versions of ``bsr_matmul``, ``csa_matmul`` and
``lookahead_matmul`` against the JAX oracles and the Pallas kernels
(interpret mode) at float32, rtol 2e-5 / atol 1e-4 (the tolerance of
``tests/test_kernels.py``), and the dispatcher's plans against the JAX
dispatcher's.  On the CPU each wrapper runs its plain version and
launches nothing; ``test_torch_gpu.py`` holds the CUDA kernels against
these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jencoding
from repro.core import pruning as jpruning
from repro.core import sparsity as jsparsity
from repro.kernels import dispatch as jdispatch
from repro.kernels import ref as jref
from repro.kernels.bsr_matmul import bsr_matmul as jbsr
from repro.kernels.csa_matmul import csa_matmul as jcsa
from repro.kernels.lookahead_decode import lookahead_matmul as jlookahead
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparsity import LookaheadPack
from repro_torch.kernels import bsr_matmul as bsr_mod
from repro_torch.kernels import csa_matmul as csa_mod
from repro_torch.kernels import dispatch
from repro_torch.kernels import lookahead_decode as lookahead_mod
from test_torch_kernels import close, rand
from test_torch_model import flatten
from test_torch_pack_formats import BK, BN, tile_map, tile_zeroed

PAD = 6            # slots per strip: more than any strip's count (<= 4)


def packs(seed, pad_to=PAD):
    """JAX block, combined and lookahead packs of one tile-zeroed weight
    (a ``counts == 0`` strip, padding slots) and the port's copies."""
    w = jnp.asarray(tile_zeroed(seed))
    bw, _ = jpruning.block_semi_structured(w, 0.5, block=BK)
    cw, _ = jpruning.combined_nm(w, 0.5, 2, 4, group=BN, block=BK)
    lw, _ = jpruning.block_semi_structured(w, 0.5, block=4)
    jp = {"block": jsparsity.pack_block_sparse(bw, BK, BN, pad_to=pad_to),
          "combined": jsparsity.pack_combined(cw, 2, 4, BK, BN,
                                              pad_to=pad_to),
          "lookahead": jsparsity.LookaheadPack.from_float(lw)}
    return jp, params_from_numpy(flatten(jp), "cpu")


KERNELS = {
    "block": (bsr_mod, bsr_mod.bsr_matmul, jref.bsr_matmul_ref, jbsr),
    "combined": (csa_mod, csa_mod.csa_matmul, jref.csa_matmul_ref, jcsa),
    "lookahead": (lookahead_mod, lookahead_mod.lookahead_matmul,
                  jref.lookahead_matmul_ref, jlookahead),
}


@pytest.mark.parametrize("M", [1, 3, 8, 17, 130])
@pytest.mark.parametrize("fmt", sorted(KERNELS))
def test_plain_versions_match_jax(fmt, M):
    jp, tp = packs(0)
    mod, wrapper, oracle, pallas = KERNELS[fmt]
    if fmt != "lookahead":
        counts = tp[fmt].counts.tolist()
        assert 0 in counts and max(counts) < tp[fmt].max_nnz == PAD
    x = rand(1, (M, 512))
    before = mod.launches
    got = wrapper(torch.from_numpy(x), tp[fmt])
    assert mod.launches == before          # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (M, 384)
    close(got, oracle(jnp.asarray(x), jp[fmt]))
    kw = dict(bm=M, interpret=True)
    if fmt == "lookahead":
        kw.update(bk=128, bn=128)
    close(got, pallas(jnp.asarray(x), jp[fmt], **kw))
    dense = jp[fmt].decode() if fmt == "lookahead" else jp[fmt].densify()
    close(got, x @ np.asarray(dense))
    if fmt != "lookahead":                 # the empty strip gives zeros
        assert (got[:, 2 * BN:3 * BN] == 0).all()


def test_lookahead_plain_is_bit_exact():
    """Identity x, integer weights in [-64, 63], scale 1: the product is
    the weights, exactly (``tests/test_kernels.py::
    test_lookahead_int7_exact``)."""
    w = np.random.default_rng(8).integers(-64, 64, size=(128, 128)).astype(
        np.int8)
    enc = np.asarray(jencoding.encode_weight_matrix(jnp.asarray(w)))
    pack = LookaheadPack(enc=torch.from_numpy(enc),
                         scale=torch.ones((1, 128)), K=128, N=128)
    out = lookahead_mod.lookahead_matmul(torch.eye(128), pack)
    np.testing.assert_array_equal(out.numpy(), w.astype(np.float32))


def test_plans_equal_the_jax_plans():
    """The same packed tree gets the JAX dispatcher's kernel names and
    pattern strings (``bsr128x128d0.50``-style densities included)."""
    jp, tp = packs(2, pad_to=None)
    jtree = {"mlp": {"w_in": jp["combined"], "w_gate": jp["block"],
                     "w_out": jp["lookahead"]}}
    ttree = {"mlp": {"w_in": tp["combined"], "w_gate": tp["block"],
                     "w_out": tp["lookahead"]}}
    want = {r["param"]: (r["kernel"], r["pattern"])
            for r in jdispatch.plan_params(jtree, M=8, impl="ref")}
    got = {r["param"]: (r["kernel"], r["pattern"])
           for r in dispatch.plan_params(ttree, M=8, device="cpu")}
    assert got == want
    density = tile_map(tp["block"].densify()).mean()
    assert density < 0.5
    assert got["mlp/w_in"] == ("csa_matmul", f"csa128x128d{density:.2f}+2:4")
    assert got["mlp/w_gate"] == ("bsr_matmul", f"bsr128x128d{density:.2f}")
    assert got["mlp/w_out"] == ("lookahead_decode", "lookahead")


def test_kernel_entries_call_the_new_wrappers(monkeypatch):
    """In ``kernel`` mode each format's entry calls its kernel wrapper —
    which on a CUDA tensor launches or raises — never a plain version."""
    calls = []
    for name in ("bsr_matmul", "csa_matmul", "lookahead_matmul"):
        monkeypatch.setattr(dispatch, name,
                            lambda x, p, name=name: calls.append(name) or x)
    monkeypatch.setattr(dispatch, "resolve_mode", lambda device: "kernel")
    _, tp = packs(3)
    x = torch.zeros((2, 512))
    for fmt in ("block", "combined", "lookahead"):
        dispatch.sparse_matmul(x, tp[fmt])
    assert calls == ["bsr_matmul", "csa_matmul", "lookahead_matmul"]
    with pytest.raises(TypeError):
        dispatch.sparse_matmul(x, torch.zeros(3, 4, 5))


def test_wrappers_refuse_other_devices():
    _, tp = packs(4)
    x = torch.zeros((2, 512), device="meta")
    for fmt, (_, wrapper, _, _) in KERNELS.items():
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper(x, tp[fmt])
