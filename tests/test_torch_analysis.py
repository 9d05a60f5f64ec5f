"""The port's roofline numerators (``repro_torch.launch.analysis``) against
the JAX package's (``repro.launch.analysis``) on the CPU: the twins of
``tests/test_analysis.py::TestJaxprFlops`` on ``meta`` tensors — a plain
matmul, a batched einsum, a Python loop in place of ``scan``, nested
loops and a convolution, each exactly equal to the JAX count; the
backward and the remat cases with their matmul terms exactly equal to
the JAX jaxpr's ``dot_general`` FLOPs — plus the kernels' costs taken
from their wrappers, the live-bytes peak, ``memory_traffic`` and the
collective count on one device."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro.launch import analysis as janalysis
from repro.launch.analysis import _dot_flops
from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import nm_spmm as nm_mod
from repro_torch.launch import analysis as A


def meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def jax_dot_flops(fn, *args) -> float:
    """The ``dot_general`` FLOPs of ``fn``'s jaxpr, scans multiplied by
    their length: the JAX count's matmul term."""
    def walk(jaxpr):
        total = 0.0
        for eqn in getattr(jaxpr, "jaxpr", jaxpr).eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                total += _dot_flops(eqn)
            elif name == "scan":
                total += eqn.params["length"] * walk(eqn.params["jaxpr"])
            else:
                for k in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                    if k in eqn.params:
                        total += walk(eqn.params[k])
                        break
        return total
    return walk(jax.make_jaxpr(fn)(*args))


class TestStepFlops:
    def test_plain_matmul(self):
        want = janalysis.step_flops(lambda a, b: a @ b, sds(8, 16),
                                    sds(16, 32))
        assert A.step_flops(lambda a, b: a @ b, meta(8, 16),
                            meta(16, 32)) == want == 2 * 8 * 16 * 32

    def test_batched_einsum(self):
        want = janalysis.step_flops(
            lambda a, b: jnp.einsum("bij,bjk->bik", a, b), sds(4, 8, 16),
            sds(4, 16, 32))
        got = A.step_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                           meta(4, 8, 16), meta(4, 16, 32))
        assert got == want == 2 * 4 * 8 * 16 * 32

    def test_loop_multiplies(self):
        def jf(x, w):
            out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                  length=7)
            return out

        def tf(x, w):
            for _ in range(7):
                x = x @ w
            return x
        want = janalysis.step_flops(jf, sds(8, 8), sds(8, 8))
        assert A.step_flops(tf, meta(8, 8), meta(8, 8)) == want \
            == 7 * 2 * 8 * 8 * 8

    def test_nested_loops(self):
        def jf(x, w):
            def outer(c, _):
                c2, _ = jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None,
                                     length=3)
                return c2, None
            out, _ = jax.lax.scan(outer, x, None, length=5)
            return out

        def tf(x, w):
            for _ in range(5):
                for _ in range(3):
                    x = x @ w
            return x
        want = janalysis.step_flops(jf, sds(4, 4), sds(4, 4))
        assert A.step_flops(tf, meta(4, 4), meta(4, 4)) == want \
            == 15 * 2 * 4 * 4 * 4

    def test_grad_counts_backward(self):
        def tf(a, b):
            (a @ b).sum().backward()
        fwd = A.step_flops(lambda a, b: a @ b, meta(8, 16), meta(16, 32))
        count = A.count_step(tf, meta(8, 16, grad=True),
                             meta(16, 32, grad=True))
        assert count.flops >= fwd
        want = jax_dot_flops(jax.grad(lambda a, b: jnp.sum(a @ b),
                                      argnums=(0, 1)), sds(8, 16),
                             sds(16, 32))
        assert count.matmul_flops == want == 3 * fwd

    def test_remat_counted(self):
        base = 2 * 8 * 8 * 8

        def tf(x, w):
            y = ckpt.checkpoint(lambda x: torch.tanh(x @ w), x,
                                use_reentrant=False)
            y.sum().backward()
        count = A.count_step(tf, meta(8, 8, grad=True),
                             meta(8, 8, grad=True))
        assert count.flops >= 2 * base            # fwd + recompute + bwd
        want = jax_dot_flops(jax.grad(
            lambda x, w: jnp.sum(jax.checkpoint(
                lambda x: jnp.tanh(x @ w))(x)), argnums=(0, 1)),
            sds(8, 8), sds(8, 8))
        assert count.matmul_flops == want == 4 * base

    def test_conv_flops(self):
        want = janalysis.step_flops(
            lambda x, w: jax.lax.conv_general_dilated(
                x, w, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")),
            sds(1, 8, 8, 3), sds(3, 3, 3, 16))
        got = A.count_step(lambda x, w: F.conv2d(x, w, padding=1),
                           meta(1, 3, 8, 8), meta(16, 3, 3, 3))
        assert got.conv_flops == want == 2 * (1 * 8 * 8 * 16) * (3 * 3) * 3


class TestKernelsAndBytes:
    def test_kernels_count_their_cost_only(self):
        """A wrapper's meta route reports its ``cost``; the ops it issues
        to shape the output are not counted."""
        pack = NMPack(values=meta(128, 256, dtype=torch.bfloat16),
                      idx=meta(128, 2, dtype=torch.int32), K=256, N=256, n=2,
                      m=4, g=128)
        x = meta(8, 256, dtype=torch.bfloat16)
        count = A.count_step(nm_mod.nm_spmm, x, pack)
        assert count.out.shape == (8, 256) and count.out.device.type == "meta"
        assert count.kernel_flops == {"nm_spmm": 2.0 * 8 * 128 * 256}
        assert count.kernel_calls == {"nm_spmm": 1}
        assert count.kernel_bytes["nm_spmm"] == nm_mod.cost(
            8, 256, 256, torch.bfloat16)["bytes"]
        assert count.flops == count.kernel_flops["nm_spmm"]
        q = meta(1, 4, 32, 64, dtype=torch.bfloat16)
        kv = meta(1, 2, 48, 64, dtype=torch.bfloat16)
        count = A.count_step(flash_mod.flash_attention, q, kv, kv)
        assert count.flops == 4.0 * 4 * 64 * 32 * 48

    def test_peak_counts_storages_not_views(self):
        def f(x):
            y = x * 2                       # 4 KiB
            v = y.view(32, 32)              # a view: no new storage
            z = v + 1                       # 4 KiB more, y still alive
            del y, v
            return z.sum()
        x = meta(1024)
        assert A.peak_live_bytes(f, x) == 3 * 4096
        count = A.count_step(f, x)
        assert count.entry_bytes == 4096 and count.temp_bytes == 2 * 4096

    def test_freed_temporaries_leave_the_count(self):
        def f(x):
            for _ in range(10):
                x = x * 2                   # each one frees the last
            return x
        assert A.peak_live_bytes(f, meta(1024)) == 3 * 4096

    def test_memory_traffic_is_the_jax_model(self):
        args = dict(param_bytes_pd=1000, temp_bytes_pd=300,
                    cache_bytes_pd=70, opt_bytes_pd=11, microbatches=4)
        assert A.memory_traffic(**args) == janalysis.memory_traffic(**args)

    def test_no_collectives_on_one_device(self):
        got = A.collective_bytes(lambda a, b: a @ b, meta(8, 8),
                                 meta(8, 8))
        assert got == {"bytes_by_kind": {}, "total_bytes": 0}


def test_sinks_are_removed_after_a_count():
    from repro_torch.kernels import _build
    before = list(_build.COST_SINKS)
    with pytest.raises(RuntimeError):
        A.count_step(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    A.step_flops(lambda a, b: a @ b, meta(2, 2), meta(2, 2))
    assert _build.COST_SINKS == before and _build.META_DEPTH == 0
