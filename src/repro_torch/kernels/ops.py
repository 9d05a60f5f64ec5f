"""Per-format wrappers of the sparse kernels, with an explicit ``impl``.

Call sites of the port go through ``kernels.dispatch`` (the registry and
the autotune rows), never through this module: nothing on the serving or
training path imports it.  ``ops`` is the thin per-format shim of the JAX
package's ``kernels/ops.py``, for callers that want to name the
implementation:

  * ``"auto"``   — the device's mode: the hand-written kernel on a CUDA
                   tensor, the plain version on the CPU, the shape-only
                   route on ``meta``;
  * ``"kernel"`` — the hand-written kernel; on a CPU tensor it raises,
                   since a CUDA kernel has no interpret mode;
  * ``"ref"``    — the plain PyTorch version (``kernels/ref.py``) on any
                   device.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.sparsity import (BlockSparsePack, CombinedPack,
                                       LookaheadPack, NMPack)
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.bsr_matmul import bsr_matmul as _bsr_kernel
from repro_torch.kernels.csa_matmul import csa_matmul as _csa_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.lookahead_decode import lookahead_matmul as _la
from repro_torch.kernels.nm_spmm import nm_spmm as _nm_kernel

Impl = Literal["auto", "kernel", "ref"]


def _resolve(impl: Impl, x: torch.Tensor) -> str:
    """``"kernel"`` or ``"ref"`` (the wrappers take ``meta`` themselves)."""
    if impl == "ref":
        return "ref"
    if impl == "auto":
        return "ref" if dispatch.resolve_mode(x.device) == "ref" else \
            "kernel"
    if impl == "kernel":
        if x.device.type == "cpu":
            raise ValueError("impl='kernel' needs a CUDA tensor: the "
                             "hand-written kernels have no interpret mode "
                             "(impl='ref' runs the plain version)")
        return "kernel"
    raise ValueError(f"impl {impl!r} not in ('auto', 'kernel', 'ref')")


def block_sparse_matmul(x: torch.Tensor, pack: BlockSparsePack,
                        impl: Impl = "auto") -> torch.Tensor:
    """SSSA analogue — see ``kernels/bsr_matmul.py``."""
    if _resolve(impl, x) == "ref":
        return ref.bsr_matmul_ref(x, pack)
    return _bsr_kernel(x, pack)


def nm_matmul(x: torch.Tensor, pack: NMPack,
              impl: Impl = "auto") -> torch.Tensor:
    """USSA analogue — see ``kernels/nm_spmm.py``."""
    if _resolve(impl, x) == "ref":
        return ref.nm_spmm_ref(x, pack)
    return _nm_kernel(x, pack)


def combined_matmul(x: torch.Tensor, pack: CombinedPack,
                    impl: Impl = "auto") -> torch.Tensor:
    """CSA analogue — see ``kernels/csa_matmul.py``."""
    if _resolve(impl, x) == "ref":
        return ref.csa_matmul_ref(x, pack)
    return _csa_kernel(x, pack)


def lookahead_matmul(x: torch.Tensor, pack: LookaheadPack,
                     impl: Impl = "auto") -> torch.Tensor:
    """The LSB-encoded int7 matmul — see ``kernels/lookahead_decode.py``."""
    if _resolve(impl, x) == "ref":
        return ref.lookahead_matmul_ref(x, pack)
    return _la(x, pack)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, impl: Impl = "auto") -> torch.Tensor:
    """Fused attention — see ``kernels/flash_attention.py``."""
    if _resolve(impl, q) == "ref":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                  scale=scale)


def sparse_matmul(x: torch.Tensor, weight, impl: Impl = "auto"
                  ) -> torch.Tensor:
    """Format-dispatched matmul; ``weight`` a dense tensor or any pack."""
    if isinstance(weight, BlockSparsePack):
        return block_sparse_matmul(x, weight, impl)
    if isinstance(weight, NMPack):
        return nm_matmul(x, weight, impl)
    if isinstance(weight, CombinedPack):
        return combined_matmul(x, weight, impl)
    if isinstance(weight, LookaheadPack):
        return lookahead_matmul(x, weight, impl)
    _resolve(impl, x)
    return x @ weight
