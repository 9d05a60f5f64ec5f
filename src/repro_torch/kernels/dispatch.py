"""Sparse-kernel dispatch of the port: descriptor → registry → kernel.

A :class:`SparsityDescriptor` summarizes a weight (or a paged cache);
the registry picks the kernel that serves its kind.  The mode follows
the tensor's device: a CUDA tensor runs the hand-written kernel, a CPU
tensor the plain PyTorch version.  On a CUDA tensor the kernel runs or
the call raises — there is no fallback to the plain version, no mode
override and no autotune sweep (the kernels take no tunable blocks
yet).  Callers (``core.sparse_linear``, the model layers) go through
:func:`sparse_matmul`, :func:`attention` and :func:`paged_attention`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.sparsity import (PACK_TYPES, BlockSparsePack,
                                       CombinedPack, LookaheadPack, NMPack)
from repro_torch.kernels import ref
from repro_torch.kernels.bsr_matmul import bsr_matmul
from repro_torch.kernels.csa_matmul import csa_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lookahead_decode import lookahead_matmul
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.kernels.paged_attention import \
    paged_attention as _paged_attention


@dataclasses.dataclass(frozen=True)
class SparsityDescriptor:
    """Structural summary of a weight: the dispatch key.

    ``pattern`` is the sparsity signature used in plans and logs, with
    the JAX package's strings: ``"2:4g128"``, ``"bsr128x128d0.50"``,
    ``"csa128x128d0.50+2:4"``, ``"lookahead"``, ``"paged16x32"``,
    ``"dense"``.  For a paged cache ``K`` is the logical view
    (``max_pages * page_size``), ``N`` the head dim, ``g`` the page size
    and ``bk`` the page count.
    """
    kind: str          # dense | block | nm | combined | lookahead | paged
    K: int
    N: int
    dtype: str
    n: Optional[int] = None
    m: Optional[int] = None
    g: Optional[int] = None
    bk: Optional[int] = None
    bn: Optional[int] = None
    density: Optional[float] = None  # non-zero tile fraction

    @property
    def pattern(self) -> str:
        if self.kind == "nm":
            return f"{self.n}:{self.m}g{self.g}"
        if self.kind == "block":
            return f"bsr{self.bk}x{self.bn}d{self.density:.2f}"
        if self.kind == "combined":
            return (f"csa{self.bk}x{self.bn}d{self.density:.2f}"
                    f"+{self.n}:{self.m}")
        if self.kind == "paged":
            return f"paged{self.g}x{self.bk}"
        return self.kind

    @classmethod
    def of(cls, weight: Any) -> "SparsityDescriptor":
        """The descriptor of a dense tensor, a pack or a paged cache; a
        block or combined pack's density reads its ``counts`` on the
        host."""
        if isinstance(weight, NMPack):
            return cls(kind="nm", K=weight.K, N=weight.N,
                       dtype=_dtype(weight.values), n=weight.n, m=weight.m,
                       g=weight.g)
        if isinstance(weight, BlockSparsePack):
            return cls(kind="block", K=weight.K, N=weight.N,
                       dtype=_dtype(weight.values), bk=weight.bk,
                       bn=weight.bn, density=weight.density)
        if isinstance(weight, CombinedPack):
            return cls(kind="combined", K=weight.K, N=weight.N,
                       dtype=_dtype(weight.values), n=weight.n, m=weight.m,
                       bk=weight.bk, bn=weight.bn, density=weight.density)
        if isinstance(weight, LookaheadPack):
            return cls(kind="lookahead", K=weight.K, N=weight.N,
                       dtype=_dtype(weight.enc))
        if isinstance(weight, PagedKV):
            return cls(kind="paged", K=weight.max_pages * weight.page_size,
                       N=weight.head_dim,
                       dtype=_dtype(weight.k), g=weight.page_size,
                       bk=weight.max_pages)
        if isinstance(weight, torch.Tensor) and weight.dim() == 2:
            return cls(kind="dense", K=weight.shape[0], N=weight.shape[1],
                       dtype=_dtype(weight))
        raise TypeError(f"cannot describe weight of type {type(weight)}")


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


#: The descriptor kind of each weight type: what :func:`sparse_matmul`
#: dispatches on without building a descriptor (whose density would read
#: ``counts`` back from the card on every call).
_KINDS = {NMPack: "nm", BlockSparsePack: "block", CombinedPack: "combined",
          LookaheadPack: "lookahead", torch.Tensor: "dense"}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; without a CUDA device they raise instead of silently
    running the plain versions — the caller asks for ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_mode(device: torch.device) -> str:
    """``kernel`` for a CUDA device, ``ref`` (the plain version) for the
    CPU; anything else raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernels for device {device}")


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One dispatchable kernel: ``run(x, weight, mode)``."""
    name: str
    kind: str
    run: Callable[[torch.Tensor, Any, str], torch.Tensor]


def _nm_run(x, pack, mode):
    return ref.nm_spmm_ref(x, pack) if mode == "ref" else nm_spmm(x, pack)


def _bsr_run(x, pack, mode):
    return ref.bsr_matmul_ref(x, pack) if mode == "ref" else \
        bsr_matmul(x, pack)


def _csa_run(x, pack, mode):
    return ref.csa_matmul_ref(x, pack) if mode == "ref" else \
        csa_matmul(x, pack)


def _lookahead_run(x, pack, mode):
    return ref.lookahead_matmul_ref(x, pack) if mode == "ref" else \
        lookahead_matmul(x, pack)


def _paged_run(q, kv, mode):
    if mode == "ref":
        return ref.paged_attention_ref(q, kv.k, kv.v, kv.ptab, kv.lens)
    return _paged_attention(q, kv.k, kv.v, kv.ptab, kv.lens)


_REGISTRY: Dict[str, KernelEntry] = {e.name: e for e in (
    KernelEntry("nm_spmm", "nm", _nm_run),
    KernelEntry("bsr_matmul", "block", _bsr_run),
    KernelEntry("csa_matmul", "combined", _csa_run),
    KernelEntry("lookahead_decode", "lookahead", _lookahead_run),
    KernelEntry("paged_attention", "paged", _paged_run),
    # a plain matrix product: what the JAX package leaves to XLA
    KernelEntry("dense", "dense", lambda x, w, mode: x @ w),
)}


def registry() -> Dict[str, KernelEntry]:
    return dict(_REGISTRY)


def _entry_for(kind: str) -> KernelEntry:
    for e in _REGISTRY.values():
        if e.kind == kind:
            return e
    raise NotImplementedError(f"no kernel for {kind!r} weights")


def sparse_matmul(x: torch.Tensor, weight: Any) -> torch.Tensor:
    """``x (M, K) @ weight (K, N) -> (M, N)`` for a dense tensor or any
    pack."""
    kind = next((k for t, k in _KINDS.items() if isinstance(weight, t)),
                None)
    if kind is None or (kind == "dense" and weight.dim() != 2):
        raise TypeError(f"cannot multiply by a weight of type "
                        f"{type(weight)}")
    return _entry_for(kind).run(x, weight, resolve_mode(x.device))


def paged_attention(q: torch.Tensor, kv: PagedKV) -> torch.Tensor:
    """Decode attention against a paged KV cache (``q (B, H, D)``)."""
    return _paged_run(q, kv, resolve_mode(q.device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention, ``(B, H, Lq, D)`` layout, behind the same mode
    policy as the matmuls."""
    if resolve_mode(q.device) == "ref":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def plan_params(params: Any, M: int, device) -> List[dict]:
    """The dispatch decision for every packed weight of a param tree at
    ``M`` rows on ``device`` — what the engine records per phase."""
    mode = resolve_mode(device)
    plan: List[dict] = []

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        elif isinstance(node, PACK_TYPES):
            d = SparsityDescriptor.of(node)
            plan.append({"param": "/".join(path), "M": M,
                         "kernel": _entry_for(d.kind).name, "mode": mode,
                         "pattern": d.pattern})

    visit(params, ())
    return plan
