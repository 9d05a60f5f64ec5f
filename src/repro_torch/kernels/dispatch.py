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

from repro_torch.core.sparsity import NMPack
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.kernels.paged_attention import \
    paged_attention as _paged_attention


@dataclasses.dataclass(frozen=True)
class SparsityDescriptor:
    """Structural summary of a weight: the dispatch key.

    ``pattern`` is the sparsity signature used in plans and logs, with
    the JAX package's strings: ``"2:4g128"``, ``"paged16x32"``,
    ``"dense"``.  For a paged cache ``K`` is the logical view
    (``max_pages * page_size``), ``N`` the head dim, ``g`` the page size
    and ``bk`` the page count.
    """
    kind: str          # dense | nm | paged
    K: int
    N: int
    dtype: str
    n: Optional[int] = None
    m: Optional[int] = None
    g: Optional[int] = None
    bk: Optional[int] = None

    @property
    def pattern(self) -> str:
        if self.kind == "nm":
            return f"{self.n}:{self.m}g{self.g}"
        if self.kind == "paged":
            return f"paged{self.g}x{self.bk}"
        return self.kind

    @classmethod
    def of(cls, weight: Any) -> "SparsityDescriptor":
        if isinstance(weight, NMPack):
            return cls(kind="nm", K=weight.K, N=weight.N,
                       dtype=str(weight.values.dtype).replace("torch.", ""),
                       n=weight.n, m=weight.m, g=weight.g)
        if isinstance(weight, PagedKV):
            return cls(kind="paged", K=weight.max_pages * weight.page_size,
                       N=weight.head_dim,
                       dtype=str(weight.k.dtype).replace("torch.", ""),
                       g=weight.page_size, bk=weight.max_pages)
        if isinstance(weight, torch.Tensor) and weight.dim() == 2:
            return cls(kind="dense", K=weight.shape[0], N=weight.shape[1],
                       dtype=str(weight.dtype).replace("torch.", ""))
        raise TypeError(f"cannot describe weight of type {type(weight)} "
                        "(only dense and nm are ported)")


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


def _paged_run(q, kv, mode):
    if mode == "ref":
        return ref.paged_attention_ref(q, kv.k, kv.v, kv.ptab, kv.lens)
    return _paged_attention(q, kv.k, kv.v, kv.ptab, kv.lens)


_REGISTRY: Dict[str, KernelEntry] = {e.name: e for e in (
    KernelEntry("nm_spmm", "nm", _nm_run),
    KernelEntry("paged_attention", "paged", _paged_run),
    # a plain matrix product: what the JAX package leaves to XLA
    KernelEntry("dense", "dense", lambda x, w, mode: x @ w),
)}


def registry() -> Dict[str, KernelEntry]:
    return dict(_REGISTRY)


def _entry_for(desc: SparsityDescriptor) -> KernelEntry:
    for e in _REGISTRY.values():
        if e.kind == desc.kind:
            return e
    raise NotImplementedError(f"no kernel for {desc.kind!r} weights")


def sparse_matmul(x: torch.Tensor, weight: Any) -> torch.Tensor:
    """``x (M, K) @ weight (K, N) -> (M, N)`` for a dense tensor or an
    :class:`NMPack`."""
    entry = _entry_for(SparsityDescriptor.of(weight))
    return entry.run(x, weight, resolve_mode(x.device))


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
        elif isinstance(node, NMPack):
            d = SparsityDescriptor.of(node)
            plan.append({"param": "/".join(path), "M": M,
                         "kernel": _entry_for(d).name, "mode": mode,
                         "pattern": d.pattern})

    visit(params, ())
    return plan
