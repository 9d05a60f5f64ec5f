"""Sparse-kernel dispatch of the port: descriptor → registry → kernel.

A :class:`SparsityDescriptor` summarizes a weight (or a paged cache);
the registry picks the kernel that serves its kind.  The mode follows
the tensor's device: a CUDA tensor runs the hand-written kernel, a CPU
tensor the plain PyTorch version, and a ``meta`` tensor (the dry run,
``launch.dryrun``) the wrapper's shape-only route, which reports the
kernel's ``cost`` and runs no arithmetic.  On a CUDA tensor the kernel
runs or the call raises — there is no fallback to the plain version and
no process-wide mode override.  Callers (``core.sparse_linear``, the
model layers) go through :func:`sparse_matmul`, :func:`attention` and
:func:`paged_attention`.

The one exception is a scope, not a fallback: inside
:func:`plain_versions` the three calls run the plain versions on the
card in the kernels' place, each counted in its kernel module's
``plain_launches`` (never in ``launches``).  Only a degraded serving
engine enters it, around its own prefills and decode chunks
(``serving.faults``); the scope is a context variable, so another
engine in the same process keeps its kernels.  :func:`load_kernels`
builds and binds every library up front, so a build or load error
raises where the engine is made and is never contained as a chunk's
fault.

Autotune rows (``kernels/autotune.py``): on the card each wrapper runs
the plan the cache holds for its key (:func:`cache_key`), else the
tiling rule's.  :func:`tune` sweeps a key's candidate plans (the
``candidates`` of each kernel module, from ``kernels/tiling.py``) by
their device time (CUDA events over a captured graph) and persists the
fastest; it and :func:`select` with
``autotune=True`` are the only places a sweep runs, never inside a
CUDA-graph capture.  A cached plan that fails to launch raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.sparsity import (PACK_TYPES, BlockSparsePack,
                                       CombinedPack, LookaheadPack, NMPack)
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as _at
from repro_torch.kernels import bsr_matmul as _bsr
from repro_torch.kernels import csa_matmul as _csa
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import lookahead_decode as _la
from repro_torch.kernels import nm_spmm as _nm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels.autotune import (ARCH, AutotuneCache,
                                          autotune_cache, set_autotune_cache)
from repro_torch.kernels.bsr_matmul import bsr_matmul
from repro_torch.kernels.csa_matmul import csa_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lookahead_decode import lookahead_matmul
from repro_torch.kernels.nm_spmm import nm_spmm
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.kernels.paged_attention import \
    paged_attention as _paged_attention

__all__ = ["ARCH", "AutotuneCache", "Decision", "KernelEntry",
           "SparsityDescriptor", "attention", "autotune_cache", "cache_key",
           "load_kernels", "paged_attention", "plain_active", "plain_versions",
           "plan_params", "registry", "resolve_device", "resolve_mode",
           "select", "set_autotune_cache", "sparse_matmul", "tune"]


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
    def of(cls, weight: Any, nominal: bool = False) -> "SparsityDescriptor":
        """The descriptor of a dense tensor, a pack or a paged cache; a
        block or combined pack's density reads its ``counts`` on the
        host, except with ``nominal`` or on ``meta`` (nothing to read):
        then it is the slot density ``max_nnz / (K / bk)``, what the
        kernel's plan depends on (the autotune keys' density, and the
        JAX package's for abstract packs)."""
        if isinstance(weight, (BlockSparsePack, CombinedPack)) and (
                nominal or weight.counts.device.type == "meta"):
            kw = dict(K=weight.K, N=weight.N, dtype=_dtype(weight.values),
                      bk=weight.bk, bn=weight.bn,
                      density=_bsr.slot_density(weight.K, weight.bk,
                                                weight.max_nnz))
            if isinstance(weight, CombinedPack):
                return cls(kind="combined", n=weight.n, m=weight.m, **kw)
            return cls(kind="block", **kw)
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


def resolve_device(device, allow_meta: bool = False) -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; without a CUDA device they raise instead of silently
    running the plain versions — the caller asks for ``"cpu"``.  ``meta``
    is accepted only where ``allow_meta`` says so: the abstract builders
    of the dry run (``models.abstract_model``, ``models.abstract_cache``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    if device.type not in ("cuda", "cpu") and not (
            allow_meta and device.type == "meta"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_mode(device: torch.device) -> str:
    """``kernel`` for a CUDA device, ``ref`` (the plain version) for the
    CPU, ``meta`` (the wrappers' shape-only route) for ``meta``; anything
    else raises."""
    device = torch.device(device)
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "ref"
    if device.type == "meta":
        return "meta"
    raise ValueError(f"no kernels for device {device}")


#: On inside :func:`plain_versions`: the card's calls run the plain
#: versions.  A context variable, so the scope is the caller's alone.
_PLAIN = contextvars.ContextVar("repro_torch_plain_versions", default=False)

#: The kernel modules, each with a ``_fns()`` that loads and binds its
#: library.
KERNEL_MODULES = (_nm, _bsr, _csa, _la, _paged, _flash)


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Run the plain PyTorch versions in place of the kernels on the card
    for the calls made inside the ``with`` block (``on=False`` leaves the
    kernels on, so a caller can pass its own flag).  Each such call adds
    one to its kernel module's ``plain_launches``.  CPU and ``meta``
    calls are unchanged."""
    token = _PLAIN.set(bool(on))
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_active() -> bool:
    """Whether the caller is inside :func:`plain_versions`."""
    return _PLAIN.get()


def _call_mode(device: torch.device, module: Any) -> str:
    """:func:`resolve_mode`, turned to ``ref`` on the card inside
    :func:`plain_versions` (counted in ``module.plain_launches``)."""
    mode = resolve_mode(device)
    if mode == "kernel" and plain_active():
        if module is not None:
            module.plain_launches += 1
        return "ref"
    return mode


def load_kernels() -> None:
    """Build what is missing and load and bind every kernel library now:
    a build or load error raises here, not at a kernel's first call."""
    _build.build_all()
    for mod in KERNEL_MODULES:
        mod._fns()


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One dispatchable kernel: ``run(x, weight, mode)``; ``module`` is its
    wrapper's module (``plan``, ``candidates``, ``cost``), ``None`` for
    the dense product."""
    name: str
    kind: str
    run: Callable[[torch.Tensor, Any, str], torch.Tensor]
    module: Any = None


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


def _paged_run(q, kv, mode, window=None, softcap=None):
    if mode == "ref":
        return ref.paged_attention_ref(q, kv.k, kv.v, kv.ptab, kv.lens,
                                       window=window, softcap=softcap)
    return _paged_attention(q, kv.k, kv.v, kv.ptab, kv.lens, window=window,
                            softcap=softcap)


_REGISTRY: Dict[str, KernelEntry] = {e.name: e for e in (
    KernelEntry("nm_spmm", "nm", _nm_run, _nm),
    KernelEntry("bsr_matmul", "block", _bsr_run, _bsr),
    KernelEntry("csa_matmul", "combined", _csa_run, _csa),
    KernelEntry("lookahead_decode", "lookahead", _lookahead_run, _la),
    KernelEntry("paged_attention", "paged", _paged_run, _paged),
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
    entry = _entry_for(kind)
    return entry.run(x, weight, _call_mode(x.device, entry.module))


def paged_attention(q: torch.Tensor, kv: PagedKV, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention against a paged KV cache: ``q (B, H, D)``, one
    query per sequence, or ``(B, Q, H, D)``, a verify block whose query
    ``i`` sits at position ``kv.lens - Q + i`` and sees the keys up to
    it (the last ``window`` of them under a sliding window), its logits
    soft-capped by ``softcap``; the output has ``q``'s shape."""
    return _paged_run(q, kv, _call_mode(q.device, _paged), window, softcap)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention, ``(B, H, Lq, D)`` layout, behind the same mode
    policy as the matmuls."""
    if _call_mode(q.device, _flash) == "ref":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


# --- autotune rows -----------------------------------------------------------

def cache_key(kernel: str, M: int, desc: SparsityDescriptor,
              arch: str = ARCH) -> str:
    """``kernel|M|K|N|dtype|pattern|arch``: the key of a launch of
    ``kernel`` at ``M`` rows on a weight described by ``desc`` (with the
    slot density of ``SparsityDescriptor.of(..., nominal=True)``, and
    ``dtype`` the dtype of ``x``); ``arch`` is ``sm90`` for the card and
    ``ref`` for the plain version's rows."""
    return _at.key(kernel, M, desc.K, desc.N, desc.dtype, desc.pattern, arch)


@dataclasses.dataclass(frozen=True)
class Decision:
    """What dispatch resolves for one call: the kernel, the mode, the
    launch plan (``{}`` off the card), whether it came from the cache,
    the descriptor and the cache key."""
    kernel: str
    mode: str
    plan: Dict[str, Any]
    descriptor: SparsityDescriptor
    reason: str = ""
    key: str = ""

    @property
    def blocks(self) -> Dict[str, Any]:
        """The JAX ``Decision``'s name for the plan."""
        return self.plan


def _x_dtype(weight: Any) -> torch.dtype:
    """The dtype of ``x`` a pack is multiplied in on the card: its values'
    (a lookahead pack's int8 codes take bfloat16)."""
    if isinstance(weight, LookaheadPack):
        return torch.bfloat16
    return weight.values.dtype


def _rule_plan(entry: KernelEntry, M: int, weight: Any,
               dtype: torch.dtype) -> dict:
    args = _plan_args(entry, M, weight, dtype)
    return entry.module.plan(*args)


def _plan_args(entry: KernelEntry, M: int, weight: Any,
               dtype: torch.dtype) -> tuple:
    """The arguments of ``entry.module.plan``/``candidates`` for ``x (M,
    K)`` of ``dtype`` times ``weight``."""
    w = weight
    if entry.kind == "nm":
        return (M, w.K, w.N, dtype, w.n, w.m, w.g)
    if entry.kind == "block":
        return (M, w.K, w.N, dtype, w.max_nnz, w.bk, w.bn)
    if entry.kind == "combined":
        return (M, w.K, w.N, dtype, w.max_nnz, w.bk, w.bn, w.n, w.m)
    return (M, w.K, w.N, dtype)


def _weight_key(entry: KernelEntry, M: int, weight: Any,
                dtype: torch.dtype, arch: str) -> str:
    desc = dataclasses.replace(SparsityDescriptor.of(weight, nominal=True),
                               dtype=_at.dtype_name(dtype))
    return cache_key(entry.name, M, desc, arch)


def paged_key(B: int, H: int, Hk: int, Q: int, n_pages: int, D: int,
              dtypes, page_size: int, window: Optional[int] = None,
              arch: str = ARCH) -> str:
    """The autotune key of a ``paged_attention`` launch: B, H, Hk, Q, the
    view's pages, D, the dtypes and the window (the JAX
    ``_paged_attn_run`` row's geometry, with the heads and queries the
    port's plans depend on)."""
    return _at.key("paged_attention", *_paged.key_fields(
        B, H, Hk, Q, n_pages, D, dtypes, page_size, window), arch)


def select(weight: Any, M: int = 128, device=None, *,
           autotune: bool = False, dtype: Optional[torch.dtype] = None
           ) -> Decision:
    """Kernel, mode and launch plan for ``x (M, K) @ weight`` on ``device``
    (default the weight's), ``x`` of ``dtype`` (default the pack's).  On
    the card the plan is the cached one (``reason="cached"``), else —
    with ``autotune`` — the winner of a sweep at this key run now on
    random ``x`` (``"tuned"``), else the tiling rule's (``"tiling
    rule"``).  Off the card the plan is ``{}``.  No launch happens
    without ``autotune``."""
    desc = SparsityDescriptor.of(weight, nominal=True)
    if device is None:
        leaf = weight if isinstance(weight, torch.Tensor) else (
            weight.enc if isinstance(weight, LookaheadPack)
            else weight.values)
        device = leaf.device
    mode = resolve_mode(device)
    entry = _entry_for(desc.kind)
    if entry.module is None or mode in ("ref", "meta"):
        return Decision(entry.name, mode, {}, desc,
                        "dense weight" if entry.module is None else
                        "no plan off the card")
    dtype = dtype or _x_dtype(weight)
    key = _weight_key(entry, M, weight, dtype, ARCH)
    hit = autotune_cache().get(key)
    if hit is not None:
        return Decision(entry.name, mode, _at.plan_of(hit), desc, "cached",
                        key)
    if autotune:
        x = torch.randn((M, desc.K), device=device).to(dtype)
        plan = tune(x, weight)
        return Decision(entry.name, mode, plan, desc, "tuned", key)
    return Decision(entry.name, mode, _rule_plan(entry, M, weight, dtype),
                    desc, "tiling rule", key)


#: Candidates :func:`tune` skipped because they failed to launch, since
#: the count was last set to 0.
skipped = 0


def _timer(device: torch.device):
    """``time(fn, reps) -> µs per call``.  On the card: ``reps`` calls
    captured in one CUDA graph (after two eager warm calls, which raise
    for a plan that does not launch) and replayed between CUDA events,
    so the device's time counts and not the host's launch cost.  On the
    CPU: the host clock."""
    def cuda_us(fn, reps):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / (3 * reps)

    def host_us(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e6 / reps

    return cuda_us if device.type == "cuda" else host_us


def tune(x: torch.Tensor, weight: Any,
         candidates: Optional[Sequence[dict]] = None,
         cache: Optional[AutotuneCache] = None, reps: int = 10, *,
         window: Optional[int] = None) -> dict:
    """Sweep the launch plans of ``x (M, K) @ weight`` (or of
    ``paged_attention`` for ``x = q (B, [Q,] H, D)`` and a
    :class:`PagedKV` ``weight`` under ``window``), persist the fastest and
    return it.  ``candidates`` defaults to the kernel module's (the
    tiling rule's plan first).  On the card each is timed with CUDA
    events over a captured graph of ``reps`` calls (its device time); one
    that fails to launch is skipped and counted in
    :data:`skipped` and in the entry's ``skipped``.  On the CPU the plain
    version runs for each (the plan does not apply there) and the row is
    keyed ``ref``, exercising the cache on the same keys.  A hit returns
    the cached plan without a sweep.  Raises inside a CUDA-graph
    capture: a sweep there would land in the graph."""
    global skipped
    if x.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune sweeps never run inside a CUDA-graph "
                           "capture; warm the cache first "
                           "(benchmarks.warm_autotune)")
    mode = resolve_mode(x.device)
    if mode == "meta":
        raise ValueError("nothing to time on meta tensors")
    arch = ARCH if mode == "kernel" else "ref"
    if isinstance(weight, PagedKV):
        B, Q, H, D = x.shape if x.dim() == 4 else \
            (x.shape[0], 1, *x.shape[1:])
        args = (B, H, weight.k.shape[2], Q, weight.max_pages, D,
                (x.dtype, weight.k.dtype), weight.page_size)
        key = paged_key(*args, window=window, arch=arch)
        default = _paged.candidates(*args)

        def run(plan):
            if mode == "ref":
                return _paged_run(x, weight, "ref", window)
            return _paged_attention(x, weight.k, weight.v, weight.ptab,
                                    weight.lens, window=window,
                                    use_plan=plan)
    else:
        entry = _entry_for(SparsityDescriptor.of(weight, nominal=True).kind)
        if entry.module is None:
            return {}
        key = _weight_key(entry, x.shape[0], weight, x.dtype, arch)
        wrapper = {"nm": nm_spmm, "block": bsr_matmul, "combined": csa_matmul,
                   "lookahead": lookahead_matmul}[entry.kind]
        default = entry.module.candidates(
            *_plan_args(entry, x.shape[0], weight, x.dtype))

        def run(plan):
            if mode == "ref":
                return entry.run(x, weight, "ref")
            return wrapper(x, weight, use_plan=plan)
    cache = cache or autotune_cache()
    hit = cache.get(key)
    if hit is not None:
        return _at.plan_of(hit)
    cands = list(candidates) if candidates is not None else default
    time_us = _timer(x.device)
    best, best_us, rule_us, missed = None, math.inf, None, 0
    for i, plan in enumerate(cands):
        try:
            us = time_us(lambda p=plan: run(p), reps)
        except Exception:
            missed += 1
            continue
        if i == 0:
            rule_us = us
        if us < best_us:
            best, best_us = dict(plan), us
    skipped += missed
    if best is None:            # nothing launched: the first candidate
        return dict(cands[0]) if cands else {}
    cache.put(key, {**best, "us": round(best_us, 3),
                    "rule_us": None if rule_us is None else round(rule_us, 3),
                    "skipped": missed})
    return best


def plan_params(params: Any, M: int, device,
                expert_M: Optional[int] = None,
                with_plans: bool = False) -> List[dict]:
    """The dispatch decision for every packed weight of a param tree at
    ``M`` rows on ``device`` — what the engine records per phase.  A
    routed expert's packs (``moe/w_in|w_gate|w_out/<e>``) take
    ``expert_M`` rows when it is given: the rows a capacity dispatch
    hands each expert (``models.moe.expert_rows``).  ``with_plans`` adds
    each row's card launch plan (``"plan"``) and where it comes from
    (``"source"``: ``"cache"`` or ``"rule"``), read without a launch."""
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
            routed = expert_M is not None and len(path) >= 3 and \
                path[-3] == "moe" and path[-2] in ("w_in", "w_gate", "w_out")
            rows = expert_M if routed else M
            entry = _entry_for(d.kind)
            row = {"param": "/".join(path), "M": rows, "kernel": entry.name,
                   "mode": mode, "pattern": d.pattern}
            if with_plans:
                dtype = _x_dtype(node)
                hit = autotune_cache().get(
                    _weight_key(entry, rows, node, dtype, ARCH))
                row["plan"] = _at.plan_of(hit) if hit is not None else \
                    _rule_plan(entry, rows, node, dtype)
                row["source"] = "cache" if hit is not None else "rule"
            plan.append(row)

    visit(params, ())
    return plan
