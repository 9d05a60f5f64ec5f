"""Roofline numerators of the port: FLOPs, live bytes and collective bytes
of one step, counted on ``meta`` tensors.

The JAX package walks a step's jaxpr; the port runs the step once on
``meta`` tensors (``models.abstract_model`` / ``abstract_cache``) under a
``TorchDispatchMode`` that sees every aten op, forward and backward:

  * :func:`step_flops` counts with the JAX ``jaxpr_flops`` convention:
    ``mm``/``addmm``/``bmm``/``baddbmm`` and convolutions (forward and
    backward) from their shapes; the six hand-written kernels from their
    wrappers' ``cost`` (their meta route reports it, and the ops it
    issues to shape the output are not counted); every floating output of
    any other op at 1 FLOP per element.  Views (``reshape``,
    ``permute``, ``expand``, ``detach``...) count 0: they move no data in
    PyTorch, where XLA's ``reshape``/``transpose`` eqns count their
    elements.  A Python loop is counted as many times as it runs, as a
    ``scan`` is counted ``length`` times; ``torch.utils.checkpoint``
    recomputation is counted where it runs.
  * :func:`peak_live_bytes` is the counterpart of ``memory_analysis()``:
    the most bytes of storage alive at once during the step, storages
    counted once however many views share them, the step's inputs
    included (they are alive from the start).
  * collective bytes: the operand bytes of the ``torch.distributed``
    functional collectives (``_c10d_functional``) and ``c10d`` ops the
    mode sees; 0 on one device.  The JAX ``hlo_collective_bytes`` parses
    compiled XLA text, which the port does not have; this count replaces
    it.
  * :func:`memory_traffic` is the JAX model of a step's HBM bytes,
    copied as it is.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build

aten = torch.ops.aten

_MATMULS = {aten.mm: (0, 1), aten.addmm: (1, 2), aten.bmm: (0, 1),
            aten.baddbmm: (1, 2)}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")


@dataclasses.dataclass
class StepCount:
    """What one step did on ``meta``: FLOPs by term, kernel costs, bytes."""
    matmul_flops: float = 0.0
    conv_flops: float = 0.0
    other_flops: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    entry_bytes: int = 0
    peak_live_bytes: int = 0
    out: Any = None

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.conv_flops + self.other_flops \
            + sum(self.kernel_flops.values())

    @property
    def temp_bytes(self) -> int:
        """The peak's bytes beyond the step's inputs: the counterpart of
        XLA's temp size."""
        return self.peak_live_bytes - self.entry_bytes


def tensors_of(tree: Any) -> list:
    """Every tensor of a nested dict / list / tuple / dataclass (a pack)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name))]
    return []


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point or t.dtype.is_complex


def _matmul_flops(a: torch.Tensor, b: torch.Tensor) -> float:
    """``2 · batch · m · k · n`` of ``a (..., m, k) @ b (..., k, n)``."""
    *batch, m, k = a.shape
    return 2.0 * math.prod(batch) * m * k * b.shape[-1]


def _conv_flops(out_shape, weight: torch.Tensor, transposed: bool,
                in_shape) -> float:
    """``2 · out elements · kernel elements · in channels per group`` (a
    transposed convolution: over its input's elements)."""
    kernel = math.prod(weight.shape[2:])
    if transposed:
        return 2.0 * math.prod(in_shape) * kernel * weight.shape[1]
    return 2.0 * math.prod(out_shape) * kernel * weight.shape[1]


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, kernel costs, collective bytes and live storage of
    the ops run under it (see the module docstring).  ``inputs`` are the
    tensors alive when the step starts: their storages count from the
    start and are never released."""

    def __init__(self, inputs: Any = ()):
        super().__init__()
        self.count = StepCount()
        self._live = 0
        self._known: Dict[int, int] = {}
        for t in tensors_of(inputs):
            key = t.untyped_storage()._cdata
            if key not in self._known:
                self._known[key] = -1               # never released
                self._live += t.untyped_storage().nbytes()
        self.count.entry_bytes = self.count.peak_live_bytes = self._live

    # --- the kernels' meta route ----------------------------------------
    def _sink(self, name: str, cost: dict) -> None:
        c = self.count
        c.kernel_flops[name] = c.kernel_flops.get(name, 0.0) + cost["flops"]
        c.kernel_bytes[name] = c.kernel_bytes.get(name, 0.0) + cost["bytes"]
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1

    def __enter__(self):
        _build.COST_SINKS.append(self._sink)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COST_SINKS.remove(self._sink)
        return super().__exit__(*exc)

    # --- live storage -----------------------------------------------------
    def _release(self, key: int, nbytes: int) -> None:
        if self._known.pop(key, None) is not None:
            self._live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._known:
            return
        n = s.nbytes()
        self._known[key] = n
        self._live += n
        self.count.peak_live_bytes = max(self.count.peak_live_bytes,
                                         self._live)
        weakref.finalize(s, self._release, key, n)

    # --- the count --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if _build.META_DEPTH:
            return out
        c, packet = self.count, func.overloadpacket
        if packet in _MATMULS:
            i, j = _MATMULS[packet]
            c.matmul_flops += _matmul_flops(args[i], args[j])
        elif packet is aten.convolution:
            x, w, transposed = args[0], args[1], args[6]
            c.conv_flops += _conv_flops(out.shape, w, transposed, x.shape)
        elif packet is aten.convolution_backward:
            grad, x, w, transposed, mask = (args[0], args[1], args[2],
                                            args[7], args[10])
            fwd = _conv_flops(grad.shape, w, transposed, x.shape)
            c.conv_flops += fwd * (int(mask[0]) + int(mask[1]))
        elif func.namespace in _COLLECTIVE_NAMESPACES:
            name = packet.__name__
            c.collective_bytes[name] = c.collective_bytes.get(name, 0) + sum(
                t.numel() * t.element_size() for t in tree_flatten(args)[0]
                if isinstance(t, torch.Tensor))
        elif not func.is_view:
            c.other_flops += sum(t.numel() for t in outs if _is_float(t))
        return out


def count_step(fn: Callable, *args: Any, **kwargs: Any) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter` (the
    arguments alive from the start) and return its count; the count's
    ``out`` is what ``fn`` returned."""
    counter = StepCounter((args, kwargs))
    with counter:
        counter.count.out = fn(*args, **kwargs)
    return counter.count


def step_flops(fn: Callable, *meta_args: Any) -> float:
    """FLOPs of one call of ``fn`` on ``meta`` arguments (the JAX
    ``step_flops``' convention, see the module docstring)."""
    return count_step(fn, *meta_args).flops


def peak_live_bytes(fn: Callable, *meta_args: Any) -> int:
    """The most bytes of storage alive at once during one call of ``fn``,
    its arguments included."""
    return count_step(fn, *meta_args).peak_live_bytes


def collective_bytes(fn: Callable, *meta_args: Any) -> Dict[str, Any]:
    """Operand bytes of the collectives one call of ``fn`` issues, by op,
    and their total (0 on one device)."""
    by = count_step(fn, *meta_args).collective_bytes
    return {"bytes_by_kind": dict(by), "total_bytes": int(sum(by.values()))}


# ---------------------------------------------------------------------------
# HBM traffic model
# ---------------------------------------------------------------------------

def memory_traffic(param_bytes_pd: int, temp_bytes_pd: int,
                   cache_bytes_pd: int = 0, opt_bytes_pd: int = 0,
                   microbatches: int = 1) -> int:
    """Modeled per-chip HBM bytes of one step (lower bound, see module
    docstring)."""
    return int(param_bytes_pd * microbatches      # weights streamed per µb
               + 2 * opt_bytes_pd                 # moments read + written
               + cache_bytes_pd                   # KV/SSM cache read
               + 2 * temp_bytes_pd)               # temps written + read
