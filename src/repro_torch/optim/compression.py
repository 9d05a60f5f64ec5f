"""Gradient compression: int8 with a per-leaf absmax scale and error
feedback — ``compress_int8``, ``decompress_int8`` and ``compress_tree``
of the JAX package's ``optim/compression.py``.

Each gradient leaf is quantized to int8 against its own absmax; error
feedback keeps the residual and folds it into the next step's gradient,
so the quantization error does not accumulate.  A layer stack of the
port's trees (a list of per-layer dicts) is one stacked ``(L, ...)``
leaf of the JAX package's, so in ``compress_tree`` the leaves of one
name across a list share one scale, their absmax over the list, as the
JAX leaf's absmax is over its stacked array.  The collectives that
move the int8 payload (``compressed_psum``, ``psum_compressed_tree``)
come with tensor parallelism (ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import leaves, stack_names, tree_map, unflatten


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.where(absmax > 0, absmax / 127.0, 1.0)


def compress_int8(g: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient leaf → (int8 payload, fp32 scale): the leaf's own absmax
    / 127 unless a shared ``scale`` is given."""
    g32 = g.float()
    if scale is None:
        scale = _scale(g32.abs().max())
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: Any, error: Optional[Any] = None
                  ) -> Tuple[Any, Any, Any]:
    """Quantize a gradient tree with error feedback, one scale per leaf
    of the JAX package's stacked tree (see the module docstring).

    Returns ``(payload {q, scale} per leaf, new_error, approx_grads)``;
    ``error`` is the previous step's residual (``None`` on step 0)."""
    if error is not None:
        grads = tree_map(lambda g, e: g.float() + e, grads, error)
    flat, names = leaves(grads), stack_names(grads)
    absmax: Dict[tuple, torch.Tensor] = {}
    for name, g in zip(names, flat):
        m = g.float().abs().max()
        absmax[name] = m if name not in absmax else \
            torch.maximum(absmax[name], m)
    qs = [compress_int8(g, _scale(absmax[name]))
          for name, g in zip(names, flat)]
    payload = unflatten(grads, [{"q": q, "scale": sc} for q, sc in qs])
    approx = unflatten(grads, [decompress_int8(q, sc) for q, sc in qs])
    new_error = tree_map(lambda g, a: g.float() - a, grads, approx)
    return payload, new_error, approx
