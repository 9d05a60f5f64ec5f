"""Carry parameters from the JAX package into the port, with numpy as the
bridge (this module imports neither ``jax`` nor ``repro``).

The input is the JAX parameter tree flattened to nested dicts of numpy
arrays: every pack becomes the dict of its fields (``NMPack``:
``values, idx, K, N, n, m, g``; ``BlockSparsePack``: ``values, indices,
counts, K, N, bk, bn, max_nnz``; ``CombinedPack``: those plus ``gidx, n,
m``; ``LookaheadPack``: ``enc, scale, K, N``), and the layer stacks
(``STACKS``) keep their leading layer axis (the JAX models scan over
them).  The output is the port's tree: ``layers``, ``mamba`` (the hybrid
family's trunk) and the enc-dec ``encoder`` and ``decoder`` become lists
of per-layer dicts, packs included, the hybrid ``shared`` block converts
as it is,
packs become the port's pack classes, arrays become tensors on
``device`` in their own dtype — so both sides compute the same thing.
A layer of a stacked block or combined pack keeps the padding slots the
JAX packer added up to the largest layer's ``max_nnz``.  An MoE layer's
expert projections (``moe/w_in``, ``w_gate``, ``w_out``; the JAX tree
stacks them ``(L, E, …)``) keep their expert axis as a dense ``(E, K, N)``
tensor, or become a list of ``E`` packs — the forms
``core.sparse_linear.pack_params`` gives; ``router`` stays fp32.
gemma's post-norms (``ln_attn_post``, ``ln_mlp_post``) are per-layer
leaves like the other norms and carry over as they are.  A ``None`` leaf
(a mask tree's dense entry) stays ``None``; an optimizer state
(``{"mu", "nu", "step"}``, plus ``"ef"`` under compressed grads)
converts each moment tree as a param tree and keeps the step counter as
an int32 tensor on the host, where the port's AdamW keeps it.

:func:`cnn_params_from_numpy` does the same for the TinyML CNNs of
``models/cnn.py``: conv kernels go from HWIO to the port's OIHW, every
other array (fc ``(K, N)``, norms, biases) keeps its shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.sparsity import PACK_TYPES

#: field names of each pack class; the key sets are distinct
_PACKS = {frozenset(f.name for f in dataclasses.fields(c)): c
          for c in PACK_TYPES}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _pack_class(node: Any) -> Optional[type]:
    return _PACKS.get(frozenset(node)) if isinstance(node, dict) else None


#: the subtrees the JAX models stack over layers
STACKS = ("layers", "mamba", "encoder", "decoder")
#: the expert projections of an MoE layer's ``moe`` subtree
_EXPERTS = ("w_in", "w_gate", "w_out")


def _convert(node: Any, device, index: tuple = (), moe: bool = False
             ) -> Any:
    """Convert a subtree, taking ``a[index]`` of every array (``index``
    names a layer of a layer stack, and an expert of an expert stack);
    under an ``moe`` dict, an expert pack stack becomes a list of packs."""
    if node is None:
        return None
    cls = _pack_class(node)
    if cls is not None:
        return cls(**{k: int(v) if isinstance(v, (int, np.integer)) else
                      _tensor(np.asarray(v)[index], device)
                      for k, v in node.items()})
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if moe and k in _EXPERTS and _pack_class(v) is not None:
                E = _lead(v)[len(index)]
                out[k] = [_convert(v, device, index + (e,))
                          for e in range(E)]
            else:
                out[k] = _convert(v, device, index, moe=k == "moe")
        return out
    return _tensor(np.asarray(node)[index], device)


def _lead(node: Any) -> Optional[tuple]:
    """Shape of the first array in a subtree (a pack's ``values`` or
    ``enc``), ``None`` for a subtree of ``None`` leaves only."""
    if node is None:
        return None
    cls = _pack_class(node)
    if cls is not None:
        return np.asarray(node["enc" if "enc" in node else "values"]).shape
    if isinstance(node, dict):
        return next((s for s in map(_lead, node.values()) if s is not None),
                    None)
    return np.asarray(node).shape


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's params from a numpy-flattened JAX param tree (or mask
    tree, or optimizer state: see the module docstring)."""
    from repro_torch.kernels.dispatch import resolve_device
    device = resolve_device(device)
    if {"mu", "nu"} <= set(tree):
        return {k: torch.tensor(int(np.asarray(v)), dtype=torch.int32)
                if k == "step" else params_from_numpy(v, device)
                for k, v in tree.items()}
    out = {}
    for k, v in tree.items():
        if k in STACKS and v is not None:
            out[k] = [_convert(v, device, (l,)) for l in range(_lead(v)[0])]
        else:
            out[k] = _convert(v, device)
    return out


def cnn_params_from_numpy(tree: Any, device="cuda") -> Any:
    """The port's CNN params from a JAX CNN param tree of numpy arrays
    (nested dicts and lists as ``repro/models/cnn.py`` builds them)."""
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models.cnn import hwio_to_oihw
    device = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v) for v in node]
        t = _tensor(np.asarray(node), device)
        return hwio_to_oihw(t) if t.dim() == 4 else t

    return visit(tree)
