"""Carry parameters from the JAX package into the port, with numpy as the
bridge (this module imports neither ``jax`` nor ``repro``).

The input is the JAX parameter tree flattened to nested dicts of numpy
arrays: every pack becomes the dict of its fields (``NMPack``:
``values, idx, K, N, n, m, g``; ``BlockSparsePack``: ``values, indices,
counts, K, N, bk, bn, max_nnz``; ``CombinedPack``: those plus ``gidx, n,
m``; ``LookaheadPack``: ``enc, scale, K, N``), and the ``layers``
subtree keeps its leading layer axis (the JAX model scans over it).  The
output is the port's tree: ``layers`` becomes a list of per-layer dicts,
packs become the port's pack classes, arrays become tensors on
``device`` in their own dtype — so both sides compute the same thing.
A layer of a stacked block or combined pack keeps the padding slots the
JAX packer added up to the largest layer's ``max_nnz``.
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


def _convert(node: Any, device, layer=None) -> Any:
    """Convert a subtree, taking slice ``layer`` of every array when the
    subtree is a layer stack."""
    cls = _pack_class(node)
    if cls is not None:
        return cls(**{k: int(v) if isinstance(v, (int, np.integer)) else
                      _tensor(v[layer] if layer is not None else v, device)
                      for k, v in node.items()})
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a[layer] if layer is not None else a, device)


def _depth(node: Any) -> int:
    """Leading-axis length of the first array in a layer stack."""
    cls = _pack_class(node)
    if cls is not None:
        first = "enc" if "enc" in node else "values"
        return np.asarray(node[first]).shape[0]
    if isinstance(node, dict):
        return _depth(next(iter(node.values())))
    return np.asarray(node).shape[0]


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's params from a numpy-flattened JAX param tree."""
    from repro_torch.kernels.dispatch import resolve_device
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = [_convert(v, device, l) for l in range(_depth(v))]
        else:
            out[k] = _convert(v, device)
    return out
