"""Carry parameters from the JAX package into the port, with numpy as the
bridge (this module imports neither ``jax`` nor ``repro``).

The input is the JAX parameter tree flattened to nested dicts of numpy
arrays: every ``NMPack`` becomes a dict with ``values``, ``idx``, ``K``,
``N``, ``n``, ``m`` and ``g``, and the ``layers`` subtree keeps its
leading layer axis (the JAX model scans over it).  The output is the
port's tree: ``layers`` becomes a list of per-layer dicts, packs become
:class:`~repro_torch.core.sparsity.NMPack`, arrays become tensors on
``device`` in their own dtype — so both sides compute the same thing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sparsity import NMPack

_PACK_KEYS = {"values", "idx", "K", "N", "n", "m", "g"}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                       # a writable, contiguous copy
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _is_pack(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == _PACK_KEYS


def _convert(node: Any, device, layer=None) -> Any:
    """Convert a subtree, taking slice ``layer`` of every array when the
    subtree is a layer stack."""
    if _is_pack(node):
        pick = (lambda a: a[layer]) if layer is not None else (lambda a: a)
        return NMPack(values=_tensor(pick(node["values"]), device),
                      idx=_tensor(pick(node["idx"]), device).to(torch.int32),
                      K=int(node["K"]), N=int(node["N"]), n=int(node["n"]),
                      m=int(node["m"]), g=int(node["g"]))
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a[layer] if layer is not None else a, device)


def _depth(node: Any) -> int:
    """Leading-axis length of the first array in a layer stack."""
    if _is_pack(node):
        return np.asarray(node["values"]).shape[0]
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
