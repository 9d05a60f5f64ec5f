"""Magnitude pruning to the N:M structure ``nm_spmm`` consumes.

Only ``n_m`` is ported so far (the main path packs every projection
2:4); block, unstructured and combined pruning are ROADMAP queue 1
item 10.  Weights are ``(K, N)`` = (in-features, out-features) and the
pattern is imposed along K, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def n_m_numpy(w: np.ndarray, n: int, m: int, group: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the top-``n`` of every ``m`` consecutive K-entries per column
    (positions shared across ``group`` output columns).  Returns
    ``(pruned, mask)``; sparsity is exactly ``1 - n/m``."""
    K, N = w.shape
    if K % m:
        raise ValueError(f"K={K} not divisible by m={m}")
    if N % group:
        raise ValueError(f"N={N} not divisible by group={group}")
    if not 0 < n <= m:
        raise ValueError(f"need 0 < n <= m, got {n}:{m}")
    s = np.abs(w).reshape(K // m, m, N // group, group).sum(axis=3)
    # rank within each m-group (stable, as jnp.argsort): keep the top-n
    order = np.argsort(-s, axis=1, kind="stable")       # (Kg, m, Ng)
    ranks = np.argsort(order, axis=1, kind="stable")
    gmask = (ranks < n).astype(w.dtype)
    mask = np.repeat(gmask[..., None], group, axis=3).reshape(K, N)
    return w * mask, mask


def n_m(w: torch.Tensor, n: int, m: int, group: int = 1
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`n_m_numpy` on a tensor (host float32; exact for bf16/f32);
    the result lands on ``w``'s device in ``w``'s dtype."""
    pruned, mask = n_m_numpy(w.detach().float().cpu().numpy(), n, m, group)
    return (torch.from_numpy(pruned).to(w.device, w.dtype),
            torch.from_numpy(mask).to(w.device, w.dtype))
