"""Magnitude pruning to the structures the port's kernels consume.

Weights are ``(K, N)`` = (in-features, out-features) and every pattern is
imposed along K, as in the JAX package:

  * :func:`n_m` — keep ``n`` of every ``m`` K-entries, positions shared
    over ``group`` columns (``nm_spmm``);
  * :func:`block_semi_structured` — zero whole ``(block × 1)``
    K-segments, ranked by L1 mass against one global threshold
    (``bsr_matmul``; the int7 ``lookahead`` path at block 4);
  * :func:`combined_nm` — the block mask times an n:m mask
    (``csa_matmul``).

Scores are computed on the host in float32 numpy (exact for bf16 and f32
weights); each result lands on ``w``'s device in ``w``'s dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import BLOCK


def _host(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy()


def _back(w: torch.Tensor, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(w.device, w.dtype) for a in arrays)


def _threshold_topk(scores: np.ndarray, keep: int) -> np.ndarray:
    """Mask keeping the globally top-``keep`` entries of ``scores``;
    ``>= kth`` keeps ties beyond ``keep``, as the JAX package does."""
    flat = scores.reshape(-1)
    keep = min(max(int(keep), 1), flat.size)
    kth = np.partition(flat, flat.size - keep)[flat.size - keep]
    return (scores >= kth).astype(scores.dtype)


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
    """:func:`n_m_numpy` on a tensor."""
    return _back(w, *n_m_numpy(_host(w), n, m, group))


def block_semi_structured_numpy(w: np.ndarray, sparsity: float,
                                block: int = BLOCK
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero the lowest-scoring ``sparsity`` fraction of ``(block × 1)``
    K-segments (the paper's 4:4 at ``block = 4``).  Returns ``(pruned,
    mask)``."""
    K, N = w.shape
    if K % block:
        raise ValueError(f"K={K} not divisible by block={block}")
    s = np.abs(w).reshape(K // block, block, N).sum(axis=1)   # (Kb, N)
    bmask = _threshold_topk(s, round(s.size * (1.0 - sparsity)))
    mask = np.repeat(bmask, block, axis=0).astype(w.dtype)
    return w * mask, mask


def block_semi_structured(w: torch.Tensor, sparsity: float,
                          block: int = BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`block_semi_structured_numpy` on a tensor."""
    return _back(w, *block_semi_structured_numpy(_host(w), sparsity, block))


def combined_nm(w: torch.Tensor, x_ss: float, n: int, m: int,
                group: int = 1, block: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSA pruning: the block mask of :func:`block_semi_structured` (block
    sparsity ``x_ss``) times the n:m mask of :func:`n_m`, both scored on
    ``w``.  ``block`` defaults to ``max(4, m)``."""
    block = block or max(BLOCK, m)
    if block % m:
        raise ValueError(f"block={block} must be a multiple of m={m}")
    h = _host(w)
    _, bmask = block_semi_structured_numpy(h, x_ss, block)
    _, nmask = n_m_numpy(h, n, m, group)
    mask = bmask * nmask
    return _back(w, h * mask, mask)
