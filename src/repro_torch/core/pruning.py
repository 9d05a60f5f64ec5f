"""Magnitude pruning to the structures the port's kernels consume.

Weights are ``(K, N)`` = (in-features, out-features) and every pattern is
imposed along K, as in the JAX package:

  * :func:`n_m` — keep ``n`` of every ``m`` K-entries, positions shared
    over ``group`` columns (``nm_spmm``);
  * :func:`block_semi_structured` — zero whole ``(block × 1)``
    K-segments, ranked by L1 mass against one global threshold
    (``bsr_matmul``; the int7 ``lookahead`` path at block 4);
  * :func:`combined_nm` — the block mask times an n:m mask
    (``csa_matmul``);
  * :func:`unstructured` — arbitrary zeros (the paper's USSA target);
  * :func:`combined` — block sparsity ``x_ss`` outside, unstructured
    ``x_us`` inside the surviving blocks (the paper's CSA target, Fig. 10).

Convolution kernels ``(H, W, Cin, Cout)`` are pruned as their
``(H·W·Cin, Cout)`` view, as Algorithm 1 walks ``kernel[h][w][c]``.

Scores are computed on the host in float32 numpy (exact for bf16 and f32
weights); each result lands on ``w``'s device in ``w``'s dtype.  The
exception is :func:`n_m`, which runs in torch ops on ``w``'s device (a
full-width model's weights are tens of GB, which a host pass would copy
out and back at minutes per model): its float32 group sums run in that
device's order, so two positions within rounding of each other may rank
apart from :func:`n_m_numpy`'s.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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


def _check_n_m(K: int, N: int, n: int, m: int, group: int) -> None:
    if K % m:
        raise ValueError(f"K={K} not divisible by m={m}")
    if N % group:
        raise ValueError(f"N={N} not divisible by group={group}")
    if not 0 < n <= m:
        raise ValueError(f"need 0 < n <= m, got {n}:{m}")


def n_m_numpy(w: np.ndarray, n: int, m: int, group: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the top-``n`` of every ``m`` consecutive K-entries per column
    (positions shared across ``group`` output columns).  Returns
    ``(pruned, mask)``; sparsity is exactly ``1 - n/m``."""
    K, N = w.shape
    _check_n_m(K, N, n, m, group)
    s = np.abs(w).reshape(K // m, m, N // group, group).sum(axis=3)
    # rank within each m-group (stable, as jnp.argsort): keep the top-n
    order = np.argsort(-s, axis=1, kind="stable")       # (Kg, m, Ng)
    ranks = np.argsort(order, axis=1, kind="stable")
    gmask = (ranks < n).astype(w.dtype)
    mask = np.repeat(gmask[..., None], group, axis=3).reshape(K, N)
    return w * mask, mask


def n_m(w: torch.Tensor, n: int, m: int, group: int = 1
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`n_m_numpy` in torch ops on ``w``'s device (float32 group
    sums in that device's order)."""
    K, N = w.shape
    _check_n_m(K, N, n, m, group)
    s = w.float().abs().reshape(K // m, m, N // group, group).sum(dim=3)
    order = torch.argsort(-s, dim=1, stable=True)           # (Kg, m, Ng)
    gmask = torch.argsort(order, dim=1, stable=True) < n
    mask = gmask[..., None].expand(-1, -1, -1, group).reshape(K, N)
    mask = mask.to(w.dtype)
    return w * mask, mask


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


def unstructured_numpy(w: np.ndarray, sparsity: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero the ``sparsity`` fraction of smallest-|w| entries, anywhere
    (ties at the threshold are kept).  ``keep`` is Python's ``round``, as
    in the JAX package."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity {sparsity} must be in [0, 1)")
    keep = round(w.size * (1.0 - sparsity))
    mask = _threshold_topk(np.abs(w), keep).astype(w.dtype)
    return w * mask, mask


def unstructured(w: torch.Tensor, sparsity: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`unstructured_numpy` on a tensor."""
    return _back(w, *unstructured_numpy(_host(w), sparsity))


def combined_numpy(w: np.ndarray, x_ss: float, x_us: float,
                   block: int = BLOCK) -> Tuple[np.ndarray, np.ndarray]:
    """CSA pruning (paper Section III-D, Fig. 10): remove ``x_ss`` of the
    ``(block × 1)`` K-segments, then ``x_us`` of the surviving weights by
    magnitude.  Total sparsity is ``x_ss + (1 - x_ss) · x_us``.

    As the JAX package: ``keep = round(surviving · (1 - x_us))`` in
    float32 (half to even), and the threshold is the ``keep``-th largest
    surviving score, ties kept."""
    _, bmask = block_semi_structured_numpy(w, x_ss, block)
    surviving = np.float32(bmask.sum(dtype=np.float64))
    keep = int(np.round(surviving * np.float32(1.0 - x_us)))
    s = np.where(bmask > 0, np.abs(w * bmask), -np.inf).astype(np.float32)
    flat = s.reshape(-1)
    rank = max(keep - 1, 0)                  # in the descending order
    kth_val = np.partition(flat, flat.size - 1 - rank)[flat.size - 1 - rank]
    umask = ((s >= kth_val) & (bmask > 0)).astype(w.dtype)
    return w * umask, umask


def combined(w: torch.Tensor, x_ss: float, x_us: float, block: int = BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`combined_numpy` on a tensor."""
    return _back(w, *combined_numpy(_host(w), x_ss, x_us, block))


def iterative_schedule(target: float, steps: int,
                       power: float = 3.0) -> List[float]:
    """Zhu-Gupta cubic sparsity schedule ``s_t = target·(1-(1-t/T)^power)``:
    per-step sparsities ending exactly at ``target``."""
    if steps < 1:
        raise ValueError("steps >= 1")
    return [target * (1.0 - (1.0 - (t + 1) / steps) ** power)
            for t in range(steps)]


def sparsity_of(mask_or_w: torch.Tensor) -> float:
    """Fraction of zeros (the paper's sparsity ratio x) as the JAX
    package's float32 mean computes it on the CPU: the zero count times
    the float32 reciprocal of the size."""
    zeros = int((mask_or_w == 0).sum())
    inv = np.float32(1.0) / np.float32(mask_or_w.numel())
    return float(np.float32(zeros) * inv)


PRUNERS = {"unstructured": unstructured, "block": block_semi_structured,
           "nm": n_m, "combined": combined, "combined_nm": combined_nm}


def prune(w: torch.Tensor, method: str, **kw
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """String-dispatched entry point: ``unstructured(sparsity=)``,
    ``block(sparsity=, block=)``, ``nm(n=, m=, group=)``,
    ``combined(x_ss=, x_us=)``, ``combined_nm(x_ss=, n=, m=, group=)``."""
    if method not in PRUNERS:
        raise ValueError(f"unknown pruning method {method!r}; one of "
                         f"{list(PRUNERS)}")
    return PRUNERS[method](w, **kw)
