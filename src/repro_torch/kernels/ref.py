"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held
against on the card, and the port's CPU execution path (a wrapper takes
it for a tensor on the CPU).  They repeat the JAX package's oracles in
``repro/kernels/ref.py`` operation for operation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import encoding
from repro_torch.core.sparsity import (BlockSparsePack, CombinedPack,
                                       LookaheadPack, NMPack)

NEG_INF = -1e30


def nm_spmm_ref(x: torch.Tensor, pack: NMPack) -> torch.Tensor:
    """``x (M, K) @ densify(pack)`` via activation gather + short-K matmul
    (fp32 accumulation, output in ``x.dtype``)."""
    M = x.shape[0]
    Ng, g = pack.N // pack.g, pack.g
    xg = x[:, pack.src_rows()]                            # (M, Kc, Ng)
    vals = pack.values.reshape(pack.Kc, Ng, g)
    out = torch.einsum("mkj,kjg->mjg", xg.float(), vals.float())
    return out.reshape(M, pack.N).to(x.dtype)


def bsr_matmul_ref(x: torch.Tensor, pack: BlockSparsePack) -> torch.Tensor:
    """``x (M, K) @ densify(pack)`` over the packed tiles only: gather the
    x K-tiles the strips list, mask the padding slots, contract."""
    M, K = x.shape
    bk = pack.bk
    xt = x.reshape(M, K // bk, bk)
    xg = xt[:, pack.indices.long(), :].permute(1, 2, 0, 3)  # (Nb, T, M, bk)
    valid = (torch.arange(pack.max_nnz, device=x.device)[None, :]
             < pack.counts[:, None])
    vals = torch.where(valid[:, :, None, None], pack.values, 0)
    out = torch.einsum("jtmk,jtkn->jmn", xg.float(), vals.float())
    return out.permute(1, 0, 2).reshape(M, pack.N).to(x.dtype)


def csa_matmul_ref(x: torch.Tensor, pack: CombinedPack) -> torch.Tensor:
    """``x (M, K) @ densify(pack)``: gather each listed K-tile, then its
    n:m-kept rows through ``gidx``, mask the padding slots, contract."""
    M, K = x.shape
    Nb, T, bkc = pack.gidx.shape
    xt = x.reshape(M, K // pack.bk, pack.bk)
    xg = xt[:, pack.indices.long(), :]                     # (M, Nb, T, bk)
    xs = torch.gather(xg, 3, pack.gidx.long()[None].expand(M, Nb, T, bkc))
    valid = (torch.arange(T, device=x.device)[None, :]
             < pack.counts[:, None])
    vals = torch.where(valid[:, :, None, None], pack.values, 0)
    out = torch.einsum("mjtk,jtkn->mjn", xs.float(), vals.float())
    return out.reshape(M, pack.N).to(x.dtype)


def lookahead_matmul_ref(x: torch.Tensor, pack: LookaheadPack
                         ) -> torch.Tensor:
    """Decode the INT7 values, apply the per-column scale, then the
    product (the kernel applies the scale after it)."""
    w = encoding.decode_values(pack.enc).float() * pack.scale
    return (x.float() @ w).to(x.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, ptab: torch.Tensor,
                        lens: torch.Tensor,
                        scale: Optional[float] = None, *,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention against a paged KV cache.

    ``q (B, H, D)`` — one query per sequence — or ``(B, Q, H, D)``, a
    decode-shaped block whose query ``i`` sits at position ``qpos = lens
    - Q + i`` and sees the keys ``kpos <= qpos`` (and ``kpos > qpos -
    window`` under a sliding ``window``); ``k_pool/v_pool (P, ps, Hk,
    D)``; ``ptab (B, np)`` page table; ``lens (B,)`` valid rows including
    the block.  The logits are scaled, then soft-capped as ``tanh(s /
    softcap) * softcap``, then masked, as the JAX ``_sdpa`` does over the
    gathered view.  Fully masked rows (``lens == 0``) give zeros.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, Q, H, D = q.shape
    ps, Hk = k_pool.shape[1], k_pool.shape[2]
    pt = ptab.long()
    k = k_pool[pt]                                   # (B, np, ps, Hk, D)
    v = v_pool[pt]
    L = k.shape[1] * ps
    k = k.reshape(B, L, Hk, D).transpose(1, 2)       # (B, Hk, L, D)
    v = v.reshape(B, L, Hk, D).transpose(1, 2)
    if H != Hk:
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    s = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bqhd,bhkd->bhqk", q.float(), k.float()) * s
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = lens.long()[:, None] - Q + torch.arange(Q, device=q.device)
    kpos = torch.arange(L, device=q.device)[None, None, :]
    mask = kpos <= qpos[:, :, None]                             # (B, Q, L)
    if window is not None:
        mask &= kpos > qpos[:, :, None] - window
    mask = mask[:, None]                                        # (B,1,Q,L)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask, p, 0.0)
    out = torch.einsum("bhqk,bhkd->bqhd", p, v.float()).to(q.dtype)
    return out[:, 0] if squeeze else out


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """``(B, H, Lq, D), (B, Hk, Lk, D), (B, Hk, Lk, D) -> (B, H, Lq, D)``.

    Causal masking, sliding windows, logit soft-capping and GQA (H a
    multiple of Hk).  The Lq queries are the *last* Lq positions of the
    Lk keys.
    """
    Lq, D = q.shape[-2:]
    Lk = k.shape[-2]
    H, Hk = q.shape[1], k.shape[1]
    if H != Hk:
        if H % Hk:
            raise ValueError(f"H={H} not a multiple of Hk={Hk}")
        k = k.repeat_interleave(H // Hk, dim=1)
        v = v.repeat_interleave(H // Hk, dim=1)
    s = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * s
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(Lq, device=q.device) + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
