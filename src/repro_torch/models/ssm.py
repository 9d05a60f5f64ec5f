"""Mamba-2 (SSD — state-space duality) block of the port, chunked, plain
torch: the JAX package's ``models/ssm.py`` op for op.

Within chunks of length Q the recurrence is a (Q, Q) lower-triangular
attention-like product; across chunks a linear recurrence over the
per-chunk states runs in O(L/Q).  Decode is the O(1) recurrent update.
``in_proj`` and ``out_proj`` go through ``apply_linear`` (dense or a
pack, per the config's ``mlp_sparsity``); the scan, the causal conv and
the recurrent update are elementwise and small products, as in the JAX
reference, which computes them outside any Pallas kernel.

Cast points follow the JAX block: the conv runs in the model dtype on
``xBC`` with the cached state cast to it, ``dt`` and its softplus in
fp32, the scan in fp32, the gated RMSNorm on the model dtype.  The
recurrent caches are fp32 whatever the model dtype.

A cache passed in is written in place (``copy_``): a captured decode
chunk holds the state's addresses, as it holds the KV pool's.

Shapes: d_inner = expand·d_model, H heads of dim P = d_inner/H, state N,
B/C shared across G groups (expanded per head).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import (DENSE, SparsityConfig,
                                            apply_linear, init_linear)
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_mamba(cfg: ModelConfig, dtype: torch.dtype,
               generator: torch.Generator, device) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    K = cfg.ssm_conv
    conv_dim = di + 2 * G * N
    conv_w = torch.randn((K, conv_dim), generator=generator, device=device,
                         dtype=torch.float32) / math.sqrt(K)
    return {
        "in_proj": init_linear(d, 2 * di + 2 * G * N + H, dtype, generator,
                               device),
        "out_proj": init_linear(di, d, dtype, generator, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": L.init_rmsnorm(di, device),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   n_layers: Optional[int] = None, *,
                   dtype: torch.dtype = torch.float32, device) -> Params:
    """Stacked per-layer recurrent state, O(1) in sequence length:
    ``conv (nl, B, K-1, conv_dim)`` and ``ssm (nl, B, H, P, N)``."""
    nl = n_layers if n_layers is not None else cfg.n_layers
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    conv_dim = cfg.d_inner + 2 * G * N
    return {
        "conv": torch.zeros((nl, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((nl, batch, H, P, N), dtype=dtype, device=device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) → (..., Q, Q): S[i, j] = Σ_{k=j+1..i} a[k] (−inf above the
    diagonal)."""
    c = torch.cumsum(a, dim=-1)
    S = c[..., :, None] - c[..., None, :]
    Q = a.shape[-1]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(tri, S, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                return_states: bool = False):
    """SSD scan.  ``x (b, l, h, p)``, ``dt (b, l, h)``, ``A (h,)``, ``B/C
    (b, l, h, n)`` → ``(y (b, l, h, p), final_state (b, h, p, n))``, both
    fp32.

    ``return_states=True`` forces ``chunk=1`` and also returns the state
    *after every position*, ``(b, l, h, p, n)``: what speculative
    decoding needs to roll the state back to an accepted prefix."""
    if return_states:
        chunk = 1
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")
    nc = l // chunk

    xd = (x * dt[..., None]).float()                      # discretized input
    a = (dt * A).float()                                  # (b, l, h)

    xd = xd.reshape(b, nc, chunk, h, p)
    Bc = B.reshape(b, nc, chunk, h, n).float()
    Cc = C.reshape(b, nc, chunk, h, n).float()
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)   # (b, h, nc, Q)
    a_cum = torch.cumsum(ac, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(ac))                         # (b, h, nc, Q, Q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp",
                          Cc, Bc, Lmat, xd)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)     # (b, h, nc, Q)
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", Bc, decay_states, xd)

    # 3. inter-chunk recurrence (the initial state is slot 0)
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                 device=x.device)
    states = torch.cat([init_state[:, None].float(), states], dim=1)
    chunk_sum = a_cum[..., -1]                            # (b, h, nc)
    padded = F.pad(chunk_sum, (1, 0))                     # (b, h, nc + 1)
    decay_chunk = torch.exp(_segsum(padded))              # (b, h, nc+1, nc+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_in, final = new_states[:, :-1], new_states[:, -1]

    # 4. inter-chunk contribution to the outputs
    out_decay = torch.exp(a_cum)                          # (b, h, nc, Q)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states_in, out_decay)

    y = (y_diag + y_off).reshape(b, l, h, p)
    if return_states:
        # the state after position t is the state before t + 1; the last
        # one is the final state (chunk 1: one position per chunk)
        after = torch.cat([states_in[:, 1:], final[:, None]], dim=1)
        return y, final, after
    return y, final


def ssm_update(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(1) recurrent update of one position: ``state (b, h, p, n)``,
    ``x (b, h, p)``, ``dt (b, h)``, ``A (h,)``, ``B/C (b, h, n)`` →
    ``(y (b, h, p), new_state (b, h, p, n))``, both fp32."""
    dA = torch.exp(dt * A)                                # (b, h)
    xd = x.float() * dt[..., None]                        # (b, h, p)
    new = state.float() * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xd, B.float())
    return torch.einsum("bhn,bhpn->bhp", C.float(), new), new


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along L.  ``xBC (b, l, c)``, ``w (K, c)`` →
    ``(out (b, l, c), new_state (b, K-1, c))``, in ``xBC``'s dtype; the
    taps are summed in order k = 0..K-1, as the JAX conv sums them."""
    K, l = w.shape[0], xBC.shape[1]
    pad = state if state is not None else \
        torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]), dtype=xBC.dtype,
                    device=xBC.device)
    xp = torch.cat([pad.to(xBC.dtype), xBC], dim=1)
    out = xp[:, 0:l] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + l] * w[k]
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out + bias, new_state


def _pick_chunk(l: int, target: int) -> int:
    """Largest divisor of ``l`` that is ≤ ``target`` (the SSD chunk)."""
    c = min(target, l)
    while l % c:
        c -= 1
    return c


def mamba_block(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[Params] = None,
                sparsity: SparsityConfig = DENSE,
                collect_states: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba-2 mixer, ``x (b, l, d)`` → ``(out (b, l, d), cache)``.

    ``cache`` ``{"conv": (b, K-1, c), "ssm": (b, h, p, n)}`` (views of
    one layer of the stacked cache) is read and written in place and
    returned; ``None`` runs the chunked scan from zero state and returns
    ``None``.  With a cache, ``l > 1`` is a prefill (the chunked scan
    seeded from the cached state) and ``l == 1`` the O(1) update.

    ``collect_states=True`` (the speculative verify block, with a cache
    and ``l > 1``) returns a dict of the updated ``conv``/``ssm`` plus
    the state after each of the ``l`` positions: ``"conv_seq" (b, l, K-1,
    c)`` and ``"ssm_seq" (b, l, h, p, n)``, so the caller can truncate the
    recurrence to any accepted prefix."""
    b, l, d = x.shape
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    P = cfg.ssm_head_dim

    zxbcdt = apply_linear(x, params["in_proj"], sparsity)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])       # (b, l, H)

    conv_state = cache["conv"] if cache is not None else None
    xBC_raw = xBC                       # the pre-conv inputs (state domain)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 conv_state)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, B, C = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(b, l, H, P)
    rep = H // G
    B = B.reshape(b, l, G, N).repeat_interleave(rep, dim=2)
    C = C.reshape(b, l, G, N).repeat_interleave(rep, dim=2)
    A = -torch.exp(params["A_log"])                       # (H,)

    new_cache: Optional[Params] = None
    if cache is None:
        y, _ = ssd_chunked(xs, dt, A, B, C, _pick_chunk(l, cfg.ssm_chunk))
    elif l > 1:
        init = cache["ssm"].float()
        if collect_states:
            y, final, ssm_seq = ssd_chunked(xs, dt, A, B, C, 1,
                                            init_state=init,
                                            return_states=True)
            # the conv state after position t: the last K-1 pre-conv
            # inputs of the prefix ending at t, sliding windows over the
            # padded input
            Kc = params["conv_w"].shape[0]
            xp = torch.cat([conv_state.to(xBC_raw.dtype), xBC_raw], 1)
            win = (torch.arange(l, device=x.device)[:, None] + 1
                   + torch.arange(Kc - 1, device=x.device)[None, :])
            conv_seq = xp[:, win].to(conv_state.dtype)    # (b, l, K-1, c)
            new_cache = {"conv_seq": conv_seq, "ssm_seq": ssm_seq}
        else:
            y, final = ssd_chunked(xs, dt, A, B, C,
                                   _pick_chunk(l, cfg.ssm_chunk),
                                   init_state=init)
    else:
        y, final = ssm_update(cache["ssm"], xs[:, 0], dt[:, 0], A, B[:, 0],
                              C[:, 0])
        y = y[:, None]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(final)
        new_cache = {"conv": cache["conv"], "ssm": cache["ssm"],
                     **(new_cache or {})}

    y = y + xs.float() * params["D"][:, None]
    y = y.reshape(b, l, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rmsnorm(params["norm"], y, cfg.norm_eps)
    return apply_linear(y, params["out_proj"], sparsity), new_cache
