"""Mixture-of-Experts block of the port (qwen2-moe / dbrx style), the
twin of the JAX package's ``models/moe.py``.

Top-k routed experts plus optional always-on shared experts.  The router,
its softmax and the gates run in fp32; payloads stay in the model's dtype.
Expert weights come in one of two forms:

  * a dense stack ``(E, K, N)`` per projection, run as batched matmuls
    (the JAX einsums, which run outside any Pallas kernel);
  * a list of ``E`` packs per projection (``core.sparse_linear
    .pack_params``), run as one ``apply_linear`` per expert and
    projection, so 2:4 experts launch ``nm_spmm`` on their own rows.

Four dispatches, each returning ``(y, aux)`` as the JAX function does
(``aux`` the Switch-style load-balancing term, computed before drops):

  * :func:`moe` — every expert on every token, combine-weighted;
  * :func:`moe_grouped` — GShard's one-hot capacity dispatch;
  * :func:`moe_sorted` — group-local capacity dispatch, the served path:
    static shapes (an ``(E·C, d)`` buffer per group), no host sync, and a
    combine that gathers each token's ``k`` routed rows and sums them in
    slot order (no atomics), so a captured decode chunk replays it
    bitwise;
  * :func:`moe_sparse_expert` — every expert on every token through
    ``apply_linear``, the JAX package's route for packed experts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_linear import DENSE, SparsityConfig, apply_linear
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

#: The per-expert projections of a ``moe`` param dict.
EXPERT_WEIGHTS = ("w_in", "w_gate", "w_out")

#: When set to ``{"decode": t, "prefill": t}`` with ``t`` an int64
#: ``(2,)`` tensor on the model's device, :func:`moe_sorted` adds its
#: kept and its total routes to ``t`` (decode: one row per sequence), on
#: the device, so a captured chunk's replays count too.  ``None`` (the
#: default) adds nothing.
route_tally: Optional[Dict[str, torch.Tensor]] = None


def init_moe(cfg: ModelConfig, dtype: torch.dtype,
             generator: torch.Generator, device) -> Params:
    """Random router (fp32) and expert stacks, every leaf scaled by
    ``1/sqrt(d_model)`` as the JAX init; one expert's slice at a time,
    so the fp32 draw of a whole stack is never alive."""
    d, ff, E = cfg.d_model, cfg.d_expert, cfg.n_experts
    scale = 1.0 / math.sqrt(d)

    def stack(K: int, N: int) -> torch.Tensor:
        w = torch.empty((E, K, N), dtype=dtype, device=device)
        for e in range(E):
            w[e] = torch.randn((K, N), generator=generator, device=device,
                               dtype=torch.float32) * scale
        return w

    p = {"router": torch.randn((d, E), generator=generator, device=device,
                               dtype=torch.float32) * scale,
         "w_in": stack(d, ff), "w_gate": stack(d, ff), "w_out": stack(ff, d)}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(d, ff * cfg.n_shared_experts, dtype,
                                 generator, device)
    return p


def route_topk(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` router logits → (combine ``(T, E)`` float, dispatch
    ``(T, E)`` bool): a softmax over the top-k experts only."""
    vals, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(vals, dim=-1)
    combine = torch.zeros_like(logits).scatter(1, idx, gates)
    return combine, combine > 0


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Float one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _expert_ffn(params: Params, xe: torch.Tensor,
                sparsity: SparsityConfig = DENSE) -> torch.Tensor:
    """Each expert's gated FFN on its own rows: ``xe (E, M, d)`` →
    ``(E, M, d)``.  A dense stack runs batched matmuls; a list of packs
    one ``apply_linear`` per expert and projection, its outputs stacked
    so the gate's elementwise ops run once over all experts."""
    w_in, w_gate, w_out = (params[k] for k in EXPERT_WEIGHTS)
    if isinstance(w_in, torch.Tensor):
        xe = xe.to(w_in.dtype)
        h_in = torch.matmul(xe, w_in)
        h_gate = torch.matmul(xe, w_gate)
    else:
        h_in, h_gate = (torch.stack([apply_linear(xe[e], w[e], sparsity)
                                     for e in range(len(w))])
                        for w in (w_in, w_gate))
    h = F.silu(h_gate.float()).to(h_in.dtype) * h_in
    if isinstance(w_out, torch.Tensor):
        return torch.matmul(h, w_out)
    return torch.stack([apply_linear(h[e], w_out[e], sparsity)
                        for e in range(len(w_out))])


def _shared(params: Params, y: torch.Tensor, x: torch.Tensor,
            sparsity: SparsityConfig) -> torch.Tensor:
    if "shared" in params:
        y = y + L.mlp(params["shared"], x, sparsity=sparsity)
    return y


def _dense_dispatch(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    sparsity: SparsityConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe` and :func:`moe_sparse_expert`: every expert on every
    token, combine-weighted in fp32."""
    B, Lq, d = x.shape
    T = B * Lq
    xt = x.reshape(T, d)
    logits = xt.float() @ params["router"]                    # (T, E)
    combine, dispatch = route_topk(logits, cfg.top_k)
    probs = torch.softmax(logits, dim=-1)
    aux = cfg.n_experts * torch.sum(dispatch.float().mean(0) * probs.mean(0))
    E = cfg.n_experts
    y_e = _expert_ffn(params, xt.expand(E, T, d), sparsity)  # (E, T, d)
    y = torch.einsum("etd,te->td", y_e.float(), combine).to(x.dtype)
    y = _shared(params, y, xt, sparsity)
    return y.reshape(B, Lq, d), aux


def moe(params: Params, cfg: ModelConfig, x: torch.Tensor,
        sparsity: SparsityConfig = DENSE
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, L, d)`` → (``(B, L, d)``, aux): the dense dispatch, every
    expert computing every token."""
    return _dense_dispatch(params, cfg, x, sparsity)


def moe_sparse_expert(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      sparsity: SparsityConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe` over packed expert weights: each expert's three
    projections through ``apply_linear`` on all ``T`` tokens."""
    return _dense_dispatch(params, cfg, x, sparsity)


def _capacity(cfg: ModelConfig, S: int, capacity_factor: float) -> int:
    return max(int(math.ceil(S * cfg.top_k / cfg.n_experts
                             * capacity_factor)), 1)


def _to_experts(buf: torch.Tensor, E: int) -> torch.Tensor:
    """``(G, E·C, d)`` → ``(E, G·C, d)``: each expert's rows of every
    group, contiguous."""
    G, EC, d = buf.shape
    return buf.reshape(G, E, EC // E, d).transpose(0, 1).reshape(E, -1, d)


def _from_experts(y_e: torch.Tensor, G: int) -> torch.Tensor:
    """The inverse of :func:`_to_experts`."""
    E, GC, d = y_e.shape
    return y_e.reshape(E, G, GC // G, d).transpose(0, 1).reshape(G, -1, d)


def moe_grouped(params: Params, cfg: ModelConfig, x: torch.Tensor,
                sparsity: SparsityConfig = DENSE,
                capacity_factor: float = 1.25,
                group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard capacity dispatch: groups of ``S`` tokens (one group when
    ``group_size`` does not divide ``T``), ``C`` rows per expert and
    group, routes taken slot-major and dropped past ``C``; dispatch and
    combine are one-hot contractions."""
    B, Lq, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * Lq
    S = min(group_size, T)
    if T % S:
        S = T
    G = T // S
    C = _capacity(cfg, S, capacity_factor)

    xt = x.reshape(G, S, d)
    logits = xt.float() @ params["router"]                    # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    vals, eidx = torch.topk(logits, k, dim=-1)                # (G, S, k)
    gates = torch.softmax(vals, dim=-1)

    onehot = _one_hot(eidx, E).long()                         # (G, S, k, E)
    slotmajor = onehot.transpose(1, 2).reshape(G, k * S, E)
    pos_sm = torch.cumsum(slotmajor, dim=1) - slotmajor
    pos = pos_sm.reshape(G, k, S, E).transpose(1, 2)
    pos = torch.sum(pos * onehot, dim=-1)                     # (G, S, k)
    keep = pos < C
    gates = gates * keep

    frac_tokens = _one_hot(eidx, E).sum(dim=2).mean(dim=1)    # (G, E)
    frac_probs = probs.mean(dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    disp = (_one_hot(eidx, E)[..., None] * _one_hot(pos, C)[..., None, :]
            * keep[..., None, None].float())                  # (G,S,k,E,C)
    comb = torch.sum(disp * gates[..., None, None], dim=2)    # (G, S, E, C)
    disp = torch.sum(disp, dim=2)

    xe = torch.einsum("gsec,gsd->gecd", disp.to(xt.dtype), xt)
    y_e = _expert_ffn(params, _to_experts(xe.reshape(G, E * C, d), E),
                      sparsity)
    y_e = _from_experts(y_e, G).reshape(G, E, C, d)
    y = torch.einsum("gsec,gecd->gsd", comb.float(),
                     y_e.float()).to(x.dtype)
    return _shared(params, y.reshape(B, Lq, d), x, sparsity), aux


def moe_sorted(params: Params, cfg: ModelConfig, x: torch.Tensor,
               sparsity: SparsityConfig = DENSE,
               capacity_factor: float = 1.25,
               group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-local capacity dispatch, the served path, with the JAX
    function's drop rule: ``S = min(group_size, T)`` halved until it
    divides ``T``; ``C = max(ceil(S·k/E·capacity_factor), 1)``; each
    group's routes in slot-major order, a route at or past position
    ``C`` of its expert (in that order) dropped.

    The buffer row ``(e, c)`` of a group is gathered from the token that
    holds it (a zero row where none does), each expert runs its ``G·C``
    rows, and each token gathers its ``k`` routed rows back, gate-weighted
    in the payload dtype, and sums them in slot order."""
    B, Lq, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * Lq
    S = min(group_size, T)
    while T % S:
        S //= 2
    G = T // S
    C = _capacity(cfg, S, capacity_factor)
    dev = x.device

    xg = x.reshape(G, S, d)
    logits = xg.float() @ params["router"]                    # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    vals, eidx = torch.topk(logits, k, dim=-1)                # (G, S, k)
    gates = torch.softmax(vals, dim=-1)

    frac_tokens = _one_hot(eidx, E).sum(dim=2).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)

    # slot-major routes: route j*S + s is token s's j-th choice; its
    # position in its expert's queue counts the earlier routes there
    e_flat = eidx.transpose(1, 2).reshape(G, k * S)
    g_flat = gates.transpose(1, 2).reshape(G, k * S)
    hits = e_flat[..., None] == torch.arange(E, device=dev)   # (G, kS, E)
    pos = (torch.cumsum(hits, dim=1) * hits).sum(dim=-1) - 1
    keep = pos < C
    slot = e_flat * C + torch.where(keep, pos, 0)             # (G, kS)
    if route_tally is not None:
        t = route_tally["decode" if Lq == 1 else "prefill"]
        t[0] += keep.sum()
        t[1] += keep.numel()

    # dispatch: row (e, c) of a group takes the token of the route that
    # holds it; a dropped route writes its own spare column, an empty row
    # gathers the zero row S
    ar = torch.arange(k * S, device=dev)
    dest = torch.where(keep, slot, E * C + ar)
    src = torch.full((G, E * C + k * S), S, dtype=torch.long, device=dev)
    src.scatter_(1, dest, (ar % S).expand(G, -1))
    xpad = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)
    buf = torch.gather(xpad, 1, src[:, :E * C, None].expand(-1, -1, d))

    y_buf = _from_experts(_expert_ffn(params, _to_experts(buf, E),
                                      sparsity), G)          # (G, E·C, d)

    # combine: gather each route's row back, weight it by its gate in the
    # payload dtype, sum a token's k routes in slot order
    routed = torch.gather(y_buf, 1, slot[..., None].expand(-1, -1, d))
    routed = torch.where(keep[..., None],
                         routed * g_flat[..., None].to(y_buf.dtype), 0)
    y = routed.reshape(G, k, S, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, Lq, d)
    return _shared(params, y, x, sparsity), aux


def expert_rows(cfg: ModelConfig, tokens: int) -> int:
    """Rows each expert's projections take in a forward of ``tokens``
    tokens under ``cfg.moe_impl``: ``G·C`` under the capacity dispatches,
    every token under the dense one."""
    S = min(cfg.moe_group, tokens)
    if cfg.moe_impl == "sorted":
        while tokens % S:
            S //= 2
    elif cfg.moe_impl == "grouped":
        S = tokens if tokens % S else S
    else:
        return tokens
    return tokens // S * _capacity(cfg, S, cfg.capacity_factor)


def moe_block(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE half of a transformer block, by ``cfg.moe_impl`` as the
    JAX ``block`` routes it."""
    if cfg.moe_impl == "grouped":
        return moe_grouped(params, cfg, x, sparsity=cfg.expert_sparsity,
                           capacity_factor=cfg.capacity_factor,
                           group_size=cfg.moe_group)
    if cfg.moe_impl == "sorted":
        return moe_sorted(params, cfg, x, sparsity=cfg.expert_sparsity,
                          capacity_factor=cfg.capacity_factor,
                          group_size=cfg.moe_group)
    return moe(params, cfg, x, sparsity=cfg.expert_sparsity)
