"""SparseLinear — the paper's technique as a layer of the port.

Configs declare a :class:`SparsityConfig` per layer family; models build
projections through :func:`init_linear` / :func:`apply_linear` and never
branch on format.  Lifecycle as in the JAX package: dense init →
``pack_params`` (offline prune + pack per layer) → forward through
``kernels.dispatch.sparse_matmul``.

Formats: ``dense``, ``nm`` (2:4-style, ``nm_spmm``), ``block``
(block skip, ``bsr_matmul``), ``combined`` (block skip × n:m,
``csa_matmul``) and ``lookahead`` (int7 with LSB skip bits,
``lookahead_matmul``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import pruning, sparsity
from repro_torch.core.sparsity import (PACK_TYPES, BlockSparsePack,
                                       CombinedPack, LookaheadPack, NMPack)
from repro_torch.kernels import dispatch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Per-layer-family sparsity declaration (config-file level).

    ``format``: ``dense | lookahead | block | nm | combined``;
    ``sparsity``: the block sparsity of ``block``/``combined``/
    ``lookahead`` (the paper's x_ss); ``n, m``: the N:M pattern of
    ``nm``/``combined``; ``block_k, block_n``: the skip-tile geometry
    (``block_n`` is also the column group ``g`` of ``nm``).  ``impl`` is
    carried for field parity with the JAX config.
    """
    format: str = "dense"
    sparsity: float = 0.5
    n: int = 2
    m: int = 4
    block_k: int = 128
    block_n: int = 128
    impl: str = "auto"

    def __post_init__(self):
        if self.format not in ("dense", "lookahead", "block", "nm", "combined"):
            raise ValueError(f"unknown sparsity format {self.format!r}")


DENSE = SparsityConfig(format="dense")


def init_linear(K: int, N: int, dtype: torch.dtype,
                generator: torch.Generator, device) -> torch.Tensor:
    """Dense init (fan-in scaled); packing is a separate offline pass."""
    w = torch.randn((K, N), generator=generator, device=device,
                    dtype=torch.float32) / math.sqrt(K)
    return w.to(dtype)


def prune_weight(w: torch.Tensor, cfg: SparsityConfig):
    """Offline pruning matching the configured format's structure."""
    if cfg.format == "dense":
        return w, torch.ones_like(w)
    if cfg.format == "lookahead":
        # the faithful path prunes at the paper's block-4 granularity
        return pruning.block_semi_structured(w, cfg.sparsity, block=4)
    if cfg.format == "block":
        return pruning.block_semi_structured(w, cfg.sparsity,
                                             block=cfg.block_k)
    if cfg.format == "nm":
        return pruning.n_m(w, cfg.n, cfg.m, group=cfg.block_n)
    if cfg.format == "combined":
        return pruning.combined_nm(w, cfg.sparsity, cfg.n, cfg.m,
                                   group=cfg.block_n, block=cfg.block_k)
    raise ValueError(cfg.format)


def pack_weight(w: torch.Tensor, cfg: SparsityConfig,
                pad_to: Optional[int] = None):
    """Offline packing of a (pruned) dense weight; ``dense`` passes
    through.  ``pad_to`` sets the slots per strip of a block or combined
    pack."""
    if cfg.format == "dense":
        return w
    if cfg.format == "lookahead":
        return LookaheadPack.from_float(w)
    if cfg.format == "block":
        return sparsity.pack_block_sparse(w, cfg.block_k, cfg.block_n,
                                          pad_to=pad_to)
    if cfg.format == "nm":
        return sparsity.pack_nm(w, cfg.n, cfg.m, g=cfg.block_n)
    if cfg.format == "combined":
        return sparsity.pack_combined(w, cfg.n, cfg.m, cfg.block_k,
                                      cfg.block_n, pad_to=pad_to)
    raise ValueError(cfg.format)


def sparsify_weight(w: torch.Tensor, cfg: SparsityConfig):
    """Prune + pack in one offline call."""
    pruned, _ = prune_weight(w, cfg)
    return pack_weight(pruned, cfg)


def _family_sparsity(names: Sequence[str], cfg: Any
                     ) -> Optional[SparsityConfig]:
    """Name-based rule: which per-family SparsityConfig governs a weight
    (same rule as the JAX package)."""
    if any(n in ("w_in", "w_gate", "w_out") for n in names):
        moe = "moe" in names and "shared" not in names
        return cfg.expert_sparsity if moe else cfg.mlp_sparsity
    if any(n in ("in_proj", "out_proj") for n in names):
        return cfg.mlp_sparsity
    if any(n in ("wq", "wk", "wv", "wo") for n in names):
        return cfg.attn_sparsity
    return None


def _geometry_ok(K: int, N: int, scfg: SparsityConfig) -> bool:
    """Every dim the pack format assumes must divide."""
    if scfg.format in ("nm", "combined") and (K % scfg.m or
                                              N % scfg.block_n):
        return False
    if scfg.format in ("block", "combined") and K % scfg.block_k:
        return False
    return True


def _pack_stacked(w: torch.Tensor, scfg: SparsityConfig) -> list:
    """Prune + pack each slice of an ``(E, K, N)`` expert stack: a list of
    ``E`` packs, each the JAX package's ``_pack_stacked`` slice (block
    and combined packs padded to the stack's largest ``max_nnz``)."""
    pruned = [prune_weight(s, scfg)[0] for s in w]
    pad = None
    if scfg.format in ("block", "combined"):
        pad = max(pack_weight(p, scfg).max_nnz for p in pruned)
    return [pack_weight(p, scfg, pad_to=pad) for p in pruned]


def pack_params(params: Any, cfg: Any) -> Any:
    """Offline prune + pack of a whole param tree (nested dicts/lists of
    tensors, ``layers`` a list of per-layer dicts).  Weights whose
    geometry does not divide the pack tiling stay dense; everything else
    a family's :class:`SparsityConfig` governs becomes a pack, and an
    ``(E, K, N)`` expert stack a list of ``E`` packs."""

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, names) for v in node]
        scfg = _family_sparsity(names, cfg)
        if scfg is None or scfg.format == "dense" or node.ndim not in (2, 3):
            return node
        if not _geometry_ok(*node.shape[-2:], scfg):
            return node
        if node.ndim == 3:
            return _pack_stacked(node, scfg)
        pruned, _ = prune_weight(node, scfg)
        return pack_weight(pruned, scfg)

    return visit(params, ())


def make_draft_params(params: Any, cfg: Any) -> Any:
    """The sparse drafter of speculative serving (``spec_draft="pack"``):
    the verify params pruned and packed into the model config's
    per-family formats, as :func:`pack_params` does.

    Memory contract (the JAX package's): only the weights a
    :class:`SparsityConfig` governs become packs; every other leaf
    (embeddings, norms, dense-format families, geometry misfits) is the
    verify params' own tensor, not a copy, so draft and verify together
    cost the packed values on top of one model.  A config whose families
    are all ``dense`` returns ``params`` itself: the pack draft is then
    the self draft."""
    families = (cfg.mlp_sparsity, cfg.attn_sparsity, cfg.expert_sparsity)
    if all(f.format == "dense" for f in families):
        return params
    return pack_params(params, cfg)


# --- abstract (meta) packs for the dry run ----------------------------------

def abstract_pack(K: int, N: int, cfg: SparsityConfig,
                  dtype: torch.dtype = torch.bfloat16,
                  density: Optional[float] = None, device="meta"):
    """The pack of a ``(K, N)`` weight with ``meta`` tensors (nothing
    allocated): the layout :func:`pack_weight` gives, a block or combined
    pack sized at the nominal tile density ``1 - cfg.sparsity`` (or
    ``density``), as the JAX package's ``abstract_pack`` sizes it."""
    def t(shape, dt):
        return torch.empty(shape, dtype=dt, device=device)

    if cfg.format == "dense":
        return t((K, N), dtype)
    if cfg.format == "lookahead":
        return LookaheadPack(enc=t((K, N), torch.int8),
                             scale=t((1, N), torch.float32), K=K, N=N)
    d = density if density is not None else (1.0 - cfg.sparsity)
    Kb, Nb = K // cfg.block_k, N // cfg.block_n
    max_nnz = max(1, math.ceil(Kb * d))
    if cfg.format == "block":
        return BlockSparsePack(
            values=t((Nb, max_nnz, cfg.block_k, cfg.block_n), dtype),
            indices=t((Nb, max_nnz), torch.int32),
            counts=t((Nb,), torch.int32), K=K, N=N, bk=cfg.block_k,
            bn=cfg.block_n, max_nnz=max_nnz)
    if cfg.format == "nm":
        Kc = K * cfg.n // cfg.m
        return NMPack(values=t((Kc, N), dtype),
                      idx=t((Kc, N // cfg.block_n), torch.int32),
                      K=K, N=N, n=cfg.n, m=cfg.m, g=cfg.block_n)
    if cfg.format == "combined":
        bkc = cfg.block_k * cfg.n // cfg.m
        return CombinedPack(
            values=t((Nb, max_nnz, bkc, cfg.block_n), dtype),
            gidx=t((Nb, max_nnz, bkc), torch.int32),
            indices=t((Nb, max_nnz), torch.int32),
            counts=t((Nb,), torch.int32), K=K, N=N, n=cfg.n, m=cfg.m,
            bk=cfg.block_k, bn=cfg.block_n, max_nnz=max_nnz)
    raise ValueError(cfg.format)


def sparsify_abstract(abstract_params: Any, cfg: Any) -> Any:
    """:func:`pack_params` on an abstract (``meta``) param tree: every
    weight a family's :class:`SparsityConfig` governs becomes an
    :func:`abstract_pack` (an ``(E, K, N)`` expert stack a list of ``E``
    of them), the rest stays as it is — the layout
    ``models.init_model(packed=True)`` gives, sized at the nominal
    density, so byte counts agree with the JAX ``sparsify_abstract``."""

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, names) for v in node]
        scfg = _family_sparsity(names, cfg)
        if scfg is None or scfg.format == "dense" or node.ndim not in (2, 3):
            return node
        K, N = node.shape[-2:]
        if not _geometry_ok(K, N, scfg):
            return node
        if node.ndim == 3:
            return [abstract_pack(K, N, scfg, node.dtype, device=node.device)
                    for _ in range(node.shape[0])]
        return abstract_pack(K, N, scfg, node.dtype, device=node.device)

    return visit(abstract_params, ())


def apply_linear(x: torch.Tensor, weight: Any,
                 cfg: SparsityConfig = DENSE) -> torch.Tensor:
    """``x (..., K) @ weight (K, N) -> (..., N)`` for any ported format.

    Leading dims are flattened to the kernel's M dimension and restored;
    kernel choice is the dispatcher's job."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = dispatch.sparse_matmul(x2, weight)
    return out.reshape(*lead, out.shape[-1])


def weight_out_features(weight: Any) -> int:
    if isinstance(weight, PACK_TYPES):
        return weight.N
    return weight.shape[-1]


def format_stats(weight: Any) -> dict:
    """Values and metadata bytes of a weight, plus the tile density of a
    block pack and 1.0 for a dense weight."""
    if isinstance(weight, PACK_TYPES):
        stats = {"values_bytes": sparsity.values_bytes(weight),
                 "metadata_bytes": sparsity.metadata_bytes(weight)}
        if isinstance(weight, sparsity.BlockSparsePack):
            stats["density"] = weight.density
        return stats
    return {"values_bytes": weight.numel() * weight.element_size(),
            "metadata_bytes": 0, "density": 1.0}
