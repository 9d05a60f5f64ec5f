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
from repro_torch.core.sparsity import PACK_TYPES, LookaheadPack
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


def pack_params(params: Any, cfg: Any) -> Any:
    """Offline prune + pack of a whole param tree (nested dicts/lists of
    tensors, ``layers`` a list of per-layer dicts).  Weights whose
    geometry does not divide the pack tiling stay dense; everything else
    a family's :class:`SparsityConfig` governs becomes a pack."""

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, names) for v in node]
        scfg = _family_sparsity(names, cfg)
        if scfg is None or scfg.format == "dense" or node.ndim != 2:
            return node
        if not _geometry_ok(*node.shape, scfg):
            return node
        pruned, _ = prune_weight(node, scfg)
        return pack_weight(pruned, scfg)

    return visit(params, ())


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
