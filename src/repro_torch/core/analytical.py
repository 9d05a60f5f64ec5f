"""Closed-form speedup models from the paper (Section IV-D/E) + tile-level
generalizations used by the TPU roofline.

The port's copy of the JAX package's ``repro/core/analytical.py`` (numpy
and ``math`` only, the same values).

Paper quantities (block size 4, IID sparsity x = P(weight == 0)):

  USSA analytical cycles   c_a(x) = Σ_{k=0..4} C(4,k) x^k (1-x)^{4-k} (4-k)
                                  = 4(1-x)            (linearity of E[·])
  USSA observed cycles     c_o(x) = c_a(x) + x^4      (all-zero block still
                                                       costs 1 cycle)
  speedups                 s_a = 4 / c_a,  s_o = 4 / c_o       (Fig. 8)

  SSSA analytical speedup  s_a(x_blocks) = 1 / (1 - x_blocks)  (Fig. 9;
      "ratio of the total number of weights to the number of [non-]zero
      weights" — at 4:4 granularity weight sparsity == block sparsity)

These functions are the oracles for ``core.cycle_model`` (the simulator must
match them to float precision on IID inputs) and for ``benchmarks/bench_ussa``
/ ``bench_sssa`` which regenerate the paper's Figure 8/9 curves.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np

from repro_torch.core.encoding import BLOCK


def _binom_pmf(k: int, n: int, x: float) -> float:
    return math.comb(n, k) * x**k * (1.0 - x) ** (n - k)


def ussa_cycles_analytical(x: float, block: int = BLOCK) -> float:
    """Expected cycles per block for the *ideal* variable-cycle MAC."""
    return sum(_binom_pmf(k, block, x) * (block - k) for k in range(block + 1))


def ussa_cycles_observed(x: float, block: int = BLOCK) -> float:
    """Expected cycles for the paper's USSA: an all-zero block costs 1."""
    c = sum(_binom_pmf(k, block, x) * (block - k) for k in range(block))
    return c + _binom_pmf(block, block, x) * 1.0


def ussa_speedup_analytical(x: float, block: int = BLOCK) -> float:
    c = ussa_cycles_analytical(x, block)
    return math.inf if c == 0 else block / c


def ussa_speedup_observed(x: float, block: int = BLOCK) -> float:
    return block / ussa_cycles_observed(x, block)


def sssa_speedup_analytical(x_blocks: float) -> float:
    """Fig. 9's analytical curve: work ∝ surviving blocks."""
    if not 0.0 <= x_blocks < 1.0:
        raise ValueError("block sparsity must be in [0, 1)")
    return 1.0 / (1.0 - x_blocks)


def csa_cycles_analytical(x_ss: float, x_us: float, block: int = BLOCK,
                          cap: int = 15) -> float:
    """Expected per-*original*-block cycles for CSA under the independent
    two-level model: a fraction ``x_ss`` of blocks is skipped outright by
    the lookahead walk (0 cycles, runs ≤ cap); surviving blocks pay the
    variable-cycle MAC on their unstructured sparsity ``x_us`` plus one
    ``inc_indvar`` issue cycle.
    """
    surviving = 1.0 - x_ss
    mac = sum(_binom_pmf(k, block, x_us) * max(block - k, 1)
              for k in range(block + 1))
    return surviving * (mac + 1.0)


def csa_speedup_analytical(x_ss: float, x_us: float, block: int = BLOCK) -> float:
    """vs the 4-cycle sequential baseline + 1 loop-bookkeeping cycle."""
    base = block + 1.0
    return base / csa_cycles_analytical(x_ss, x_us, block)


# ---------------------------------------------------------------------------
# Tile-level generalization (TPU adaptation)
# ---------------------------------------------------------------------------

def expected_nonzero_tile_fraction(x: float, tile_elems: int) -> float:
    """P(a tile of ``tile_elems`` IID-sparse weights has ≥1 non-zero).

    The paper's block-of-4 skip probability is the special case
    ``tile_elems=4`` → ``1 - x^4``.  At MXU tiles (e.g. 128·128 = 16384
    elements) unstructured sparsity almost never yields skippable tiles
    (1-x^16384 ≈ 1) — this is *why* the TPU adaptation needs structured
    (block) pruning to recreate the paper's win, which DESIGN.md §2 records
    as a changed assumption.
    """
    return 1.0 - x**tile_elems


def block_speedup_tile(x_block: float, overhead_frac: float = 0.0) -> float:
    """Speedup of the block-skip kernel at tile granularity: work ∝ non-zero
    tiles, plus a fixed per-tile overhead fraction (index/prefetch)."""
    dense = 1.0
    sparse = (1.0 - x_block) * (1.0 + overhead_frac)
    return dense / max(sparse, 1e-12)


def nm_flop_fraction(n: int, m: int) -> float:
    """Matmul FLOPs of the compressed-K kernel relative to dense."""
    return n / m


def combined_flop_fraction(x_block: float, n: int, m: int) -> float:
    return (1.0 - x_block) * n / m


def sweep(fn, xs: Iterable[float]) -> np.ndarray:
    return np.array([fn(float(x)) for x in xs])
