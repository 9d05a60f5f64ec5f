"""Cycle-accurate simulator of the paper's CFU designs on VexRiscv.

The port's copy of the JAX package's ``repro/core/cycle_model.py``: numpy
only, the same counts.  These are simulated CFU cycles, not a measurement
of any device.

This is the *faithful* reproduction layer: it counts clock cycles for the
baseline and the three proposed accelerators over real (pruned) weight
tensors, reproducing the paper's Figures 8, 9, 10 and the Table I speedup
bands — independent of the TPU adaptation.

Timing model (documented so every benchmark number is derivable):

  The host is a 5-stage in-order VexRiscv; CFU instructions occupy the
  pipeline for their ``cycles`` and the surrounding loop costs bookkeeping
  instructions.  Per *block* of 4 weights in the innermost loop:

    baseline SIMD (Listing 1)     1 (cfu_simd_mac)            + LOOP_OVH
    baseline sequential (III-C1)  4 (1 mul/cycle)             + LOOP_OVH
    USSA (III-C2)                 max(nnz, 1)                 + LOOP_OVH
    SSSA (III-B) visited block    1 (sssa_mac) + 1 (inc_indvar) + BRANCH
         skipped block            0
    CSA  (III-D) visited block    max(nnz, 1) + 1 (inc_indvar) + BRANCH
         skipped block            0

  LOOP_OVH = 3: the TFLite-style baseline inner loop advances the
  induction variable plus the filter/input pointers and branches
  (addi + addi + bne on the in-order 5-stage).  BRANCH = 1: in Listing 2
  the induction update IS ``sssa_inc_indvar`` (counted as its own issue
  cycle), so the while loop's only bookkeeping is the bne.  This
  4-vs-3-cycle bookkeeping asymmetry is exactly why the paper's observed
  SSSA speedups can EXCEED the analytical 1/(1-x) curve (Section IV-E:
  "reduced overhead ... eliminating unnecessary iterations") — the
  block-skip removes whole loop iterations, not just MACs.

The simulator is exact given a mask, so on IID masks it converges to the
closed forms in ``core.analytical`` (tested), and on 4:4-pruned weights it
reproduces the "observed ≥ analytical" crossover of Fig. 9.

Speedup conventions per paper section:
  * USSA (Fig. 8): vs the *sequential* 4-cycle baseline, pure MAC cycles
    (s = 4/c, no loop overhead — the paper's formulas carry none).
  * SSSA (Fig. 9): vs the SIMD baseline *with* loop overhead (that is the
    measured-kernel comparison of Listing 1 vs Listing 2).
  * CSA (Fig. 10): whole-model cycles vs SIMD baseline with overhead.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.encoding import BLOCK, SKIP_CAP


class Design(enum.Enum):
    BASELINE_SIMD = "baseline_simd"     # Listing 1: 4x4 MAC, 1 cycle
    BASELINE_SEQ = "baseline_seq"       # III-C1: sequential, 4 cycles
    USSA = "ussa"                       # III-C2: variable-cycle MAC
    SSSA = "sssa"                       # III-B : lookahead block skip
    CSA = "csa"                         # III-D : both


@dataclasses.dataclass(frozen=True)
class Timing:
    """Per-instruction cycle costs of the host pipeline."""
    loop_overhead: int = 3     # addi ×2 + bne per baseline for-iteration
    branch: int = 1            # while-loop bne per visited SSSA/CSA block
    inc_indvar: int = 1        # sssa/csa_inc_indvar issue
    simd_mac: int = 1          # cfu_simd_mac / sssa_mac
    seq_mac_lane: int = 1      # per non-skipped multiply of the seq unit
    all_zero_block: int = 1    # USSA/CSA vcmac cost of an all-zero block


DEFAULT_TIMING = Timing()


# ---------------------------------------------------------------------------
# Stream-level cycle counts (one innermost-loop walk)
# ---------------------------------------------------------------------------

def _blocks(mask_stream: np.ndarray) -> np.ndarray:
    m = np.asarray(mask_stream).astype(bool).reshape(-1)
    if m.size % BLOCK:
        raise ValueError(f"stream length {m.size} not a multiple of {BLOCK}")
    return m.reshape(-1, BLOCK)


def _visited(zero_blocks: np.ndarray, cap: int) -> np.ndarray:
    """Indices visited by the lookahead walk (Listing 2) over one stream."""
    nb = zero_blocks.shape[0]
    # skip counts identical to encoding.skip_counts, numpy version
    run = np.zeros(nb + 1, np.int64)
    for b in range(nb - 1, -1, -1):
        run[b] = run[b + 1] + 1 if zero_blocks[b] else 0
    visited = []
    b = 0
    while b < nb:
        visited.append(b)
        b += min(run[b + 1], cap) + 1
    return np.array(visited, np.int64)


def stream_cycles(mask_stream: np.ndarray, design: Design,
                  timing: Timing = DEFAULT_TIMING,
                  cap: int = SKIP_CAP,
                  include_loop_overhead: bool = True) -> int:
    """Clock cycles to MAC one weight stream under ``design``.

    ``mask_stream``: bool/0-1 array, True where the weight is non-zero.
    """
    blocks = _blocks(mask_stream)
    nb = blocks.shape[0]
    nnz = blocks.sum(axis=1)
    zero = nnz == 0
    ovh = timing.loop_overhead if include_loop_overhead else 0

    if design is Design.BASELINE_SIMD:
        return int(nb * (timing.simd_mac + ovh))
    if design is Design.BASELINE_SEQ:
        return int(nb * (BLOCK * timing.seq_mac_lane + ovh))
    if design is Design.USSA:
        mac = np.where(zero, timing.all_zero_block, nnz * timing.seq_mac_lane)
        return int(mac.sum() + nb * ovh)
    if design is Design.SSSA:
        vis = _visited(zero, cap)
        per = timing.simd_mac + timing.inc_indvar
        per += timing.branch if include_loop_overhead else 0
        return int(len(vis) * per)
    if design is Design.CSA:
        vis = _visited(zero, cap)
        mac = np.where(zero[vis], timing.all_zero_block,
                       nnz[vis] * timing.seq_mac_lane)
        per = timing.inc_indvar + (timing.branch if include_loop_overhead else 0)
        return int(mac.sum() + len(vis) * per)
    raise ValueError(design)


# ---------------------------------------------------------------------------
# Layer-level: convolution and linear layers (Listing 1 loop structure)
# ---------------------------------------------------------------------------

def conv_layer_cycles(mask: np.ndarray, out_hw: tuple[int, int],
                      design: Design, timing: Timing = DEFAULT_TIMING,
                      cap: int = SKIP_CAP) -> int:
    """``mask``: (H, W, Cin, Cout) filter non-zero mask.

    Listing 1 walks, per output position and output channel, the
    (H·W·Cin) reduction — with the lookahead encoding computed along Cin
    per (h, w) exactly as Algorithm 1 does.  Cycles are identical across
    output positions, so we count one position and multiply.
    """
    H, W, Cin, Cout = mask.shape
    total = 0
    m = np.asarray(mask).astype(bool)
    for co in range(Cout):
        per_pos = 0
        for h in range(H):
            for w in range(W):
                per_pos += stream_cycles(m[h, w, :, co], design, timing, cap)
        total += per_pos
    return int(total * out_hw[0] * out_hw[1])


def conv_layer_cycles_fast(mask: np.ndarray, out_hw: tuple[int, int],
                           design: Design, timing: Timing = DEFAULT_TIMING,
                           cap: int = SKIP_CAP) -> int:
    """Vectorized equivalent of :func:`conv_layer_cycles` for the non-walk
    designs (BASELINE_*, USSA), used on big models.  SSSA/CSA need the walk
    and fall back to the exact per-stream loop, vectorized over streams."""
    H, W, Cin, Cout = mask.shape
    m = np.asarray(mask).astype(bool)
    if Cin % BLOCK:
        raise ValueError(f"Cin={Cin} must be a multiple of {BLOCK}")
    blocks = m.transpose(3, 0, 1, 2).reshape(Cout * H * W, Cin // BLOCK, BLOCK)
    nnz = blocks.sum(axis=2)
    zero = nnz == 0
    nb_total = nnz.size
    t = timing
    if design is Design.BASELINE_SIMD:
        c = nb_total * (t.simd_mac + t.loop_overhead)
    elif design is Design.BASELINE_SEQ:
        c = nb_total * (BLOCK * t.seq_mac_lane + t.loop_overhead)
    elif design is Design.USSA:
        mac = np.where(zero, t.all_zero_block, nnz * t.seq_mac_lane)
        c = mac.sum() + nb_total * t.loop_overhead
    else:
        c = 0
        for s in range(blocks.shape[0]):
            c += stream_cycles(blocks[s].reshape(-1), design, t, cap)
    return int(c * out_hw[0] * out_hw[1])


def linear_layer_cycles(mask: np.ndarray, design: Design,
                        timing: Timing = DEFAULT_TIMING,
                        cap: int = SKIP_CAP) -> int:
    """``mask``: (K, N) non-zero mask of a fully connected layer. One walk
    per output feature (Section IV-A: FC supported without modification)."""
    K, N = mask.shape
    return conv_layer_cycles_fast(
        np.asarray(mask).reshape(1, 1, K, N), (1, 1), design, timing, cap)


# ---------------------------------------------------------------------------
# Model-level speedups (Fig. 10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One MAC-bearing layer of a benchmark model."""
    kind: str                  # "conv" | "linear"
    shape: tuple               # conv: (H, W, Cin, Cout); linear: (K, N)
    out_hw: tuple = (1, 1)


def model_cycles(layers: Sequence[LayerShape], masks: Sequence[np.ndarray],
                 design: Design, timing: Timing = DEFAULT_TIMING,
                 cap: int = SKIP_CAP) -> int:
    total = 0
    for spec, mask in zip(layers, masks):
        if spec.kind == "conv":
            total += conv_layer_cycles_fast(mask, spec.out_hw, design,
                                            timing, cap)
        elif spec.kind == "linear":
            total += linear_layer_cycles(mask, design, timing, cap)
        else:
            raise ValueError(spec.kind)
    return total


def model_speedup(layers: Sequence[LayerShape], masks: Sequence[np.ndarray],
                  design: Design, baseline: Optional[Design] = None,
                  timing: Timing = DEFAULT_TIMING, cap: int = SKIP_CAP) -> float:
    """Speedup vs each design's fair baseline (paper convention):
    SSSA compares against the SIMD-MAC Listing 1; USSA/CSA are sequential
    variable-cycle MAC units, compared against the 4-cycle sequential MAC
    (Sections IV-D/F)."""
    if baseline is None:
        baseline = (Design.BASELINE_SIMD if design is Design.SSSA
                    else Design.BASELINE_SEQ)
    b = model_cycles(layers, masks, baseline, timing, cap)
    d = model_cycles(layers, masks, design, timing, cap)
    return b / d
