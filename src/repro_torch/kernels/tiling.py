"""Tile shape and K-split of the tensor-core route of ``nm_spmm``,
``lookahead_matmul``, ``bsr_matmul`` and ``csa_matmul``
(``csrc/tensor_core.cuh``).

A block owns ``bn`` weight columns by ``bm`` rows of x and one of
``split`` K-slices of ``steps`` stages; the ``split`` blocks of a tile
form a cluster.  The slices are equal for ``nm_spmm`` and
``lookahead_matmul``; a strip kernel's rank takes every split-th stage of
its strip, at most ``ceil(steps / split)``.  The rules were chosen by
timing every feasible (bm, bn, split) on the qwen3-0.6b projections on an
H100 (``tools/mma_tile_sweep.py``).  Pure Python, so the CPU tests check
it and ``chip_smoke.py`` prints it.
"""

from __future__ import annotations

from typing import Sequence

TARGET_BLOCKS = 128     # about one block per SM of the 132
MAX_BLOCKS = 264        # two blocks per SM: one wave
MAX_SPLIT = 8           # the largest portable cluster
WIDTHS = (128, 64, 32)  # column tiles the kernels are built for


def mma_tiles(M: int, K: int, N: int, steps: int,
              widths: Sequence[int], ceil: bool = False) -> dict:
    """``bm``, ``bn``, ``split`` and the launch grid for ``x (M, K)`` times
    a ``(K, N)`` weight contracted in ``steps`` stages; ``widths`` are the
    column tiles the weight's layout allows, largest first; the first is
    taken (wide tiles read x fewer times).  A split divides ``steps``;
    with ``ceil`` (the strip kernels) it is any split below ``2 * steps``
    (fewer than half of the ranks of the longest strip idle) and a block
    takes at most ``ceil(steps / split)`` stages (``steps_per_block``).

    Decode (M <= 8) takes 8-row tiles and the smallest split that gives
    ``TARGET_BLOCKS`` blocks, else the largest; with ``ceil`` always the
    largest (the sweep found it fastest on every strip shape, also where
    fewer splits reach ``TARGET_BLOCKS``).  Beyond, among 32- and
    64-row tiles (only 64 for K > 2048: each row tile reads the whole
    weight slice again) and the splits: the most blocks up to
    ``MAX_BLOCKS``, then at most two stages per block (one and two count
    alike), then the smaller row tile (a smaller partial tile to sum)."""
    if not widths:
        raise ValueError(f"no column tile of {WIDTHS} fits N={N}")
    if steps < 1:
        raise ValueError("K is shorter than one stage")
    bn = widths[0]
    splits = [s for s in (1, 2, 4, MAX_SPLIT)
              if (s < 2 * steps if ceil else steps % s == 0)]

    def per_block(s):
        return -(-steps // s)

    if M <= 8:
        bm = 8
        split = splits[-1] if ceil else next(
            (s for s in splits if N // bn * s >= TARGET_BLOCKS), splits[-1])
    else:
        def blocks(bm, s):
            return N // bn * -(-M // bm) * s
        shapes = [(bm, s) for bm in ((64,) if K > 2048 else (32, 64))
                  for s in splits]
        fits = [c for c in shapes if blocks(*c) <= MAX_BLOCKS] or \
            [(64, 1)]
        bm, split = max(fits, key=lambda c: (
            blocks(*c), -max(per_block(c[1]), 2), -c[0]))
    return dict(route="mma", bm=bm, bn=bn, split=split,
                steps_per_block=per_block(split),
                grid=(N // bn * split, -(-M // bm)))


def fma_tiles(M: int, N: int, narrow: int) -> dict:
    """The fp32 FMA route: ``mt`` rows (the smallest of 1, 2, 4, 8 that
    covers M, 8 beyond) by ``bn`` columns (one ``narrow``-column load up
    to 8 rows, 32 beyond)."""
    mt = next(t for t in (1, 2, 4, 8) if M <= t) if M <= 8 else 8
    bn = narrow if M <= 8 else 32
    return dict(route="fma", mt=mt, bn=bn, grid=(N // bn, -(-M // mt)))
