"""Launch plans of the port's kernels: the tile shape and K-split of the
tensor-core route of ``nm_spmm``, ``lookahead_matmul``, ``bsr_matmul`` and
``csa_matmul`` (``csrc/tensor_core.cuh``), and the route, tile and split
of ``flash_attention`` and ``paged_attention`` (:func:`flash_plan`,
:func:`paged_plan`, chosen from ``tools/attention_sweep.py``).

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


# --- attention: flash_attention.cu and paged_attention.cu -------------------

ATTN_DTYPES = ("float32", "bfloat16")
HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernels are built for
MMA_HEAD_DIMS = (64, 128)        # head dims of the tensor-core routes
FLASH_BQ = (16, 32, 64)          # query rows per block: 1, 2 or 4 warps
FLASH_BK = (32, 64)              # keys per tile
FLASH_FMA_BQ = 16
FLASH_SHORT_KEYS = 256           # up to here, tiles of 32 keys
PAGED_CHUNK = 16                 # keys per chunk (one k16 step of P V)
PAGED_ROWS = 16                  # query rows of the m16 tile: Q * G <= 16
PAGED_WARPS = (1, 2, 4)
PAGED_CHUNKS_PER_PART = 2        # chunks of the view a part walks, at most
PAGED_MAX_WARPS = 1024           # warps of a one-wave grid (8 per SM)
SPLITS = (1, 2, 4, MAX_SPLIT)


def _dtype_name(dtype) -> str:
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in ATTN_DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    return name


def _heads(H: int, Hk: int, D: int) -> int:
    if Hk < 1 or H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernels take D in {HEAD_DIMS}, got D={D}")
    return H // Hk


def flash_plan(B: int, H: int, Hk: int, Lq: int, Lk: int, D: int,
               dtype) -> dict:
    """Route, tile and grid of ``flash_attention`` for q ``(B, H, Lq, D)``
    over k/v ``(B, Hk, Lk, D)``.

    bfloat16 at D in ``MMA_HEAD_DIMS`` takes the tensor cores (``mma``):
    ``bq`` query rows per block (16 per warp) and ``bk`` keys per tile;
    float32, and bfloat16 at D = 32 or 256, take the FMA kernel (``fma``,
    16 rows and 32 keys).  The mma tile: 64 rows (each K/V tile serves
    four warps), fewer only when ``Lq`` is shorter, and 32 keys up to
    ``Lk = 256``, 64 beyond.  In the sweep 64 rows were fastest, or
    within 8% of the fastest, at every prompt length (128, 200, 512),
    also where that leaves 32 blocks on 132 SMs (L = 128); 32 keys were
    faster up to L = 200, 64 at L = 512."""
    name = _dtype_name(dtype)
    _heads(H, Hk, D)
    if name == "float32" or D not in MMA_HEAD_DIMS:
        return dict(route="fma", bq=FLASH_FMA_BQ, bk=32,
                    grid=(B * H, -(-Lq // FLASH_FMA_BQ)))
    bq = next((r for r in FLASH_BQ if Lq <= r), FLASH_BQ[-1])
    bk = FLASH_BK[0] if Lk <= FLASH_SHORT_KEYS else FLASH_BK[1]
    return dict(route="mma", bq=bq, bk=bk, warps=bq // 16,
                grid=(B * H, -(-Lq // bq)))


def paged_plan(B: int, H: int, Hk: int, Q: int, n_pages: int, D: int,
               dtypes, page_size: int = PAGED_CHUNK) -> dict:
    """Route, warps, split, ring and grid of ``paged_attention`` for ``Q``
    queries of ``H`` heads per sequence over a view of ``n_pages`` pages
    of ``page_size`` rows; ``dtypes`` is ``(q dtype, pool dtype)``.

    bfloat16 q and pools at D in ``MMA_HEAD_DIMS`` take the tensor cores
    (``mma``) for ``Q * H / Hk <= 16`` query rows per kv head, and raise
    beyond.  float32 q (over float32 or bfloat16 pools), and bfloat16 at
    D = 32 or 256, take the FMA kernel (``fma``), which takes one query
    per sequence.  The mma route's ``split`` blocks of ``warps`` warps per
    (sequence, kv head) form a cluster; its ``split * warps`` parts take
    the view's 16-row chunks round-robin, each into a ring of ``ring``
    chunks.  The rule, from ``tools/attention_sweep.py``: enough parts
    that a part walks at most 2 chunks of the view, 4 warps per block
    where there are that many parts, then the fewest blocks per cluster
    that give them; the split halves while the grid would hold more than
    ``PAGED_MAX_WARPS`` warps (one wave).  It depends on ``B * Hk`` and
    the view only, never on the lengths, so a decode step never reads
    them on the host."""
    qn, kvn = (_dtype_name(t) for t in dtypes)
    G = _heads(H, Hk, D)
    if Q < 1 or n_pages < 1 or page_size < 1:
        raise ValueError(f"need Q, n_pages and page_size >= 1, got Q={Q}, "
                         f"n_pages={n_pages}, page_size={page_size}")
    if qn == "bfloat16" and kvn == "float32":
        raise TypeError("bfloat16 q over float32 pools is not built")
    if qn == "float32" or D not in MMA_HEAD_DIMS:
        if Q != 1:
            raise ValueError(f"the fma route takes one query per sequence, "
                             f"got Q={Q} ({qn} q, D={D})")
        if G > 8:
            raise ValueError(f"the fma route takes H/Hk <= 8, got {G}")
        return dict(route="fma", warps=8, split=1, grid=(B, Hk))
    if Q * G > PAGED_ROWS:
        raise ValueError(f"the mma route takes Q*H/Hk <= {PAGED_ROWS} query "
                         f"rows per kv head, got Q={Q}, H/Hk={G}")
    chunks = -(-n_pages * page_size // PAGED_CHUNK)
    parts = -(-chunks // PAGED_CHUNKS_PER_PART)
    warps = next(w for w in reversed(PAGED_WARPS) if w <= parts)
    split = next((s for s in SPLITS if s * warps >= parts), SPLITS[-1])
    while split > 1 and B * Hk * split * warps > PAGED_MAX_WARPS:
        split //= 2
    return dict(route="mma", warps=warps, split=split,
                ring=paged_ring(chunks, split * warps), rows=Q * G,
                grid=(B * Hk * split,))


def paged_ring(chunks: int, parts: int) -> int:
    """Ring slots per warp: as many as the chunks a part may walk
    (``chunks`` of the view over ``parts`` parts), so that all of its
    loads go out at once; at least 2, at most 4."""
    return min(4, max(2, -(-chunks // parts)))
