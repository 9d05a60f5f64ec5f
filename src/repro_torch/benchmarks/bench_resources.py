"""Table III analogue: the resource cost of each sparsity format.

The paper reports FPGA LUT/FF/DSP increments (<5% LUTs, 0 BRAM, +1 DSP).
The analogue per format, for a (4096, 4096) weight at its natural
sparsity:

  * values bytes      — the weight payload the kernel streams;
  * metadata bytes    — index lists / positions; the lookahead format's
    headline property is 0 extra bytes;
  * FLOP fraction     — the compute the format issues, relative to dense;
  * ``smem_bytes``    — the dynamic shared memory per block that the port's
    bfloat16 (tensor-core) launcher passes for that format at M = 128,
    read from the compiled kernel library (``None`` without a card, and
    for ``dense``, which no kernel of the port runs).  It takes the place
    of the JAX bench's per-grid-step VMEM working set.

The first four columns equal the JAX package's
``benchmarks/bench_resources.py`` on the same weight.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import analytical, sparsity
from repro_torch.core.sparse_linear import SparsityConfig, sparsify_weight

K = N = 4096
BK = BN = 128
M_SMEM = 128                         # prefill rows of the smem column

FORMATS = {
    "dense": SparsityConfig(format="dense"),
    "lookahead": SparsityConfig(format="lookahead", sparsity=0.5),
    "block": SparsityConfig(format="block", sparsity=0.5,
                            block_k=BK, block_n=BN),
    "nm": SparsityConfig(format="nm", n=2, m=4, block_n=BN),
    "combined": SparsityConfig(format="combined", sparsity=0.5,
                               n=2, m=4, block_k=BK, block_n=BN),
}


def smem_bytes(fmt: str, pack) -> Optional[int]:
    """The bfloat16 launcher's dynamic shared memory per block for
    ``pack`` at ``M_SMEM`` rows, from the compiled library; ``None``
    without a card or for ``dense``."""
    if fmt == "dense" or not torch.cuda.is_available():
        return None
    from repro_torch.kernels import (bsr_matmul, csa_matmul,
                                     lookahead_decode, nm_spmm)
    if fmt == "lookahead":
        return lookahead_decode.smem_bytes(M_SMEM, pack.K, pack.N)
    if fmt == "nm":
        return nm_spmm.smem_bytes(M_SMEM, pack.K, pack.N, pack.n, pack.m,
                                  pack.g)
    if fmt == "block":
        return bsr_matmul.smem_bytes(M_SMEM, pack.K, pack.N, pack.max_nnz,
                                     pack.bk, pack.bn)
    return csa_matmul.smem_bytes(M_SMEM, pack.K, pack.N, pack.max_nnz,
                                 pack.bk, pack.bn, pack.n, pack.m)


def run(w: Optional[torch.Tensor] = None) -> dict:
    """One row per format; ``w`` defaults to a seeded float32 normal
    weight on the CPU (packing is an offline host pass)."""
    if w is None:
        gen = torch.Generator().manual_seed(0)
        w = torch.randn((K, N), generator=gen)
    dense_bytes = K * N * 2          # bf16 reference
    rows = []
    for fmt, cfg in FORMATS.items():
        pack = sparsify_weight(w, cfg)
        if fmt == "dense":
            vals, meta = dense_bytes, 0
            flop_frac = 1.0
        else:
            vals = sparsity.values_bytes(pack)
            meta = sparsity.metadata_bytes(pack)
            flop_frac = {
                "lookahead": 1.0,     # storage-optimal, not compute-skipping
                "block": analytical.block_speedup_tile(0.5) ** -1,
                "nm": analytical.nm_flop_fraction(2, 4),
                "combined": analytical.combined_flop_fraction(0.5, 2, 4),
            }[fmt]
        rows.append({
            "format": fmt,
            "values_bytes": vals,
            "metadata_bytes": meta,
            "meta_pct_of_values": 100.0 * meta / max(vals, 1),
            "smem_bytes": smem_bytes(fmt, pack),
            "flop_fraction": flop_frac,
        })
    return {"rows": rows}


def main(out=None) -> None:
    if out is None:
        out = run()
    print("# Table III analogue — per-format resource costs "
          f"({K}x{N} weight, 50% sparsity / 2:4; byte counts, smem from "
          f"the bf16 launchers at M={M_SMEM})")
    print("format,values_MB,metadata_KB,meta_pct,smem_KB,flop_fraction")
    for r in out["rows"]:
        smem = "null" if r["smem_bytes"] is None else \
            f"{r['smem_bytes']/2**10:.1f}"
        print(f"{r['format']},{r['values_bytes']/2**20:.2f},"
              f"{r['metadata_bytes']/2**10:.1f},"
              f"{r['meta_pct_of_values']:.2f},{smem},"
              f"{r['flop_fraction']:.2f}")
    la = next(r for r in out["rows"] if r["format"] == "lookahead")
    small = all(r["meta_pct_of_values"] < 5.0 for r in out["rows"])
    print(f"lookahead metadata bytes == 0 (paper's headline): "
          f"{'PASS' if la['metadata_bytes'] == 0 else 'FAIL'}")
    print(f"all formats metadata <5% of values (paper: <5% LUT increase): "
          f"{'PASS' if small else 'FAIL'}")


if __name__ == "__main__":
    main()
