"""Quickstart on the port: the paper's technique end to end in seconds.

1. Prune a (512, 256) weight the paper's three ways: semi-structured 4:4
   (SSSA), 2:4 N:M (the USSA analogue) and combined (CSA).
2. Encode the 4:4 weights with the lookahead LSB scheme (Algorithms 1+2)
   and walk the embedded metadata.
3. Run the four sparse matmul kernels (block skip, 2:4, combined,
   lookahead int7) against their plain versions (``kernels/ref.py``) in
   float32 and bfloat16: on the card (``--device cuda``, the default) the
   hand-written kernels, each with the route of the plan
   ``dispatch.select`` resolves (the autotune cache's, else the tiling
   rule's); on the CPU the wrappers run the plain versions themselves.
4. Report the cycle-model speedups the FPGA design would see and the
   FLOP fractions of the formats.

The JAX package's ``examples/quickstart.py`` is the reference.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import analytical, encoding, pruning, sparsity
from repro_torch.core.cycle_model import Design, linear_layer_cycles
from repro_torch.kernels import (bsr_matmul, csa_matmul, dispatch,
                                 lookahead_decode, nm_spmm, ref)

#: the error a kernel may show against its plain version, per dtype:
#: float32 sums in another order; bfloat16 rounds its output
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


def kernel_rows(w: torch.Tensor, w_ss, w_nm, w_cs, device) -> list:
    """``(name, kernel, route, max abs err)`` of each pack format's kernel
    against its plain version at 128 rows of x, in float32 and bfloat16;
    raises past ``TOL``."""
    rng = np.random.default_rng(1)
    x32 = torch.from_numpy(rng.normal(size=(128, w.shape[0]))
                           .astype(np.float32))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        def on(t):
            return t.to(device, dtype)
        x = on(x32)
        blk = pruning.block_semi_structured(w, 0.5, block=128)[0]
        cases = (
            ("block-skip (SSSA)",
             sparsity.pack_block_sparse(on(blk), 128, 128),
             bsr_matmul.bsr_matmul, ref.bsr_matmul_ref),
            ("2:4 compressed (USSA)",
             sparsity.pack_nm(on(w_nm), 2, 4, g=128),
             nm_spmm.nm_spmm, ref.nm_spmm_ref),
            ("combined (CSA)",
             sparsity.pack_combined(on(w_cs), 2, 4, 128, 128),
             csa_matmul.csa_matmul, ref.csa_matmul_ref),
            ("lookahead int7",
             sparsity.LookaheadPack.from_float(w_ss).to(device),
             lookahead_decode.lookahead_matmul, ref.lookahead_matmul_ref),
        )
        for name, pack, kernel, plain in cases:
            sel = dispatch.select(pack, M=x.shape[0], device=device,
                                  dtype=dtype)
            got, want = kernel(x, pack).float(), plain(x, pack).float()
            err = float((got - want).abs().max())
            rtol, atol = TOL[dtype]
            bound = atol + rtol * float(want.abs().max())
            if not err <= bound:
                raise AssertionError(f"{name} {dtype}: kernel-vs-plain max "
                                     f"err {err:.3e} > {bound:.3e}")
            rows.append((f"{name} {str(dtype).split('.')[-1]}",
                         sel.kernel, sel.plan.get("route", sel.mode), err))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.kernels.dispatch import resolve_device
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    K, N = 512, 256
    w = torch.from_numpy((rng.normal(size=(K, N)) / np.sqrt(K))
                         .astype(np.float32))

    print("=== 1. pruning (paper Fig. 1 structures) ===")
    w_ss, m_ss = pruning.block_semi_structured(w, 0.5, block=4)
    w_nm, m_nm = pruning.n_m(w, 2, 4, group=128)
    w_cs, m_cs = pruning.combined_nm(w, 0.5, 2, 4, group=128, block=128)
    for name, m in (("4:4 semi-structured", m_ss), ("2:4 N:M", m_nm),
                    ("combined", m_cs)):
        print(f"  {name:22s} sparsity={pruning.sparsity_of(m):.3f}")

    print("\n=== 2. lookahead LSB encoding (Algorithms 1+2) ===")
    q, _ = encoding.quantize_int7(w_ss, axis=0)
    enc = encoding.encode_weight_matrix(q)
    vals, _ = encoding.decode_weight_matrix(enc)
    print(f"  int7 round-trip exact: {bool(torch.equal(vals, q))}")
    print("  metadata bytes beyond weights: 0 (rides in the LSBs)")
    visited = encoding.simulate_walk(enc[:, 0].numpy())
    print(f"  walk on column 0 visits {len(visited)}/{K // 4} blocks")

    print(f"\n=== 3. sparse kernels vs their plain versions ({device}) ===")
    for name, kernel, route, err in kernel_rows(w, w_ss, w_nm, w_cs,
                                                device):
        where = f"{kernel}/{route}" if device.type == "cuda" else \
            f"{kernel}/plain"
        print(f"  {name:32s} -> {where:26s} kernel-vs-plain max err "
              f"{err:.2e}")

    print("\n=== 4. what the FPGA would see (cycle model) ===")
    base = linear_layer_cycles(m_ss.numpy().astype(bool),
                               Design.BASELINE_SIMD)
    for d, m in ((Design.SSSA, m_ss), (Design.USSA, m_nm),
                 (Design.CSA, m_cs)):
        mask = m.numpy().astype(bool)
        c = linear_layer_cycles(mask, d)
        baseline = base if d is Design.SSSA else linear_layer_cycles(
            mask, Design.BASELINE_SEQ)
        print(f"  {d.value:6s} speedup {baseline / c:.2f}x")

    print("\n=== 5. what the tensor cores see (FLOP fractions) ===")
    print(f"  block-skip : {analytical.block_speedup_tile(0.5) ** -1:.2f} "
          "of dense FLOPs")
    print(f"  2:4        : {analytical.nm_flop_fraction(2, 4):.2f}")
    print(f"  combined   : "
          f"{analytical.combined_flop_fraction(0.5, 2, 4):.2f}")
    print("\nok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
