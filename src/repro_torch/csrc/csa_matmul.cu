// csa_matmul: x (M, K) @ CombinedPack (K, N) -> (M, N): the paper's
// combined unit, block skip outside and n:m compression inside.
//
// Replaces the Pallas TPU kernel repro/kernels/csa_matmul.py::csa_matmul
// (pallas_call at csa_matmul.py:81, body _kernel at :34).  The TPU grid
// (M/bm, Nb, max_nnz) fetched the x tile of indices[j, t], gathered its
// bkc = bk*n/m kept rows through gidx[j, t] and ran a dense (bm, bkc) @
// (bkc, bn); here a loop inside the block walks the strip's counts[j]
// tiles, each as bkc rows gathered through gidx.
//
// What bounds it on an H100: the weight stream, as for bsr_matmul, now
// halved again by the n:m compression (a quarter of the dense bytes at
// tile density 0.5 with 2:4), plus gidx (4 bytes per kept row, shared by
// the strip's bn columns).  At prefill the fp32 FMAs of this first
// version bound it.
//
// Layout (strip_spmm.cuh): as bsr_matmul, with the block's shared-memory
// source list built as indices[j, t] * bk + gidx[j, t, r]; the x gather is
// then one shared-memory read and one cached load per row.
#include "strip_spmm.cuh"

// Shapes: x (M, K), values (N/bn, max_nnz, bkc, bn), gidx (N/bn, max_nnz,
// bkc) int32, indices (N/bn, max_nnz) int32, counts (N/bn,) int32, out (M,
// N); all contiguous, values 16-byte aligned, bn % 32 == 0, K % bk == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int csa_matmul_launch(const void* x, const void* values,
                                 const void* gidx, const void* indices,
                                 const void* counts, void* out, int M, int K,
                                 int N, int bk, int bn, int bkc, int max_nnz,
                                 int dtype, void* stream) {
  return repro::strip_dispatch<true>(x, values, indices, counts, gidx, out,
                                     M, K, N, bk, bn, bkc, max_nnz, dtype,
                                     stream);
}
