// csa_matmul: x (M, K) @ CombinedPack (K, N) -> (M, N): the paper's
// combined unit, block skip outside and n:m compression inside.
//
// Replaces the Pallas TPU kernel repro/kernels/csa_matmul.py::csa_matmul
// (pallas_call at csa_matmul.py:81, body _kernel at :34).  The TPU grid
// (M/bm, Nb, max_nnz) fetched the x tile of indices[j, t], gathered its
// bkc = bk*n/m kept rows through gidx[j, t] and ran a dense (bm, bkc) @
// (bkc, bn); here the blocks of a cluster share the strip's counts[j]
// tiles, each gathered through gidx, and stop there.
//
// What bounds it on an H100: the weight stream, as for bsr_matmul, now
// halved again by the n:m compression (a quarter of the dense bytes at
// tile density 0.5 with 2:4), plus gidx (4 bytes per kept row, shared by
// the strip's bn columns).  A projection streams 0.25-0.8 MB, so latency
// sets the time at decode and at prefill alike.
//
// Layout (strip_spmm.cuh says more), bf16: a block owns BN <= bn columns
// of one strip by BM rows of x and one of `split` ranks of a cluster; a
// stage is one kept tile's 64 compressed rows (bkc = 64 for 2:4 at bk =
// 128; at bk = 64 a tile's 32 kept rows are one half stage of 32), and
// rank r copies every split-th stage with cp.async: the (64, BN) values
// slab, the tile's bk x columns for BM rows and its 64 gidx entries.
// Each warp reads four gidx entries per k step and gathers its B
// fragments with 16-bit shared loads (nm_spmm_mma's stage with src =
// gidx[r]); mma.sync.m16n8k16 into fp32, then the ranks' partial tiles are
// summed in rank order through distributed shared memory.  fp32 keeps the
// CUDA-core FMA walk of strip_spmm.cuh.
#include "strip_spmm.cuh"

// Shapes: x (M, K), values (N/bn, max_nnz, bkc, bn), gidx (N/bn, max_nnz,
// bkc) int32, indices (N/bn, max_nnz) int32, counts (N/bn,) int32, out (M,
// N); all contiguous.  The tile shapes come from
// kernels/csa_matmul.py::plan (strip_spmm.cuh lists what each route
// takes).  Each returns the launch's error, then cudaGetLastError().
extern "C" int csa_matmul_mma_launch(const void* x, const void* values,
                                     const void* gidx, const void* indices,
                                     const void* counts, void* out, int M,
                                     int K, int N, int bk, int bn, int bkc,
                                     int max_nnz, int bm, int bnt, int split,
                                     int steps, int ks, void* stream) {
  return repro::strip_mma_dispatch<true>(x, values, indices, counts, gidx,
                                         out, M, K, N, bk, bn, bkc, max_nnz,
                                         bm, bnt, split, steps, ks, stream);
}

extern "C" int csa_matmul_fma_launch(const void* x, const void* values,
                                     const void* gidx, const void* indices,
                                     const void* counts, void* out, int M,
                                     int K, int N, int bk, int bn, int bkc,
                                     int max_nnz, void* stream) {
  return repro::strip_fma_dispatch<true>(x, values, indices, counts, gidx,
                                         out, M, K, N, bk, bn, bkc, max_nnz,
                                         stream);
}

// The dynamic shared memory per block that csa_matmul_mma_launch passes for
// these arguments, or -1 for a tile it does not list.
extern "C" int csa_matmul_mma_smem_bytes(int bk, int max_nnz, int bm, int bnt,
                                         int steps, int ks) {
  return repro::strip_mma_smem_bytes<true>(bk, max_nnz, bm, bnt, steps, ks);
}
