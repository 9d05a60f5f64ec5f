// bsr_matmul: x (M, K) @ BlockSparsePack (K, N) -> (M, N), skipping the
// all-zero (bk, bn) K-tiles of every N-strip.
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_matmul.py::bsr_matmul
// (pallas_call at bsr_matmul.py:86, body _kernel at :42).  The TPU grid
// (M/bm, Nb, max_nnz) ran its third axis in order, steering the x tile
// with the scalar-prefetched indices[j, t] and idling through padding
// slots t >= counts[j]; here the blocks of a cluster share the strip's
// counts[j] tiles and stop there.
//
// What bounds it on an H100: the kept tiles' bytes (half of the dense
// weight at tile density 0.5).  At decode (M = 8 slots) the product does
// 2*M flops per weight it reads, far below the ~295 flops/byte that would
// make it compute-bound; at prefill (M = 128..200) still bytes at these
// widths, now that bf16 runs on the tensor cores.  A projection streams
// 0.5-1.5 MB, so latency sets the time: loads in flight and dependent
// steps per block.
//
// Layout (strip_spmm.cuh says more), bf16: a block owns BN <= bn columns
// of one strip by BM rows of x and one of `split` ranks of a cluster; a
// 128-row kept tile is two stages of 64 rows, and rank r copies every
// split-th stage of the strip with cp.async: the (64, BN) values slab and
// the 64 contiguous x columns indices[j, t] * bk + h * 64 it multiplies, so
// the B fragments are plain 32-bit shared loads with no gather.
// mma.sync.m16n8k16 into fp32, then the ranks' partial tiles are summed in
// rank order through distributed shared memory.  fp32 keeps the CUDA-core
// FMA walk of strip_spmm.cuh.
#include "strip_spmm.cuh"

// Shapes: x (M, K), values (N/bn, max_nnz, bk, bn), indices (N/bn,
// max_nnz) int32, counts (N/bn,) int32, out (M, N); all contiguous.  The
// tile shapes come from kernels/bsr_matmul.py::plan (strip_spmm.cuh lists
// what each route takes).  Each returns the launch's error, then
// cudaGetLastError().
extern "C" int bsr_matmul_mma_launch(const void* x, const void* values,
                                     const void* indices, const void* counts,
                                     void* out, int M, int K, int N, int bk,
                                     int bn, int max_nnz, int bm, int bnt,
                                     int split, int steps, void* stream) {
  return repro::strip_mma_dispatch<false>(x, values, indices, counts,
                                          nullptr, out, M, K, N, bk, bn, bk,
                                          max_nnz, bm, bnt, split, steps,
                                          stream);
}

extern "C" int bsr_matmul_fma_launch(const void* x, const void* values,
                                     const void* indices, const void* counts,
                                     void* out, int M, int K, int N, int bk,
                                     int bn, int max_nnz, void* stream) {
  return repro::strip_fma_dispatch<false>(x, values, indices, counts,
                                          nullptr, out, M, K, N, bk, bn, bk,
                                          max_nnz, stream);
}

// The dynamic shared memory per block that bsr_matmul_mma_launch passes for
// these arguments, or -1 for a tile it does not list.
extern "C" int bsr_matmul_mma_smem_bytes(int bk, int max_nnz, int bm, int bnt,
                                         int steps) {
  return repro::strip_mma_smem_bytes<false>(bk, max_nnz, bm, bnt, steps);
}
