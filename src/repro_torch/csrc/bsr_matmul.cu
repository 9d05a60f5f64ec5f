// bsr_matmul: x (M, K) @ BlockSparsePack (K, N) -> (M, N), skipping the
// all-zero (bk, bn) K-tiles of every N-strip.
//
// Replaces the Pallas TPU kernel repro/kernels/bsr_matmul.py::bsr_matmul
// (pallas_call at bsr_matmul.py:86, body _kernel at :42).  The TPU grid
// (M/bm, Nb, max_nnz) ran its third axis in order, steering the x tile
// with the scalar-prefetched indices[j, t] and idling through padding
// slots t >= counts[j]; here a loop inside the block walks the strip's
// counts[j] tiles and stops there.
//
// What bounds it on an H100: at decode M is the slot count (8), so the
// product does 2*M flops per weight it reads, far below the ~295
// flops/byte that would make it compute-bound: the kept tiles' bytes are
// the cost (half of the dense weight at tile density 0.5), and a projection
// only streams them at HBM rate with many loads in flight.  At prefill
// (M = 128) the fp32 FMAs of this first version bound it.
//
// Layout (strip_spmm.cuh): a block owns one 16-byte slice of columns (8
// bf16) of one strip at M <= 8, so a projection launches N/8 = 128..384
// blocks, or 32 columns beyond 8 rows; it copies its strip's source rows
// indices[j, t] * bk + r into shared memory, then its 256 threads walk
// counts[j] * bk value rows with four 16-byte loads in flight each.  Tensor
// cores and TMA are later work.
#include "strip_spmm.cuh"

// Shapes: x (M, K), values (N/bn, max_nnz, bk, bn), indices (N/bn,
// max_nnz) int32, counts (N/bn,) int32, out (M, N); all contiguous, values
// 16-byte aligned, bn % 32 == 0, K % bk == 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int bsr_matmul_launch(const void* x, const void* values,
                                 const void* indices, const void* counts,
                                 void* out, int M, int K, int N, int bk,
                                 int bn, int max_nnz, int dtype,
                                 void* stream) {
  return repro::strip_dispatch<false>(x, values, indices, counts, nullptr,
                                      out, M, K, N, bk, bn, bk, max_nnz,
                                      dtype, stream);
}
