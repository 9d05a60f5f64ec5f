// The strip walk shared by bsr_matmul.cu and csa_matmul.cu.
//
// Both packs cut the weight's N axis into strips of bn columns.  Strip j
// keeps counts[j] non-zero K-tiles (K-tile index indices[j, t]); each kept
// tile holds R value rows of bn columns: R = bk for a block pack, R = bkc
// (the n:m-kept rows, local row gidx[j, t, r] of the tile) for a combined
// pack.  Seen from one strip, the kept rows are one list of counts[j] * R
// rows, contiguous in `values` (row r of the strip is values[j, r / R,
// r % R, :]), each multiplying x column src[r] = indices[j, r / R] * bk +
// (gidx ? gidx[j, r / R, r % R] : r % R).
//
// The block copies its strip's src list into shared memory (the TPU
// kernel's scalar prefetch of indices/counts) and then walks it exactly as
// nm_spmm.cu walks its compressed rows: a block owns BN columns of one
// strip and MT <= 8 rows of x; 256 threads split the rows, each keeping
// UNROLL rows' 16-byte value loads in flight before the dependent x
// gathers; fp32 FMAs into MT x VEC register accumulators, summed across
// the block at the end.  The walk stops at counts[j], so padding slots
// (converted JAX packs are padded to the largest layer's max_nnz) are
// never read, and a strip with counts[j] == 0 writes zeros.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kStripThreads = 256;
constexpr int kStripWarps = kStripThreads / 32;
constexpr int kStripUnroll = 4;

template <typename T, int MT, int BN, bool GATHER>
__global__ void __launch_bounds__(kStripThreads)
strip_spmm_kernel(const T* __restrict__ x, const T* __restrict__ values,
                  const int* __restrict__ indices,
                  const int* __restrict__ counts,
                  const int* __restrict__ gidx, T* __restrict__ out, int M,
                  int K, int N, int bk, int bn, int R, int max_nnz) {
  constexpr int VEC = 16 / sizeof(T);        // columns per 16-byte load
  constexpr int LPR = BN / VEC;              // lanes per row
  constexpr int RL = kStripThreads / LPR;    // rows walked side by side
  extern __shared__ int src_s[];             // max_nnz * R source rows
  __shared__ float red[kStripWarps][MT][BN];

  const int col0 = blockIdx.x * BN;
  const int j = col0 / bn;                   // the slice lies in one strip
  const int row0 = blockIdx.y * MT;
  const int rows = min(MT, M - row0);
  const int nrows = counts[j] * R;
  for (int r = threadIdx.x; r < nrows; r += kStripThreads) {
    const int t = r / R, rr = r - t * R;
    const size_t slot = (size_t)j * max_nnz + t;
    src_s[r] = indices[slot] * bk + (GATHER ? gidx[slot * R + rr] : rr);
  }
  __syncthreads();

  const int lc = threadIdx.x % LPR;
  const int rl = threadIdx.x / LPR;
  const T* xb = x + (size_t)row0 * K;
  const T* vb = values + (size_t)j * max_nnz * R * bn + (col0 - j * bn)
                + lc * VEC;

  float acc[MT][VEC] = {};
  for (int r0 = rl; r0 < nrows; r0 += RL * kStripUnroll) {
    uint4 w[kStripUnroll];
    int src[kStripUnroll];
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u) {
      const int r = r0 + u * RL;
      const bool in = r < nrows;
      w[u] = in ? load16(vb + (size_t)r * bn) : zero16();
      src[u] = in ? src_s[r] : -1;
    }
    float a[kStripUnroll][MT];
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a[u][i] = (src[u] >= 0 && i < rows) ? to_f(xb[(size_t)i * K + src[u]])
                                            : 0.f;
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u) {
      const T* wv = reinterpret_cast<const T*>(&w[u]);
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float b = to_f(wv[c]);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][c] += a[u][i] * b;
      }
    }
  }

  // lanes LPR apart hold the same columns: sum them within the warp ...
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[i][c] += __shfl_xor_sync(kFull, acc[i][c], o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < VEC; ++c) red[warp][i][lc * VEC + c] = acc[i][c];
  }
  __syncthreads();
  // ... then across the warps, one output element per thread
  for (int e = threadIdx.x; e < MT * BN; e += kStripThreads) {
    const int i = e / BN, c = e % BN;
    if (i >= rows) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kStripWarps; ++wi) s += red[wi][i][c];
    out[(size_t)(row0 + i) * N + col0 + c] = from_f<T>(s);
  }
}

template <typename T, int MT, int BN, bool GATHER>
cudaError_t strip_launch(const void* x, const void* values,
                         const void* indices, const void* counts,
                         const void* gidx, void* out, int M, int K, int N,
                         int bk, int bn, int R, int max_nnz, cudaStream_t s) {
  auto kernel = strip_spmm_kernel<T, MT, BN, GATHER>;
  const size_t smem = (size_t)max_nnz * R * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, (M + MT - 1) / MT);
  kernel<<<grid, kStripThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(values),
      static_cast<const int*>(indices), static_cast<const int*>(counts),
      static_cast<const int*>(gidx), static_cast<T*>(out), M, K, N, bk, bn,
      R, max_nnz);
  return cudaGetLastError();
}

// Row tile: the smallest of 1, 2, 4, 8 that covers M (8 beyond); column
// slice: one 16-byte load wide up to 8 rows, 32 columns beyond.
template <typename T, bool GATHER>
cudaError_t strip_launch_m(const void* x, const void* values,
                           const void* indices, const void* counts,
                           const void* gidx, void* out, int M, int K, int N,
                           int bk, int bn, int R, int max_nnz,
                           cudaStream_t s) {
  constexpr int NARROW = 16 / sizeof(T);
#define REPRO_STRIP(MT, BN)                                                  \
  return strip_launch<T, MT, BN, GATHER>(x, values, indices, counts, gidx,  \
                                         out, M, K, N, bk, bn, R, max_nnz, s)
  if (M > 8) REPRO_STRIP(8, 32);
  if (M > 4) REPRO_STRIP(8, NARROW);
  if (M > 2) REPRO_STRIP(4, NARROW);
  if (M > 1) REPRO_STRIP(2, NARROW);
  REPRO_STRIP(1, NARROW);
#undef REPRO_STRIP
}

template <bool GATHER>
int strip_dispatch(const void* x, const void* values, const void* indices,
                   const void* counts, const void* gidx, void* out, int M,
                   int K, int N, int bk, int bn, int R, int max_nnz,
                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = strip_launch_m<float, GATHER>(x, values, indices, counts, gidx, out,
                                        M, K, N, bk, bn, R, max_nnz, s);
  else if (dtype == kBFloat16)
    err = strip_launch_m<__nv_bfloat16, GATHER>(x, values, indices, counts,
                                                gidx, out, M, K, N, bk, bn, R,
                                                max_nnz, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace repro
