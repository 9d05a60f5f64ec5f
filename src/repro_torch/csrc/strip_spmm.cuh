// The strip walk shared by bsr_matmul.cu and csa_matmul.cu.
//
// Both packs cut the weight's N axis into strips of bn columns.  Strip j
// keeps counts[j] non-zero K-tiles (K-tile index indices[j, t]); each kept
// tile holds R value rows of bn columns: R = bk for a block pack, R = bkc
// (the n:m-kept rows, local row gidx[j, t, r] of the tile) for a combined
// pack.  Seen from one strip, the kept rows are one list of counts[j] * R
// rows, contiguous in `values` (row r of the strip is values[j, r / R,
// r % R, :]), each multiplying x column src[r] = indices[j, r / R] * bk +
// (gidx ? gidx[j, r / R, r % R] : r % R).  A walk stops at counts[j], so
// the values of padding slots (converted JAX packs are padded to the
// largest layer's max_nnz) are never read, and a strip with counts[j] == 0
// writes zeros.  Two routes, chosen by the wrapper from x's dtype
// (kernels/bsr_matmul.py::strip_plan, which also picks every tile shape
// and K-split passed in here):
//
// bf16 -> tensor cores (strip_spmm_mma), on the route of tensor_core.cuh
// that nm_spmm.cu takes.  What bounds it on an H100: the kept tiles' bytes
// at decode (2*M flops per weight byte pair, far below the ~295 flops/byte
// of the card's balance point), and at prefill (M = 128..200) still bytes
// at these widths once the products run on the tensor cores; streams of
// 0.3-3 MB per projection are set by latency, so what counts is how many
// loads are in flight and how few dependent steps a block takes.  Layout:
// a block owns BN columns of one strip (BN divides bn, so they share one
// tile list) by BM rows of x (8 at decode, 32 or 64 beyond) and one of
// `split` ranks of a thread-block cluster.  A stage is KS = 64 kept rows of
// the strip (KS = 32, two k16 steps, where R is not a multiple of 64: a
// combined pack of bk = 64 keeps 32 rows a tile at 2:4); rank r takes the strip's stages r, r + split, ... below
// counts[j] * R / 64, read from the device inside the kernel, so the ranks
// stay balanced to one stage whatever the counts and the host never reads
// them.  The ring (tensor_core.cuh's Layout, sized on the host from
// max_nnz) is filled by cp.async: the dense (64, BN) values slab of the
// stage (contiguous strip rows), the x window it multiplies for BM rows
// (zero fill past M), and for a combined pack the stage's 64 gidx entries.
//   - block: the window is the 64 contiguous x columns indices[j, t] * bk
//     + h * 64 (h = the stage's half of a 128-row tile), so the staged x
//     rows are x^T's B fragments as stored: ldmatrix.x4 loads those of
//     two n8 tiles (x2 of one), conflict-free at the padded row stride.
//   - combined: the window is the tile's bk columns; each warp reads the
//     four gidx entries of its rows once per k step and gathers its B
//     fragments with 16-bit shared loads, as nm_spmm_mma does.
// A fragments come from the row-major values slab by ldmatrix.x4.trans;
// mma.sync.m16n8k16 (bf16 in, fp32 out).  The strip's tile list is copied
// to shared memory first (one index row, read beside counts[j]).  A rank
// with no stages, and every rank of an empty strip, still writes a zero
// partial and joins the cluster's rank-order sum, so the result is the
// same on every run.
//
// fp32 -> CUDA-core FMAs (strip_spmm_kernel), kept for fp32 parity (TF32
// would change the numbers): the block copies its strip's src list into
// shared memory (the TPU kernel's scalar prefetch of indices/counts) and
// walks it exactly as nm_spmm_fma walks its compressed rows: a block owns
// BN columns of one strip and MT <= 8 rows of x; 256 threads split the
// rows, each keeping UNROLL rows' 16-byte value loads in flight before the
// dependent x gathers; fp32 FMAs into MT x VEC register accumulators,
// summed across the block at the end.
#pragma once

#include "tensor_core.cuh"

namespace repro {
// Internal linkage: each kernel library that includes this header keeps
// its own kernels and launch state (the `opted` sizes), even when two
// libraries built from it are loaded into one process.
namespace {

// ---- bf16: tensor cores ---------------------------------------------------

// One ring slot: the (KS, BN) values slab, BM rows of an XW-column x
// window, and (GATHER) the stage's KS gidx entries; KS kept rows per
// stage, 64 (four k16 steps) or 32 (two).
template <int BN, bool GATHER, int KS>
struct StripStage {
  static constexpr int VLD = BN + 8;          // bf16 row stride of values
  __host__ __device__ static size_t bytes(int XW, int BM) {
    return sizeof(tc::bf16) * (KS * VLD + (size_t)BM * (XW + 8)) +
           (GATHER ? sizeof(int) * KS : 0);
  }
};

template <int BN, int BM, bool GATHER, int KS>
__global__ void __launch_bounds__(tc::Tile<BN, BM>::THREADS)
strip_spmm_mma(const tc::bf16* __restrict__ x,
               const tc::bf16* __restrict__ values,
               const int* __restrict__ indices, const int* __restrict__ counts,
               const int* __restrict__ gidx, tc::bf16* __restrict__ out, int M,
               int K, int N, int bk, int bn, int R, int max_nnz, int slots,
               int recv, int tiles_at) {
  using namespace tc;
  using TL = Tile<BN, BM>;
  using ST = StripStage<BN, GATHER, KS>;
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  cluster_arrive_started();
  const int split = cg::this_cluster().num_blocks();
  const int rank = cg::this_cluster().block_rank();
  const int XW = GATHER ? bk : KS, XLD = XW + 8;
  const size_t stage_bytes = ST::bytes(XW, BM);
  const int n0 = blockIdx.x / split * BN, m0 = blockIdx.y * BM;
  const int j = n0 / bn, c0 = n0 - j * bn;    // the strip, column within it
  const int per_tile = R / KS;                // stages per kept tile

  int* tile = reinterpret_cast<int*>(smem + tiles_at);
  const int* row = indices + (size_t)j * max_nnz;
  for (int t = threadIdx.x; t < max_nnz; t += TL::THREADS) tile[t] = row[t];
  const int stages = min(counts[j], max_nnz) * per_tile;
  const int mine = stages > rank ? (stages - rank + split - 1) / split : 0;
  __syncthreads();

  auto slot = [&](int s) { return smem + s * stage_bytes; };
  auto load = [&](int s, int i) {            // this rank's i-th stage
    const int st = rank + i * split;
    const int t = st / per_tile, h = st - t * per_tile;
    bf16* vs = reinterpret_cast<bf16*>(slot(s));
    bf16* xs = vs + KS * ST::VLD;
    const bf16* vsrc =
        values + ((size_t)j * max_nnz * R + (size_t)st * KS) * bn + c0;
    for (int c = threadIdx.x; c < KS * (BN / 8); c += TL::THREADS) {
      const int r = c / (BN / 8), q = c % (BN / 8);
      cp_async16(vs + r * ST::VLD + q * 8, vsrc + (size_t)r * bn + q * 8,
                 true);
    }
    const int xk0 = tile[t] * bk + (GATHER ? 0 : h * KS);
    const int XQ = XW / 8;
    for (int c = threadIdx.x; c < BM * XQ; c += TL::THREADS) {
      const int r = c / XQ, q = c % XQ;
      const bool in = m0 + r < M;
      cp_async16(xs + r * XLD + q * 8,
                 x + (size_t)(in ? m0 + r : 0) * K + xk0 + q * 8, in);
    }
    if constexpr (GATHER) {
      int* is = reinterpret_cast<int*>(xs + BM * XLD);
      const int* gsrc = gidx + ((size_t)j * max_nnz + t) * R + h * KS;
      for (int r = threadIdx.x; r < KS; r += TL::THREADS)
        cp_async4(is + r, gsrc + r);
    }
  };

  for (int s = 0; s < slots - 1; ++s) {
    if (s < mine) load(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn0 = warp % TL::WARPS_N * TL::WN;
  const int wm0 = warp / TL::WARPS_N * TL::WM;
  const int gq = lane / 4, t4 = lane % 4;
  float acc[TL::MT][TL::NT][4] = {};

  for (int i = 0; i < mine; ++i) {
    cp_async_wait_dyn(slots - 2);
    __syncthreads();
    if (i + slots - 1 < mine) load((i + slots - 1) % slots, i + slots - 1);
    cp_async_commit();
    const bf16* vs = reinterpret_cast<const bf16*>(slot(i % slots));
    const unsigned short* xs =
        reinterpret_cast<const unsigned short*>(vs + KS * ST::VLD);
    const int* is = reinterpret_cast<const int*>(xs + BM * XLD);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      unsigned a[TL::MT][4];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt) {
        const int q = lane / 8, r = lane % 8;     // matrix q, its row r
        ldmatrix_x4_trans(a[mt], vs + (kk * 16 + q / 2 * 8 + r) * ST::VLD +
                                     wn0 + mt * 16 + q % 2 * 8);
      }
      unsigned b[TL::NT][2];                      // x^T rows 2t.., 2t+8..
      if constexpr (GATHER) {
        int src[4];                               // rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
        for (int e = 0; e < 4; ++e)
          src[e] = is[kk * 16 + 2 * t4 + (e & 1) + (e >> 1) * 8];
#pragma unroll
        for (int nt = 0; nt < TL::NT; ++nt) {
          const unsigned short* xr = xs + (wm0 + nt * 8 + gq) * XLD;
          b[nt][0] = xr[src[0]] | (unsigned)xr[src[1]] << 16;
          b[nt][1] = xr[src[2]] | (unsigned)xr[src[3]] << 16;
        }
      } else {                                    // matrix q, its row r
        const int q = lane / 8, r = lane % 8;
        if constexpr (TL::NT % 2 == 0) {
#pragma unroll
          for (int nt = 0; nt < TL::NT; nt += 2) {
            unsigned v[4];
            ldmatrix_x4(v, xs + (wm0 + (nt + q / 2) * 8 + r) * XLD + kk * 16 +
                               q % 2 * 8);
            b[nt][0] = v[0]; b[nt][1] = v[1];
            b[nt + 1][0] = v[2]; b[nt + 1][1] = v[3];
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < TL::NT; ++nt)
            ldmatrix_x2(b[nt], xs + (wm0 + nt * 8 + r) * XLD + kk * 16 +
                                   q % 2 * 8);
        }
      }
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: reuse it

  // accumulator (mt, nt, 2h + e) is column wn0 + 16 mt + gq + 8h of the
  // tile, row wm0 + 8 nt + 2t + e
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(wm0 + nt * 8 + 2 * t4 + (e & 1)) * TL::RED_LD + wn0 + mt * 16 +
            gq + (e >> 1) * 8] = acc[mt][nt][e];
  cluster_reduce_store<TL>(red, reinterpret_cast<float*>(smem + recv), out,
                           nullptr, M, N, m0, n0);
}

// The shared-memory layout of a block: the stage ring, then the strip's
// tile list (`max_nnz` ints, 16-byte aligned).
template <int BN, int BM, bool GATHER, int KS>
tc::Layout<tc::Tile<BN, BM>> strip_layout(int bk, int max_nnz, int steps) {
  const size_t list = (sizeof(int) * max_nnz + 15) / 16 * 16;
  return tc::Layout<tc::Tile<BN, BM>>(
      steps, StripStage<BN, GATHER, KS>::bytes(GATHER ? bk : KS, BM), list);
}

template <int BN, int BM, bool GATHER, int KS>
cudaError_t strip_launch_mma(const void* x, const void* values,
                             const void* indices, const void* counts,
                             const void* gidx, void* out, int M, int K, int N,
                             int bk, int bn, int R, int max_nnz, int split,
                             int steps, cudaStream_t s) {
  using TL = tc::Tile<BN, BM>;
  static size_t opted = 0;
  const auto lay = strip_layout<BN, BM, GATHER, KS>(bk, max_nnz, steps);
  const dim3 grid(N / BN * split, (M + BM - 1) / BM);
  return tc::launch_cluster(
      strip_spmm_mma<BN, BM, GATHER, KS>, opted, grid, TL::THREADS, lay.bytes,
      split, s, static_cast<const tc::bf16*>(x),
      static_cast<const tc::bf16*>(values), static_cast<const int*>(indices),
      static_cast<const int*>(counts), static_cast<const int*>(gidx),
      static_cast<tc::bf16*>(out), M, K, N, bk, bn, R, max_nnz, lay.slots,
      (int)lay.recv, (int)lay.extra_at);
}

// bf16 x and values: (bm, bnt) in {8, 32, 64} x {32, 64, 128} with bnt
// dividing bn, ks (kept rows per stage) in {64, 32} dividing R, `split`
// in {1, 2, 4, 8} blocks per cluster taking `steps` stages each at most
// (split * steps * ks >= max_nnz * R); x and values 16-byte aligned, K %
// 8 == 0, bk % 8 == 0.  Anything else returns cudaErrorInvalidValue
// without a launch.
template <bool GATHER>
int strip_mma_dispatch(const void* x, const void* values, const void* indices,
                       const void* counts, const void* gidx, void* out, int M,
                       int K, int N, int bk, int bn, int R, int max_nnz,
                       int bm, int bnt, int split, int steps, int ks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bnt <= 0 || (ks != 64 && ks != 32) || R % ks || bn % bnt ||
      steps < 1 || (long long)split * steps * ks < (long long)max_nnz * R ||
      (split != 1 && split != 2 && split != 4 && split != 8))
    return static_cast<int>(err);
#define STRIP_MMA(BN, BM, KS)                                                \
  if (bnt == BN && bm == BM && ks == KS)                                     \
    err = strip_launch_mma<BN, BM, GATHER, KS>(x, values, indices, counts,   \
                                               gidx, out, M, K, N, bk, bn,   \
                                               R, max_nnz, split, steps, s);
  STRIP_MMA(32, 8, 64) STRIP_MMA(64, 8, 64) STRIP_MMA(128, 8, 64)
  STRIP_MMA(32, 32, 64) STRIP_MMA(64, 32, 64) STRIP_MMA(128, 32, 64)
  STRIP_MMA(32, 64, 64) STRIP_MMA(64, 64, 64) STRIP_MMA(128, 64, 64)
  STRIP_MMA(32, 8, 32) STRIP_MMA(64, 8, 32) STRIP_MMA(128, 8, 32)
  STRIP_MMA(32, 32, 32) STRIP_MMA(64, 32, 32) STRIP_MMA(128, 32, 32)
  STRIP_MMA(32, 64, 32) STRIP_MMA(64, 64, 32) STRIP_MMA(128, 64, 32)
#undef STRIP_MMA
  return static_cast<int>(err);
}

// The dynamic shared memory per block that strip_mma_dispatch passes for
// these arguments, or -1 for a tile it does not list.
template <bool GATHER>
int strip_mma_smem_bytes(int bk, int max_nnz, int bm, int bnt, int steps,
                         int ks) {
#define STRIP_SMEM(BN, BM, KS)                                              \
  if (bnt == BN && bm == BM && ks == KS)                                    \
    return (int)strip_layout<BN, BM, GATHER, KS>(bk, max_nnz, steps).bytes;
  STRIP_SMEM(32, 8, 64) STRIP_SMEM(64, 8, 64) STRIP_SMEM(128, 8, 64)
  STRIP_SMEM(32, 32, 64) STRIP_SMEM(64, 32, 64) STRIP_SMEM(128, 32, 64)
  STRIP_SMEM(32, 64, 64) STRIP_SMEM(64, 64, 64) STRIP_SMEM(128, 64, 64)
  STRIP_SMEM(32, 8, 32) STRIP_SMEM(64, 8, 32) STRIP_SMEM(128, 8, 32)
  STRIP_SMEM(32, 32, 32) STRIP_SMEM(64, 32, 32) STRIP_SMEM(128, 32, 32)
  STRIP_SMEM(32, 64, 32) STRIP_SMEM(64, 64, 32) STRIP_SMEM(128, 64, 32)
#undef STRIP_SMEM
  return -1;
}

// ---- fp32: CUDA-core FMAs ---------------------------------------------------

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

// fp32 x and values: row tile the smallest of 1, 2, 4, 8 that covers M (8
// beyond); column slice one 16-byte load wide up to 8 rows, 32 columns
// beyond (tiling.fma_tiles(M, N, narrow=4) says the same); values 16-byte
// aligned, bn % 32 == 0, K % bk == 0.
template <bool GATHER>
int strip_fma_dispatch(const void* x, const void* values, const void* indices,
                       const void* counts, const void* gidx, void* out, int M,
                       int K, int N, int bk, int bn, int R, int max_nnz,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_STRIP(MT, BN)                                                  \
  err = strip_launch<float, MT, BN, GATHER>(x, values, indices, counts,     \
                                            gidx, out, M, K, N, bk, bn, R,  \
                                            max_nnz, s)
  if (M > 8) REPRO_STRIP(8, 32);
  else if (M > 4) REPRO_STRIP(8, 4);
  else if (M > 2) REPRO_STRIP(4, 4);
  else if (M > 1) REPRO_STRIP(2, 4);
  else REPRO_STRIP(1, 4);
#undef REPRO_STRIP
  return static_cast<int>(err);
}

}  // namespace
}  // namespace repro
