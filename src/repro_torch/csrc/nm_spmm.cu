// nm_spmm: x (M, K) @ NMPack (K, N) -> (M, N), K compressed by n/m.
//
// Replaces the Pallas TPU kernel repro/kernels/nm_spmm.py::nm_spmm
// (pallas_call at nm_spmm.py:95, body _make_kernel at :43).  Two routes,
// chosen by the wrapper from x's dtype (kernels/nm_spmm.py::plan, which
// also picks every tile shape and K-split passed in here):
//
// bf16 -> tensor cores (nm_spmm_mma).  What bounds it on an H100: at
// decode (M = 8 slots) the product does 2*M flops per weight element it
// reads, far below the ~295 flops/byte at which the card turns
// compute-bound, so the weight stream (values + idx, 1-3 MB per
// projection) is the cost, and streams that small are set by latency:
// how many loads are in flight, and how few dependent steps a block takes.
// At prefill (M = 128..200) still bytes for these widths, provided the
// products run on the tensor cores and not as scalar FMAs (issue-bound).
// The design (tensor_core.cuh says more): out^T = values^T . xg^T, where
// xg is x gathered through idx.  A block owns BN <= g columns -- so one
// g-column group, one list of source rows -- by BM rows (8 at decode, 32
// or 64 beyond), and one of `split` K-slices; the slices of a tile form a
// cluster and sum their fp32 partials through distributed shared memory.
// A ring of up to 8 stages, each KS = 64 compressed rows, is filled by
// cp.async (all of a block's stages at once where they fit): the dense
// (KS, BN) values tile, the dense x columns those rows come from (KS m/n
// per row of x; rows past M zero-filled), and the KS idx entries of the
// group.  A projection with fewer kept rows than a stage, or a count that
// 64 does not divide (K = 64 at 2:4: 32 kept rows), takes the half-stage
// instances, KS = 32 (two k16 steps per stage); the plan picks KS.  Per
// 16-row k step a warp loads each A fragment (16 weight columns x 16
// rows) from the row-major values tile with one
// ldmatrix.x4.trans, computes the four source columns (r/n)*m + idx[r] of
// its rows 2t, 2t+1, 2t+8, 2t+9 once, gathers the B fragment (x^T) for
// each 8-row group with four 16-bit shared loads, and issues
// mma.sync.m16n8k16 (bf16 in, fp32 out).  The g-shared idx layout is not
// the per-row metadata of mma.sp, so the kept weights multiply densely.
//
// fp32 -> CUDA-core FMAs (nm_spmm_fma), kept for fp32 parity (TF32 would
// change the numbers): a block owns a BN-column slice and MT <= 8 rows;
// 256 threads split the compressed rows, each keeps UNROLL rows' loads and
// their x gathers in flight, contracts into MT x VEC fp32 registers, and
// the block sums across threads (shuffles, then shared memory).
#include "tensor_core.cuh"

namespace {

using repro::tc::bf16;

// ---- bf16: tensor cores ---------------------------------------------------

// KS: compressed rows per stage, 64 (four k16 steps) or 32 (two).
template <int BN, int KS>
struct NmStage {             // one ring slot; XW = KS m / n x columns
  static constexpr int VLD = BN + 8;          // bf16 row stride of values
  __host__ __device__ static size_t bytes(int XW, int BM) {
    return sizeof(bf16) * (KS * VLD + (size_t)BM * (XW + 8)) + sizeof(int) * KS;
  }
};

template <int BN, int BM, int KS>
__global__ void __launch_bounds__(repro::tc::Tile<BN, BM>::THREADS)
nm_spmm_mma(const bf16* __restrict__ x, const bf16* __restrict__ values,
            const int* __restrict__ idx, bf16* __restrict__ out, int M, int K,
            int N, int n, int m, int g, int steps, int slots, int recv) {
  using namespace repro::tc;
  using TL = Tile<BN, BM>;
  using ST = NmStage<BN, KS>;
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  cluster_arrive_started();
  const int split = cg::this_cluster().num_blocks();
  const int rank = cg::this_cluster().block_rank();
  const int ns = __ffs(n) - 1;                  // n is a power of two
  const int XW = KS * m / n, XLD = XW + 8;
  const size_t stage_bytes = ST::bytes(XW, BM);
  const int n0 = blockIdx.x / split * BN, m0 = blockIdx.y * BM;
  const int Ng = N / g, grp = n0 / g;
  const int kc_begin = rank * steps * KS;

  auto slot = [&](int s) { return smem + s * stage_bytes; };
  auto load = [&](int s, int step) {
    bf16* vs = reinterpret_cast<bf16*>(slot(s));
    bf16* xs = vs + KS * ST::VLD;
    int* is = reinterpret_cast<int*>(xs + BM * XLD);
    const int kc0 = kc_begin + step * KS, xk0 = (kc0 >> ns) * m;
    for (int c = threadIdx.x; c < KS * (BN / 8); c += TL::THREADS) {
      const int r = c / (BN / 8), q = c % (BN / 8);
      cp_async16(vs + r * ST::VLD + q * 8,
                 values + (size_t)(kc0 + r) * N + n0 + q * 8, true);
    }
    const int XQ = XW / 8;
    for (int c = threadIdx.x; c < BM * XQ; c += TL::THREADS) {
      const int r = c / XQ, q = c % XQ;
      const bool in = m0 + r < M;
      cp_async16(xs + r * XLD + q * 8,
                 x + (size_t)(in ? m0 + r : 0) * K + xk0 + q * 8, in);
    }
    for (int r = threadIdx.x; r < KS; r += TL::THREADS)
      cp_async4(is + r, idx + (size_t)(kc0 + r) * Ng + grp);
  };

  for (int s = 0; s < slots - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn0 = warp % TL::WARPS_N * TL::WN;
  const int wm0 = warp / TL::WARPS_N * TL::WM;
  const int gq = lane / 4, t = lane % 4;
  float acc[TL::MT][TL::NT][4] = {};

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_dyn(slots - 2);
    __syncthreads();
    if (step + slots - 1 < steps)
      load((step + slots - 1) % slots, step + slots - 1);
    cp_async_commit();
    const bf16* vs = reinterpret_cast<const bf16*>(slot(step % slots));
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
      int src[4];                                 // rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = kk * 16 + 2 * t + (j & 1) + (j >> 1) * 8;
        src[j] = (r >> ns) * m + is[r];
      }
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const unsigned short* xr = xs + (wm0 + nt * 8 + gq) * XLD;
        const unsigned b0 = xr[src[0]] | (unsigned)xr[src[1]] << 16;
        const unsigned b1 = xr[src[2]] | (unsigned)xr[src[3]] << 16;
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt)
          mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: reuse it

  // accumulator (mt, nt, 2h + j) is column wn0 + 16 mt + gq + 8h of the
  // tile, row wm0 + 8 nt + 2t + j
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(wm0 + nt * 8 + 2 * t + (e & 1)) * TL::RED_LD + wn0 + mt * 16 + gq +
            (e >> 1) * 8] = acc[mt][nt][e];
  cluster_reduce_store<TL>(red, reinterpret_cast<float*>(smem + recv), out,
                           nullptr, M, N, m0, n0);
}

int mma_steps(int K, int n, int m, int split, int ks) {  // per block
  return K / m * n / ks / split;
}

// The shared-memory layout of a block of `steps` stages.
template <int BN, int BM, int KS>
repro::tc::Layout<repro::tc::Tile<BN, BM>> mma_layout(int steps, int n,
                                                     int m) {
  return repro::tc::Layout<repro::tc::Tile<BN, BM>>(
      steps, NmStage<BN, KS>::bytes(KS * m / n, BM));
}

template <int BN, int BM, int KS>
cudaError_t launch_mma(const void* x, const void* values, const void* idx,
                       void* out, int M, int K, int N, int n, int m, int g,
                       int split, cudaStream_t s) {
  using TL = repro::tc::Tile<BN, BM>;
  static size_t opted = 0;
  const int steps = mma_steps(K, n, m, split, KS);
  const auto lay = mma_layout<BN, BM, KS>(steps, n, m);
  const dim3 grid(N / BN * split, (M + BM - 1) / BM);
  return repro::tc::launch_cluster(
      nm_spmm_mma<BN, BM, KS>, opted, grid, TL::THREADS, lay.bytes, split, s,
      static_cast<const bf16*>(x), static_cast<const bf16*>(values),
      static_cast<const int*>(idx), static_cast<bf16*>(out), M, K, N, n, m, g,
      steps, lay.slots, (int)lay.recv);
}

// ---- fp32: CUDA-core FMAs ---------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;    // compressed rows a thread loads before use

// BN columns per block (divides g), MT rows of x per block.
template <int MT, int BN>
__global__ void __launch_bounds__(THREADS)
nm_spmm_fma(const float* __restrict__ x, const float* __restrict__ values,
            const int* __restrict__ idx, float* __restrict__ out, int M, int K,
            int N, int n, int m, int g) {
  using namespace repro;
  constexpr int VEC = 4;                     // columns per 16-byte load
  constexpr int LPR = BN / VEC;              // lanes per compressed row
  constexpr int RL = THREADS / LPR;          // rows walked side by side
  __shared__ float red[WARPS][MT][BN];

  const int Kc = K / m * n;
  const int Ng = N / g;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * MT;
  const int rows = min(MT, M - row0);
  const int grp = col0 / g;                  // the slice lies in one group
  const int lc = threadIdx.x % LPR;          // which VEC columns
  const int rl = threadIdx.x / LPR;          // which row of each pass
  const float* xb = x + (size_t)row0 * K;
  const float* vb = values + col0 + lc * VEC;

  float acc[MT][VEC] = {};
  for (int r0 = rl; r0 < Kc; r0 += RL * UNROLL) {
    float4 w[UNROLL];
    int src[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * RL;
      const bool in = r < Kc;
      w[u] = in ? *reinterpret_cast<const float4*>(vb + (size_t)r * N)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      src[u] = in ? (r / n) * m + idx[(size_t)r * Ng + grp] : -1;
    }
    float a[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a[u][i] = (src[u] >= 0 && i < rows) ? xb[(size_t)i * K + src[u]] : 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float wv[VEC] = {w[u].x, w[u].y, w[u].z, w[u].w};
#pragma unroll
      for (int j = 0; j < VEC; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][j] += a[u][i] * wv[j];
    }
  }

  // lanes LPR apart hold the same columns: sum them within the warp ...
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp][i][lc * VEC + j] = acc[i][j];
  }
  __syncthreads();
  // ... then across the warps, one output element per thread
  for (int e = threadIdx.x; e < MT * BN; e += THREADS) {
    const int i = e / BN, c = e % BN;
    if (i >= rows) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i][c];
    out[(size_t)(row0 + i) * N + col0 + c] = s;
  }
}

template <int MT, int BN>
cudaError_t launch_fma(const void* x, const void* values, const void* idx,
                       void* out, int M, int K, int N, int n, int m, int g,
                       cudaStream_t s) {
  const dim3 grid(N / BN, (M + MT - 1) / MT);
  nm_spmm_fma<MT, BN><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(values),
      static_cast<const int*>(idx), static_cast<float*>(out), M, K, N, n, m, g);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (M, K), values (K*n/m, N), idx (K*n/m, N/g) int32, out (M, N);
// all contiguous.  The tile shapes come from kernels/nm_spmm.py::plan; a
// shape it does not list returns cudaErrorInvalidValue.  Each returns
// the launch's error, then cudaGetLastError().

// bf16 x and values: BN in {32, 64, 128} dividing g, BM in {8, 32, 64},
// ks (compressed rows per stage) in {64, 32}, `split` blocks per cluster
// dividing K*n/m / ks; x and values 16-byte aligned, K % 8 == 0, ks % n ==
// 0, (ks m / n) % 8 == 0.
extern "C" int nm_spmm_mma_launch(const void* x, const void* values,
                                  const void* idx, void* out, int M, int K,
                                  int N, int n, int m, int g, int bm, int bn,
                                  int split, int ks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define NM_MMA(BN, BM, KS)                                                    \
  if (bn == BN && bm == BM && ks == KS)                                       \
    err = launch_mma<BN, BM, KS>(x, values, idx, out, M, K, N, n, m, g,       \
                                 split, s);
  NM_MMA(32, 8, 64) NM_MMA(64, 8, 64) NM_MMA(128, 8, 64)
  NM_MMA(32, 32, 64) NM_MMA(64, 32, 64) NM_MMA(128, 32, 64)
  NM_MMA(32, 64, 64) NM_MMA(64, 64, 64) NM_MMA(128, 64, 64)
  NM_MMA(32, 8, 32) NM_MMA(64, 8, 32) NM_MMA(128, 8, 32)
  NM_MMA(32, 32, 32) NM_MMA(64, 32, 32) NM_MMA(128, 32, 32)
  NM_MMA(32, 64, 32) NM_MMA(64, 64, 32) NM_MMA(128, 64, 32)
#undef NM_MMA
  return static_cast<int>(err);
}

// The dynamic shared memory per block that nm_spmm_mma_launch passes for
// these arguments, or -1 for a tile it does not list.
extern "C" int nm_spmm_mma_smem_bytes(int K, int n, int m, int bm, int bn,
                                      int split, int ks) {
#define NM_SMEM(BN, BM, KS)                                                  \
  if (bn == BN && bm == BM && ks == KS)                                      \
    return (int)mma_layout<BN, BM, KS>(mma_steps(K, n, m, split, KS), n, m) \
        .bytes;
  NM_SMEM(32, 8, 64) NM_SMEM(64, 8, 64) NM_SMEM(128, 8, 64)
  NM_SMEM(32, 32, 64) NM_SMEM(64, 32, 64) NM_SMEM(128, 32, 64)
  NM_SMEM(32, 64, 64) NM_SMEM(64, 64, 64) NM_SMEM(128, 64, 64)
  NM_SMEM(32, 8, 32) NM_SMEM(64, 8, 32) NM_SMEM(128, 8, 32)
  NM_SMEM(32, 32, 32) NM_SMEM(64, 32, 32) NM_SMEM(128, 32, 32)
  NM_SMEM(32, 64, 32) NM_SMEM(64, 64, 32) NM_SMEM(128, 64, 32)
#undef NM_SMEM
  return -1;
}

// fp32 x and values: (mt, bn) in {(1|2|4|8, 4), (8, 32)}, bn dividing g;
// values 16-byte aligned, K % m == 0.
extern "C" int nm_spmm_fma_launch(const void* x, const void* values,
                                  const void* idx, void* out, int M, int K,
                                  int N, int n, int m, int g, int mt, int bn,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bn == 32 && mt == 8)
    err = launch_fma<8, 32>(x, values, idx, out, M, K, N, n, m, g, s);
  else if (bn == 4 && mt == 8)
    err = launch_fma<8, 4>(x, values, idx, out, M, K, N, n, m, g, s);
  else if (bn == 4 && mt == 4)
    err = launch_fma<4, 4>(x, values, idx, out, M, K, N, n, m, g, s);
  else if (bn == 4 && mt == 2)
    err = launch_fma<2, 4>(x, values, idx, out, M, K, N, n, m, g, s);
  else if (bn == 4 && mt == 1)
    err = launch_fma<1, 4>(x, values, idx, out, M, K, N, n, m, g, s);
  return static_cast<int>(err);
}
