// lookahead_matmul: x (M, K) @ decode(LookaheadPack) (K, N) -> (M, N), the
// int7 weights decoded from their encoded bytes in registers.
//
// Replaces the Pallas TPU kernel
// repro/kernels/lookahead_decode.py::lookahead_matmul (pallas_call at
// lookahead_decode.py:84, body _kernel at :43, decode _decode_int7 at :35).
// Each encoded byte is [sign, b5..b0, skip]: the int7 value is
// ((e >> 1) & 0x3f) | (sign << 6), sign-extended from 7 bits (the JAX bit
// formula; the same as an arithmetic shift right of the signed byte).  The
// skip bit is ignored here: this is the faithful, non-skipping path.  The
// per-column scale multiplies the fp32 sum once, at the end, as on the
// TPU.  Two routes, chosen by the wrapper from x's dtype
// (kernels/lookahead_decode.py::plan, which also picks every tile shape
// and K-split passed in here):
//
// bf16 -> tensor cores (lookahead_mma).  What bounds it on an H100: the
// 1-byte weight stream (K * N bytes, 1-3 MB per projection) at decode,
// where the product does 2*M flops per byte; at prefill (M = 128) still
// bytes, once the products run on the tensor cores rather than as scalar
// FMAs.  The design is nm_spmm.cu's without the gather (tensor_core.cuh
// says more): out^T = W^T . x^T, a block owns BN columns x BM rows (8 at
// decode, 32 or 64 beyond) and one of `split` K-slices, the slices of a
// tile sum through their cluster's shared memory, and a ring of up to 8
// stages of 128 K rows is filled by cp.async with the int8 (128, BN) tile
// and x's (BM, 128) tile.  ldmatrix cannot decode, so A fragments are
// built from 32-bit shared words: a thread reads the word of 4 columns
// (4 gq .. +3) at each of its K rows 2t, 2t+1, 2t+8, 2t+9, and those 4
// columns are the rows gq and gq+8 of the warp's two m16 tiles (column map
// in the code).
// One byte_perm pairs a column's two K bytes, a shift, a mask and an xor
// turn the pair into the bf16 bits of v + 192 (v + 64 in 7 mantissa bits
// under the exponent of 128), and one bf16x2 subtract leaves v exactly:
// every int7 value is exact in bf16, so the products are exact too.
//
// fp32 -> CUDA-core FMAs (lookahead_fma), kept for fp32 parity: a block
// owns BN columns and MT <= 8 rows, 256 threads split K with UNROLL rows'
// 8-byte loads in flight, decode and multiply into MT x 8 fp32
// accumulators, and the block sums across threads, scaling on the way out.
#include "tensor_core.cuh"

namespace {

using repro::tc::bf16;

__device__ __forceinline__ int decode_int7(int e) {
  e &= 0xFF;
  const int sign = (e >> 7) & 0x1;
  const int u = ((e >> 1) & 0x3F) | (sign << 6);
  return u >= 64 ? u - 128 : u;
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int KS = 128;      // K rows per stage (eight k16 steps)

template <int BN, int BM>
struct LaStage {
  static constexpr int ELD = BN + 16;         // byte row stride of enc
  static constexpr int XLD = KS + 8;          // bf16 row stride of x
  static constexpr size_t BYTES = KS * ELD + sizeof(bf16) * BM * XLD;
};

// bf16x2 of the int7 values of byte j of `lo` (low half) and of `hi`.
__device__ __forceinline__ unsigned decode_pair(unsigned lo, unsigned hi,
                                                int j) {
  const unsigned p = __byte_perm(lo, hi, j | j << 4 | (4 + j) << 8 |
                                             (4 + j) << 12);
  unsigned v = ((p >> 1) & 0x007f007fu) ^ 0x43404340u;   // v + 192, in bf16
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(192.f, 192.f));
  return *reinterpret_cast<unsigned*>(&h);
}

template <int BN, int BM>
__global__ void __launch_bounds__(repro::tc::Tile<BN, BM>::THREADS)
lookahead_mma(const bf16* __restrict__ x, const int8_t* __restrict__ enc,
              const float* __restrict__ scale, bf16* __restrict__ out, int M,
              int K, int N, int steps, int slots, int recv) {
  using namespace repro::tc;
  using TL = Tile<BN, BM>;
  using ST = LaStage<BN, BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  const int split = cg::this_cluster().num_blocks();
  const int rank = cg::this_cluster().block_rank();
  cluster_arrive_started();
  const int n0 = blockIdx.x / split * BN, m0 = blockIdx.y * BM;
  const int k_begin = rank * steps * KS;

  auto slot = [&](int s) { return smem + s * ST::BYTES; };
  auto load = [&](int s, int step) {
    unsigned char* es = slot(s);
    bf16* xs = reinterpret_cast<bf16*>(es + KS * ST::ELD);
    const int k0 = k_begin + step * KS;
    for (int c = threadIdx.x; c < KS * (BN / 16); c += TL::THREADS) {
      const int r = c / (BN / 16), q = c % (BN / 16);
      cp_async16(es + r * ST::ELD + q * 16,
                 enc + (size_t)(k0 + r) * N + n0 + q * 16, true);
    }
    for (int c = threadIdx.x; c < BM * (KS / 8); c += TL::THREADS) {
      const int r = c / (KS / 8), q = c % (KS / 8);
      const bool in = m0 + r < M;
      cp_async16(xs + r * ST::XLD + q * 8,
                 x + (size_t)(in ? m0 + r : 0) * K + k0 + q * 8, in);
    }
  };

#pragma unroll
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
    const unsigned char* es = slot(step % slots);
    const bf16* xs = reinterpret_cast<const bf16*>(es + KS * ST::ELD);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      // the words of columns wn0 + 4gq .. +3 at K rows 2t, 2t+1, 2t+8, 2t+9
      const unsigned char* er = es + (kk * 16 + 2 * t) * ST::ELD + wn0 + 4 * gq;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(er);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(er + ST::ELD);
      const unsigned w8 = *reinterpret_cast<const unsigned*>(er + 8 * ST::ELD);
      const unsigned w9 = *reinterpret_cast<const unsigned*>(er + 9 * ST::ELD);
      unsigned a[TL::MT][4];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt) {     // byte 2mt: row gq, 2mt+1: gq+8
        a[mt][0] = decode_pair(w0, w1, 2 * mt);
        a[mt][1] = decode_pair(w0, w1, 2 * mt + 1);
        a[mt][2] = decode_pair(w8, w9, 2 * mt);
        a[mt][3] = decode_pair(w8, w9, 2 * mt + 1);
      }
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const bf16* xr = xs + (wm0 + nt * 8 + gq) * ST::XLD + kk * 16 + 2 * t;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(xr);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(xr + 8);
#pragma unroll
        for (int mt = 0; mt < TL::MT; ++mt)
          mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: reuse it

  // accumulator (mt, nt, 2h + j) is column wn0 + 4gq + 2mt + h of the
  // tile, row wm0 + 8 nt + 2t + j
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(wm0 + nt * 8 + 2 * t + (e & 1)) * TL::RED_LD + wn0 + 4 * gq +
            2 * mt + (e >> 1)] = acc[mt][nt][e];
  cluster_reduce_store<TL>(red, reinterpret_cast<float*>(smem + recv), out,
                           scale, M, N, m0, n0);
}

template <int BN, int BM>
cudaError_t launch_mma(const void* x, const void* enc, const void* scale,
                       void* out, int M, int K, int N, int split,
                       cudaStream_t s) {
  using TL = repro::tc::Tile<BN, BM>;
  static size_t opted = 0;
  const int steps = K / KS / split;               // stages per block
  const repro::tc::Layout<TL> lay(steps, LaStage<BN, BM>::BYTES);
  const dim3 grid(N / BN * split, (M + BM - 1) / BM);
  return repro::tc::launch_cluster(
      lookahead_mma<BN, BM>, opted, grid, TL::THREADS, lay.bytes, split, s,
      static_cast<const bf16*>(x), static_cast<const int8_t*>(enc),
      static_cast<const float*>(scale), static_cast<bf16*>(out), M, K, N,
      steps, lay.slots, (int)lay.recv);
}

// ---- fp32: CUDA-core FMAs ---------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int VB = 8;                        // encoded bytes per load

template <int MT, int BN>
__global__ void __launch_bounds__(THREADS)
lookahead_fma(const float* __restrict__ x, const int8_t* __restrict__ enc,
              const float* __restrict__ scale, float* __restrict__ out, int M,
              int K, int N) {
  using namespace repro;
  constexpr int LPR = BN / VB;               // lanes per row
  constexpr int RL = THREADS / LPR;          // rows walked side by side
  __shared__ float red[WARPS][MT][BN];

  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * MT;
  const int rows = min(MT, M - row0);
  const int lc = threadIdx.x % LPR;
  const int rl = threadIdx.x / LPR;
  const float* xb = x + (size_t)row0 * K;
  const int8_t* eb = enc + col0 + lc * VB;

  float acc[MT][VB] = {};
  for (int r0 = rl; r0 < K; r0 += RL * UNROLL) {
    uint2 w[UNROLL];
    float a[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * RL;
      w[u] = r < K ? *reinterpret_cast<const uint2*>(eb + (size_t)r * N)
                   : make_uint2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * RL;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a[u][i] = (r < K && i < rows) ? xb[(size_t)i * K + r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int8_t* wb = reinterpret_cast<const int8_t*>(&w[u]);
#pragma unroll
      for (int c = 0; c < VB; ++c) {
        const float b = (float)decode_int7(wb[c]);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][c] += a[u][i] * b;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < VB; ++c)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[i][c] += __shfl_xor_sync(kFull, acc[i][c], o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < LPR) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < VB; ++c) red[warp][i][lc * VB + c] = acc[i][c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MT * BN; e += THREADS) {
    const int i = e / BN, c = e % BN;
    if (i >= rows) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i][c];
    out[(size_t)(row0 + i) * N + col0 + c] = s * scale[col0 + c];
  }
}

template <int MT, int BN>
cudaError_t launch_fma(const void* x, const void* enc, const void* scale,
                       void* out, int M, int K, int N, cudaStream_t s) {
  const dim3 grid(N / BN, (M + MT - 1) / MT);
  lookahead_fma<MT, BN><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(enc),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// Shapes: x (M, K), enc (K, N) int8, scale (N,) float32, out (M, N); all
// contiguous.  The tile shapes come from kernels/lookahead_decode.py::plan;
// a shape it does not list returns cudaErrorInvalidValue.  Each returns
// the launch's error, then cudaGetLastError().

// bf16 x: BN in {32, 64, 128} dividing N, BM in {8, 32, 64}, `split` blocks
// per cluster dividing K / 128; x and enc 16-byte aligned, K % 128 == 0.
extern "C" int lookahead_mma_launch(const void* x, const void* enc,
                                    const void* scale, void* out, int M,
                                    int K, int N, int bm, int bn, int split,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define LA_MMA(BN, BM)                                                        \
  if (bn == BN && bm == BM)                                                   \
    err = launch_mma<BN, BM>(x, enc, scale, out, M, K, N, split, s);
  LA_MMA(32, 8) LA_MMA(64, 8) LA_MMA(128, 8)
  LA_MMA(32, 32) LA_MMA(64, 32) LA_MMA(128, 32)
  LA_MMA(32, 64) LA_MMA(64, 64) LA_MMA(128, 64)
#undef LA_MMA
  return static_cast<int>(err);
}

// fp32 x: (mt, bn) in {(1|2|4|8, 8), (8, 32)}, bn dividing N; enc 8-byte
// aligned.
extern "C" int lookahead_fma_launch(const void* x, const void* enc,
                                    const void* scale, void* out, int M,
                                    int K, int N, int mt, int bn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bn == 32 && mt == 8)
    err = launch_fma<8, 32>(x, enc, scale, out, M, K, N, s);
  else if (bn == VB && mt == 8)
    err = launch_fma<8, VB>(x, enc, scale, out, M, K, N, s);
  else if (bn == VB && mt == 4)
    err = launch_fma<4, VB>(x, enc, scale, out, M, K, N, s);
  else if (bn == VB && mt == 2)
    err = launch_fma<2, VB>(x, enc, scale, out, M, K, N, s);
  else if (bn == VB && mt == 1)
    err = launch_fma<1, VB>(x, enc, scale, out, M, K, N, s);
  return static_cast<int>(err);
}
