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
// TPU.
//
// What bounds it on an H100: at decode (M = 8 slots) the 1-byte weight
// stream, K * N bytes per projection; the product does 2*M flops per byte.
// At prefill (M = 128) the fp32 FMAs of this first version.
//
// Layout: as nm_spmm.cu without a gather.  A block owns BN columns and
// MT <= 8 rows of x; at M <= 8 BN is one 8-byte load (8 int8 columns), so
// a projection launches N/8 = 128..384 blocks, and 32 columns beyond 8
// rows.  The 256 threads split K: a thread keeps UNROLL rows' 8-byte loads
// in flight, reads the matching x values (consecutive across threads, so
// coalesced), decodes and multiplies into MT x 8 fp32 accumulators; the
// block sums across threads and applies the scale on the way out.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int VB = 8;                        // encoded bytes per load

__device__ __forceinline__ int decode_int7(int e) {
  e &= 0xFF;
  const int sign = (e >> 7) & 0x1;
  const int u = ((e >> 1) & 0x3F) | (sign << 6);
  return u >= 64 ? u - 128 : u;
}

template <typename T, int MT, int BN>
__global__ void __launch_bounds__(THREADS)
lookahead_kernel(const T* __restrict__ x, const int8_t* __restrict__ enc,
                 const float* __restrict__ scale, T* __restrict__ out, int M,
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
  const T* xb = x + (size_t)row0 * K;
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
        a[u][i] = (r < K && i < rows) ? to_f(xb[(size_t)i * K + r]) : 0.f;
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
    out[(size_t)(row0 + i) * N + col0 + c] = from_f<T>(s * scale[col0 + c]);
  }
}

template <typename T, int MT, int BN>
cudaError_t launch(const void* x, const void* enc, const void* scale,
                   void* out, int M, int K, int N, cudaStream_t s) {
  const dim3 grid(N / BN, (M + MT - 1) / MT);
  lookahead_kernel<T, MT, BN><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(enc),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

// Row tile: the smallest of 1, 2, 4, 8 that covers M (8 beyond); column
// slice: one 8-byte load wide up to 8 rows, 32 columns beyond.
template <typename T>
cudaError_t launch_m(const void* x, const void* enc, const void* scale,
                     void* out, int M, int K, int N, cudaStream_t s) {
  if (M > 8) return launch<T, 8, 32>(x, enc, scale, out, M, K, N, s);
  if (M > 4) return launch<T, 8, VB>(x, enc, scale, out, M, K, N, s);
  if (M > 2) return launch<T, 4, VB>(x, enc, scale, out, M, K, N, s);
  if (M > 1) return launch<T, 2, VB>(x, enc, scale, out, M, K, N, s);
  return launch<T, 1, VB>(x, enc, scale, out, M, K, N, s);
}

}  // namespace

// Shapes: x (M, K), enc (K, N) int8, scale (N,) float32, out (M, N); all
// contiguous, enc 8-byte aligned, N % 32 == 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int lookahead_matmul_launch(const void* x, const void* enc,
                                       const void* scale, void* out, int M,
                                       int K, int N, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = launch_m<float>(x, enc, scale, out, M, K, N, s);
  else if (dtype == repro::kBFloat16)
    err = launch_m<__nv_bfloat16>(x, enc, scale, out, M, K, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
