// nm_spmm: x (M, K) @ NMPack (K, N) -> (M, N), K compressed by n/m.
//
// Replaces the Pallas TPU kernel repro/kernels/nm_spmm.py::nm_spmm
// (pallas_call at nm_spmm.py:95, body _make_kernel at :43).
//
// What bounds it on an H100: at decode M is the slot count (8), so the
// product does 2*M flops per weight element it reads -- far below the
// ~295 flops/byte the card needs to be compute-bound.  The weight stream
// (values + idx) is the whole cost, and with a few MB per projection the
// stream only reaches HBM speed when many loads are in flight at once.
// At prefill (M = 128..200 prompt rows) it is still bound by bytes for
// the 0.6B model's widths.
//
// What the design does about it: one block owns a BN-column slice of one
// g-column group and MT <= 8 rows of x, where a 128-row tile would pad
// decode's 8 rows 16x.  At decode (M <= 8) the slice is one 16-byte load
// wide (8 bf16 or 4 fp32 columns), so every projection launches N/8 =
// 128..384 blocks and all 132 SMs stream weights; beyond 8 rows it is 32
// columns, so a block reuses each gathered x value 32 times.  The 256
// threads split the compressed rows: a thread owns one 16-byte load of
// each row it walks and issues UNROLL rows' value and idx loads, then
// their x gathers
// ((r/n)*m + idx, shared by the g columns of the group; x is small and
// stays in L1/L2), before it uses any of them, so 16 KB of loads per
// block are in flight.  Rows are contracted with fp32 FMAs into MT x VEC
// register accumulators, then summed across the block (warp shuffles,
// then shared memory) and written once.  Larger M takes more blocks along
// y; ragged M is masked, not padded.  The g-shared idx layout is not the
// per-row metadata of mma.sp, so the faithful first version gathers and
// multiplies densely; tensor cores and TMA are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;    // compressed rows a thread loads before use

// BN columns per block (divides g), MT rows of x per block.
template <typename T, int MT, int BN>
__global__ void __launch_bounds__(THREADS)
nm_spmm_kernel(const T* __restrict__ x, const T* __restrict__ values,
               const int* __restrict__ idx, T* __restrict__ out, int M, int K,
               int N, int n, int m, int g) {
  using namespace repro;
  constexpr int VEC = 16 / sizeof(T);        // columns per 16-byte load
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
  const T* xb = x + (size_t)row0 * K;
  const T* vb = values + col0 + lc * VEC;

  float acc[MT][VEC] = {};
  for (int r0 = rl; r0 < Kc; r0 += RL * UNROLL) {
    uint4 w[UNROLL];
    int src[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * RL;
      const bool in = r < Kc;
      w[u] = in ? *reinterpret_cast<const uint4*>(vb + (size_t)r * N)
                : make_uint4(0, 0, 0, 0);
      src[u] = in ? (r / n) * m + idx[(size_t)r * Ng + grp] : -1;
    }
    float a[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a[u][i] = (src[u] >= 0 && i < rows) ? to_f(xb[(size_t)i * K + src[u]])
                                            : 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* wv = reinterpret_cast<const T*>(&w[u]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float b = to_f(wv[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][j] += a[u][i] * b;
      }
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
    out[(size_t)(row0 + i) * N + col0 + c] = from_f<T>(s);
  }
}

template <typename T, int MT, int BN>
cudaError_t launch(const void* x, const void* values, const void* idx,
                   void* out, int M, int K, int N, int n, int m, int g,
                   cudaStream_t s) {
  const dim3 grid(N / BN, (M + MT - 1) / MT);
  nm_spmm_kernel<T, MT, BN><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(values),
      static_cast<const int*>(idx), static_cast<T*>(out), M, K, N, n, m, g);
  return cudaGetLastError();
}

// Row tile: the smallest of 1, 2, 4, 8 that covers M (8 beyond); column
// slice: one 16-byte load wide up to 8 rows, 32 columns beyond.
template <typename T>
cudaError_t launch_m(const void* x, const void* values, const void* idx,
                     void* out, int M, int K, int N, int n, int m, int g,
                     cudaStream_t s) {
  constexpr int NARROW = 16 / sizeof(T);
  if (M > 8) return launch<T, 8, 32>(x, values, idx, out, M, K, N, n, m, g, s);
  if (M > 4) return launch<T, 8, NARROW>(x, values, idx, out, M, K, N, n, m, g, s);
  if (M > 2) return launch<T, 4, NARROW>(x, values, idx, out, M, K, N, n, m, g, s);
  if (M > 1) return launch<T, 2, NARROW>(x, values, idx, out, M, K, N, n, m, g, s);
  return launch<T, 1, NARROW>(x, values, idx, out, M, K, N, n, m, g, s);
}

}  // namespace

// Shapes: x (M, K), values (K*n/m, N), idx (K*n/m, N/g) int32, out (M, N);
// all contiguous, values 16-byte aligned, g % 32 == 0, K % m == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nm_spmm_launch(const void* x, const void* values,
                              const void* idx, void* out, int M, int K, int N,
                              int n, int m, int g, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32)
    err = launch_m<float>(x, values, idx, out, M, K, N, n, m, g, s);
  else if (dtype == repro::kBFloat16)
    err = launch_m<__nv_bfloat16>(x, values, idx, out, M, K, N, n, m, g, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
