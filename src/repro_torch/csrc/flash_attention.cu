// flash_attention: causal attention of q (B, H, Lq, D) over k/v
// (B, Hk, Lk, D) with online softmax; optional sliding window, tanh
// softcap, GQA (query head h reads kv head h / (H/Hk)), and the suffix
// offset Lk - Lq (the Lq queries are the last Lq positions).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (pallas_call at
// flash_attention.py:140, body _make_kernel at :34).
//
// What bounds it on an H100: at the main path's prefill (one prompt of
// 128..200 rows, 16 heads of 128) the whole problem is a few MB and a
// few GFLOP -- it is bound by latency and by the fp32 FMA rate of this
// first version, not by HBM.
//
// What the design does about it: one block of 4 warps owns BQ = 16 query
// rows of one head (4 rows per warp) and walks KV tiles of BK = 32 keys
// staged in shared memory as fp32, so each K/V row is read from memory
// once per 16 queries.  A tile moves as 16-byte loads, all of a thread's
// issued before the barrier, so the tile costs one memory latency rather
// than one per element.  Within a tile each lane owns one key for the
// scores (one pass over D, the K tile padded to D + 1 floats to keep the
// lanes on distinct banks) and D/32 output elements for the P*V product
// (p broadcast by shuffles), so the online-softmax max and sum are one
// warp reduction per tile and row.  Tiles wholly outside the causal
// reach or the window are never loaded (the TPU kernel's pl.when skip);
// ragged Lq/Lk edges are masked instead of padded, and a fully masked
// row gives zeros.  Tensor cores (mma/wgmma) are later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;              // query rows per warp
constexpr int BQ = WARPS * RPW;     // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hk, int Lq, int Lk, int causal, int window,
                       float softcap, float scale) {
  using namespace repro;
  constexpr int VPT = D / 32;
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int NT = BK * D / VEC / THREADS; // 16-byte loads per K/V tile
  static_assert(NT * VEC * THREADS == BK * D, "tile must split evenly");
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][D]
  float* k_s = q_s + BQ * D;           // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);     // [BK][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const int q0 = blockIdx.y * BQ;
  const int q_off = Lk - Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;

#pragma unroll
  for (int e = threadIdx.x * VEC; e < BQ * D; e += THREADS * VEC) {
    const int i = q0 + e / D;
    store_vec<T>(q_s + e, i < Lq ? load16(qp + (size_t)i * D + e % D) : zero16());
  }

  // keys any query of this block can reach
  const int q_lo = q0 + q_off;
  const int q_hi = min(q0 + BQ, Lq) - 1 + q_off;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;

  float m_run[RPW], l_run[RPW], acc[RPW][VPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (k_beg / BK) * BK; kt < k_end; kt += BK) {
    uint4 kr[NT], vr[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int e = (threadIdx.x + t * THREADS) * VEC;
      const int kpos = kt + e / D;
      const size_t off = (size_t)kpos * D + e % D;
      kr[t] = kpos < Lk ? load16(kp + off) : zero16();
      vr[t] = kpos < Lk ? load16(vp + off) : zero16();
    }
    __syncthreads();                  // q_s written / previous tile consumed
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int e = (threadIdx.x + t * THREADS) * VEC;
      store_vec<T>(k_s + (e / D) * (D + 1) + e % D, kr[t]);
      store_vec<T>(v_s + e, vr[t]);
    }
    __syncthreads();
    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qi = q0 + warp * RPW + r;
      const int qpos = qi + q_off;
      const float* qr = q_s + (warp * RPW + r) * D;
      const float* kr_s = k_s + lane * (D + 1);
      float part[4] = {0.f, 0.f, 0.f, 0.f};   // four independent FMA chains
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) part[c] += qr[d + c] * kr_s[d + c];
      }
      float s = (part[0] + part[1]) + (part[2] + part[3]);
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const bool valid = qi < Lq && kpos < Lk && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[r][j] *= alpha;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float pk = __shfl_sync(kFull, p, kk);
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[r][j] += pk * v_s[kk * D + lane + 32 * j];
      }
      m_run[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi >= Lq) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      out[((size_t)bh * Lq + qi) * D + lane + 32 * j] = from_f<T>(acc[r][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hk, int Lq, int Lk, int causal, int window,
                   float softcap, float scale, cudaStream_t s) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, (Lq + BQ - 1) / BQ), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hk, Lq, Lk, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int Hk, int Lq, int Lk, int causal,
                     int window, float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Lq, D), k/v (B, Hk, Lk, D), out (B, H, Lq, D), all contiguous
// and 16-byte aligned, in one dtype.  window <= 0 means none, softcap <= 0 means none.
// D in {32, 64, 128, 256}.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hk, int Lq, int Lk, int D, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hk) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kFloat32)
    err = launch_d<float>(D, q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
  else if (dtype == kBFloat16)
    err = launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, Hk, Lq, Lk, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
