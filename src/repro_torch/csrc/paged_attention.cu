// paged_attention: decode attention of q (B, H, D) over the page pools
// k/v (P, ps, Hk, D) through the page table ptab (B, >= n_pages) and the
// per-sequence lengths lens (B,).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention (pallas_call at
// paged_attention.py:166, body _make_kernel at :62), Q = 1 (decode).
//
// What bounds it on an H100: each cached K/V row is read once and used
// for 2*G*D flops per matrix (G = H/Hk query heads share it), so the
// kernel is bound by the bytes of the live rows -- and, at decode's small
// batch, by the latency of walking them.
//
// What the design does about it: one block per (sequence, kv head)
// folds the G query heads of the group onto each K/V row it reads (GQA
// without repeating K/V).  Its 8 warps split the sequence's rows and
// walk only ceil(lens/ps) pages.  The block first copies those entries
// of its page-table row into shared memory (the TPU's scalar-prefetched
// index map), so a row's address costs a shared-memory read, not a
// second dependent trip to HBM.  A warp loads UNROLL rows before it uses
// them, so several loads are in flight, and folds them into its online
// softmax (running max, denominator, accumulator) in one update, so the
// rows' dot products and warp reductions overlap.  Each lane holds D/32
// elements of q and of the running output.  The block merges the 8
// warps' states in shared memory at the end.  lens is clamped to the
// view (n_pages * ps rows), as the gathered view of the plain version
// is; a row with lens == 0 gives zeros, not NaN.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int GMAX = 8;      // query heads per kv head

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp, const int* __restrict__ ptab,
                       const int* __restrict__ lens, TQ* __restrict__ out, int H,
                       int Hk, int ps, int n_pages, int ptab_stride,
                       float scale) {
  using namespace repro;
  constexpr int VPT = D / 32;
  constexpr int UNROLL = D <= 128 ? 8 : 4;   // rows a warp loads before use
  extern __shared__ float smem[];  // [WARPS][G][D + 2], then the page row
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(lens[b], n_pages * ps));
  int* pt = reinterpret_cast<int*>(smem + (size_t)WARPS * G * (D + 2));
  for (int i = threadIdx.x; i < (len + ps - 1) / ps; i += WARPS * 32)
    pt[i] = ptab[(size_t)b * ptab_stride + i];
  __syncthreads();

  float qv[GMAX][VPT], acc[GMAX][VPT], m_run[GMAX], l_run[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      acc[g][j] = 0.f;
      qv[g][j] = g < G ? to_f(q[((size_t)b * H + hk * G + g) * D + lane + 32 * j])
                       : 0.f;
    }
  }

  for (int row0 = warp; row0 < len; row0 += WARPS * UNROLL) {
    float kv[UNROLL][VPT], vv[UNROLL][VPT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = row0 + u * WARPS;
      const size_t base =
          row < len ? (((size_t)pt[row / ps] * ps + row % ps) * Hk + hk) * D : 0;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        kv[u][j] = row < len ? to_f(kp[base + lane + 32 * j]) : 0.f;
        vv[u][j] = row < len ? to_f(vp[base + lane + 32 * j]) : 0.f;
      }
    }
    // one online-softmax update per UNROLL rows: the rows' dot products
    // and warp reductions are independent, so their latencies overlap
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float s[UNROLL];
      float mx = m_run[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < VPT; ++j) d += qv[g][j] * kv[u][j];
        d = warp_sum(d) * scale;
        s[u] = row0 + u * WARPS < len ? d : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m_run[g] - mx);
      float l = l_run[g] * alpha;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = row0 + u * WARPS < len ? expf(s[u] - mx) : 0.f;
        l += p;
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[g][j] += p * vv[u][j];
      }
      l_run[g] = l;
      m_run[g] = mx;
    }
  }

  float* mine = smem + (size_t)warp * G * (D + 2);
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int j = 0; j < VPT; ++j) mine[g * (D + 2) + lane + 32 * j] = acc[g][j];
    if (lane == 0) {
      mine[g * (D + 2) + D] = m_run[g];
      mine[g * (D + 2) + D + 1] = l_run[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += WARPS * 32) {
    const int g = e / D, d = e % D;
    float mx = kNegInf;
    for (int w = 0; w < WARPS; ++w)
      mx = fmaxf(mx, smem[((size_t)w * G + g) * (D + 2) + D]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float* st = smem + ((size_t)w * G + g) * (D + 2);
      const float f = expf(st[D] - mx);
      l += st[D + 1] * f;
      a += st[d] * f;
    }
    out[((size_t)b * H + hk * G + g) * D + d] = from_f<TQ>(l > 0.f ? a / l : 0.f);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* ptab, const int* lens, void* out, int B, int H,
                   int Hk, int ps, int n_pages, int ptab_stride, float scale,
                   cudaStream_t s) {
  auto kernel = paged_attention_kernel<TQ, TKV, D>;
  const size_t smem =
      sizeof(float) * WARPS * (H / Hk) * (D + 2) + sizeof(int) * n_pages;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hk), WARPS * 32, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ptab, lens, static_cast<TQ*>(out), H, Hk, ps,
      n_pages, ptab_stride, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const int* ptab, const int* lens, void* out, int B, int H,
                     int Hk, int ps, int n_pages, int ptab_stride, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(q, kp, vp, ptab, lens, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
    case 64: return launch<TQ, TKV, 64>(q, kp, vp, ptab, lens, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
    case 128: return launch<TQ, TKV, 128>(q, kp, vp, ptab, lens, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
    case 256: return launch<TQ, TKV, 256>(q, kp, vp, ptab, lens, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D) and out in q_dtype; pools (P, ps, Hk, D) in kv_dtype; ptab
// rows ptab_stride apart, n_pages of each row in view; lens (B,) int32.
// H/Hk <= 8, D in {32, 64, 128, 256}.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ptab,
                                      const void* lens, void* out, int B, int H,
                                      int Hk, int D, int ps, int n_pages,
                                      int ptab_stride, float scale, int q_dtype,
                                      int kv_dtype, void* stream) {
  using namespace repro;
  const int* pt = static_cast<const int*>(ptab);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hk || H / Hk > GMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    err = launch_d<float, float>(D, q, kp, vp, pt, ln, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16)
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, kp, vp, pt, ln, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
  else if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    err = launch_d<float, __nv_bfloat16>(D, q, kp, vp, pt, ln, out, B, H, Hk, ps, n_pages, ptab_stride, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
