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
// 128..200 rows, 16 heads of 128) the whole problem is 1-3 MB and 70-170
// MFLOP, a few microseconds at the card's peak rates -- it is bound by
// latency: how many dependent steps a block takes and how many blocks
// share the card, not by HBM nor by the tensor cores' rate.
//
// Two routes, chosen by the wrapper's plan (kernels/tiling.py::flash_plan):
//
// bf16, D in {64, 128, 160} -> tensor cores (flash_attention_mma), the
// FlashAttention-2 layout.  A block of WARPS warps owns BQ = 16 * WARPS
// query rows of one head; each warp owns 16 rows, their Q fragments held
// in registers (ldmatrix from the staged Q tile).  K/V tiles of BK keys
// stream through a ring of shared-memory stages filled by cp.async while
// the previous tiles are computed, so a block waits on about one memory
// latency rather than one per tile.  S = Q K^T is mma.sync.m16n8k16 with
// the K tile as the B operand (ldmatrix, keys as rows); the online
// softmax runs on S's C fragments in registers, a row's max and sum over
// the 4 lanes of its quad; P goes back to the MMA as bf16 A fragments
// built straight from S's C fragments (two n8 tiles make one k16
// fragment), V as the B operand by ldmatrix.trans.  Tiles wholly outside
// the block's causal or window reach are never loaded (the TPU kernel's
// pl.when skip), and a warp skips the MMAs of a loaded tile that none of
// its rows reaches.  Ragged Lq/Lk edges are zero-filled and masked, a
// fully masked row gives zeros, and row tiles with the most keys are
// launched first.  The plan picks BQ and BK so that the grid fills the
// card at the prompt's shape (tools/attention_sweep.py).  Nothing here
// needs D to be a power of two: D = 160 (stablelm) is 10 k16 steps of
// S = Q K^T and 20 n8 tiles of O, paired two by two by the x4 loads of
// V, and 20 sixteen-byte pieces per staged row (row stride D + 8 = 168
// bf16: eight ldmatrix rows still fall in distinct bank groups).
//
// fp32 (and bf16 at D = 16, 32 or 256) -> CUDA-core FMAs
// (flash_attention_fma), kept for fp32 parity: a block of 4 warps owns 16
// query rows and walks KV tiles of 32 keys staged as fp32, one key per
// lane for the scores and D/32 output elements per lane for P*V (at D =
// 16, one on each of the lanes below 16: the bench models' heads).
#include "tensor_core.cuh"

namespace {

using repro::tc::bf16;

// ---- bf16: tensor cores -----------------------------------------------------

template <int BK>
constexpr int kStages = BK == 32 ? 4 : 3;   // ring slots of K/V tiles

template <int D, int WARPS, int BK>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (D + 8) *
         (16 * WARPS + 2 * kStages<BK> * BK);
}

template <int D, int WARPS, int BK>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                    int Hk, int Lq, int Lk, int causal, int window,
                    float softcap, float scale) {
  using namespace repro;
  using namespace repro::tc;
  constexpr int THREADS = WARPS * 32, BQ = 16 * WARPS;
  constexpr int LD = D + 8;                 // bf16 row stride: no conflicts
  constexpr int STAGES = kStages<BK>;
  constexpr int DQ = D / 8;                 // 16-byte pieces per row
  constexpr int NT = BK / 8;                // n8 tiles of S
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);       // [BQ][LD]
  bf16* k_s = q_s + BQ * LD;                       // [STAGES][BK][LD]
  bf16* v_s = k_s + STAGES * BK * LD;              // [STAGES][BK][LD]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int q_off = Lk - Lq;
  const bf16* qp = q + (size_t)bh * Lq * D;
  const bf16* kp = k + (size_t)kvh * Lk * D;
  const bf16* vp = v + (size_t)kvh * Lk * D;

  // keys any query of this block can reach
  const int q_lo = q0 + q_off;
  const int q_hi = min(q0 + BQ, Lq) - 1 + q_off;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = k_beg / BK;
  const int ntiles = k_end > t0 * BK ? (k_end - t0 * BK + BK - 1) / BK : 0;

  for (int c = threadIdx.x; c < BQ * DQ; c += THREADS) {
    const int r = c / DQ, col = c % DQ * 8;
    const bool in = q0 + r < Lq;
    cp_async16(q_s + r * LD + col, qp + (size_t)(in ? q0 + r : 0) * D + col,
               in);
  }
  cp_async_commit();
  auto load = [&](int slot, int i) {        // KV tile i of the block
    const int kt = (t0 + i) * BK;
    bf16* ks = k_s + slot * BK * LD;
    bf16* vs = v_s + slot * BK * LD;
    for (int c = threadIdx.x; c < BK * DQ; c += THREADS) {
      const int r = c / DQ, col = c % DQ * 8;
      const bool in = kt + r < Lk;
      const size_t off = (size_t)(in ? kt + r : 0) * D + col;
      cp_async16(ks + r * LD + col, kp + off, in);
      cp_async16(vs + r * LD + col, vp + off, in);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;   // C fragment row, column pair
  const int lq = lane / 8, lr = lane % 8;   // ldmatrix: matrix, its row
  const int wq0 = q0 + warp * 16;           // the warp's first query row
  const int qpos[2] = {wq0 + gq + q_off, wq0 + gq + 8 + q_off};
  const int wq_lo = wq0 + q_off, wq_hi = min(wq0 + 16, Lq) - 1 + q_off;

  cp_async_wait<STAGES - 1>();              // the Q tile has landed
  __syncthreads();
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], q_s + (warp * 16 + (lq % 2) * 8 + lr) * LD +
                            kk * 16 + (lq / 2) * 8);

  float o[D / 8][4] = {};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                        // tile i visible, i-1 consumed
    if (i + STAGES - 1 < ntiles) load((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_async_commit();
    const int kt = (t0 + i) * BK;
    if (wq0 >= Lq || (causal && kt > wq_hi) ||
        (window > 0 && kt + BK - 1 <= wq_lo - window))
      continue;                             // no row of this warp reaches it
    const bf16* ks = k_s + (i % STAGES) * BK * LD;
    const bf16* vs = v_s + (i % STAGES) * BK * LD;

    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (nt * 8 + (lq / 2) * 8 + lr) * LD + kk * 16 +
                            (lq % 2) * 8);
        mma_bf16(s[nt], qa[kk], bk[0], bk[1]);
        mma_bf16(s[nt + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // s[nt][e] is row gq + 8 (e >> 1), key kt + 8 nt + 2 t4 + (e & 1)
    float mx[2] = {m_run[0], m_run[1]};
    unsigned valid = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + nt * 8 + 2 * t4 + (e & 1);
        const int qp_ = qpos[e >> 1];
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool ok = key < Lk && (!causal || key <= qp_) &&
                        (window <= 0 || key > qp_ - window);
        valid |= (unsigned)ok << (nt * 4 + e);
        s[nt][e] = ok ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (valid >> (nt * 4 + e)) & 1u
                            ? __expf(s[nt][e] - mx[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }

    // O += P V: P's k16 fragment kk is S's n8 tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* src = s[2 * kk + j / 2] + (j % 2) * 2;
        __nv_bfloat162 pk = __floats2bfloat162_rn(src[0], src[1]);
        a[j] = *reinterpret_cast<unsigned*>(&pk);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lq % 2) * 8 + lr) * LD +
                                  dn * 8 + (lq / 2) * 8);
        mma_bf16(o[dn], a, bv[0], bv[1]);
        mma_bf16(o[dn + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    const int qi = wq0 + gq + 8 * r;
    if (qi >= Lq) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    bf16* dst = out + ((size_t)bh * Lq + qi) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
  }
}

template <int D, int WARPS, int BK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int Hk, int Lq, int Lk, int causal,
                       int window, float softcap, float scale,
                       cudaStream_t s) {
  auto kernel = flash_attention_mma<D, WARPS, BK>;
  constexpr size_t smem = mma_smem_bytes<D, WARPS, BK>();
  static bool opted = false;
  if (!opted) {
    if (cudaError_t err = repro::allow_smem(kernel, smem)) return err;
    opted = true;
  }
  kernel<<<dim3(B * H, (Lq + 16 * WARPS - 1) / (16 * WARPS)), WARPS * 32,
           smem, s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out), H,
                      Hk, Lq, Lk, causal, window, softcap, scale);
  return cudaGetLastError();
}

// ---- fp32: CUDA-core FMAs ---------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRpw = 4;              // query rows per warp
constexpr int kBq = kWarps * kRpw;     // query rows per block
constexpr int kBk = 32;              // keys per tile: one per lane

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBq * D + kBk * (D + 1) + kBk * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int H,
                    int Hk, int Lq, int Lk, int causal, int window,
                    float softcap, float scale) {
  using namespace repro;
  // output columns per lane: D / 32, or one for D = 16 (lanes 16..31 then
  // hold no column of their own and write nothing)
  constexpr int VPT = (D + 31) / 32;
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  // 16-byte loads per thread per K/V tile (the last pass partial for a
  // tile smaller than one load per thread: bf16 at D = 16)
  constexpr int NT = (kBk * D / VEC + kThreads - 1) / kThreads;
  static_assert(D % VEC == 0 && (D >= 32 || 32 % D == 0),
                "D must be a whole number of 16-byte loads");
  extern __shared__ float smem_f[];
  float* q_s = smem_f;                 // [kBq][D]
  float* k_s = q_s + kBq * D;           // [kBk][D + 1]
  float* v_s = k_s + kBk * (D + 1);     // [kBk][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hk + h / (H / Hk);
  const int q0 = blockIdx.y * kBq;
  const int q_off = Lk - Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;

#pragma unroll
  for (int e = threadIdx.x * VEC; e < kBq * D; e += kThreads * VEC) {
    const int i = q0 + e / D;
    store_vec<T>(q_s + e, i < Lq ? load16(qp + (size_t)i * D + e % D) : zero16());
  }

  // keys any query of this block can reach
  const int q_lo = q0 + q_off;
  const int q_hi = min(q0 + kBq, Lq) - 1 + q_off;
  const int k_end = causal ? min(Lk, q_hi + 1) : Lk;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;

  float m_run[kRpw], l_run[kRpw], acc[kRpw][VPT];
#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (k_beg / kBk) * kBk; kt < k_end; kt += kBk) {
    uint4 kr[NT], vr[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int e = (threadIdx.x + t * kThreads) * VEC;
      const int kpos = kt + e / D;
      const size_t off = (size_t)kpos * D + e % D;
      const bool in = e < kBk * D && kpos < Lk;
      kr[t] = in ? load16(kp + off) : zero16();
      vr[t] = in ? load16(vp + off) : zero16();
    }
    __syncthreads();                  // q_s written / previous tile consumed
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int e = (threadIdx.x + t * kThreads) * VEC;
      if (e >= kBk * D) break;
      store_vec<T>(k_s + (e / D) * (D + 1) + e % D, kr[t]);
      store_vec<T>(v_s + e, vr[t]);
    }
    __syncthreads();
    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRpw; ++r) {
      const int qi = q0 + warp * kRpw + r;
      const int qpos = qi + q_off;
      const float* qr = q_s + (warp * kRpw + r) * D;
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
      for (int kk = 0; kk < kBk; ++kk) {
        const float pk = __shfl_sync(kFull, p, kk);
#pragma unroll
        for (int j = 0; j < VPT; ++j)
          acc[r][j] += pk * v_s[kk * D + (lane + 32 * j) % D];
      }
      m_run[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRpw; ++r) {
    const int qi = q0 + warp * kRpw + r;
    if (qi >= Lq) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (lane + 32 * j < D)
        out[((size_t)bh * Lq + qi) * D + lane + 32 * j] =
            from_f<T>(acc[r][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int Hk, int Lq, int Lk, int causal,
                       int window, float softcap, float scale,
                       cudaStream_t s) {
  auto kernel = flash_attention_fma<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, (Lq + kBq - 1) / kBq), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hk, Lq, Lk, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// Both entry points: q (B, H, Lq, D), k/v (B, Hk, Lk, D), out (B, H, Lq,
// D), all contiguous and 16-byte aligned; H % Hk == 0.  window <= 0 means
// none, softcap <= 0 means none.  Anything else returns
// cudaErrorInvalidValue without a launch; otherwise cudaGetLastError().

// bf16, D in {64, 128, 160}; bq (query rows per block) in {16, 32, 64}, bk
// (keys per tile) in {32, 64}.
extern "C" int flash_attention_mma_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Hk, int Lq, int Lk, int D,
                                          int causal, int window,
                                          float softcap, float scale, int bq,
                                          int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (Hk <= 0 || H % Hk) return static_cast<int>(err);
#define FLASH_MMA(DD, W, KB)                                                 \
  if (D == DD && bq == 16 * W && bk == KB)                                   \
    err = launch_mma<DD, W, KB>(q, k, v, out, B, H, Hk, Lq, Lk, causal,      \
                                window, softcap, scale, s);
  FLASH_MMA(64, 1, 32) FLASH_MMA(64, 2, 32) FLASH_MMA(64, 4, 32)
  FLASH_MMA(64, 1, 64) FLASH_MMA(64, 2, 64) FLASH_MMA(64, 4, 64)
  FLASH_MMA(128, 1, 32) FLASH_MMA(128, 2, 32) FLASH_MMA(128, 4, 32)
  FLASH_MMA(128, 1, 64) FLASH_MMA(128, 2, 64) FLASH_MMA(128, 4, 64)
  FLASH_MMA(160, 1, 32) FLASH_MMA(160, 2, 32) FLASH_MMA(160, 4, 32)
  FLASH_MMA(160, 1, 64) FLASH_MMA(160, 2, 64) FLASH_MMA(160, 4, 64)
#undef FLASH_MMA
  return static_cast<int>(err);
}

// float32 at D in {16, 32, 64, 128, 160, 256}; bfloat16 only at D in
// {16, 32, 256} (64, 128 and 160 take the tensor cores).
extern "C" int flash_attention_fma_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int Hk, int Lq, int Lk, int D,
                                          int causal, int window,
                                          float softcap, float scale,
                                          int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (Hk <= 0 || H % Hk) return static_cast<int>(err);
#define FLASH_FMA(T, DD)                                                     \
  if (D == DD)                                                               \
    err = launch_fma<T, DD>(q, k, v, out, B, H, Hk, Lq, Lk, causal, window,  \
                            softcap, scale, s);
  if (dtype == kFloat32) {
    FLASH_FMA(float, 16) FLASH_FMA(float, 32) FLASH_FMA(float, 64)
    FLASH_FMA(float, 128) FLASH_FMA(float, 160) FLASH_FMA(float, 256)
  } else if (dtype == kBFloat16) {
    FLASH_FMA(bf16, 16) FLASH_FMA(bf16, 32) FLASH_FMA(bf16, 256)
  }
#undef FLASH_FMA
  return static_cast<int>(err);
}
