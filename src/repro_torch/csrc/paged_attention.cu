// paged_attention: decode attention of q (B, Q, H, D) -- Q = 1 for one
// token per sequence, Q > 1 for a verify block -- over the page pools k/v
// (P, ps, Hk, D) through the page table ptab (B, >= n_pages) and the
// per-sequence lengths lens (B,).  Query qi of sequence b sits at position
// lens[b] - Q + qi and sees keys kpos < lens[b] - (Q - 1 - qi); lens is
// clamped to the view (n_pages * ps rows), as the gathered view of the
// plain version is; a row with no key gives zeros, not NaN.  Optional,
// as in flash_attention.cu: a tanh softcap of the scaled logits
// (softcap <= 0: none) and a sliding window (window <= 0: none), under
// which query qpos sees only keys kpos > qpos - window.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py::paged_attention (pallas_call at
// paged_attention.py:166, body _make_kernel at :62).
//
// What bounds it on an H100: each cached K/V row is read once and used
// for 2*G*Q*D flops per matrix (G = H/Hk query heads share it), far below
// the card's ~295 flops per byte, so the bound is the bytes of the live
// rows (a few MB per layer at decode).  At decode's batch that stream is
// short, and what sets the time is latency: how many dependent loads a
// block waits on and how many blocks walk the longest sequence.
//
// Two routes, chosen by the wrapper's plan (kernels/tiling.py::paged_plan):
//
// bf16 q and pools, D in {64, 128, 160} -> tensor cores (paged_attention_mma),
// flash-decoding.  The `split` blocks of one (sequence, kv head) form a
// thread-block cluster, and each block's WARPS warps walk on their own:
// part v = rank * WARPS + warp of the V = split * WARPS parts takes the
// 16-row chunks v, v + V, ... below ceil(min(lens[b], view) / 16), with
// lens read on the card (a chunk is one page at ps = 16), so the parts
// stay balanced to one chunk, the host never reads lens, and the split
// comes from the view and B * Hk alone (a call can be captured in a CUDA
// graph).  A warp stages its chunks' K and V rows (256 contiguous bytes
// per row at D = 128, rows Hk * D apart) with cp.async into a private ring
// of 2 to 4 chunks (as many as a warp may walk, at most 4): all of its
// slots are filled at once, so a warp that walks up to 4 chunks waits on
// one memory latency, and a slot is refilled as soon as its chunk is
// consumed; only __syncwarp orders the ring.  The block first copies its
// page-table row into shared memory (the TPU's scalar-prefetched index
// map), so a row's address costs a shared-memory read.
//   Layout on the MMA: the query rows of one kv head are the m side, row
// r = qi * G + gi (the G heads of the group, times Q for a verify block),
// 16 rows per m16 tile, the last one zero-padded; Q * G > 16 rows take
// ceil(Q * G / 16) row tiles, a grid axis: each tile's cluster walks the
// keys its rows reach with its own online softmax, so a row tile costs a
// second read of the live rows (from L2 for the short views of a verify
// block).  Keys are n (two n8 tiles per chunk)
// for S = Q K^T and k for P V, so a chunk is exactly one k16 step of P V
// and P's A fragment is S's C fragments, as in flash_attention.cu.  At
// Q * G = 2 most of the m16 tile is padding; that costs nothing here,
// since the kernel waits on loads, not on the tensor cores.  The swapped
// layout (keys as m, queries as n, as tensor_core.cuh's projections do)
// would fill more of each MMA but puts P in the B operand of P V, which
// needs a transpose through shared memory per chunk; not taken.
//   Merge (the softmax-aware sibling of tensor_core.cuh's
// cluster_reduce_store): each warp publishes its running max, denominator
// and accumulator rows in its block's shared memory; the block merges its
// warps' states (common max, rescaled sums, warps in order) and pushes,
// for each unit of four output columns, its accumulator to the unit's
// owner rank and each row's max and denominator to every rank, through
// distributed shared memory (stores only: nothing waits on a remote
// load).  After one cluster barrier each owner takes the rows' common
// max and sums the ranks' rescaled accumulators in rank order, so two
// calls are bitwise equal, and stores.  A part with no chunk publishes
// max -1e30 and denominator 0 and still joins both cluster barriers (the
// "started" one at entry and the one after the pushes).
//   A window moves the walk's start: the chunks wholly before the window
// of the tile's first (lowest) query are never loaded, and the parts
// take the chunks from the first one it reaches, round-robin as before
// (the split is still planned from the view, so under a short window
// some parts walk nothing).  Each row masks keys outside its own reach
// from below as from above, and the softcap is applied to the scaled
// logits before the mask (flash_attention.cu does the same).  D = 160
// (stablelm) needs no power of two: 10 k16 steps, 20 n8 tiles paired by
// the x4 loads, 20 sixteen-byte pieces per staged row, 40 float4 units
// per output row in the merge, and a warp's published state (10,368 B)
// still fits in a ring of two chunks (21,504 B).
//
// fp32 q (over fp32 or bf16 pools), and bf16 at D = 16, 32 or 256 ->
// CUDA-core FMAs (paged_attention_fma), kept for fp32 parity: one block
// per (sequence, kv head, tile of 8 query rows) folds its rows -- row
// r = qi * G + gi as above, so Q = 1 folds the G query heads of the
// group -- onto each K/V row, each row masked at its own causal reach;
// its 8 warps split the sequence's rows, UNROLL rows' loads in flight
// per warp, and merge their softmax states in shared memory at the end.
// Under a window the walk starts at the first key the block's lowest
// query reaches.  A lane holds D / 32 columns of a row; at D = 16 the
// lanes below 16 hold one each and the others hold zeros.
#include "tensor_core.cuh"

namespace {

using repro::tc::bf16;

// ---- bf16: tensor cores -----------------------------------------------------

constexpr int kChunk = 16;     // keys per chunk: one k16 step of P V
constexpr int kRows = 16;      // query rows of the m16 tile

template <int D>
struct PagedMma {
  static constexpr int LD = D + 8;                  // bf16 row stride
  static constexpr int CH = kChunk * LD;            // one K (or V) chunk
  // a warp's published state, overlaying its ring: acc [16][D], max, sum
  static constexpr int ST = kRows * D + 2 * kRows;  // floats
  static_assert(ST * sizeof(float) <= 2 * 2 * CH * sizeof(bf16),
                "the state fits in a ring of two chunks");
  // the receive buffer of the cluster merge, in floats: every rank's
  // share of the block's R x D outputs (float4 units), then every rank's
  // max and sum of each row
  __host__ __device__ static int share(int R, int split) {
    return (R * D / 4 + split - 1) / split;
  }
  __host__ __device__ static int recv_floats(int R, int split) {
    return 4 * split * share(R, split) + 2 * split * kRows;
  }
  // q rows, a ring of `ring` chunks per warp, the receive buffer, the
  // page-table row
  static size_t smem_bytes(int warps, int ring, int R, int split,
                           int n_pages) {
    return sizeof(bf16) * ((size_t)kRows * LD + (size_t)warps * ring * 2 * CH)
           + sizeof(float) * recv_floats(R, split) + sizeof(int) * n_pages;
  }
};

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp, const int* __restrict__ ptab,
                    const int* __restrict__ lens, bf16* __restrict__ out,
                    int Q, int H, int Hk, int ps, int n_pages,
                    int ptab_stride, float scale, int window, float softcap,
                    int ring) {
  using namespace repro;
  using namespace repro::tc;
  using PM = PagedMma<D>;
  constexpr int LD = PM::LD, DQ = D / 8, THREADS = WARPS * 32;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int G = H / Hk;
  // the grid is tiles x (sequence, kv head) x split: a cluster never
  // straddles two row tiles
  const int per_tile = gridDim.x / ((Q * G + kRows - 1) / kRows);
  const int r0 = blockIdx.x / per_tile * kRows;   // this tile's first row
  const int grp = blockIdx.x % per_tile / split;  // (sequence, kv head)
  const int b = grp / Hk, hk = grp % Hk;
  const int R = min(kRows, Q * G - r0);           // rows of this tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);      // [16][LD]
  const int RING = ring * 2 * PM::CH;             // a warp's ring, bf16
  bf16* rings = q_s + kRows * LD;                 // [WARPS][RING]
  float* recv = reinterpret_cast<float*>(rings + WARPS * RING);
  int* pt = reinterpret_cast<int*>(recv + PM::recv_floats(R, split));
  cluster_arrive_started();                 // before any rank writes here

  // the query rows, the page-table row and lens: three independent loads
  for (int c = threadIdx.x; c < kRows * DQ; c += THREADS) {
    const int r = c / DQ, col = c % DQ * 8, gr = r0 + (r < R ? r : 0);
    const bool in = r < R;
    const bf16* src = q + (((size_t)b * Q + gr / G) * H + hk * G + gr % G) *
                              D + col;
    cp_async16(q_s + r * LD + col, src, in);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < n_pages; i += THREADS)
    pt[i] = ptab[(size_t)b * ptab_stride + i];
  const int lb = lens[b];
  const int view = n_pages * ps;
  // the keys the tile's last row reaches: the furthest of its rows
  const int len = max(0, min(lb - (Q - 1 - (r0 + R - 1) / G), view));
  // under a window, the first chunk the tile's first row reaches: the
  // walk starts there, and nch counts the chunks from it
  const int c0 = window > 0
      ? min(max(0, lb - Q + r0 / G - window + 1), len) / kChunk : 0;
  const int nch = (len + kChunk - 1) / kChunk - c0;
  __syncthreads();                          // the page-table row is staged

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;   // C fragment row, column pair
  const int lq = lane / 8, lr = lane % 8;   // ldmatrix: matrix, its row
  const int V = split * WARPS, part = rank * WARPS + warp;
  const int mine = nch > part ? (nch - part + V - 1) / V : 0;
  bf16* my_ring = rings + warp * RING;
  // keys [first, limit) of rows gq and gq + 8: the verify block's
  // causal reach, and under a window its start
  int limit[2], first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gq + 8 * h;
    limit[h] = r < R ? min(lb - (Q - 1 - (r0 + r) / G), view) : 0;
    first[h] = window > 0 ? lb - Q + (r0 + r) / G - window + 1 : 0;
  }

  auto load = [&](int slot, int j) {        // the warp's j-th chunk
    const int row0 = (c0 + part + j * V) * kChunk;
    bf16* ks = my_ring + slot * 2 * PM::CH;
    bf16* vs = ks + PM::CH;
#pragma unroll
    for (int e = lane; e < kChunk * DQ; e += 32) {
      const int r = e / DQ, col = e % DQ * 8, row = row0 + r;
      const bool in = row < len;
      const size_t off =
          in ? (((size_t)pt[row / ps] * ps + row % ps) * Hk + hk) * D + col
             : 0;
      cp_async16(ks + r * LD + col, kp + off, in);
      cp_async16(vs + r * LD + col, vp + off, in);
    }
  };
  // every slot of the ring gets a chunk at once (one group each); a slot
  // is refilled once its chunk is consumed
  int issued = min(mine, ring);
  for (int s = 0; s < issued; ++s) {
    load(s, s);
    cp_async_commit();
  }

  cp_async_wait_dyn(issued);                // the query rows have landed
  __syncthreads();
  unsigned qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], q_s + ((lq % 2) * 8 + lr) * LD + kk * 16 +
                            (lq / 2) * 8);
  float o[D / 8][4] = {};
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < mine; ++j) {
    cp_async_wait_dyn(issued - j - 1);      // chunk j has landed
    __syncwarp();
    const bf16* ks = my_ring + (j % ring) * 2 * PM::CH;
    const bf16* vs = ks + PM::CH;
    const int key0 = (c0 + part + j * V) * kChunk;

    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned bk[4];
      ldmatrix_x4(bk, ks + ((lq / 2) * 8 + lr) * LD + kk * 16 + (lq % 2) * 8);
      mma_bf16(s[0], qa[kk], bk[0], bk[1]);
      mma_bf16(s[1], qa[kk], bk[2], bk[3]);
    }
    // s[nt][e] is row gq + 8 (e >> 1), key key0 + 8 nt + 2 t4 + (e & 1)
    float mx[2] = {m_run[0], m_run[1]};
    unsigned valid = 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
        const bool ok = key < limit[e >> 1] && key >= first[e >> 1];
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        valid |= (unsigned)ok << (nt * 4 + e);
        s[nt][e] = ok ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = __expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
    unsigned a[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * h + c;
          p[c] = (valid >> (nt * 4 + e)) & 1u ? __expf(s[nt][e] - mx[h]) : 0.f;
          l_run[h] += p[c];
        }
        __nv_bfloat162 pk = __floats2bfloat162_rn(p[0], p[1]);
        a[2 * nt + h] = *reinterpret_cast<unsigned*>(&pk);
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, vs + ((lq % 2) * 8 + lr) * LD + dn * 8 +
                                (lq / 2) * 8);
      mma_bf16(o[dn], a, bv[0], bv[1]);
      mma_bf16(o[dn + 1], a, bv[2], bv[3]);
    }
    if (issued < mine) {                    // refill the consumed slot
      __syncwarp();
      load(issued % ring, issued);
      ++issued;
      cp_async_commit();
    }
  }
  __syncwarp();                             // the ring is free: publish

  float* st = reinterpret_cast<float*>(my_ring);   // acc [16][D], max, sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFull, l_run[h], 2);
    const int r = gq + 8 * h;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<float2*>(st + r * D + dn * 8 + 2 * t4) =
          make_float2(o[dn][2 * h], o[dn][2 * h + 1]);
    if (t4 == 0) {
      st[kRows * D + r] = m_run[h];
      st[kRows * D + kRows + r] = l_run[h];
    }
  }
  __syncthreads();                          // every warp is published

  // Merge: unit u (row r, four columns c..c+3) of the R x D outputs is
  // owned by rank u / share.  Each block merges its warps' states of each
  // unit (local shared memory, warps in order) and pushes the block's
  // accumulator to the owner's receive buffer, slot [its rank], and each
  // row's max and sum to every rank; after one cluster barrier each owner
  // takes a row's common max and sums the ranks' rescaled accumulators in
  // rank order.  Only stores cross the cluster, and no block reads another
  // block's shared memory, so a block may leave once it has stored.
  const int units = R * (D / 4);
  const int share = PM::share(R, split);
  float4* recv_acc = reinterpret_cast<float4*>(recv);      // [split][share]
  float* recv_ml = recv + 4 * split * share;               // [2][split][16]
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // started
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int r = u / (D / 4), c = u % (D / 4) * 4;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mx = fmaxf(mx, reinterpret_cast<const float*>(
                         rings + w * RING)[kRows * D + r]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* ws = reinterpret_cast<const float*>(rings + w * RING);
      const float f = __expf(ws[kRows * D + r] - mx);
      const float4 x = *reinterpret_cast<const float4*>(ws + r * D + c);
      l += ws[kRows * D + kRows + r] * f;
      acc.x += x.x * f; acc.y += x.y * f; acc.z += x.z * f; acc.w += x.w * f;
    }
    const int owner = u / share;
    *(cluster.map_shared_rank(recv_acc, owner) + rank * share +
      (u - owner * share)) = acc;
    if (c == 0)
      for (int dst = 0; dst < split; ++dst) {
        float* ml = cluster.map_shared_rank(recv_ml, dst);
        ml[rank * kRows + r] = mx;
        ml[(split + rank) * kRows + r] = l;
      }
  }
  cluster.sync();                           // every push has landed

  for (int i = threadIdx.x; i < share; i += THREADS) {
    const int u = rank * share + i;
    if (u >= units) break;
    const int r = u / (D / 4), c = u % (D / 4) * 4, gr = r0 + r;
    float mx = kNegInf;
    for (int k = 0; k < split; ++k) mx = fmaxf(mx, recv_ml[k * kRows + r]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < split; ++k) {
      const float f = __expf(recv_ml[k * kRows + r] - mx);
      const float4 x = recv_acc[k * share + i];
      l += recv_ml[(split + k) * kRows + r] * f;
      acc.x += x.x * f; acc.y += x.y * f; acc.z += x.z * f; acc.w += x.w * f;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(
        out + (((size_t)b * Q + gr / G) * H + hk * G + gr % G) * D + c) = packed;
  }
}

template <int D, int WARPS>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp,
                       const int* ptab, const int* lens, void* out, int B,
                       int Q, int H, int Hk, int ps, int n_pages,
                       int ptab_stride, float scale, int window,
                       float softcap, int split, int ring, cudaStream_t s) {
  static size_t opted = 0;
  const int rows = Q * (H / Hk), tiles = (rows + kRows - 1) / kRows;
  return repro::tc::launch_cluster(
      paged_attention_mma<D, WARPS>, opted, dim3(tiles * B * Hk * split),
      WARPS * 32,
      PagedMma<D>::smem_bytes(WARPS, ring, std::min(rows, kRows), split,
                               n_pages),
      split, s,
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), ptab, lens, static_cast<bf16*>(out), Q, H,
      Hk, ps, n_pages, ptab_stride, scale, window, softcap, ring);
}

// ---- fp32: CUDA-core FMAs ---------------------------------------------------

constexpr int kFmaWarps = 8;
constexpr int kGMax = 8;      // query rows per block

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kFmaWarps * 32)
paged_attention_fma(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp, const int* __restrict__ ptab,
                       const int* __restrict__ lens, TQ* __restrict__ out, int Q,
                       int H, int Hk, int ps, int n_pages, int ptab_stride,
                       float scale, int window, float softcap) {
  using namespace repro;
  constexpr int VPT = (D + 31) / 32;         // columns a lane holds
  static_assert(D >= 32 ? D % 32 == 0 : 32 % D == 0, "D must tile a warp");
  constexpr int UNROLL = D <= 128 ? 8 : 4;   // rows a warp loads before use
  // lane + 32 j is a column of the row where it is below D (always but at
  // D = 16, where the lanes above hold zeros)
  auto has = [&](int j) { return D >= 32 || threadIdx.x % 32 + 32 * j < D; };
  extern __shared__ float smem_f[];  // [kFmaWarps][NR][D + 2], then the page row
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = H / Hk;
  const int r0 = blockIdx.z * kGMax;           // this tile's first query row
  const int NR = min(kGMax, Q * G - r0);       // its rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lb = lens[b], view = n_pages * ps;
  // row r's key limit: query qi = r / G sits at lens - Q + qi and sees
  // the keys before lens - (Q - 1 - qi), within the view (recomputed
  // where used: registers are scarce at D = 256)
  auto limit = [&](int g) {
    return min(lb - (Q - 1 - (r0 + g) / G), view);
  };
  // the first key row g sees under a window (0 without one)
  auto first = [&](int g) {
    return window > 0 ? lb - Q + (r0 + g) / G - window + 1 : 0;
  };
  // the keys the tile's last row reaches: the furthest of its rows; the
  // walk starts at the first key its first row sees
  const int len = max(0, limit(NR - 1));
  const int beg = max(0, first(0));
  int* pt = reinterpret_cast<int*>(smem_f + (size_t)kFmaWarps * NR * (D + 2));
  for (int i = threadIdx.x; i < (len + ps - 1) / ps; i += kFmaWarps * 32)
    pt[i] = ptab[(size_t)b * ptab_stride + i];
  __syncthreads();

  float qv[kGMax][VPT], acc[kGMax][VPT], m_run[kGMax], l_run[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
    const int gr = r0 + g;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      acc[g][j] = 0.f;
      qv[g][j] = g < NR && has(j)
                     ? to_f(q[(((size_t)b * Q + gr / G) * H + hk * G +
                               gr % G) * D + lane + 32 * j])
                     : 0.f;
    }
  }

  for (int row0 = beg + warp; row0 < len; row0 += kFmaWarps * UNROLL) {
    float kv[UNROLL][VPT], vv[UNROLL][VPT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = row0 + u * kFmaWarps;
      const size_t base =
          row < len ? (((size_t)pt[row / ps] * ps + row % ps) * Hk + hk) * D : 0;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const bool in = row < len && has(j);
        kv[u][j] = in ? to_f(kp[base + lane + 32 * j]) : 0.f;
        vv[u][j] = in ? to_f(vp[base + lane + 32 * j]) : 0.f;
      }
    }
    // one online-softmax update per UNROLL rows: the rows' dot products
    // and warp reductions are independent, so their latencies overlap
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= NR) break;
      const int lim = limit(g), fst = first(g);
      float s[UNROLL];
      unsigned valid = 0;
      float mx = m_run[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < VPT; ++j) d += qv[g][j] * kv[u][j];
        d = warp_sum(d) * scale;
        if (softcap > 0.f) d = tanhf(d / softcap) * softcap;
        const int row = row0 + u * kFmaWarps;
        const bool ok = row < lim && row >= fst;
        valid |= (unsigned)ok << u;
        s[u] = ok ? d : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m_run[g] - mx);
      float l = l_run[g] * alpha;
#pragma unroll
      for (int j = 0; j < VPT; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = (valid >> u) & 1u ? expf(s[u] - mx) : 0.f;
        l += p;
#pragma unroll
        for (int j = 0; j < VPT; ++j) acc[g][j] += p * vv[u][j];
      }
      l_run[g] = l;
      m_run[g] = mx;
    }
  }

  float* mine = smem_f + (size_t)warp * NR * (D + 2);
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g >= NR) break;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (has(j)) mine[g * (D + 2) + lane + 32 * j] = acc[g][j];
    if (lane == 0) {
      mine[g * (D + 2) + D] = m_run[g];
      mine[g * (D + 2) + D + 1] = l_run[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NR * D; e += kFmaWarps * 32) {
    const int g = e / D, d = e % D, gr = r0 + g;
    float mx = kNegInf;
    for (int w = 0; w < kFmaWarps; ++w)
      mx = fmaxf(mx, smem_f[((size_t)w * NR + g) * (D + 2) + D]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kFmaWarps; ++w) {
      const float* st = smem_f + ((size_t)w * NR + g) * (D + 2);
      const float f = expf(st[D] - mx);
      l += st[D + 1] * f;
      a += st[d] * f;
    }
    out[(((size_t)b * Q + gr / G) * H + hk * G + gr % G) * D + d] =
        from_f<TQ>(l > 0.f ? a / l : 0.f);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_fma(const void* q, const void* kp, const void* vp,
                       const int* ptab, const int* lens, void* out, int B,
                       int Q, int H, int Hk, int ps, int n_pages,
                       int ptab_stride, float scale, int window,
                       float softcap, cudaStream_t s) {
  auto kernel = paged_attention_fma<TQ, TKV, D>;
  const int rows = Q * (H / Hk), tiles = (rows + kGMax - 1) / kGMax;
  const size_t smem = sizeof(float) * kFmaWarps * std::min(rows, kGMax) *
                          (D + 2) + sizeof(int) * n_pages;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hk, tiles), kFmaWarps * 32, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ptab, lens, static_cast<TQ*>(out), Q, H, Hk,
      ps, n_pages, ptab_stride, scale, window, softcap);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const int* ptab, const int* lens, void* out, int B, int Q,
                     int H, int Hk, int ps, int n_pages, int ptab_stride,
                     float scale, int window, float softcap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_fma<TQ, TKV, 16>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    case 32: return launch_fma<TQ, TKV, 32>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    case 64: return launch_fma<TQ, TKV, 64>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    case 128: return launch_fma<TQ, TKV, 128>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    case 160: return launch_fma<TQ, TKV, 160>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    case 256: return launch_fma<TQ, TKV, 256>(q, kp, vp, ptab, lens, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points: pools (P, ps, Hk, D) in kv_dtype; ptab rows
// ptab_stride apart, n_pages of each row in view; lens (B,) int32; q and
// out contiguous and 16-byte aligned, H % Hk == 0; window <= 0 means no
// window, softcap <= 0 no softcap.  Anything else returns
// cudaErrorInvalidValue without a launch; otherwise cudaGetLastError().

// bf16 q (B, Q, H, D) and pools, D in {64, 128, 160}, one row tile of 16 query
// rows per 16 of the Q * H / Hk; warps in {1, 2, 4} per block, split in
// {1, 2, 4, 8} blocks per cluster, a ring of 2 to 4 chunks per warp.
extern "C" int paged_attention_mma_launch(const void* q, const void* kp,
                                          const void* vp, const void* ptab,
                                          const void* lens, void* out, int B,
                                          int Q, int H, int Hk, int D, int ps,
                                          int n_pages, int ptab_stride,
                                          float scale, int window,
                                          float softcap, int warps, int split,
                                          int ring, void* stream) {
  const int* pt = static_cast<const int*>(ptab);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (Hk <= 0 || H % Hk || Q < 1 || ps < 1 || n_pages < 1 || ring < 2 ||
      ring > 4 ||
      (split != 1 && split != 2 && split != 4 && split != 8))
    return static_cast<int>(err);
#define PAGED_MMA(DD, W)                                                     \
  if (D == DD && warps == W)                                                 \
    err = launch_mma<DD, W>(q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, \
                            ptab_stride, scale, window, softcap, split,    \
                            ring, s);
  PAGED_MMA(64, 1) PAGED_MMA(64, 2) PAGED_MMA(64, 4)
  PAGED_MMA(128, 1) PAGED_MMA(128, 2) PAGED_MMA(128, 4)
  PAGED_MMA(160, 1) PAGED_MMA(160, 2) PAGED_MMA(160, 4)
#undef PAGED_MMA
  return static_cast<int>(err);
}

// q (B, Q, H, D) and out in q_dtype, one block per 8 of the Q * H / Hk
// query rows, D in {16, 32, 64, 128, 160, 256}: float32 q over float32
// or bf16 pools; bf16 q and pools only at D in {16, 32, 256} (64, 128 and
// 160 take the tensor cores).
extern "C" int paged_attention_fma_launch(const void* q, const void* kp,
                                          const void* vp, const void* ptab,
                                          const void* lens, void* out, int B,
                                          int Q, int H, int Hk, int D, int ps,
                                          int n_pages, int ptab_stride,
                                          float scale, int window,
                                          float softcap, int q_dtype,
                                          int kv_dtype, void* stream) {
  using namespace repro;
  const int* pt = static_cast<const int*>(ptab);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk || Q < 1 || ps < 1 || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == kFloat32 && kv_dtype == kFloat32)
    err = launch_d<float, float>(D, q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
  else if (q_dtype == kFloat32 && kv_dtype == kBFloat16)
    err = launch_d<float, bf16>(D, q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16 && D == 16)
    err = launch_fma<bf16, bf16, 16>(q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16 && D == 32)
    err = launch_fma<bf16, bf16, 32>(q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
  else if (q_dtype == kBFloat16 && kv_dtype == kBFloat16 && D == 256)
    err = launch_fma<bf16, bf16, 256>(q, kp, vp, pt, ln, out, B, Q, H, Hk, ps, n_pages, ptab_stride, scale, window, softcap, s);
  return static_cast<int>(err);
}
