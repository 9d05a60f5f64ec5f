// The tensor-core route shared by nm_spmm.cu, lookahead_decode.cu and the
// strip kernels (strip_spmm.cuh: bsr_matmul.cu, csa_matmul.cu):
// asynchronous copies into a ring of shared-memory stages, bf16 mma.sync
// with fp32 accumulators, and a K-split whose partial tiles are summed
// inside a thread-block cluster.
//
// Every kernel computes out^T = W^T x^T ("swap AB"): the weight's output
// columns are the MMA's m (16 rows of a tile), the rows of x its n (8 per
// tile), so a decode batch of <= 8 rows fills n exactly.  A block owns a
// (BN columns) x (BM rows) output tile and one of `split` slices of K
// (equal runs of stages, or every split-th stage of a strip); the `split`
// blocks of one tile form a cluster and sum their fp32 partial tiles
// through distributed shared memory, each block one 1/split share of the
// tile, in a fixed order (cluster_reduce_store).
// Nothing touches the output but that one store.  The attention kernels
// (flash_attention.cu, paged_attention.cu) take the copy, ldmatrix, MMA
// and cluster-launch helpers.  Internal linkage, as in common.cuh.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int STAGES = 8;      // most ring slots of a block
// Shared memory a block may take so that two fit on an SM (228 KB, 1 KB
// of it reserved per block).
constexpr size_t SMEM_BUDGET = 113 * 1024;

// Output tile of a block: BN weight columns x BM rows of x.  A warp owns
// 32 columns (two m16 MMA tiles) by WM <= 32 rows (WM / 8 n8 MMA tiles).
template <int BN_, int BM_>
struct Tile {
  static constexpr int BN = BN_, BM = BM_;
  static constexpr int WN = 32;
  static constexpr int WM = BM < 32 ? BM : 32;
  static constexpr int WARPS_N = BN / WN, WARPS_M = BM / WM;
  static constexpr int THREADS = 32 * WARPS_N * WARPS_M;
  static constexpr int MT = WN / 16, NT = WM / 8;
  static constexpr int RED_LD = BN + 4;     // fp32 row stride, partial tile
  static constexpr size_t RED_BYTES = sizeof(float) * BM * RED_LD;
  static constexpr size_t RECV_BYTES = sizeof(float) * BM * BN;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !valid zero-fills the 16
// bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n (0 <= n <= 7) committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>();
  }
}

// Shared memory of a block of tile TL with `steps` stages of `stage`
// bytes: a ring of `alloc` slots (the partial tile overlays it once the
// loop is done), then the receive buffer at `recv`, then `extra` bytes of
// the kernel's own at `extra_at` (a multiple of 16 when `stage` is); at
// most SMEM_BUDGET where two slots fit in it.  `slots` is the ring
// modulus: steps + 1 when every stage fits, so that all loads go out at
// once.
template <class TL>
struct Layout {
  int alloc, slots;
  size_t recv, extra_at, bytes;
  __host__ Layout(int steps, size_t stage, size_t extra = 0) {
    const size_t room = SMEM_BUDGET - TL::RECV_BYTES - extra;
    const int fit = std::min(STAGES, (int)(room / stage));
    alloc = std::min(steps, std::max(2, fit));
    slots = alloc == steps ? steps + 1 : alloc;
    recv = std::max(alloc * stage, TL::RED_BYTES);
    extra_at = recv + TL::RECV_BYTES;
    bytes = extra_at + extra;
  }
};

// Four 8x8 bf16 matrices, transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Four (two) 8x8 bf16 matrices as stored: lane l gets row l/4, columns
// 2(l%4), 2(l%4)+1 of each, the B fragment of a row-major x^T tile.
// Lanes 0..31 (0..15) give the row addresses, eight per matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Every thread of a block that calls cluster_reduce_store arrives here
// first thing: the arrival tells cluster_reduce_store that all blocks of
// the cluster have started before it writes into their shared memory.
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Sum the cluster's partial tiles and store rows m0.. < M, columns
// n0..n0+BN of out (row stride N), times scale[col] where scale is given.
// `red` holds this block's partial tile (BM x RED_LD fp32; it may overlap
// the ring, which is free by now); `recv` (RECV_BYTES) must not overlap
// the ring, since faster blocks of the cluster write into it while this
// one may still be in its main loop.  Block r owns 1/split of the tile:
// every block pushes each share to its owner's recv (16-byte stores to
// distributed shared memory, slot = the pusher's rank), one cluster
// barrier makes them visible, and each owner sums its slots in rank order
// (fixed order: the same result on every run) and stores.  Every thread
// of every block of the cluster calls it, after cluster_arrive_started.
template <class TL>
__device__ __forceinline__ void cluster_reduce_store(
    const float* red, float* recv, bf16* __restrict__ out,
    const float* __restrict__ scale, int M, int N, int m0, int n0) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks();
  const int rank = cluster.block_rank();
  constexpr int Q = TL::BN / 4;                // float4s per tile row
  constexpr int U = TL::BM * Q;                // float4s per tile
  const int share = U / split;                 // split divides U
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // started
  __syncthreads();                             // red is complete
  for (int u = threadIdx.x; u < U; u += TL::THREADS) {
    const int owner = u / share;
    const float4 v = *reinterpret_cast<const float4*>(
        red + u / Q * TL::RED_LD + u % Q * 4);
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(
        recv, owner)) + rank * share + (u - owner * share);
    *dst = v;
  }
  cluster.sync();                              // every share has arrived
  const float4* mine = reinterpret_cast<const float4*>(recv);
  for (int o = threadIdx.x; o < share; o += TL::THREADS) {
    const int u = rank * share + o, i = u / Q, c = u % Q * 4;
    if (m0 + i >= M) continue;
    float4 s = mine[o];
    for (int r = 1; r < split; ++r) {
      const float4 v = mine[r * share + o];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (scale != nullptr) {
      const float4 k = *reinterpret_cast<const float4*>(scale + n0 + c);
      s.x *= k.x; s.y *= k.y; s.z *= k.z; s.w *= k.w;
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + i) * N + n0 + c) = packed;
  }
}

// Launch `kernel` on a grid whose runs of `split` blocks along x (the
// K-slices of one output tile) form clusters, with `smem` bytes of
// dynamic shared memory.  `opted` is the caller's per-kernel record of the
// largest size opted into so far (above 48 KB each kernel must opt in).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), size_t& opted, dim3 grid,
                           int threads, size_t smem, int split,
                           cudaStream_t stream, Args... args) {
  if (smem > opted) {
    if (cudaError_t err = allow_smem(kernel, smem)) return err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...)) return err;
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace repro
