// Shared helpers of the port's hand-written Hopper kernels: element
// conversion (every kernel computes in fp32), warp reductions, and the
// dtype codes the Python wrappers pass (0 = float32, 1 = bfloat16).
// Internal linkage (an anonymous namespace): every kernel library that
// includes this header keeps its own copy, even when two libraries built
// from it are loaded into one process.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;   // the JAX kernels' masked-logit value

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// 16-byte moves: load16 reads 8 bf16 or 4 fp32 from global memory in one
// instruction; store_vec widens them to fp32 in shared memory.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 zero16() { return make_uint4(0, 0, 0, 0); }

template <typename T>
__device__ __forceinline__ void store_vec(float* dst, uint4 raw) {
  const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) dst[j] = to_f(p[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Kernels with more than 48 KB of dynamic shared memory must opt in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
}  // namespace repro
