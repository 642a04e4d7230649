// Shared helpers for the hand-written Hopper attention kernels: element
// conversions between the storage type (f32 or bf16) and the f32 the
// kernels accumulate in, warp reductions, and the masked-score constant
// the TPU kernels use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Masked scores are set to NEG_INF; any score at or below NEG_INF / 2
// contributes exactly 0 to the softmax (the guard of the TPU kernels),
// so a row whose keys are all masked ends with l == 0 and writes zeros.
constexpr float NEG_INF = -1e30f;
constexpr int MAX_HEAD_DIM = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Weight of one score in the online softmax, with the masked-score guard.
__device__ __forceinline__ float softmax_weight(float s, float m_new) {
  return s <= NEG_INF * 0.5f ? 0.f : expf(s - m_new);
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro_torch
