// Shared helpers for the port's kernels: dtype conversion and warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// dtype codes the Python wrappers pass (kernels/build.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// reductions over the `width` lanes of a warp segment (width: power of 2)
template <int width = 32>
__device__ __forceinline__ float seg_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int width = 32>
__device__ __forceinline__ float seg_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float softcap_logit(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

}  // namespace repro
