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

constexpr float kLog2e = 1.4426950408889634f;

// ---- asynchronous 16-byte copies global -> shared (sm_80+)

// Copies 16 bytes; with `pred` false it writes 16 zero bytes and reads none.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

// Asks for the 128-byte line holding `gmem` to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `n` of this thread's committed groups are pending
// (n: 0..3, the stage counts the plans choose less two).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// ---- bf16 tensor-core fragments (mma.sync m16n8k16, f32 accumulate)

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c[16x8] += a[16x16] b[16x8]; a row-major bf16, b column-major bf16
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as a bf16x2 high part and the bf16x2 rounding of what is left:
// hi + lo carries x and y to ~2^-17 relative
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// ---- f32 products on tensor cores: error-compensated 3xTF32
// (mma.sync m16n8k8, tf32 in, f32 accumulate). Fragments of a 16x8 A tile
// (row-major) and an 8x8 B tile (column-major), g = lane / 4, t = lane % 4:
//   a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   b0 (k t, n g)  b1 (k t+4, n g)
//   c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// The order of k inside one mma is free, so an accumulator can serve as
// the A operand of the next product as (c0, c2, c1, c3) -- its columns 2t
// and 2t+1 taken as k = t and t+4 -- when B's rows are read as 2t, 2t+1.

// x = hi + lo as two tf32 operands. hi is x rounded to tf32 as
// cvt.rna.tf32.f32 rounds it (nearest, ties away from zero), in two
// integer ops: a conversion runs at a quarter of their rate. lo = x - hi
// (exact) is passed as it is: the tensor core reads a tf32 operand's upper
// 19 bits, so it takes lo truncated to tf32 (an error under 2^-21 |x|).
struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment split once into hi and lo halves
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Tf32Frag split_frag(float a0, float a1, float a2,
                                               float a3) {
  const float a[4] = {a0, a1, a2, a3};
  Tf32Frag f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Tf32Pair p = split_tf32(a[e]);
    f.hi[e] = p.hi;
    f.lo[e] = p.lo;
  }
  return f;
}

// c += a b in 3xTF32: the two small cross terms, then hi . hi (lo . lo,
// ~2^-22 relative, is dropped)
__device__ __forceinline__ void mma_3xtf32(float* c, const Tf32Frag& a,
                                           float b0, float b1) {
  const Tf32Pair p0 = split_tf32(b0), p1 = split_tf32(b1);
  mma_tf32(c, a.lo, p0.hi, p1.hi);
  mma_tf32(c, a.hi, p0.lo, p1.lo);
  mma_tf32(c, a.hi, p0.hi, p1.hi);
}

// ---- launches

// Raises a kernel's dynamic shared memory limit to `smem` where it was set
// lower (`smem_set`: the attribute as last set for that instance).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int& smem_set) {
  if (smem <= smem_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // returned here; not left for a later launch
    return err;
  }
  smem_set = smem;
  return cudaSuccess;
}

// ---- flags between the CTAs of one launch (device scope)

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

}  // namespace repro
