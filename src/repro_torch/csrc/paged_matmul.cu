// Paged weight-streaming matmul: y = x @ vstack(w_pages[page_ids]).
//
// Replaces the TPU kernel src/repro/kernels/hdm_stream/kernel.py::
// paged_matmul (body _stream_kernel). The logical weight [K, N] is
// assembled from a page table: logical page kj of page_k rows lives at
// w_pages[page_ids[kj]], anywhere in the pool. The Pallas kernel rides the
// ids in scalar-prefetch memory so that its BlockSpec index map knows the
// next page's address before the DMA is issued -- the kernel-level
// speculative read (MemSpecRd). Here each CTA loads page_ids[kj] and
// resolves the page's base address at the top of the K iteration, before
// any load of that page's tiles is issued.
//
// Layout: x [M, K] and y [M, N] row-major in one dtype (bf16 or f32),
// w_pages [n_pages, page_k, N] in that dtype, page_ids int32 [K / page_k].
// f32 accumulation, y in x's dtype. Ragged M, N and page_k are masked
// (the Pallas kernel asserts divisibility; the decode batch is M = 8). An
// id outside [0, n_pages) is clamped, like the jnp gather of the oracle,
// so that no read leaves the pool.
//
// What bounds it on an H100: at the decode batch (M = 8) the weight bytes
// -- 2 flops per weight element read, far below the ~295 flop/byte ridge;
// at a prefill chunk (M = 256) the flops. Still simple: one CTA per
// (64-row, 64-column) output tile, 32-deep K slices staged in shared
// memory as f32, each thread a 4 x 4 register tile of scalar FMAs. No
// tensor cores (mma.sync / wgmma), no cp.async or TMA pipelining.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ page_ids, T* __restrict__ y,
                    int M, int K, int N, int page_k, int n_pages) {
  __shared__ float xs[kBK][kBM + 1];  // x tile, k-major
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = K / page_k;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kj = 0; kj < n_k; ++kj) {
    // the pre-shared address: resolve logical page kj before its loads
    const int pid = min(max(page_ids[kj], 0), n_pages - 1);
    const T* wp = w + (size_t)pid * page_k * N;
    const T* xp = x + (size_t)kj * page_k;
    for (int k0 = 0; k0 < page_k; k0 += kBK) {
#pragma unroll
      for (int r = 0; r < kBM * kBK / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / kBK, col = idx % kBK;
        const int m = m0 + row, k = k0 + col;
        xs[col][row] =
            (m < M && k < page_k) ? to_f32(xp[(size_t)m * K + k]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBK * kBN / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / kBN, col = idx % kBN;
        const int k = k0 + row, n = n0 + col;
        ws[row][col] =
            (k < page_k && n < N) ? to_f32(wp[(size_t)k * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) store_f32(acc[i][j], y + (size_t)m * N + n);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* page_ids, void* y,
                   int M, int K, int N, int page_k, int n_pages,
                   cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  paged_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), page_ids,
      static_cast<T*>(y), M, K, N, page_k, n_pages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); y is allocated by the caller.
extern "C" int repro_paged_matmul(const void* x, const void* w,
                                  const int* page_ids, void* y, int M, int K,
                                  int N, int page_k, int n_pages, int dtype,
                                  void* stream) {
  if (M <= 0 || N <= 0 || page_k <= 0 || K % page_k != 0 || n_pages <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(x, w, page_ids, y, M, K, N, page_k,
                                        n_pages, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(x, w, page_ids, y, M, K, N, page_k, n_pages,
                                s);
  return cudaErrorInvalidValue;
}
