// Paged weight-streaming matmul: y = x @ vstack(w_pages[page_ids]).
//
// Replaces the TPU kernel src/repro/kernels/hdm_stream/kernel.py::
// paged_matmul (body _stream_kernel). The logical weight [K, N] is
// assembled from a page table: logical page kj of page_k rows lives at
// w_pages[page_ids[kj]], anywhere in the pool. The Pallas kernel rides the
// ids in scalar-prefetch memory so that its BlockSpec index map knows the
// next page's address before the DMA is issued -- the kernel-level
// speculative read (MemSpecRd), whose page fetch overlaps the MXU work on
// the current page. Here the same compute-shadow overlap comes from the
// cp.async ring: a tile's copy is issued stages - 1 tiles before it is
// used, and each thread reads page_ids[kj + 1] into a register as soon as
// it issues page kj's first copy, so the next page's address is resolved
// while page kj computes and is ready before that page's first copy.
//
// Layout: x [M, K] and y [M, N] row-major in one dtype (bf16 or f32),
// w_pages [n_pages, page_k, N] in that dtype, page_ids int32 [K / page_k].
// f32 accumulation, y in x's dtype. An id outside [0, n_pages) is clamped,
// like the jnp gather of the oracle, so that no read leaves the pool.
//
// What bounds it on an H100 (qwen3-1.7b's MLP width, K 2048, N 6144): at
// the decode batch (M = 8) the 25 MB of weight, 2 flops per element read
// against the card's ~295 flop/byte ridge (0.0075 ms at 3.35 TB/s); at a
// prefill chunk (M = 256) it sits near the ridge (0.0088 ms of bytes,
// 0.0065 ms of bf16 tensor-core operations). Three instances, named by
// kernels/hdm_stream/ops.py::plan and checked here (check_plan):
//
// - "skinny", bf16 at M <= 16: the weight's N axis on the 16-row side of
//   mma.sync.m16n8k16 and M on its 8-column side, y^T = W^T x^T, so that
//   no row of the product is padding. W^T's A fragments come by
//   ldmatrix.trans straight from the row-major page tiles, x's B
//   fragments by ldmatrix. Each CTA (4 warps, 16 columns each) takes a
//   64-column strip of N over one of `splits` contiguous ranges of K
//   (split-K), so that qwen3's 96 strips x 4 splits give 384 CTAs, about
//   three a SM; 64 x 64 tiles of W (8 KB) stream through a ring of
//   `stages` shared-memory buffers by 16-byte cp.async. The last CTA of a
//   strip to finish (a counter, as in paged_decode.cu) adds the strips'
//   f32 partials in split order and writes y: bit-identical run to run,
//   no float atomics. The counter is left at zero for the next call.
// - "tile", bf16 at M > 16: block tiles of tile_m x tile_n (128 x 64 with
//   4 warps of 64 x 32, 64 x 128 with 8 warps of 32 x 32, or 128 x 128
//   with 8 warps of 64 x 32) on mma.sync.m16n8k16, x's A fragments by
//   ldmatrix, W's B fragments by ldmatrix.trans, 64-deep K tiles through a
//   cp.async ring (32-deep ones took ~1.3x the time: twice the barriers
//   for the same products). The plan takes the first shape that gives a
//   CTA to every SM (chip_smoke.py's sweep, PERF.md). It stays well short
//   of the tensor cores' rate: mma.sync from a padded ring, no wgmma or
//   TMA.
// - "scalar", f32 (and any shape the two above refuse): the first
//   version, one CTA per 64 x 64 output tile, 32-deep K slices staged in
//   shared memory, scalar f32 FMAs.
//
// A K tile never crosses a page (the plan checks page_k % tile_k == 0);
// N must be a whole number of 16-byte chunks (N % 8 == 0) on tensor cores.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use
constexpr int kScalar = 0, kSkinny = 1, kTile = 2;  // plan.instance codes

using bf16 = __nv_bfloat16;

// Streams page tiles: resolves the base of logical page kj one page ahead
// (page_ids[kj + 1] is read when page kj's first tile is issued).
struct PageWalker {
  const bf16* w;
  const int* page_ids;
  int page_k, N, n_pages, n_logical;
  int page = -1, next_id = 0;
  const bf16* base = nullptr;

  __device__ PageWalker(const bf16* w_, const int* ids, int page_k_, int N_,
                        int n_pages_, int n_logical_, int first_page)
      : w(w_), page_ids(ids), page_k(page_k_), N(N_), n_pages(n_pages_),
        n_logical(n_logical_) {
    next_id = __ldg(page_ids + first_page);
    page = first_page - 1;
  }

  // the address of logical row k (tiles are issued in increasing k)
  __device__ const bf16* row(int k) {
    const int kj = k / page_k;
    if (kj != page) {
      base = w + (size_t)min(max(next_id, 0), n_pages - 1) * page_k * N;
      page = kj;
      if (kj + 1 < n_logical) next_id = __ldg(page_ids + kj + 1);
    }
    return base + (size_t)(k - kj * page_k) * N;
  }
};

// ---- skinny: bf16, M <= 16, split-K over 64-column strips

constexpr int kSkN = 64, kSkK = 64, kSkThreads = 128;
constexpr int kSkLdW = kSkN + 8;  // 144-byte rows: ldmatrix conflict-free
constexpr int kSkLdX = kSkK + 8;
constexpr int kSkStage = kSkK * kSkLdW + 16 * kSkLdX;  // elements

constexpr size_t skinny_smem_bytes(int stages) {
  return (size_t)2 * stages * kSkStage;
}

template <int MT>  // 8-column blocks of M: 1 (M <= 8) or 2 (M <= 16)
__global__ void __launch_bounds__(kSkThreads)
paged_matmul_skinny_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const int* __restrict__ page_ids,
                           bf16* __restrict__ y, float* __restrict__ part,
                           int* __restrict__ counters, int M, int K, int N,
                           int page_k, int n_pages, int splits,
                           int tiles_per_split, int stages) {
  const int strip = blockIdx.x, split = blockIdx.y;
  const int n0 = strip * kSkN;
  const int t0 = split * tiles_per_split;
  const int n_t = min(K / kSkK, t0 + tiles_per_split) - t0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  PageWalker pages(w, page_ids, page_k, N, n_pages, K / page_k,
                   t0 * kSkK / page_k);
  auto load_tile = [&](int i) {
    if (i < n_t) {
      bf16* Wt = ring + (size_t)(i % stages) * kSkStage;
      bf16* Xt = Wt + kSkK * kSkLdW;
      const int k0 = (t0 + i) * kSkK;
      const bf16* wp = pages.row(k0);
#pragma unroll
      for (int r = 0; r < kSkK * kSkN / 8 / kSkThreads; ++r) {
        const int c = tid + r * kSkThreads;
        const int row = c / (kSkN / 8), col = (c % (kSkN / 8)) * 8;
        const bool ok = n0 + col < N;
        cp_async16(Wt + row * kSkLdW + col,
                   ok ? wp + (size_t)row * N + n0 + col : w, ok);
      }
      {  // 16 rows of x, 8 chunks each: one chunk a thread
        const int row = tid >> 3, col = (tid & 7) * 8;
        const bool ok = row < M;
        cp_async16(Xt + row * kSkLdX + col,
                   ok ? x + (size_t)row * K + k0 + col : x, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait(stages - 2);  // tile i landed, this thread's part
    __syncthreads();            // ... everyone's; tile i - 1 is consumed
    load_tile(i + stages - 1);
    const bf16* Wt = ring + (size_t)(i % stages) * kSkStage;
    const bf16* Xt = Wt + kSkK * kSkLdW;
#pragma unroll
    for (int kk = 0; kk < kSkK / 16; ++kk) {
      // A = W^T (16 columns of N x 16 of K) from the row-major tile
      uint32_t a[4];
      ldmatrix_x4_trans(a, Wt + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                    kSkLdW +
                               warp * 16 + ((lane >> 3) & 1) * 8);
      // B = x^T: rows 0-7 of x give b0, b1; rows 8-15 the second block
      uint32_t b[4];
      ldmatrix_x4(b, Xt + ((lane & 7) + ((lane >> 4) << 3)) * kSkLdX +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[0], a, b[0], b[1]);
      if (MT == 2) mma_bf16(acc[MT - 1], a, b[2], b[3]);
    }
  }

  // acc[j]: n = n0 + warp*16 + gid (+8), m = 8j + 2*tig (+1)
  const int gid = lane >> 2, tig = lane & 3;
  const int nw = n0 + warp * 16 + gid;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * j + 2 * tig + (e & 1), n = nw + (e >> 1) * 8;
        if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(acc[j][e]);
      }
    return;
  }
  float* pp = part + (size_t)split * M * N;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * j + 2 * tig + (e & 1), n = nw + (e >> 1) * 8;
      if (m < M && n < N) pp[(size_t)m * N + n] = acc[j][e];
    }

  // the last split of this strip to finish adds all of them in split
  // order; every thread fences its own partial stores and the barrier
  // waits for all of them before one thread counts the split done
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(&counters[strip], 1) == splits - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  for (int i = tid; i < M * kSkN; i += kSkThreads) {
    const int m = i / kSkN, n = n0 + i % kSkN;
    if (n >= N) continue;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      s += __ldcg(part + ((size_t)sp * M + m) * N + n);
    y[(size_t)m * N + n] = __float2bfloat16(s);
  }
  if (tid == 0) counters[strip] = 0;  // ready for the next call
}

// ---- tile: bf16, M > 16, block tiles of BM x BN, warp tiles of WM x 32

constexpr int kTlK = 64;
constexpr int kTlLdA = kTlK + 8;  // 144-byte rows: ldmatrix conflict-free

// the warp tile's rows: 32 for the 64 x 128 block, 64 for the others
__host__ __device__ constexpr int tile_wm(int bm, int bn) {
  return bm == 64 ? 32 : 64;
}
__host__ __device__ constexpr int tile_threads(int bm, int bn) {
  return bm / tile_wm(bm, bn) * (bn / 32) * 32;
}
constexpr size_t tile_smem_bytes(int bm, int bn, int stages) {
  return (size_t)2 * stages * (bm * kTlLdA + kTlK * (bn + 8));
}

template <int BM, int BN>
__global__ void __launch_bounds__(tile_threads(BM, BN))
paged_matmul_tile_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const int* __restrict__ page_ids,
                         bf16* __restrict__ y, int M, int K, int N,
                         int page_k, int n_pages, int stages) {
  constexpr int kThr = tile_threads(BM, BN);
  constexpr int LdB = BN + 8;
  constexpr int kStage = BM * kTlLdA + kTlK * LdB;
  constexpr int WM = tile_wm(BM, BN), MI = WM / 16;  // m16 blocks a warp
  constexpr int WN = BN / 32;  // warps along N
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n_t = K / kTlK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  PageWalker pages(w, page_ids, page_k, N, n_pages, K / page_k, 0);
  auto load_tile = [&](int t) {
    if (t < n_t) {
      bf16* As = ring + (size_t)(t % stages) * kStage;
      bf16* Bs = As + BM * kTlLdA;
      const int k0 = t * kTlK;
      const bf16* wp = pages.row(k0);
#pragma unroll
      for (int r = 0; r < BM * kTlK / 8 / kThr; ++r) {
        const int c = tid + r * kThr;
        const int row = c / (kTlK / 8), col = (c % (kTlK / 8)) * 8;
        const bool ok = m0 + row < M;
        cp_async16(As + row * kTlLdA + col,
                   ok ? x + (size_t)(m0 + row) * K + k0 + col : x, ok);
      }
#pragma unroll
      for (int r = 0; r < kTlK * BN / 8 / kThr; ++r) {
        const int c = tid + r * kThr;
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool ok = n0 + col < N;
        cp_async16(Bs + row * LdB + col,
                   ok ? wp + (size_t)row * N + n0 + col : w, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  float acc[MI][4][4];  // [m16 block][n8 block][fragment]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait(stages - 2);
    __syncthreads();
    load_tile(t + stages - 1);
    const bf16* As = ring + (size_t)(t % stages) * kStage;
    const bf16* Bs = As + BM * kTlLdA;
#pragma unroll
    for (int kk = 0; kk < kTlK / 16; ++kk) {
      uint32_t af[MI][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], As + (wm * WM + i * 16 + (lane & 15)) * kTlLdA +
                               kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LdB +
                                 wn * 32 + j2 * 16 + (lane >> 4) * 8);
        bfr[2 * j2][0] = r[0];
        bfr[2 * j2][1] = r[1];
        bfr[2 * j2 + 1][0] = r[2];
        bfr[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WM + i * 16 + gid + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + tig * 2;
        if (n < N)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
              __floats2bfloat162_rn(acc[i][j][2 * half],
                                    acc[i][j][2 * half + 1]);
      }
    }
}

// ---- scalar: f32 (any M, N, page_k), 64 x 64 output tiles

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_matmul_scalar_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const int* __restrict__ page_ids,
                           T* __restrict__ y, int M, int K, int N, int page_k,
                           int n_pages) {
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

// ---- plan checks and launches

bool tile_shape(int bm, int bn) {
  return (bm == 128 && bn == 128) || (bm == 128 && bn == 64) ||
         (bm == 64 && bn == 128);
}

// The plan from kernels/hdm_stream/ops.py::plan, checked against what the
// instance it names can run; 0 if it holds.
int check_plan(int M, int K, int N, int page_k, int dtype, int instance,
               int tile_m, int tile_n, int tile_k, int stages, int splits,
               int smem) {
  if (instance == kScalar)
    return (tile_m == kBM && tile_n == kBN && tile_k == kBK && stages == 1 &&
            splits == 1 && smem == 0)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (dtype != kBFloat16 || N % 8 != 0 || smem > kMaxSmem || stages < 2 ||
      stages > 4 || page_k % tile_k != 0)
    return cudaErrorInvalidValue;
  if (instance == kSkinny) {
    const int n_t = K / kSkK;
    if (M > 16 || tile_m != 16 || tile_n != kSkN || tile_k != kSkK ||
        splits < 1 || splits > n_t ||
        (size_t)smem < skinny_smem_bytes(stages))
      return cudaErrorInvalidValue;
    const int per = (n_t + splits - 1) / splits;  // every split non-empty
    return (n_t + per - 1) / per == splits ? cudaSuccess
                                           : cudaErrorInvalidValue;
  }
  if (instance == kTile)
    return (M > 16 && tile_shape(tile_m, tile_n) && tile_k == kTlK &&
            splits == 1 &&
            (size_t)smem >= tile_smem_bytes(tile_m, tile_n, stages))
               ? cudaSuccess
               : cudaErrorInvalidValue;
  return cudaErrorInvalidValue;
}

cudaError_t launch_skinny(const bf16* x, const bf16* w, const int* ids,
                          bf16* y, float* part, int* counters, int M, int K,
                          int N, int page_k, int n_pages, int stages,
                          int splits, int smem, cudaStream_t s) {
  const int n_t = K / kSkK, per = (n_t + splits - 1) / splits;
  dim3 grid((N + kSkN - 1) / kSkN, splits);
  if (M <= 8) {
    static int smem_set = 0;
    cudaError_t err = allow_smem(paged_matmul_skinny_kernel<1>, smem,
                                 smem_set);
    if (err != cudaSuccess) return err;
    paged_matmul_skinny_kernel<1><<<grid, kSkThreads, smem, s>>>(
        x, w, ids, y, part, counters, M, K, N, page_k, n_pages, splits, per,
        stages);
  } else {
    static int smem_set = 0;
    cudaError_t err = allow_smem(paged_matmul_skinny_kernel<2>, smem,
                                 smem_set);
    if (err != cudaSuccess) return err;
    paged_matmul_skinny_kernel<2><<<grid, kSkThreads, smem, s>>>(
        x, w, ids, y, part, counters, M, K, N, page_k, n_pages, splits, per,
        stages);
  }
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tile(const bf16* x, const bf16* w, const int* ids, bf16* y,
                        int M, int K, int N, int page_k, int n_pages,
                        int stages, int smem, cudaStream_t s) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(paged_matmul_tile_kernel<BM, BN>, smem,
                               smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  paged_matmul_tile_kernel<BM, BN><<<grid, tile_threads(BM, BN), smem, s>>>(
      x, w, ids, y, M, K, N, page_k, n_pages, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scalar(const void* x, const void* w, const int* page_ids,
                          void* y, int M, int K, int N, int page_k,
                          int n_pages, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  paged_matmul_scalar_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), page_ids,
      static_cast<T*>(y), M, K, N, page_k, n_pages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); y, the partials [splits, M, N] (f32) and the
// per-strip counters (int32, zero) are allocated by the caller. instance,
// tile_m, tile_n, tile_k, stages, splits and smem are
// kernels/hdm_stream/ops.py::plan's, checked here before any launch.
extern "C" int repro_paged_matmul(const void* x, const void* w,
                                  const int* page_ids, void* y, void* part,
                                  void* counters, int M, int K, int N,
                                  int page_k, int n_pages, int dtype,
                                  int instance, int tile_m, int tile_n,
                                  int tile_k, int stages, int splits,
                                  int smem, void* stream) {
  using repro::bf16;
  if (M <= 0 || N <= 0 || page_k <= 0 || K % page_k != 0 || n_pages <= 0 ||
      (dtype != repro::kBFloat16 && dtype != repro::kFloat32))
    return cudaErrorInvalidValue;
  if (repro::check_plan(M, K, N, page_k, dtype, instance, tile_m, tile_n,
                        tile_k, stages, splits, smem) != cudaSuccess)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (instance == repro::kSkinny)
    return repro::launch_skinny(xb, wb, page_ids, yb,
                                static_cast<float*>(part),
                                static_cast<int*>(counters), M, K, N, page_k,
                                n_pages, stages, splits, smem, s);
  if (instance == repro::kTile) {
    if (tile_m == 128 && tile_n == 128)
      return repro::launch_tile<128, 128>(xb, wb, page_ids, yb, M, K, N,
                                          page_k, n_pages, stages, smem, s);
    if (tile_m == 128)
      return repro::launch_tile<128, 64>(xb, wb, page_ids, yb, M, K, N,
                                         page_k, n_pages, stages, smem, s);
    return repro::launch_tile<64, 128>(xb, wb, page_ids, yb, M, K, N, page_k,
                                       n_pages, stages, smem, s);
  }
  if (dtype == repro::kBFloat16)
    return repro::launch_scalar<bf16>(x, w, page_ids, y, M, K, N, page_k,
                                      n_pages, s);
  return repro::launch_scalar<float>(x, w, page_ids, y, M, K, N, page_k,
                                     n_pages, s);
}
