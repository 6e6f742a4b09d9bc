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
// 0.0065 ms of bf16 tensor-core operations). In f32 the weight is 50 MB
// (0.0150 ms of bytes at M = 8), and at M = 256 the products run as 3
// TF32 products each at 495 TFLOP/s (0.039 ms; 0.096 ms on f32 FMA).
// Five instances, named by kernels/hdm_stream/ops.py::plan and checked
// here (check_plan):
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
// - "skinny_f32", f32 at M <= 16: bytes bound it and the product is 3 us
//   of f32 FMA, so it stays off the tensor cores. The skinny instance's
//   strips, K-splits, ring and merge, with 64 x 64 f32 tiles of W (16 KB).
//   Each thread holds 4 adjacent columns for every row of x (float4 reads
//   of W, x broadcast as float4 along K) over one of 8 k-groups (8 rows
//   of each tile); the 8 k-groups' sums are added in k-group order through
//   shared memory at the end, then the splits in split order: exact f32
//   sums in a fixed order, bit-identical run to run.
// - "tile_f32", f32 at M > 16: the tile instance's block tiles, K ring and
//   page walk on mma.sync.m16n8k8 in error-compensated 3xTF32 (common.cuh:
//   lo.hi + hi.lo + hi.hi, ~2^-21 relative; one TF32 product misses the
//   f32 checks). x's A fragments by ldmatrix (b16 pairs read as 32-bit
//   elements: a 16 x 8 f32 tile is four 8 x 4 word matrices), rows padded
//   to 68 floats; there is no 32-bit ldmatrix.trans, so W's B fragments
//   are scalar shared loads from rows padded to tile_n + 8 floats (== 8
//   mod 32: the four k rows of a fragment fall in distinct banks). Each
//   operand is split once per fragment and serves every product it is in.
//   The plan takes 64 x 64 blocks (4 warps of 32 x 32) in a 2-stage ring:
//   384 CTAs, three a SM, which stage their x and W strips through L2 at
//   ~3.2 TB/s (403 MB at qwen3's width, computed from the shapes) and
//   beat the 128 x 64, 128 x 96 and 128 x 128 blocks of the sweep (fewer
//   bytes, but one or two CTAs a SM; chip_smoke.py, PERF.md).
// - "scalar" (shapes neither of its dtype's instances takes: N not a whole
//   number of 16-byte chunks, pages that are not whole 64-deep K tiles):
//   the first version, one CTA per 64 x 64 output tile, 32-deep K slices
//   staged in shared memory, scalar f32 FMAs.
//
// A K tile never crosses a page (the plan checks page_k % tile_k == 0);
// N must be a whole number of 16-byte chunks (N % 8 == 0 in bf16, N % 4
// == 0 in f32) on every instance but the scalar one.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use
constexpr int kScalar = 0, kSkinny = 1, kTile = 2, kSkinnyF32 = 3,
              kTileF32 = 4;  // plan.instance codes

using bf16 = __nv_bfloat16;

// Streams page tiles: resolves the base of logical page kj one page ahead
// (page_ids[kj + 1] is read when page kj's first tile is issued).
template <typename T>
struct PageWalker {
  const T* w;
  const int* page_ids;
  int page_k, N, n_pages, n_logical;
  int page = -1, next_id = 0;
  const T* base = nullptr;

  __device__ PageWalker(const T* w_, const int* ids, int page_k_, int N_,
                        int n_pages_, int n_logical_, int first_page)
      : w(w_), page_ids(ids), page_k(page_k_), N(N_), n_pages(n_pages_),
        n_logical(n_logical_) {
    next_id = __ldg(page_ids + first_page);
    page = first_page - 1;
  }

  // the address of logical row k (tiles are issued in increasing k)
  __device__ const T* row(int k) {
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

  PageWalker<bf16> pages(w, page_ids, page_k, N, n_pages, K / page_k,
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

// the warp tile's rows: 32 for the 64-row blocks, 64 for the others
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

  PageWalker<bf16> pages(w, page_ids, page_k, N, n_pages, K / page_k, 0);
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

// ---- skinny_f32: f32, M <= 16, split-K over 64-column strips, FFMA

constexpr int kSfN = 64, kSfK = 64, kSfThreads = 128;
constexpr int kSfGroups = kSfThreads / (kSfN / 4);  // k-groups: 8
constexpr int kSfGroupK = kSfK / kSfGroups;         // rows of a tile each
constexpr int kSfStage = kSfK * kSfN + 16 * kSfK;   // floats: W, then x

constexpr size_t skinny_f32_smem_bytes(int stages) {
  return (size_t)4 * stages * kSfStage;
}

template <int MT>  // 8-row blocks of M: 1 (M <= 8) or 2 (M <= 16)
__global__ void __launch_bounds__(kSfThreads)
paged_matmul_skinny_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const int* __restrict__ page_ids,
                               float* __restrict__ y, float* __restrict__ part,
                               int* __restrict__ counters, int M, int K,
                               int N, int page_k, int n_pages, int splits,
                               int tiles_per_split, int stages) {
  constexpr int R = 8 * MT;  // rows of x held, M padded
  const int strip = blockIdx.x, split = blockIdx.y;
  const int n0 = strip * kSfN;
  const int t0 = split * tiles_per_split;
  const int n_t = min(K / kSfK, t0 + tiles_per_split) - t0;
  const int tid = threadIdx.x;
  const int cq = tid & 15, kg = tid >> 4;  // 4-column group, k-group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);

  PageWalker<float> pages(w, page_ids, page_k, N, n_pages, K / page_k,
                          t0 * kSfK / page_k);
  auto load_tile = [&](int i) {
    if (i < n_t) {
      float* Wt = ring + (size_t)(i % stages) * kSfStage;
      float* Xt = Wt + kSfK * kSfN;
      const int k0 = (t0 + i) * kSfK;
      const float* wp = pages.row(k0);
#pragma unroll
      for (int r = 0; r < kSfK * kSfN / 4 / kSfThreads; ++r) {
        const int c = tid + r * kSfThreads;
        const int row = c / (kSfN / 4), col = (c % (kSfN / 4)) * 4;
        const bool ok = n0 + col < N;
        cp_async16(Wt + row * kSfN + col,
                   ok ? wp + (size_t)row * N + n0 + col : w, ok);
      }
#pragma unroll
      for (int r = 0; r < R * kSfK / 4 / kSfThreads; ++r) {
        const int c = tid + r * kSfThreads;
        const int row = c / (kSfK / 4), col = (c % (kSfK / 4)) * 4;
        const bool ok = row < M;
        cp_async16(Xt + row * kSfK + col,
                   ok ? x + (size_t)row * K + k0 + col : x, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    cp_async_wait(stages - 2);  // tile i landed, this thread's part
    __syncthreads();            // ... everyone's; tile i - 1 is consumed
    load_tile(i + stages - 1);
    const float* Wt = ring + (size_t)(i % stages) * kSfStage;
    const float* Xt = Wt + kSfK * kSfN;
#pragma unroll
    for (int k4 = 0; k4 < kSfGroupK; k4 += 4) {
      const int k = kg * kSfGroupK + k4;
      float4 xv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        xv[r] = *reinterpret_cast<const float4*>(Xt + r * kSfK + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv =
            *reinterpret_cast<const float4*>(Wt + (k + j) * kSfN + cq * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xr = j == 0 ? xv[r].x : j == 1 ? xv[r].y
                         : j == 2 ? xv[r].z : xv[r].w;
          acc[r][0] = fmaf(xr, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xr, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xr, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xr, wv.w, acc[r][3]);
        }
      }
    }
  }

  // the k-groups' sums through the ring, added in k-group order (every
  // copy has landed: the groups still pending are empty)
  cp_async_wait(0);
  __syncthreads();
  float* red = ring;  // [kSfGroups][R][kSfN]
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(red + (kg * R + r) * kSfN + cq * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  float* pp = part + (size_t)split * M * N;
  for (int i = tid; i < M * kSfN; i += kSfThreads) {
    const int m = i / kSfN, c = i % kSfN, n = n0 + c;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kSfGroups; ++g) s += red[(g * R + m) * kSfN + c];
    if (n >= N) continue;
    if (splits == 1) y[(size_t)m * N + n] = s;
    else pp[(size_t)m * N + n] = s;
  }
  if (splits == 1) return;

  // the last split of this strip to finish adds all of them in split
  // order (as the bf16 skinny instance does)
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(&counters[strip], 1) == splits - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  for (int i = tid; i < M * kSfN; i += kSfThreads) {
    const int m = i / kSfN, n = n0 + i % kSfN;
    if (n >= N) continue;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      s += __ldcg(part + ((size_t)sp * M + m) * N + n);
    y[(size_t)m * N + n] = s;
  }
  if (tid == 0) counters[strip] = 0;  // ready for the next call
}

// ---- tile_f32: f32, M > 16, block tiles of BM x BN in 3xTF32

constexpr int kTfK = 64;
constexpr int kTfLdA = kTfK + 4;  // 272-byte rows: ldmatrix conflict-free

__host__ __device__ constexpr int tile_f32_ldb(int bn) { return bn + 8; }
constexpr size_t tile_f32_smem_bytes(int bm, int bn, int stages) {
  return (size_t)4 * stages * (bm * kTfLdA + kTfK * tile_f32_ldb(bn));
}
// the f32 warp tile: 32 x 48 in the 128 x 96 block, else the bf16 one's
__host__ __device__ constexpr int tile_f32_wm(int bm, int bn) {
  return bn == 96 ? 32 : tile_wm(bm, bn);
}
__host__ __device__ constexpr int tile_f32_wn(int bm, int bn) {
  return bn == 96 ? 48 : 32;
}
__host__ __device__ constexpr int tile_f32_threads(int bm, int bn) {
  return bm / tile_f32_wm(bm, bn) * (bn / tile_f32_wn(bm, bn)) * 32;
}

template <int BM, int BN>
__global__ void __launch_bounds__(tile_f32_threads(BM, BN))
paged_matmul_tile_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const int* __restrict__ page_ids,
                             float* __restrict__ y, int M, int K, int N,
                             int page_k, int n_pages, int stages) {
  constexpr int kThr = tile_f32_threads(BM, BN);
  constexpr int LdB = tile_f32_ldb(BN);  // == 8 (mod 32) floats
  constexpr int kStage = BM * kTfLdA + kTfK * LdB;
  constexpr int WM = tile_f32_wm(BM, BN), MI = WM / 16;  // m16 blocks a warp
  constexpr int WNC = tile_f32_wn(BM, BN), NJ = WNC / 8;  // n8 blocks a warp
  constexpr int WN = BN / WNC;  // warps along N
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_t = K / kTfK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);

  PageWalker<float> pages(w, page_ids, page_k, N, n_pages, K / page_k, 0);
  auto load_tile = [&](int t) {
    if (t < n_t) {
      float* As = ring + (size_t)(t % stages) * kStage;
      float* Bs = As + BM * kTfLdA;
      const int k0 = t * kTfK;
      const float* wp = pages.row(k0);
#pragma unroll
      for (int r = 0; r < BM * kTfK / 4 / kThr; ++r) {
        const int c = tid + r * kThr;
        const int row = c / (kTfK / 4), col = (c % (kTfK / 4)) * 4;
        const bool ok = m0 + row < M;
        cp_async16(As + row * kTfLdA + col,
                   ok ? x + (size_t)(m0 + row) * K + k0 + col : x, ok);
      }
#pragma unroll
      for (int r = 0; r < kTfK * BN / 4 / kThr; ++r) {
        const int c = tid + r * kThr;
        const int row = c / (BN / 4), col = (c % (BN / 4)) * 4;
        const bool ok = n0 + col < N;
        cp_async16(Bs + row * LdB + col,
                   ok ? wp + (size_t)row * N + n0 + col : w, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  float acc[MI][NJ][4];  // [m16 block][n8 block][fragment]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait(stages - 2);
    __syncthreads();
    load_tile(t + stages - 1);
    const float* As = ring + (size_t)(t % stages) * kStage;
    const float* Bs = As + BM * kTfLdA;
#pragma unroll
    for (int kk = 0; kk < kTfK / 8; ++kk) {
      // A: four 8 x 4 word matrices (rows 0-7 / 8-15, k 0-3 / 4-7) give
      // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      Tf32Frag af[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t r[4];
        ldmatrix_x4(r, As + (wm * WM + i * 16 + (lane & 7) +
                             ((lane >> 3) & 1) * 8) * kTfLdA +
                            kk * 8 + (lane >> 4) * 4);
        af[i] = split_frag(__uint_as_float(r[0]), __uint_as_float(r[1]),
                           __uint_as_float(r[2]), __uint_as_float(r[3]));
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* br = Bs + (kk * 8 + tig) * LdB + wn * WNC + j * 8 + gid;
        const Tf32Pair b0 = split_tf32(br[0]), b1 = split_tf32(br[4 * LdB]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {  // mma_3xtf32's order of products
          mma_tf32(acc[i][j], af[i].lo, b0.hi, b1.hi);
          mma_tf32(acc[i][j], af[i].hi, b0.lo, b1.lo);
          mma_tf32(acc[i][j], af[i].hi, b0.hi, b1.hi);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * WM + i * 16 + gid + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn * WNC + j * 8 + tig * 2;
        if (n < N)
          *reinterpret_cast<float2*>(y + (size_t)m * N + n) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
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
// tile_f32's blocks: 64 x 64 (4 warps of 32 x 32), 128 x 96 (8 warps of
// 32 x 48), 128 x 64 and 128 x 128 (warps of 64 x 32)
bool tile_f32_shape(int bm, int bn) {
  return (bm == 64 && bn == 64) ||
         (bm == 128 && (bn == 64 || bn == 96 || bn == 128));
}

// The plan from kernels/hdm_stream/ops.py::plan, checked against what the
// instance it names can run; 0 if it holds. The scalar instance takes only
// what neither instance of its dtype takes (N not in whole 16-byte chunks,
// pages that are not whole 64-deep K tiles).
int check_plan(int M, int K, int N, int page_k, int dtype, int instance,
               int tile_m, int tile_n, int tile_k, int stages, int splits,
               int smem) {
  const bool bf16 = dtype == kBFloat16;
  const bool chunks = N % (bf16 ? 8 : 4) == 0;
  if (instance == kScalar)
    return (tile_m == kBM && tile_n == kBN && tile_k == kBK && stages == 1 &&
            splits == 1 && smem == 0 && !(chunks && page_k % kTlK == 0))
               ? cudaSuccess
               : cudaErrorInvalidValue;
  const bool skinny = instance == kSkinny || instance == kSkinnyF32;
  const bool tile = instance == kTile || instance == kTileF32;
  const bool f32_instance = instance == kSkinnyF32 || instance == kTileF32;
  if ((!skinny && !tile) || f32_instance == bf16 || !chunks ||
      smem > kMaxSmem || stages < 2 || stages > 4 || page_k % tile_k != 0)
    return cudaErrorInvalidValue;
  if (skinny) {
    const int n_t = K / kSkK;  // kSfK == kSkK
    const size_t need = bf16 ? skinny_smem_bytes(stages)
                             : skinny_f32_smem_bytes(stages);
    if (M > 16 || tile_m != 16 || tile_n != kSkN || tile_k != kSkK ||
        splits < 1 || splits > n_t || (size_t)smem < need)
      return cudaErrorInvalidValue;
    const int per = (n_t + splits - 1) / splits;  // every split non-empty
    return (n_t + per - 1) / per == splits ? cudaSuccess
                                           : cudaErrorInvalidValue;
  }
  const size_t need = bf16 ? tile_smem_bytes(tile_m, tile_n, stages)
                           : tile_f32_smem_bytes(tile_m, tile_n, stages);
  return (M > 16 &&
          (bf16 ? tile_shape(tile_m, tile_n)
                : tile_f32_shape(tile_m, tile_n)) &&
          tile_k == kTlK &&
          splits == 1 && (size_t)smem >= need)
             ? cudaSuccess
             : cudaErrorInvalidValue;
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

cudaError_t launch_skinny_f32(const float* x, const float* w, const int* ids,
                              float* y, float* part, int* counters, int M,
                              int K, int N, int page_k, int n_pages,
                              int stages, int splits, int smem,
                              cudaStream_t s) {
  const int n_t = K / kSfK, per = (n_t + splits - 1) / splits;
  dim3 grid((N + kSfN - 1) / kSfN, splits);
  if (M <= 8) {
    static int smem_set = 0;
    cudaError_t err = allow_smem(paged_matmul_skinny_f32_kernel<1>, smem,
                                 smem_set);
    if (err != cudaSuccess) return err;
    paged_matmul_skinny_f32_kernel<1><<<grid, kSfThreads, smem, s>>>(
        x, w, ids, y, part, counters, M, K, N, page_k, n_pages, splits, per,
        stages);
  } else {
    static int smem_set = 0;
    cudaError_t err = allow_smem(paged_matmul_skinny_f32_kernel<2>, smem,
                                 smem_set);
    if (err != cudaSuccess) return err;
    paged_matmul_skinny_f32_kernel<2><<<grid, kSfThreads, smem, s>>>(
        x, w, ids, y, part, counters, M, K, N, page_k, n_pages, splits, per,
        stages);
  }
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tile_f32(const float* x, const float* w, const int* ids,
                            float* y, int M, int K, int N, int page_k,
                            int n_pages, int stages, int smem,
                            cudaStream_t s) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(paged_matmul_tile_f32_kernel<BM, BN>, smem,
                               smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  paged_matmul_tile_f32_kernel<BM, BN>
      <<<grid, tile_f32_threads(BM, BN), smem, s>>>(x, w, ids, y, M, K, N,
                                                    page_k, n_pages, stages);
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
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (instance == repro::kSkinnyF32)
    return repro::launch_skinny_f32(xf, wf, page_ids, yf,
                                    static_cast<float*>(part),
                                    static_cast<int*>(counters), M, K, N,
                                    page_k, n_pages, stages, splits, smem, s);
  if (instance == repro::kTileF32) {
    if (tile_m == 128 && tile_n == 128)
      return repro::launch_tile_f32<128, 128>(xf, wf, page_ids, yf, M, K, N,
                                              page_k, n_pages, stages, smem,
                                              s);
    if (tile_m == 128 && tile_n == 96)
      return repro::launch_tile_f32<128, 96>(xf, wf, page_ids, yf, M, K, N,
                                             page_k, n_pages, stages, smem, s);
    if (tile_m == 128)
      return repro::launch_tile_f32<128, 64>(xf, wf, page_ids, yf, M, K, N,
                                             page_k, n_pages, stages, smem, s);
    return repro::launch_tile_f32<64, 64>(xf, wf, page_ids, yf, M, K, N,
                                          page_k, n_pages, stages, smem, s);
  }
  if (dtype == repro::kBFloat16)
    return repro::launch_scalar<bf16>(x, w, page_ids, y, M, K, N, page_k,
                                      n_pages, s);
  return repro::launch_scalar<float>(x, w, page_ids, y, M, K, N, page_k,
                                     n_pages, s);
}
