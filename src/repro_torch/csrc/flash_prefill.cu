// Flash attention for chunked prefill against the paged cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _attn_kernel), widened to what the serving path's
// chunk_prefill_attention (src/repro/models/attention.py:204) computes:
// query i of row b attends to cache positions kv_pos <= min(pos[b] + i,
// Smax - 1) (its prior context plus the chunk's own causal prefix), with
// ragged chunk length C and cache length Smax masked instead of asserted.
// At pos = 0 and C = Smax this is the Pallas kernel's causal attention.
//
// Layout: q [B,C,H,D]; caches [B,Smax,Hkv,D] (the flat view of the paged
// cache, read in place); pos int32 [B]; out [B,C,H,D] in q's dtype. The G
// query heads of a kv head are packed as rows row = qi*G + g, so a CTA
// loads each K/V tile once for all of them.
//
// What bounds it on an H100: at the serving path's shapes (qwen3-1.7b: a
// 256-token chunk at offset 300, 16 heads over 8 kv heads, D 128) the
// bytes of q, the output and the visible K/V are ~4.4 MB (0.0013 ms at
// 3.35 TB/s) and the products ~0.9 GFLOP (0.0009 ms at 989 TFLOP/s): each
// K/V row serves C*G = 512 query rows, ~512 flop/byte against the card's
// ~295 ridge. So the bound is bytes by a little, and at this size the
// pipeline fill, the launch and the number of CTAs set the time: the
// tensor-core kernel takes ~0.033 ms there on an H100 SXM at 700 W (~25x
// the bound, about half of SDPA's time; chip_smoke.py, PERF.md), the
// scalar kernel it replaces for bf16 took ~0.17 ms. In f32 (the int8
// path's chunk, the same shape) the bytes are ~8.8 MB (0.0026 ms) and
// the products run as 3 TF32 products each at 495 TFLOP/s (0.0054 ms), so
// operations bound it; outside the tensor cores (67 TFLOP/s) they would
// take 0.0134 ms, and the scalar kernel took ~0.135 ms.
//
// Six kernels, dispatched explicitly by (dtype, D, rows) in dispatch():
//
// - bf16 at D in {64, 80, 128} (qwen3's 128, zamba2's shared block's 80):
//   flash_prefill_mma_kernel, FlashAttention-2 style. Each warp owns 16
//   (query, head) rows; its Q fragments are loaded once with ldmatrix and
//   stay in registers. Both products run on tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate): S = Q K^T with K
//   fragments by ldmatrix, then the S accumulator is scaled, masked and
//   exponentiated in place (online softmax, row max and sum over the quad
//   of lanes that share a row), rounded to bf16 and used directly as the A
//   operand of P.V, V fragments by ldmatrix.trans: P never touches shared
//   memory. K/V tiles of 64 keys are staged as bf16 with 16-byte cp.async
//   into a ring of 3 stages (tile j+1 and j+2 load while tile j computes),
//   rows padded to D + 8 elements so that ldmatrix is free of bank
//   conflicts (row strides of 272, 176 and 144 bytes). Tiles wholly past
//   the CTA's last visible key are never loaded; keys past it inside the
//   last tile are zero-filled; the mask runs only on tiles that cross a
//   warp's first row's limit, and a warp skips tiles past its last row's
//   limit. Rows past C*G are computed on zero queries and never stored.
//   Rows per CTA (16, 32 or 64; 2 warps per 32 rows) come from the plan,
//   kernels/flash_attention/ops.py::plan, which takes the most rows that
//   still give >= 132 CTAs (one per SM): qwen3's chunk has 512 rows per kv
//   head x 8 kv heads, so 16-row CTAs, 256 of them (64-row CTAs would be
//   64); zamba2's 256 rows x 32 kv heads take 32-row CTAs, 256 of them.
//   Shared memory 2 (D + 8)(rows + 3 * 2 * 64) bytes: 108,800 at qwen3's.
//   Measured on the H100, fewer and larger CTAs are faster all the same
//   (64-row CTAs, 64 of them, take ~0.7x the time at qwen3's chunk): a
//   one-warp CTA issues every copy of each 32 KB K/V tile itself, and 32
//   CTAs stage the same tile. 64-row CTAs over a split key axis are next.
// - f32 at D in {64, 80, 128} (the int8 path's prefill, which widens q to
//   f32 over the dequantized pages): flash_prefill_tf32_kernel, the same
//   FlashAttention-2 shape on tensor cores in error-compensated 3xTF32
//   (mma.sync.m16n8k8, tf32 in, f32 accumulate). Each operand is split once
//   into hi = x rounded to tf32 and lo = x - hi, and lo.hi, hi.lo and hi.hi
//   go into one f32 accumulator: ~2^-21 relative per product, where one
//   TF32 product (10 mantissa bits) would miss the f32 checks (1e-4 on the
//   card, 3e-5 on the CPU). The split is integer ops (common.cuh), not
//   cvt, which runs at a quarter of their rate. Q's fragments are read
//   from global memory straight into registers (as f32, split per tile: hi
//   and lo of Q at D 128 would take 128 registers beside O's 64). The S
//   accumulator of 8 keys is P's A operand as (c0, c2, c1, c3), its columns
//   2t, 2t+1 taken as k = t, t+4, with V's B fragment read from key rows 2t
//   and 2t + 1: no shuffle, no shared memory. Two warps share each 16 rows,
//   each taking 32 keys of every 64-key tile with its own online softmax;
//   they merge once at the end, in group order, through shared memory. This
//   halves each warp's serial walk over the keys and keeps all four of an
//   SM's schedulers busy with a 32-row CTA. K/V tiles are staged in f32 by
//   16-byte cp.async into a ring of 2 or 3 stages, rows padded to D + 4
//   floats (row strides of 528, 336 and 272 bytes: every fragment read is
//   free of bank conflicts). Shared memory 4 (D + 4) stages 2 64 bytes:
//   135,168 at D 128 and 2 stages, 202,752 at 3 (one CTA a SM either way),
//   so q is not staged. The masking, zero-filling and row conventions are
//   the bf16 kernel's. Rows per CTA and stages come from the plan, chosen
//   by measurement on the H100 (chip_smoke.py's plan sweep; PERF.md): at
//   the int8 path's chunk 32-row CTAs (128 CTAs of 4 warps) take ~0.042
//   ms at 2 or 3 stages, 64-row ones ~0.054, 16-row ones ~0.096 (two waves
//   of one CTA a SM); the scalar kernel took ~0.131.
// - bf16 at D 256 (gemma-2b; MQA, so its 256-token chunk is 2048 rows over
//   one kv head): flash_prefill_d256_kernel, the bf16 kernel's shape with
//   two warps per 16 rows, each on half of the head dim. One warp holding
//   16 rows x 256 columns of O needs 128 f32 accumulator registers, Q's
//   fragments 64 more and S's 32: past 255. Split in halves, a warp keeps
//   Q (32 registers) and O (64) for its 128 columns, computes its half's
//   partial of S = Q K^T (16 x 64 f32), and the pair swaps partials through
//   shared memory (a named barrier per pair); both add the same two
//   numbers, so both hold the same S bit for bit, run the same online
//   softmax, and each runs P.V into its own 128 columns. The partials live
//   in the pair's own 16 staged Q rows (8448 bytes), free once Q is in
//   registers. 64-key K/V tiles padded to D + 8 (528-byte rows, ldmatrix
//   free of bank conflicts) in a ring of 2 or 3 stages: shared memory
//   2 (D + 8)(rows + stages 2 64) bytes, 219,648 at 32 rows and 3 stages
//   (one CTA a SM). At gemma's chunk every CTA reads the same 0.57 MB of
//   K/V, which stays in L2. Rows per CTA (16, 32, 64) and stages come from
//   the plan, chosen by chip_smoke.py's sweep (PERF.md).
// - f32 at D 256 (gemma-2b with int8 pages, whose prefill widens q to f32
//   over the dequantized pages): flash_prefill_tf32_256_kernel, the 3xTF32
//   kernel's arithmetic with four warps on the quarters of the head dim,
//   twice over: two key groups per 16 rows, as in the D 128 kernel. One
//   warp cannot hold 16 rows x 256 columns in f32 (O alone is 128
//   registers, Q's hi and lo fragments 256 more), nor can two (64 of O and
//   128 of Q each). A quarter is 32 registers of O and 64 of Q split once
//   into hi and lo. Each warp computes its quarter's partial of S = Q K^T
//   over its group's half of the tile's keys, the group's four warps swap
//   partials through shared memory behind a 128-thread named barrier, and
//   each adds the four in quarter order, so that all four hold S bit for
//   bit, run the same online softmax and multiply P by their own 64
//   columns of V. The two groups merge once at the end, in group order.
//   One CTA of 16 rows (8 warps) per SM: gemma's chunk has 2048 rows over
//   one kv head, 128 CTAs; with one key group, 4 warps an SM took ~0.058
//   ms there and 32-row CTAs (64 of 8 warps) ~0.073. f32 K/V tiles of 64
//   keys at rows of D + 4 floats would be 133 KB a stage, so tiles are 32
//   keys (16 took ~1.2x the time): 66,560 bytes a stage, in a ring of 2
//   or 3 stages, plus 8 KB of partials (every fragment read free of bank
//   conflicts at the 1040-byte row stride). The stages come from the plan,
//   chosen by chip_smoke.py's sweep (PERF.md).
// - bf16 at D 128 on long chunks (the training loss's 4096-token sequence
//   as one chunk at position 0: q [8, 4096, 16, 128], 8 kv heads):
//   flash_prefill_wgmma_kernel, the Hopper instance (plan "wgmma", 128
//   rows per CTA), in place of the same TPU kernel
//   (src/repro/kernels/flash_attention/kernel.py:77). There ~550 GFLOP of
//   causal products against ~0.3 GB of bytes: operations bound it (0.556
//   ms at 989 TFLOP/s), so the design is about keeping the tensor cores
//   fed. FlashAttention-3's shape:
//   * warp specialisation: one producer warpgroup (setmaxnreg 24; one
//     thread of it issues every copy) and two consumer warpgroups
//     (setmaxnreg 240), each owning 64 of the CTA's 128 (position, head)
//     rows: 64 positions x the G 2 heads of a kv head, so that every K/V
//     tile serves both heads;
//   * TMA: q's rows as one box {64 columns, G heads, 128/G positions} per
//     half of D, K and V as boxes of 128 keys, 128-byte swizzled, into a
//     ring of 3 stages of 64 KB with full and empty mbarriers. The tensor
//     maps come from cuTensorMapEncodeTiled, taken from the driver through
//     cudaGetDriverEntryPoint (no -lcuda at link time);
//   * wgmma: S = Q K^T as m64n128k16 with both operands in shared memory;
//     P.V as m64n128k16 with P (bf16) from registers -- the S
//     accumulator's fragments -- and V MN-major over its two 64-column
//     boxes (the descriptor's leading byte offset);
//   * overlap: a warpgroup issues S of tile t and P.V of tile t - 1
//     together and runs tile t's softmax while P.V does; the two
//     warpgroups issue their products in turns (named barriers 1 and 2,
//     ping-pong), so one's products run while the other does its softmax;
//   * softmax in f32 on the accumulator (base 2, the scale folded into one
//     FFMA, ex2.approx); the mask only on tiles that cross a row's limit;
//     both warpgroups walk the CTA's whole tile range (a tile past a
//     row's limit is masked whole) so that their turns pair up;
//   * order: CTAs start longest first within groups of 4 (kv head, batch
//     row) pairs, so that the CTAs in flight share a group's K/V in L2
//     (kernels/flash_attention/ops.py wgmma_order mirrors the map);
//   * no float atomics: bit for bit the same from run to run.
//   Shared memory 1024 (alignment) + 32 KB of q + 3 x 64 KB + barriers =
//   230,528 bytes: one CTA an SM. Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py; PERF.md): ~1.07 ms, against 2.90 ms for the best plan
//   of flash_prefill_mma_kernel at this shape (4.47 for the one plan()
//   took before) and ~0.9 ms for causal SDPA. plan() routes it only at
//   the query-head groups chip_smoke.py gates it at (ops.py WGMMA_GROUPS:
//   G 2); the kernel is written for any group that divides 128 rows.
// - everything else -- bf16 and f32 at D in {16, 32}, the smoke models'
//   head dims -- goes to flash_prefill_scalar_kernel, the first version:
//   64-row CTAs, f32 tiles in shared memory, scalar f32 FMAs.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

// ---- the scalar kernel: bf16 and f32 at D in {16, 32}

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kThreads = 256;  // 16 (rows/4) x 16 (keys, columns)

constexpr size_t scalar_smem_bytes(int D) {
  return (size_t)(3 * kRows * (D + 1) + kRows * (kKeys + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pos,
                     T* __restrict__ out, int C, int H, int Hkv, int Smax,
                     float scale, float softcap) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(kKeys == kRows, "tile loaders assume square tiles");
  constexpr int LD = D + 1;    // padded row: conflict-free column reads
  constexpr int NC = D / 16;   // output columns per thread
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kRows][LD]
  float* Ks = Qs + kRows * LD;    // [kKeys][LD]
  float* Vs = Ks + kKeys * LD;    // [kKeys][LD]
  float* Ps = Vs + kKeys * LD;    // [kRows][kKeys + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_rows = C * G;
  const int row0 = tile * kRows;
  const int p0 = pos[b];

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n_rows) {
      const int qi = row / G, g = row - qi * G;
      val = to_f32(q[(((size_t)b * C + qi) * H + (size_t)hk * G + g) * D + d]);
    }
    Qs[r * LD + d] = val;
  }

  int lim[4];  // last visible key of each of this thread's rows (-1: none)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    lim[i] = row < n_rows ? min(p0 + row / G, Smax - 1) : -1;
  }
  const int last_row = min(n_rows - 1, row0 + kRows - 1);
  const int kv_end = min(Smax, p0 + last_row / G + 1);  // keys [0, kv_end)

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    __syncthreads();  // Q staged / previous tile fully consumed
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int kk = i / D, d = i - kk * D;
      const int key = k0 + kk;
      float kval = 0.f, vval = 0.f;
      if (key < kv_end) {
        const size_t off = (((size_t)b * Smax + key) * Hkv + hk) * D + d;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      Ks[kk * LD + d] = kval;
      Vs[kk * LD + d] = vval;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

    // online softmax over this tile; a row's 64 keys live on 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = softcap_logit(s[i][j] * scale, softcap);
        if (key > lim[i]) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = seg_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const bool none = m_new == -INFINITY;  // no visible key yet
      const float alpha = none ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (kKeys + 1) + tx + 16 * j] = p;
        rs += p;
      }
      rs = seg_sum<16>(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V for columns tx+16*c
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kKeys + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    T* o = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) store_f32(acc[i][c] / denom, o + tx + 16 * c);
  }
}


// ---- the tensor-core kernel: bf16, D in {64, 80, 128}

constexpr int kMmaKeys = 64;         // keys per K/V tile
constexpr int kMmaMaxThreads = 128;  // 64 rows: 4 warps of 16 rows

constexpr size_t mma_smem_bytes(int D, int rows, int stages) {
  return (size_t)2 * (D + 8) * (rows + stages * 2 * kMmaKeys);
}

template <int D>
__global__ void __launch_bounds__(kMmaMaxThreads)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ pos,
                         __nv_bfloat16* __restrict__ out, int C, int H,
                         int Hkv, int Smax, int stages, float scale,
                         float softcap) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;          // padded row (elements)
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int NB = D / 8;          // 8-column blocks of O
  constexpr int SB = kMmaKeys / 8;   // 8-key blocks of S
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int nthr = blockDim.x, rows = nthr / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // fragment row, column pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [rows][LD]
  bf16* ring = Qs + rows * LD;                   // stages x {K, V} [64][LD]

  const int n_rows = C * G, row0 = tile * rows, p0 = pos[b];
  // last visible key of a row; rows past C*G take the last row's
  auto limit = [&](int row) {
    return min(p0 + min(row, n_rows - 1) / G, Smax - 1);
  };
  const int kv_end = limit(row0 + rows - 1) + 1;  // keys [0, kv_end)
  const int n_tiles = (kv_end + kMmaKeys - 1) / kMmaKeys;

  for (int i = tid; i < rows * CH; i += nthr) {
    const int r = i / CH, cc = i - r * CH, row = row0 + r;
    const bool ok = row < n_rows;
    const int qi = ok ? row / G : 0, g = ok ? row - qi * G : 0;
    cp_async16(Qs + r * LD + cc * 8,
               q + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
                   cc * 8,
               ok);
  }
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      bf16* Kt = ring + (size_t)(t % stages) * 2 * kMmaKeys * LD;
      bf16* Vt = Kt + kMmaKeys * LD;
      for (int i = tid; i < kMmaKeys * CH; i += nthr) {
        const int r = i / CH, cc = i - r * CH, key = t * kMmaKeys + r;
        const bool ok = key < kv_end;
        const size_t off =
            (((size_t)b * Smax + (ok ? key : 0)) * Hkv + hk) * D + cc * 8;
        cp_async16(Kt + r * LD + cc * 8, k + off, ok);
        cp_async16(Vt + r * LD + cc * 8, v + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);  // Q joins tile 0

  const int wrow0 = row0 + warp * 16;
  const bool warp_live = wrow0 < n_rows;
  const int lim_a = limit(wrow0 + gid), lim_b = limit(wrow0 + gid + 8);
  const int lim_lo = limit(wrow0), lim_hi = limit(wrow0 + 15);
  const float qk_scale = scale * kLog2e;

  uint32_t qf[KS][4];
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(stages - 2);  // tile t (and Q) landed, this thread's part
    __syncthreads();            // ... everyone's; tile t - 1 is consumed
    load_tile(t + stages - 1);
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const int k0 = t * kMmaKeys;
    if (!warp_live || k0 > lim_hi) continue;  // nothing visible to the warp
    const bf16* Kt = ring + (size_t)(t % stages) * 2 * kMmaKeys * LD;
    const bf16* Vt = Kt + kMmaKeys * LD;

    // S = Q K^T: s[j] holds keys k0 + 8j .. +7 of rows gid and gid + 8
    float s[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < SB / 2; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax in place (log2 domain); the mask only where a row's
    // limit falls inside the tile
    const bool masked = k0 + kMmaKeys - 1 > lim_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? softcap_logit(s[j][e] * scale, softcap) *
                                      kLog2e
                                : s[j][e] * qk_scale;
        if (masked && k0 + j * 8 + tig * 2 + (e & 1) > (e < 2 ? lim_a : lim_b))
          x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0 so that nothing becomes NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + rs_a;  // this thread's columns; summed over the quad
    l_b = l_b * al_b + rs_b;  // at the end
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V: the S fragments of keys 16kk .. 16kk + 15 are P's A operand
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wrow0 + gid + 8 * half;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    bf16* op = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
               tig * 2;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

// ---- the tensor-core kernel at D 256 (bf16): two warps per 16 rows, each
// on half of the head dim

constexpr int kD256 = 256;
constexpr int kHalfD = kD256 / 2;
constexpr int kWideKeys = 64;           // keys per K/V tile
constexpr int kWideMaxThreads = 256;    // 64 rows: 4 pairs of warps

constexpr size_t d256_smem_bytes(int rows, int stages) {
  return (size_t)2 * (kD256 + 8) * (rows + stages * 2 * kWideKeys);
}

__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

__global__ void __launch_bounds__(kWideMaxThreads)
flash_prefill_d256_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ pos,
                          __nv_bfloat16* __restrict__ out, int C, int H,
                          int Hkv, int Smax, int stages, float scale,
                          float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr int D = kD256;
  constexpr int LD = D + 8;             // padded row (elements)
  constexpr int CH = D / 8;             // 16-byte chunks per row
  constexpr int KS = kHalfD / 16;       // k-steps of the half Q K^T
  constexpr int NB = kHalfD / 8;        // 8-column blocks of the half O
  constexpr int SB = kWideKeys / 8;     // 8-key blocks of S
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int nthr = blockDim.x, rows = nthr / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp >> 1, half = warp & 1;  // 16-row block, half of D
  const int gid = lane >> 2, tig = lane & 3;  // fragment row, column pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [rows][LD]
  bf16* ring = Qs + rows * LD;                   // stages x {K, V} [64][LD]
  // once Q is in registers, a pair's 16 Q rows (8448 bytes) hold its two
  // S partials (2 x 4096 bytes), one per warp
  float* xbuf = reinterpret_cast<float*>(Qs + rw * 16 * LD);
  float* own = xbuf + half * SB * 4 * 32;
  const float* other = xbuf + (1 - half) * SB * 4 * 32;

  const int n_rows = C * G, row0 = tile * rows, p0 = pos[b];
  // last visible key of a row; rows past C*G take the last row's
  auto limit = [&](int row) {
    return min(p0 + min(row, n_rows - 1) / G, Smax - 1);
  };
  const int kv_end = limit(row0 + rows - 1) + 1;  // keys [0, kv_end)
  const int n_tiles = (kv_end + kWideKeys - 1) / kWideKeys;

  for (int i = tid; i < rows * CH; i += nthr) {
    const int r = i / CH, cc = i - r * CH, row = row0 + r;
    const bool ok = row < n_rows;
    const int qi = ok ? row / G : 0, g = ok ? row - qi * G : 0;
    cp_async16(Qs + r * LD + cc * 8,
               q + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
                   cc * 8,
               ok);
  }
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      bf16* Kt = ring + (size_t)(t % stages) * 2 * kWideKeys * LD;
      bf16* Vt = Kt + kWideKeys * LD;
      for (int i = tid; i < kWideKeys * CH; i += nthr) {
        const int r = i / CH, cc = i - r * CH, key = t * kWideKeys + r;
        const bool ok = key < kv_end;
        const size_t off =
            (((size_t)b * Smax + (ok ? key : 0)) * Hkv + hk) * D + cc * 8;
        cp_async16(Kt + r * LD + cc * 8, k + off, ok);
        cp_async16(Vt + r * LD + cc * 8, v + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);  // Q joins tile 0

  const int wrow0 = row0 + rw * 16;
  const bool warp_live = wrow0 < n_rows;
  const int lim_a = limit(wrow0 + gid), lim_b = limit(wrow0 + gid + 8);
  const int lim_lo = limit(wrow0), lim_hi = limit(wrow0 + 15);
  const float qk_scale = scale * kLog2e;
  const int col0 = half * kHalfD;  // this warp's columns of Q, K, V and O

  uint32_t qf[KS][4];
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(stages - 2);  // tile t (and Q) landed, this thread's part
    __syncthreads();            // ... everyone's; tile t - 1 is consumed
    load_tile(t + stages - 1);
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (rw * 16 + (lane & 15)) * LD + col0 +
                                kk * 16 + (lane >> 4) * 8);
      pair_sync(rw);  // both halves hold Q before its rows take S
    }
    const int k0 = t * kWideKeys;
    if (!warp_live || k0 > lim_hi) continue;  // nothing visible to the pair
    const bf16* Kt = ring + (size_t)(t % stages) * 2 * kWideKeys * LD;
    const bf16* Vt = Kt + kWideKeys * LD;

    // this half's part of S = Q K^T: s[j] holds keys k0 + 8j .. +7 of rows
    // gid and gid + 8
    float s[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < SB / 2; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + col0 + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // the two halves' partials through shared memory: both warps add the
    // same two numbers (a + b == b + a exactly), so both hold the same S.
    // The __syncthreads at the next tile's top orders the next write after
    // the partner's read.
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) own[(j * 4 + e) * 32 + lane] = s[j][e];
    pair_sync(rw);
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += other[(j * 4 + e) * 32 + lane];

    // online softmax in place (log2 domain), the same in both halves; the
    // mask only where a row's limit falls inside the tile
    const bool masked = k0 + kWideKeys - 1 > lim_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? softcap_logit(s[j][e] * scale, softcap) *
                                      kLog2e
                                : s[j][e] * qk_scale;
        if (masked && k0 + j * 8 + tig * 2 + (e & 1) > (e < 2 ? lim_a : lim_b))
          x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0 so that nothing becomes NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + rs_a;  // this thread's columns; summed over the quad
    l_b = l_b * al_b + rs_b;  // at the end
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V on this half's columns: the S fragments of keys 16kk ..
    // 16kk + 15 are P's A operand
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kHalfD / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  col0 + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wrow0 + gid + 8 * hr;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    bf16* op = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
               col0 + tig * 2;
    const float inv = hr ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) = __floats2bfloat162_rn(
          o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

// ---- the 3xTF32 tensor-core kernel: f32, D in {64, 80, 128}

constexpr int kTfKeys = 64;                   // keys per K/V tile
constexpr int kTfGroups = 2;                  // warps per 16 rows
constexpr int kTfGroupKeys = kTfKeys / kTfGroups;
constexpr int kTfMaxThreads = 64 / 16 * kTfGroups * 32;  // 64 rows

constexpr size_t tf32_smem_bytes(int D, int stages) {
  return (size_t)4 * (D + 4) * stages * 2 * kTfKeys;
}

template <int D>
__global__ void __launch_bounds__(kTfMaxThreads)
flash_prefill_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ pos, float* __restrict__ out,
                          int C, int H, int Hkv, int Smax, int stages,
                          float scale, float softcap) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 4;                  // padded row (floats)
  constexpr int CH = D / 4;                  // 16-byte chunks per row
  constexpr int KS = D / 8;                  // k-steps of Q K^T
  constexpr int NB = D / 8;                  // 8-column blocks of O
  constexpr int SB = kTfGroupKeys / 8;       // 8-key blocks of S
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int nthr = blockDim.x, n_rw = nthr / (32 * kTfGroups);
  const int rows = 16 * n_rw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % n_rw, grp = warp / n_rw;  // row block, key group
  const int gid = lane >> 2, tig = lane & 3;      // fragment row, column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // stages x {K, V}

  const int n_rows = C * G, row0 = tile * rows, p0 = pos[b];
  // last visible key of a row; rows past C*G take the last row's
  auto limit = [&](int row) {
    return min(p0 + min(row, n_rows - 1) / G, Smax - 1);
  };
  const int kv_end = limit(row0 + rows - 1) + 1;  // keys [0, kv_end)
  const int n_tiles = (kv_end + kTfKeys - 1) / kTfKeys;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      float* Kt = ring + (size_t)(t % stages) * 2 * kTfKeys * LD;
      float* Vt = Kt + kTfKeys * LD;
      for (int i = tid; i < kTfKeys * CH; i += nthr) {
        const int r = i / CH, cc = i - r * CH, key = t * kTfKeys + r;
        const bool ok = key < kv_end;
        const size_t off =
            (((size_t)b * Smax + (ok ? key : 0)) * Hkv + hk) * D + cc * 4;
        cp_async16(Kt + r * LD + cc * 4, k + off, ok);
        cp_async16(Vt + r * LD + cc * 4, v + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  const int wrow0 = row0 + rw * 16;
  const bool warp_live = wrow0 < n_rows;
  const int lim_a = limit(wrow0 + gid), lim_b = limit(wrow0 + gid + 8);
  const int lim_lo = limit(wrow0), lim_hi = limit(wrow0 + 15);
  const float qk_scale = scale * kLog2e;

  // Q's A fragments from global memory, once (zero past C*G)
  float qf[KS][4];
  {
    auto qrow = [&](int row) -> const float* {
      if (row >= n_rows) return nullptr;
      const int qi = row / G, g = row - qi * G;
      return q + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D;
    };
    const float* qa = qrow(wrow0 + gid);
    const float* qb = qrow(wrow0 + gid + 8);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c0 = kk * 8 + tig;
      qf[kk][0] = qa ? qa[c0] : 0.f;
      qf[kk][1] = qb ? qb[c0] : 0.f;
      qf[kk][2] = qa ? qa[c0 + 4] : 0.f;
      qf[kk][3] = qb ? qb[c0 + 4] : 0.f;
    }
  }
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(stages - 2);  // tile t landed, this thread's part
    __syncthreads();            // ... everyone's; tile t - 1 is consumed
    load_tile(t + stages - 1);
    const int k0 = t * kTfKeys + grp * kTfGroupKeys;  // this warp's keys
    if (!warp_live || k0 > lim_hi) continue;  // nothing visible to the warp
    const float* Kt = ring + (size_t)(t % stages) * 2 * kTfKeys * LD +
                      grp * kTfGroupKeys * LD;
    const float* Vt = Kt + kTfKeys * LD;

    // S = Q K^T: s[j] holds keys k0 + 8j .. +7 of rows gid and gid + 8
    float s[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const Tf32Frag qa = split_frag(qf[kk][0], qf[kk][1], qf[kk][2],
                                     qf[kk][3]);
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const float* kr = Kt + (j * 8 + gid) * LD + kk * 8 + tig;
        mma_3xtf32(s[j], qa, kr[0], kr[4]);
      }
    }

    // online softmax in place (log2 domain); the mask only where a row's
    // limit falls inside the warp's keys
    const bool masked = k0 + kTfGroupKeys - 1 > lim_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? softcap_logit(s[j][e] * scale, softcap) *
                                      kLog2e
                                : s[j][e] * qk_scale;
        if (masked && k0 + j * 8 + tig * 2 + (e & 1) > (e < 2 ? lim_a : lim_b))
          x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0 so that nothing becomes NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + rs_a;  // this thread's columns; summed over the quad
    l_b = l_b * al_b + rs_b;  // at the end
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V: the S accumulator of keys 8j .. 8j + 7 is P's A operand as
    // (c0, c2, c1, c3); V's B fragment from key rows 2t and 2t + 1
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const Tf32Frag pa = split_frag(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* vr = Vt + (j * 8 + 2 * tig) * LD + gid;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mma_3xtf32(o[n], pa, vr[n * 8], vr[n * 8 + LD]);
    }
  }

  // merge the key groups in group order: group 1 hands its (m, l, O) over
  // through the ring (every copy has landed: later groups are empty)
  __syncthreads();
  float* mb = ring + (size_t)rw * (NB * 4 + 4) * 32 + lane;
  if (grp == 1 && warp_live) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mb[(n * 4 + e) * 32] = o[n][e];
    mb[(NB * 4 + 0) * 32] = m_a;
    mb[(NB * 4 + 1) * 32] = m_b;
    mb[(NB * 4 + 2) * 32] = l_a;
    mb[(NB * 4 + 3) * 32] = l_b;
  }
  __syncthreads();
  if (grp != 0 || !warp_live) return;
  {
    const float pm_a = mb[(NB * 4 + 0) * 32], pm_b = mb[(NB * 4 + 1) * 32];
    const float mn_a = fmaxf(m_a, pm_a), mn_b = fmaxf(m_b, pm_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float sa = exp2f(m_a - base_a), pa = exp2f(pm_a - base_a);
    const float sb = exp2f(m_b - base_b), pb = exp2f(pm_b - base_b);
    l_a = l_a * sa + mb[(NB * 4 + 2) * 32] * pa;
    l_b = l_b * sb + mb[(NB * 4 + 3) * 32] * pb;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] = o[n][0] * sa + mb[(n * 4 + 0) * 32] * pa;
      o[n][1] = o[n][1] * sa + mb[(n * 4 + 1) * 32] * pa;
      o[n][2] = o[n][2] * sb + mb[(n * 4 + 2) * 32] * pb;
      o[n][3] = o[n][3] * sb + mb[(n * 4 + 3) * 32] * pb;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wrow0 + gid + 8 * half;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    float* op = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
                tig * 2;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

// ---- the 3xTF32 tensor-core kernel at D 256 (f32): four warps per 16 rows
// on quarters of the head dim, in two key groups

constexpr int kTqD = 256;
constexpr int kTqCols = kTqD / 4;            // a warp's columns of Q, K, V, O
constexpr int kTqGroups = 2;                 // key groups per 16 rows
constexpr int kTqRows = 16;                  // rows per CTA
constexpr int kTqKeys = 32;                  // keys per K/V tile
constexpr int kTqThreads = kTqRows / 16 * 4 * kTqGroups * 32;

constexpr size_t tf32_256_smem_bytes(int stages) {
  // the K/V ring, then each key group's four S partials of 16 rows x
  // kTqKeys / 2
  return (size_t)4 * (stages * 2 * kTqKeys * (kTqD + 4) +
                      kTqRows * 4 * kTqKeys);
}

__device__ __forceinline__ void quad_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id + 1) : "memory");
}

__global__ void __launch_bounds__(kTqThreads)
flash_prefill_tf32_256_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ pos,
                              float* __restrict__ out, int C, int H, int Hkv,
                              int Smax, int stages, float scale,
                              float softcap) {
  constexpr int D = kTqD;
  constexpr int LD = D + 4;             // padded row (floats)
  constexpr int CH = D / 4;             // 16-byte chunks per row
  constexpr int KS = kTqCols / 8;       // k-steps of the quarter's Q K^T
  constexpr int NB = kTqCols / 8;       // 8-column blocks of the quarter's O
  constexpr int KEYS = kTqKeys;
  constexpr int GK = KEYS / kTqGroups;  // a group's keys of every tile
  constexpr int SB = GK / 8;            // 8-key blocks of its S
  constexpr int PART = SB * 4 * 32;     // one warp's S partial (floats)
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, qd = warp & 3;  // key group, quarter of D
  const int gid = lane >> 2, tig = lane & 3;  // fragment row, column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // stages x {K, V}
  float* xbuf = ring + (size_t)stages * 2 * KEYS * LD + grp * 4 * PART;
  float* own = xbuf + qd * PART;

  const int n_rows = C * G, row0 = tile * kTqRows, p0 = pos[b];
  // last visible key of a row; rows past C*G take the last row's
  auto limit = [&](int row) {
    return min(p0 + min(row, n_rows - 1) / G, Smax - 1);
  };
  const int kv_end = limit(row0 + kTqRows - 1) + 1;  // keys [0, kv_end)
  const int n_tiles = (kv_end + KEYS - 1) / KEYS;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      float* Kt = ring + (size_t)(t % stages) * 2 * KEYS * LD;
      float* Vt = Kt + KEYS * LD;
      for (int i = tid; i < KEYS * CH; i += kTqThreads) {
        const int r = i / CH, cc = i - r * CH, key = t * KEYS + r;
        const bool ok = key < kv_end;
        const size_t off =
            (((size_t)b * Smax + (ok ? key : 0)) * Hkv + hk) * D + cc * 4;
        cp_async16(Kt + r * LD + cc * 4, k + off, ok);
        cp_async16(Vt + r * LD + cc * 4, v + off, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages - 1; ++s) load_tile(s);

  const bool live = row0 < n_rows;
  const int lim_a = limit(row0 + gid), lim_b = limit(row0 + gid + 8);
  const int lim_lo = limit(row0), lim_hi = limit(row0 + 15);
  const float qk_scale = scale * kLog2e;
  const int col0 = qd * kTqCols;  // this warp's columns

  // Q's A fragments of this quarter from global memory, split once (zero
  // past C*G)
  Tf32Frag qs[KS];
  {
    auto qrow = [&](int row) -> const float* {
      if (row >= n_rows) return nullptr;
      const int qi = row / G, g = row - qi * G;
      return q + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D + col0;
    };
    const float* qa = qrow(row0 + gid);
    const float* qb = qrow(row0 + gid + 8);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c0 = kk * 8 + tig;
      qs[kk] = split_frag(qa ? qa[c0] : 0.f, qb ? qb[c0] : 0.f,
                          qa ? qa[c0 + 4] : 0.f, qb ? qb[c0 + 4] : 0.f);
    }
  }
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(stages - 2);  // tile t landed, this thread's part
    __syncthreads();            // ... everyone's; tile t - 1 is consumed
    load_tile(t + stages - 1);
    const int k0 = t * KEYS + grp * GK;  // this group's keys
    if (!live || k0 > lim_hi) continue;  // nothing visible to the group
    const float* Kt = ring + (size_t)(t % stages) * 2 * KEYS * LD +
                      grp * GK * LD;
    const float* Vt = Kt + KEYS * LD;

    // this quarter's part of S = Q K^T: s[j] holds keys k0 + 8j .. +7 of
    // rows gid and gid + 8
    float s[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const float* kr = Kt + (j * 8 + gid) * LD + col0 + kk * 8 + tig;
        mma_3xtf32(s[j], qs[kk], kr[0], kr[4]);
      }
    }
    // the four quarters' partials through shared memory, added by every
    // warp of the group in quarter order, so that all four hold the same
    // S bit for bit. The __syncthreads at the next tile's top orders the
    // next write after the partners' reads.
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) own[(j * 4 + e) * 32 + lane] = s[j][e];
    quad_sync(grp);
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (j * 4 + e) * 32 + lane;
        s[j][e] = ((xbuf[i] + xbuf[PART + i]) + xbuf[2 * PART + i]) +
                  xbuf[3 * PART + i];
      }

    // online softmax in place (log2 domain), the same in the group's four
    // warps; the mask only where a row's limit falls inside its keys
    const bool masked = k0 + GK - 1 > lim_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? softcap_logit(s[j][e] * scale, softcap) *
                                      kLog2e
                                : s[j][e] * qk_scale;
        if (masked && k0 + j * 8 + tig * 2 + (e & 1) > (e < 2 ? lim_a : lim_b))
          x = -INFINITY;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0 so that nothing becomes NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + rs_a;  // this thread's columns; summed over the quad
    l_b = l_b * al_b + rs_b;  // of lanes at the end
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V on this quarter's columns: the S accumulator of keys 8j ..
    // 8j + 7 is P's A operand as (c0, c2, c1, c3); V's B fragment from key
    // rows 2t and 2t + 1
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      const Tf32Frag pa = split_frag(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* vr = Vt + (j * 8 + 2 * tig) * LD + col0 + gid;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mma_3xtf32(o[n], pa, vr[n * 8], vr[n * 8 + LD]);
    }
  }

  // merge the key groups in group order: group 1 hands its (m, l, O) over
  // through the ring (every copy has landed: later groups are empty)
  __syncthreads();
  float* mb = ring + (size_t)qd * (NB * 4 + 4) * 32 + lane;
  if (grp == 1 && live) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mb[(n * 4 + e) * 32] = o[n][e];
    mb[(NB * 4 + 0) * 32] = m_a;
    mb[(NB * 4 + 1) * 32] = m_b;
    mb[(NB * 4 + 2) * 32] = l_a;
    mb[(NB * 4 + 3) * 32] = l_b;
  }
  __syncthreads();
  if (grp != 0 || !live) return;
  {
    const float pm_a = mb[(NB * 4 + 0) * 32], pm_b = mb[(NB * 4 + 1) * 32];
    const float mn_a = fmaxf(m_a, pm_a), mn_b = fmaxf(m_b, pm_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float sa = exp2f(m_a - base_a), pa = exp2f(pm_a - base_a);
    const float sb = exp2f(m_b - base_b), pb = exp2f(pm_b - base_b);
    l_a = l_a * sa + mb[(NB * 4 + 2) * 32] * pa;
    l_b = l_b * sb + mb[(NB * 4 + 3) * 32] * pb;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] = o[n][0] * sa + mb[(n * 4 + 0) * 32] * pa;
      o[n][1] = o[n][1] * sa + mb[(n * 4 + 1) * 32] * pa;
      o[n][2] = o[n][2] * sb + mb[(n * 4 + 2) * 32] * pb;
      o[n][3] = o[n][3] * sb + mb[(n * 4 + 3) * 32] * pb;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + gid + 8 * hr;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    float* op = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * D +
                col0 + tig * 2;
    const float inv = hr ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(op + n * 8) =
          make_float2(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

// ---- the Hopper kernel: bf16 at D 128 on long chunks (the training loss);
// see the file's header for the design

constexpr int kWgD = 128;
constexpr int kWgRows = 128;      // (query, head) rows per CTA
constexpr int kWgKeys = 128;      // keys per K/V tile
constexpr int kWgHalf = 64;       // columns of one 128-byte swizzled box
constexpr int kWgConsumers = 8;   // warps of the two consumer warpgroups
// + the producer warpgroup (one thread of it issues every copy): whole
// warpgroups, so that setmaxnreg can move its registers to the consumers
constexpr int kWgThreads = (kWgConsumers + 4) * 32;
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 240;
constexpr int kWgGroupPairs = 4;  // (kv head, batch row) pairs in flight
constexpr int kWgQBytes = kWgRows * kWgD * 2;         // Q: 32 KB
constexpr int kWgTileBytes = kWgKeys * kWgD * 2;      // K or V: 32 KB
constexpr int kWgBoxBytes = kWgTileBytes / 2;         // one 64-column half

// the plan's shared memory: 1024 bytes to align the swizzled tiles, Q, the
// ring of K and V tiles, then the barriers
constexpr size_t wgmma_smem_bytes(int stages) {
  return (size_t)1024 + kWgQBytes + (size_t)stages * 2 * kWgTileBytes + 128;
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const int* __restrict__ pos,
                           __nv_bfloat16* __restrict__ out, int C, int H,
                           int Hkv, int Smax, int stages, float scale,
                           float softcap) {
  using bf16 = __nv_bfloat16;
  const int G = H / Hkv;
  // longest first, a few (kv head, batch row) pairs at a time: the CTAs
  // the hardware starts first (lowest linear index) take the last row tile
  // of each pair of the first group of kWgGroupPairs, then the one before,
  // ...; then the next group. The CTAs in flight share the K/V of a group
  // (kWgGroupPairs x 2 MB at the training shape), which stays in L2
  const int n_row_tiles = gridDim.x, pairs = Hkv * gridDim.z;
  const int lin = blockIdx.x + n_row_tiles * (blockIdx.y + Hkv * blockIdx.z);
  const int group = lin / (kWgGroupPairs * n_row_tiles);
  const int in_group = min(kWgGroupPairs, pairs - group * kWgGroupPairs);
  const int idx = lin - group * kWgGroupPairs * n_row_tiles;
  const int tile = n_row_tiles - 1 - idx / in_group;
  const int pair = group * kWgGroupPairs + idx % in_group;
  const int hk = pair % Hkv, b = pair / Hkv;

  extern __shared__ unsigned char wg_smem[];
  unsigned char* base =
      wg_smem + ((1024u - (smem_addr(wg_smem) & 1023u)) & 1023u);
  bf16* Qs = reinterpret_cast<bf16*>(base);  // 2 halves x [128 rows][64]
  unsigned char* ring = base + kWgQBytes;    // stages x {K 2 halves, V 2}
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + (size_t)stages * 2 * kWgTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + stages;

  const int n_rows = C * G, row0 = tile * kWgRows, p0 = pos[b];
  // last visible key of a row; rows past C*G take the last row's
  auto limit = [&](int row) {
    return min(p0 + min(row, n_rows - 1) / G, Smax - 1);
  };
  const int kv_end = limit(row0 + kWgRows - 1) + 1;  // keys [0, kv_end)
  const int n_tiles = (kv_end + kWgKeys - 1) / kWgKeys;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kWgConsumers) {
    // the producer warpgroup gives up its registers; one thread keeps the
    // ring full by TMA. Q's rows are (position, head) pairs, row = qi * G
    // + g: the box {64 columns, G heads, 128 / G positions} lands them in
    // that order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kWgProducerRegs));
    if (warp == kWgConsumers && lane == 0) {
      mbar_expect_tx(q_full, kWgQBytes);
      for (int h = 0; h < 2; ++h)
        tma_load_4d(Qs + h * kWgRows * kWgHalf, &tm_q, q_full, h * kWgHalf,
                    hk * G, row0 / G, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(empty + s, (t / stages - 1) & 1);
        unsigned char* kt = ring + (size_t)s * 2 * kWgTileBytes;
        mbar_expect_tx(full + s, 2 * kWgTileBytes);
        for (int h = 0; h < 2; ++h) {
          tma_load_4d(kt + h * kWgBoxBytes, &tm_k, full + s, h * kWgHalf, hk,
                      t * kWgKeys, b);
          tma_load_4d(kt + kWgTileBytes + h * kWgBoxBytes, &tm_v, full + s,
                      h * kWgHalf, hk, t * kWgKeys, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // a thread holds rows gid and gid + 8 of its warp's 16
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kWgConsumerRegs));
  const int wg = warp >> 2, wq = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow0 = row0 + wg * 64;
  const bool live = wrow0 < n_rows;
  const int r_a = wrow0 + wq * 16 + gid;
  const int lim_a = limit(r_a), lim_b = limit(r_a + 8);
  const int lim_lo = limit(wrow0);
  const float qk_scale = scale * kLog2e;

  float o[2][32];  // O's two 64-column halves
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
  float sc[64];           // S of the tile in flight, then its p
  uint32_t pa[8][4];      // P (bf16) of the previous tile: P.V's A operand
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  auto release = [&](int t) {  // this warp is done with tile t's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % stages);
  };
  // ping-pong: the two warpgroups issue their products in turns (named
  // barrier 1 + w: warpgroup w's turn), so that one's products run while
  // the other does its softmax
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
  };
  auto fence_o_p = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(o[h][i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) reg_fence_u32(pa[kk][r]);
  };
  // S = Q K^T of tile t (64 x 128 keys) issued: both operands K-major
  auto issue_s = [&](int t) {
    const unsigned char* kt = ring + (size_t)(t % stages) * 2 * kWgTileBytes;
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk) {
      const int h = kk / 4, kq = kk % 4;
      const uint64_t da = wgmma_desc(
          Qs + h * kWgRows * kWgHalf + wg * 64 * kWgHalf + kq * 16, 0, 1024);
      const uint64_t db = wgmma_desc(kt + h * kWgBoxBytes + kq * 32, 0,
                                     1024);
      wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t issued: P from registers, V MN-major, O's two
  // 64-column halves (its 64 registers in order) one n128 product over
  // V's two boxes (16 KB apart: the descriptor's leading byte offset)
  auto issue_pv = [&](int t) {
    const unsigned char* vt =
        ring + (size_t)(t % stages) * 2 * kWgTileBytes + kWgTileBytes;
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk)
      wgmma_rs_n128_tb(o[0], pa[kk],
                       wgmma_desc(vt + kk * 16 * 128, kWgBoxBytes, 1024));
    wgmma_commit();
  };
  // online softmax on S of the tile at key k0, in place (log2 domain):
  // sc[4j + e] holds key k0 + 8j + 2 tig + (e & 1) of row gid (e < 2) or
  // gid + 8; the mask only where a row's limit falls inside the tile.
  // Leaves p in sc; returns each row's rescale of O and l and its sum
  auto softmax = [&](int k0, float& al_a, float& al_b, float& rs_a,
                     float& rs_b) {
    // the logits in sc stay unscaled without a softcap (the scale is > 0,
    // so the max commutes with it) and go into the exponent by one FFMA
    const bool capped = softcap > 0.f;
    const float mul = capped ? kLog2e : qk_scale;
    const bool masked = k0 + kWgKeys - 1 > lim_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int e = i & 3;
      float x = capped ? softcap_logit(sc[i] * scale, softcap) : sc[i];
      if (masked && k0 + (i >> 2) * 8 + tig * 2 + (e & 1) >
                        (e < 2 ? lim_a : lim_b))
        x = -INFINITY;
      sc[i] = x;
      if (e < 2) mx_a = fmaxf(mx_a, x);
      else mx_b = fmaxf(mx_b, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * mul), mn_b = fmaxf(m_b, mx_b * mul);
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0 so that nothing becomes NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    al_a = fast_exp2(m_a - base_a);
    al_b = fast_exp2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    rs_a = rs_b = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const bool ra = (i & 3) < 2;
      sc[i] = fast_exp2(fmaf(sc[i], mul, -(ra ? base_a : base_b)));
      if (ra) rs_a += sc[i];
      else rs_b += sc[i];
    }
  };
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  mbar_wait(q_full, 0);
  if (wg == 1) turn_pass();  // warpgroup 0 goes first

  // both warpgroups walk all n_tiles (a tile past a row's limit is masked
  // whole and adds nothing), so that their turns pair up
  {
    // tile 0: S, then its softmax (O is still 0)
    float al_a, al_b, rs_a, rs_b;
    mbar_wait(full, 0);
    turn_wait();
    wgmma_fence();
    issue_s(0);
    turn_pass();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
    softmax(0, al_a, al_b, rs_a, rs_b);
    l_a = rs_a;
    l_b = rs_b;
    to_p();
    // tile t: its S and tile t - 1's P.V in flight together; the softmax
    // of tile t runs while P.V does
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(full + t % stages, (t / stages) & 1);
      fence_o_p();
      turn_wait();
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      turn_pass();
      wgmma_wait<1>();  // S of tile t
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      softmax(t * kWgKeys, al_a, al_b, rs_a, rs_b);
      wgmma_wait<0>();  // P.V of tile t - 1
      fence_o_p();
      release(t - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[h][i] *= (i & 3) < 2 ? al_a : al_b;
      l_a = l_a * al_a + rs_a;  // this thread's columns; summed over the
      l_b = l_b * al_b + rs_b;  // quad at the end
      to_p();
    }
    fence_o_p();
    turn_wait();
    wgmma_fence();
    issue_pv(n_tiles - 1);
    if (wg == 0) turn_pass();  // warpgroup 1's last turn passes to no one
    wgmma_wait<0>();
    fence_o_p();
    release(n_tiles - 1);
  }

  if (!live) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r_a + 8 * hr;
    if (row >= n_rows) continue;
    const int qi = row / G, g = row - qi * G;
    bf16* op = out + (((size_t)b * C + qi) * H + (size_t)hk * G + g) * kWgD +
               tig * 2;
    const float inv = hr ? inv_b : inv_a;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + h * kWgHalf + j * 8) =
            __floats2bfloat162_rn(o[h][4 * j + 2 * hr] * inv,
                                  o[h][4 * j + 2 * hr + 1] * inv);
  }
}

// ---- launches

template <typename T, int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          const int* pos, void* out, int B, int C, int H,
                          int Hkv, int Smax, float scale, float softcap,
                          int grid_x, int smem, cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_scalar_kernel<T, D>, smem,
                               smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  flash_prefill_scalar_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), C, H, Hkv, Smax,
      scale, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* pos, void* out, int B, int C, int H,
                       int Hkv, int Smax, float scale, float softcap,
                       int grid_x, int rows, int stages, int smem,
                       cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_mma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  flash_prefill_mma_kernel<D><<<grid, rows * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos,
      static_cast<__nv_bfloat16*>(out), C, H, Hkv, Smax, stages, scale,
      softcap);
  return cudaGetLastError();
}

cudaError_t launch_d256(const void* q, const void* k, const void* v,
                        const int* pos, void* out, int B, int C, int H,
                        int Hkv, int Smax, float scale, float softcap,
                        int grid_x, int rows, int stages, int smem,
                        cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_d256_kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  flash_prefill_d256_kernel<<<grid, rows * 4, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos,
      static_cast<__nv_bfloat16*>(out), C, H, Hkv, Smax, stages, scale,
      softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const int* pos, void* out, int B, int C, int H,
                        int Hkv, int Smax, float scale, float softcap,
                        int grid_x, int rows, int stages, int smem,
                        cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_tf32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  const int threads = rows * 2 * kTfGroups;
  flash_prefill_tf32_kernel<D><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos, static_cast<float*>(out), C, H, Hkv,
      Smax, stages, scale, softcap);
  return cudaGetLastError();
}

cudaError_t launch_tf32_256(const void* q, const void* k, const void* v,
                            const int* pos, void* out, int B, int C, int H,
                            int Hkv, int Smax, float scale, float softcap,
                            int grid_x, int stages, int smem,
                            cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_tf32_256_kernel, smem,
                               smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  flash_prefill_tf32_256_kernel<<<grid, kTqThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos, static_cast<float*>(out), C, H, Hkv,
      Smax, stages, scale, softcap);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// -lcuda at link time); null where the driver does not give it
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &got);
#endif
    if (err != cudaSuccess || got != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 tensor [d3][d2][d1][d0] (d0 innermost) read in boxes
// {64, box1, box2, 1}: 128-byte rows, swizzled as wgmma reads them,
// elements past an edge read as zeros
bool bf16_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
              uint64_t d2, uint64_t d3, uint32_t box1, uint32_t box2) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kWgHalf, box1, box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* pos, void* out, int B, int C, int H,
                         int Hkv, int Smax, float scale, float softcap,
                         int grid_x, int stages, int smem,
                         cudaStream_t stream) {
  const int G = H / Hkv;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!bf16_map(&tm_q, q, kWgD, H, C, B, G, kWgRows / G) ||
      !bf16_map(&tm_k, k, kWgD, Hkv, Smax, B, 1, kWgKeys) ||
      !bf16_map(&tm_v, v, kWgD, Hkv, Smax, B, 1, kWgKeys))
    return cudaErrorInvalidValue;
  static int smem_set = 0;
  cudaError_t err = allow_smem(flash_prefill_wgmma_kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(grid_x, Hkv, B);
  flash_prefill_wgmma_kernel<<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, pos, static_cast<__nv_bfloat16*>(out), C, H, Hkv,
      Smax, stages, scale, softcap);
  return cudaGetLastError();
}

// the head dims without a tensor-core instance (16 and 32)
template <typename T>
cudaError_t dispatch_scalar(const void* q, const void* k, const void* v,
                            const int* pos, void* out, int B, int C, int H,
                            int Hkv, int Smax, int D, float scale,
                            float softcap, int grid_x, int smem,
                            cudaStream_t s) {
#define REPRO_SCALAR(d)                                                     \
  case d:                                                                   \
    return launch_scalar<T, d>(q, k, v, pos, out, B, C, H, Hkv, Smax,      \
                               scale, softcap, grid_x, smem, s)
  switch (D) {
    REPRO_SCALAR(16);
    REPRO_SCALAR(32);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SCALAR
}

bool tensor_core_dim(int D) { return D == 64 || D == 80 || D == 128; }

// The plan from kernels/flash_attention/ops.py::plan, bounds-checked (its
// shared memory must cover what the kernel indexes), then the kernel it
// names: by (dtype, D), the bf16 tensor-core kernel at D 64/80/128 or at
// D 256, the 3xTF32 one for f32 at D 64/80/128 or at D 256, or the scalar
// one for the rest (D 16 and 32). No kernel is tried in place of another.
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* pos, void* out, int B, int C, int H, int Hkv,
                     int Smax, int D, int dtype, float scale, float softcap,
                     int grid_x, int rows, int stages, int smem,
                     cudaStream_t s) {
  const int n_rows = C * (H / Hkv);
  if (rows <= 0 || grid_x != (n_rows + rows - 1) / rows || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (dtype != kBFloat16 && dtype != kFloat32) return cudaErrorInvalidValue;
  const bool bf16 = dtype == kBFloat16;
  if (D == kTqD && !bf16) {  // its plan's shared memory, exactly: a bf16
                             // D 256 plan at 16 rows has more
    if (rows != kTqRows || stages < 2 || stages > 3 ||
        (size_t)smem != tf32_256_smem_bytes(stages))
      return cudaErrorInvalidValue;
    return launch_tf32_256(q, k, v, pos, out, B, C, H, Hkv, Smax, scale,
                           softcap, grid_x, stages, smem, s);
  }
  if (bf16 && D == kWgD && rows == kWgRows) {  // the Hopper instance
    if (kWgRows % (H / Hkv) != 0 || stages != 3 ||
        (size_t)smem != wgmma_smem_bytes(stages))
      return cudaErrorInvalidValue;
    return launch_wgmma(q, k, v, pos, out, B, C, H, Hkv, Smax, scale,
                        softcap, grid_x, stages, smem, s);
  }
  if (tensor_core_dim(D)) {
    const size_t need = bf16 ? mma_smem_bytes(D, rows, stages)
                             : tf32_smem_bytes(D, stages);
    if ((rows != 16 && rows != 32 && rows != 64) || stages < 2 ||
        stages > (bf16 ? 4 : 3) || (size_t)smem < need)
      return cudaErrorInvalidValue;
#define REPRO_TC(d)                                                         \
  case d:                                                                   \
    return bf16 ? launch_mma<d>(q, k, v, pos, out, B, C, H, Hkv, Smax,     \
                                scale, softcap, grid_x, rows, stages, smem, \
                                s)                                          \
                : launch_tf32<d>(q, k, v, pos, out, B, C, H, Hkv, Smax,    \
                                 scale, softcap, grid_x, rows, stages,     \
                                 smem, s)
    switch (D) {
      REPRO_TC(64);
      REPRO_TC(80);
      REPRO_TC(128);
      default: return cudaErrorInvalidValue;
    }
#undef REPRO_TC
  }
  if (D == kD256) {  // bf16 here: f32 took the 3xTF32 kernel above
    if ((rows != 16 && rows != 32 && rows != 64) || stages < 2 ||
        stages > 3 || (size_t)smem < d256_smem_bytes(rows, stages))
      return cudaErrorInvalidValue;
    return launch_d256(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap,
                       grid_x, rows, stages, smem, s);
  }
  if (rows != kRows || stages != 1 || (size_t)smem < scalar_smem_bytes(D))
    return cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return dispatch_scalar<__nv_bfloat16>(q, k, v, pos, out, B, C, H, Hkv,
                                          Smax, D, scale, softcap, grid_x,
                                          smem, s);
  return dispatch_scalar<float>(q, k, v, pos, out, B, C, H, Hkv, Smax, D,
                                scale, softcap, grid_x, smem, s);
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); head_dim D in {16, 32, 64, 80, 128, 256}.
// grid_x, rows (per CTA), stages and smem (dynamic shared memory bytes)
// are kernels/flash_attention/ops.py::plan's, checked here.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   const int* pos, void* out, int B, int C,
                                   int H, int Hkv, int Smax, int D, int dtype,
                                   float scale, float softcap, int grid_x,
                                   int rows, int stages, int smem,
                                   void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || C < 1) return cudaErrorInvalidValue;
  return repro::dispatch(q, k, v, pos, out, B, C, H, Hkv, Smax, D, dtype,
                         scale, softcap, grid_x, rows, stages, smem,
                         static_cast<cudaStream_t>(stream));
}
