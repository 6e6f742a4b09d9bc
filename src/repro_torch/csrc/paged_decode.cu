// Paged flash-decode: one new query token per slot against that slot's KV
// pages, with a per-slot length, as one pipelined split-K launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// paged_flash_decode (body _decode_kernel), widened from its one scalar
// kv_len to kv_len[B] so that it serves the continuous-batching decode tick
// (the reference tick runs the jnp _flash_decode_partial,
// src/repro/models/attention.py:135, for that reason).
//
// Layout: q [B,1,H,D]; pages [B,P,page,Hkv,D] read in place as the flat
// [B,Smax,Hkv,D] view; kv_len int32 [B]; out [B,1,H,D] in q's dtype.
// Softmax in f32 (base 2, the scale folded into log2 e); P.V multiplies f32
// p by v widened to f32, as the serving path does (attention.py:173-174).
//
// The int8 mode (the Pallas kernel's quant=True, kernel.py:50-54) reads
// int8 codes [B,P,page,Hkv,D] in place and multiplies each code by its
// page's f32 scale [B,P,Hkv], the product of the reference's
// dequantize_pages. The serving step attends to the new token at full
// precision before it requantizes (src/repro/models/attention.py:322-347),
// so the row fresh[b] (one rank: min(pos[b], Smax-1)) comes from
// new_k/new_v [B,1,Hkv,D] in q's dtype, substituted element by element
// after the code x scale product; fresh[b] < 0 substitutes no row (a rank
// of a page-sharded cache that does not hold pos). The kernel writes no
// page. In both modes row b attends over [0, min(kv_len[b], Smax)).
//
// Optionally (out_f32 and out_ml not null) the output is written in f32 to
// out_f32 [B,1,H,D] instead of out, with each (slot, query head)'s softmax
// max m (base 2: the log2 e-scaled logit) and sum l in out_ml [B,H,2]: the
// partials a rank of a page-sharded cache gives to the cross-rank combine
// (models/attention.py). A slot with no visible token gives m = -inf,
// l = 0 and a zero output.
//
// What bounds it on an H100: the K/V bytes it reads. Each (b, kv head)
// serves G query rows, so there are ~2G flops per K/V byte, far below
// the card's ~295 flop/byte ridge: tensor cores add no rate here (the
// tensor-core instance below takes them to spare per-token work). At
// qwen3-1.7b's decode tick (8 slots x 2048 tokens, Hkv 8, D 128, bf16) the
// visible K/V of chip_smoke.py's ragged lengths is 31.8 MB: 0.0095 ms at
// 3.35 TB/s, and 0.0048 ms for the int8 codes; this kernel takes ~3.6x
// and ~6x that on an H100 SXM at 700 W (chip_smoke.py; PERF.md), where the
// two-pass version it replaces took ~13x and ~22x. The lanes instance
// (paged_decode_kernel; plan "lanes") is about bytes in flight:
// - grid (splits, Hkv x group chunks, B), 128 threads. A split is a whole
//   number of pages (256 tokens at the path's shapes: 8 splits x 8 kv
//   heads x 8 slots = 512 CTAs, 2048 at zamba2-2.7b's 32 kv heads); splits
//   at or past a slot's length exit before reading a byte.
// - every K/V read is a 16-byte cp.async (8 bf16, 16 int8 codes or 4 f32)
//   into a ring of `stages` (4) shared-memory tiles of K and V. A tile is
//   4 rows per thread-row-slot (32 tokens of bf16 at D 128, 64 of int8:
//   8 KB each of K and V) and never crosses a page, so the int8 mode reads
//   one scale per tile and kv head. Each thread reads back only the chunks
//   it copied itself, so the loop needs cp.async.wait_group and no barrier.
// - a token row is spread over a group of `lanes` = pow2ceil(D*bytes/16)
//   lanes (the plan's), one 16-byte chunk each (D 80 bf16: 10 of 16 lanes
//   work); q.k is a chunk dot and log2(lanes) xor shuffles; each thread
//   keeps its own online-softmax state (m, l, acc for its chunk's columns)
//   across the split's tiles, so no [G, split] score array exists.
// - at the split's end the row slots are merged, by shuffles inside a warp
//   and once through shared memory across the 4 warps; the split writes
//   (acc, m, l) to a workspace, and the last CTA of its (b, kv head, group
//   chunk), found by an atomic counter once every thread's stores are
//   fenced (__threadfence, then a barrier), merges the splits in split
//   order (no float atomics: bit-identical run to run) and resets the
//   counter. A slot with one split writes out directly. One launch per
//   call.
// A CTA takes `group_rows` query heads of its kv head, padded to GM = 2
// or 8 (compile-time; the plan's group_pad names the instance), so q's
// chunk and the accumulator live in registers; where GM x elements per
// chunk > 32 (bf16 and int8 at more than 2 rows), q stays in shared memory
// as f32 instead. A group of more than 8 query heads (glm4-9b's 16,
// starcoder2-15b's 12) is split over ceil(G / 8) CTAs of equal rows (8 + 8,
// 6 + 6) on the grid's kv-head axis: each reads the split's K/V pages, so
// the bytes grow with the CTAs (x2 at G 12 and 16), where a 16-row
// instance would hold acc[16][E] and a [4][16] score block in registers
// (over 255 at D 128 in bf16 and int8, so spills).
//
// The tensor-core instance (paged_decode_mma_kernel; plan "mma", gm 16),
// in place of the same TPU kernel (src/repro/kernels/decode_attention/
// kernel.py:79), for bf16 q over bf16 or int8 pages at D 128 and 256 with
// up to 16 query heads a kv head; plan() routes groups of 4 or more to it
// (gemma-2b's one kv head of 8 at D 256, the VLM's G 4, starcoder2-15b's
// G 12, glm4-9b's G 16). Bytes bound it as they do the lanes instance
// (gemma-2b's tick: 9.6 MB of visible K/V, 0.0024 ms at 3.35 TB/s; 0.0012
// ms for the int8 codes), and there the lanes instance spent its time
// elsewhere: a 512-byte bf16 row takes a whole warp, so it scored one
// token at a time with 5 xor shuffles per query head, and its 64 CTAs
// left most of the card idle. This one:
// - puts the group's query heads on the 16 rows of mma.sync.m16n8k16
//   products (padding up to 16): S[16 x 32] = Q K^T with K by ldmatrix
//   from the tile, then P V with V by ldmatrix.trans, softmax state per
//   row in registers; no per-token shuffles. Each of the 4 warps owns a
//   quarter of the head dim: its partial S over its columns goes through
//   shared memory and all four add the four partials in warp order, so
//   every warp holds the same S and runs the same softmax, then multiplies
//   P by its columns of V. P goes into the product as a bf16 high part
//   plus the bf16 rounding of the rest, so that the f32 output of
//   return_ml carries f32 accuracy;
// - splits the cache into 32-token tiles (inside a page: the int8 mode
//   reads one scale a tile) and splits of the lanes instance's size,
//   halved until the grid has 2 x 132 CTAs at the cache's length (gemma-
//   2b: 64 splits of 32 tokens, 512 CTAs); 16-byte cp.async into a ring
//   of up to 2 tiles; the last CTA of a (slot, kv head) merges the splits
//   in split order (each split's m and l into shared memory, each row's
//   weights once, then float4 sums; no float atomics);
// - int8: widens a tile's codes to bf16 in shared memory (exact: |code| <=
//   127) and folds the page scales in where that is exact: the K scale
//   into S's columns, the V scale into P's; the row fresh[b] is new_k /
//   new_v as given (bf16), with scale 1.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md): at
// gemma-2b's tick ~0.021 ms in bf16 and ~0.022 ms in int8, against
// ~0.22 and ~0.17 ms for the lanes instance and ~0.062 / ~0.097 ms for
// SDPA / dequantize + SDPA; ~0.016-0.025 ms at the D 128 groups, 3-7x
// faster than the lanes instance there.
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;        // query heads a CTA takes
constexpr int kRowsPerThread = 4;   // tile rows a thread scores per tile
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block can use

// one 16-byte chunk of KV elements in shared memory, widened to f32
template <typename KV>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const unsigned char* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void load(const unsigned char* p, float* x) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int E = 16;
  __device__ static void load(const unsigned char* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(c[i]);
  }
};

// q in shared memory when its chunk would take more than 32 registers
__host__ __device__ constexpr bool q_in_smem(int gm, int elems) {
  return gm * elems > 32;
}

// The dynamic shared memory the kernel indexes: q (when staged), then the
// K/V ring, which the cross-warp merge reuses. The plan may give more.
size_t smem_needed(int kv_bytes, int gm, int D, int tile, int stages) {
  const size_t ring = (size_t)stages * 2 * tile * D * kv_bytes;
  const size_t merge = (size_t)kWarps * gm * (D + 2) * sizeof(float);
  const size_t qs = q_in_smem(gm, 16 / kv_bytes) ? (size_t)gm * D * 4 : 0;
  return qs + (ring > merge ? ring : merge);
}

// kQuant (KV = int8): codes scaled per (b, page, kv head), and the row
// fresh_at[b] (when >= 0) comes from new_k/new_v. Else KV is T. The grid's
// y axis is (kv head, group chunk); a CTA takes query heads
// [g0, g0 + group_rows) of its kv head, cut to G.
template <typename T, typename KV, int GM>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const T* __restrict__ new_k, const T* __restrict__ new_v,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ fresh_at, T* __restrict__ out,
                    float* __restrict__ out_f32, float* __restrict__ out_ml,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ counters,
                    int H, int Hkv, int Smax, int page, int D, int split,
                    int tile, int stages, int lanes, int group_rows,
                    float scale, float softcap) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int E = Chunk<KV>::E;
  constexpr bool kQSmem = q_in_smem(GM, E);
  const int si = blockIdx.x, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int n_gc = gridDim.y / Hkv;
  const int hk = blockIdx.y / n_gc, gc = blockIdx.y - hk * n_gc;
  const int G = H / Hkv;
  const int g0 = gc * group_rows;
  const int Gl = min(group_rows, G - g0);  // this CTA's query heads
  const int len = min(kv_len[b], Smax);
  const int n_active = max(1, (len + split - 1) / split);
  if (si >= n_active) return;  // past the slot's length: read nothing
  const int t0 = si * split;
  const int n_tok = max(0, min(split, len - t0));
  int fresh = -1;  // split-local row of the new token, if this split has it
  if constexpr (kQuant) {
    const int fa = fresh_at[b];
    fresh = fa >= 0 ? fa - t0 : -1;
  }

  const int n_chunks = D / E;
  const int n_slots = kThreads / lanes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid & (lanes - 1), slot = tid / lanes;
  const bool has_c = c < n_chunks;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (kQSmem ? (size_t)GM * D * sizeof(float) : 0);
  const size_t tile_bytes = (size_t)tile * D * sizeof(KV);

  const size_t row0 = (size_t)b * H + (size_t)hk * G + g0;  // first head
  const T* qb = q + row0 * D;
  float qr[kQSmem ? 1 : GM][kQSmem ? 1 : E];
  if constexpr (kQSmem) {
    for (int i = tid; i < Gl * D; i += kThreads) q_s[i] = to_f32(qb[i]);
    __syncthreads();
  } else {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[g][e] = (g < Gl && has_c) ? to_f32(qb[g * D + c * E + e]) : 0.f;
  }
  auto qval = [&](int g, int e) -> float {
    if constexpr (kQSmem) return q_s[g * D + c * E + e];
    else return qr[g][e];
  };

  const size_t tok_stride = (size_t)Hkv * D;
  const size_t chunk_off = ((size_t)b * Smax + t0) * tok_stride +
                           (size_t)hk * D + (size_t)c * E;
  const KV* kb = k + chunk_off;
  const KV* vb = v + chunk_off;
  const size_t new_off = ((size_t)b * Hkv + hk) * D + (size_t)c * E;
  const int n_tiles = (n_tok + tile - 1) / tile;

  // tile j's rows of this thread's chunk -> ring stage j % stages
  auto issue = [&](int j) {
    if (j < n_tiles && has_c) {
      unsigned char* kt = ring + (size_t)(j % stages) * 2 * tile_bytes;
      unsigned char* vt = kt + tile_bytes;
      for (int r = slot; r < tile; r += n_slots) {
        const int t = j * tile + r;
        if (t < n_tok) {
          const size_t so = ((size_t)r * D + (size_t)c * E) * sizeof(KV);
          cp_async16(kt + so, kb + (size_t)t * tok_stride);
          cp_async16(vt + so, vb + (size_t)t * tok_stride);
        }
      }
    }
    cp_async_commit();
  };

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const float qk_scale = scale * kLog2e;

  for (int s = 0; s < stages - 1; ++s) issue(s);
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait(stages - 2);  // this thread's copies of tile j landed
    issue(j + stages - 1);      // into the stage it read at tile j - 1
    const unsigned char* kt = ring + (size_t)(j % stages) * 2 * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      const size_t at = ((size_t)b * (Smax / page) + (t0 + j * tile) / page)
                        * Hkv + hk;
      ksc = k_scale[at];
      vsc = v_scale[at];
    }

    // scores of this thread's rows of the tile (log2 domain)
    float s[kRowsPerThread][GM];
    bool ok[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = slot + i * n_slots;
      const int t = j * tile + r;
      ok[i] = r < tile && t < n_tok;
      float kf[E];
      if (ok[i] && has_c) {
        Chunk<KV>::load(kt + ((size_t)r * D + (size_t)c * E) * sizeof(KV),
                        kf);
        if (kQuant && t == fresh) {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] = to_f32(new_k[new_off + e]);
        } else if (kQuant) {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[e] *= ksc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < Gl) {
          float d = 0.f;
          if (has_c) {
#pragma unroll
            for (int e = 0; e < E; ++e) d += qval(g, e) * kf[e];
          }
          for (int off = lanes >> 1; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          const float x = softcap > 0.f
                              ? softcap_logit(d * scale, softcap) * kLog2e
                              : d * qk_scale;
          s[i][g] = ok[i] ? x : -INFINITY;
        }
      }
    }

    // online softmax over the split: rescale once per tile
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < Gl) {
        float mt = s[0][g];
#pragma unroll
        for (int i = 1; i < kRowsPerThread; ++i) mt = fmaxf(mt, s[i][g]);
        const float mn = fmaxf(m[g], mt);
        if (mn != -INFINITY) {
          const float alpha = exp2f(m[g] - mn);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
          m[g] = mn;
        }
      }
    }

    // P.V over the same rows
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (!ok[i]) continue;
      const int r = slot + i * n_slots;
      float vf[E];
      if (has_c) {
        Chunk<KV>::load(vt + ((size_t)r * D + (size_t)c * E) * sizeof(KV),
                        vf);
        if (kQuant && j * tile + r == fresh) {
#pragma unroll
          for (int e = 0; e < E; ++e) vf[e] = to_f32(new_v[new_off + e]);
        } else if (kQuant) {
#pragma unroll
          for (int e = 0; e < E; ++e) vf[e] *= vsc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < Gl) {
          const float p = exp2f(s[i][g] - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += p * vf[e];
        }
      }
    }
  }

  // merge the row slots of a warp (lanes of one chunk, xor lanes, 2 lanes..)
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < Gl) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        float ao[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        const float mn = fmaxf(m[g], mo);
        if (mn != -INFINITY) {
          const float wa = exp2f(m[g] - mn), wb = exp2f(mo - mn);
          l[g] = l[g] * wa + lo * wb;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * wa + ao[e] * wb;
          m[g] = mn;
        }
      }
    }
  }

  // ... then the 4 warps once, through shared memory (the ring's bytes)
  float* w_acc = reinterpret_cast<float*>(ring);     // [kWarps][GM][D]
  float* w_ml = w_acc + (size_t)kWarps * GM * D;     // [kWarps][GM][2]
  __syncthreads();  // every thread is done with the ring
  if (lane < lanes && has_c) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < Gl) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          w_acc[((size_t)warp * GM + g) * D + c * E + e] = acc[g][e];
        if (c == 0) {
          w_ml[(warp * GM + g) * 2] = m[g];
          w_ml[(warp * GM + g) * 2 + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();

  const bool single = n_active == 1;
  const size_t part0 = (size_t)(b * Hkv + hk) * n_splits;
  // the normalised output (q's dtype, or f32 with m and l)
  auto emit = [&](int i, float a, float mx, float lsum) {
    const float o = a / fmaxf(lsum, 1e-30f);
    if (out_f32 != nullptr) {
      out_f32[row0 * D + i] = o;
      if (i % D == 0) {
        out_ml[(row0 + i / D) * 2] = mx;
        out_ml[(row0 + i / D) * 2 + 1] = lsum;
      }
    } else {
      store_f32(o, out + row0 * D + i);
    }
  };
  for (int i = tid; i < Gl * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_ml[(w * GM + g) * 2]);
    float a = 0.f, lsum = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = exp2f(w_ml[(w * GM + g) * 2] - mx);
        lsum += w_ml[(w * GM + g) * 2 + 1] * wt;
        a += w_acc[((size_t)w * GM + g) * D + d] * wt;
      }
    }
    if (single) {
      emit(i, a, mx, lsum);
    } else {
      part_acc[(part0 + si) * G * D + (size_t)g0 * D + i] = a;
      if (d == 0) {
        part_ml[((part0 + si) * G + g0 + g) * 2] = mx;
        part_ml[((part0 + si) * G + g0 + g) * 2 + 1] = lsum;
      }
    }
  }
  if (single) return;

  // the last split of this (b, kv head, group chunk) to finish merges all
  // of them; every thread fences its own partial stores and the barrier
  // waits for all of them before one thread counts the split done
  int* counter = counters + ((size_t)b * Hkv + hk) * n_gc + gc;
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(counter, 1) == n_active - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  for (int i = tid; i < Gl * D; i += kThreads) {
    const int g = g0 + i / D;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      mx = fmaxf(mx, __ldcg(part_ml + ((part0 + sp) * G + g) * 2));
    float a = 0.f, lsum = 0.f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < n_active; ++sp) {  // split order
        const float wt =
            exp2f(__ldcg(part_ml + ((part0 + sp) * G + g) * 2) - mx);
        lsum += __ldcg(part_ml + ((part0 + sp) * G + g) * 2 + 1) * wt;
        a += __ldcg(part_acc + (part0 + sp) * G * D + (size_t)g0 * D + i)
             * wt;
      }
    }
    emit(i, a, mx, lsum);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// ---- the tensor-core instance: bf16 q, bf16 or int8 pages, D 128 / 256

constexpr int kMmaRows = 16;     // the group's query heads, padded: one M tile
constexpr int kMmaQuarters = 4;  // warps: each owns a quarter of the head dim
constexpr int kMmaTile = 32;     // tokens per K/V tile

// The dynamic shared memory the tensor-core instance indexes: q's 16 rows,
// the ring of K/V tiles (bf16 rows padded to D + 8; int8: the codes, then
// one bf16 tile pair they are widened into), the warps' S partials (which
// the last split's merge reuses for each split's m and l).
size_t mma_smem_needed(int kv_bytes, int D, int stages, int n_splits) {
  const size_t row = (size_t)(D + 8) * 2;
  const size_t bf16_tiles = (size_t)2 * kMmaTile * row;
  const size_t ring = kv_bytes == 1
                          ? (size_t)stages * 2 * kMmaTile * D + bf16_tiles
                          : (size_t)stages * bf16_tiles;
  const size_t sx = (size_t)kMmaQuarters * (kMmaTile / 2) * 32;
  const size_t merge = ((size_t)2 * n_splits + 3) * kMmaRows;
  return kMmaRows * row + ring + (sx > merge ? sx : merge) * sizeof(float);
}

// the two int8 codes in bits [shift, shift + 16) of `word` as a bf16x2
// (exact: |code| <= 127)
__device__ __forceinline__ uint32_t widen2(uint32_t word, int shift) {
  const int lo = static_cast<int8_t>((word >> shift) & 0xffu);
  const int hi = static_cast<int8_t>((word >> (shift + 8)) & 0xffu);
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// One CTA per (split, kv head, slot), 4 warps. The G query heads are the
// rows of m16n8k16 products (padded to 16); warp w owns columns [w D/4,
// (w + 1) D/4) of q, K and V. Per tile: each warp's partial S over its
// columns, the four summed through shared memory in warp order (so every
// warp holds the same S, bit for bit, and runs the same online softmax),
// then P times its columns of V, with P split into a bf16 high part and
// the bf16 rounding of the rest (two products): ~2^-17 relative, so the
// f32 output of return_ml meets the f32 tolerance. kQuant (KV = int8): a
// tile's codes are widened to bf16 in shared memory (exact: |code| <= 127)
// and its page's scales folded in where the arithmetic stays exact: the K
// scale into S's columns, the V scale into P's, except on the row
// fresh_at[b] (when >= 0), which is new_k / new_v as given (bf16, scale 1).
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const KV* __restrict__ k, const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const __nv_bfloat16* __restrict__ new_k,
                        const __nv_bfloat16* __restrict__ new_v,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ fresh_at,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ out_f32,
                        float* __restrict__ out_ml,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int* __restrict__ counters, int H, int Hkv, int Smax,
                        int page, int split, int stages, float scale,
                        float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int LD = D + 8;              // padded bf16 row (elements)
  constexpr int DW = D / kMmaQuarters;   // a warp's columns
  constexpr int KS = DW / 16;            // its k-steps of Q K^T
  constexpr int NB = DW / 8;             // its 8-column blocks of O
  constexpr int CH = D * (int)sizeof(KV) / 16;  // 16-byte chunks of a row
  constexpr int tile = kMmaTile, SB = tile / 8;  // 8-key blocks of S
  const int si = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / Hkv;
  const int len = min(kv_len[b], Smax);
  const int n_active = max(1, (len + split - 1) / split);
  if (si >= n_active) return;  // past the slot's length: read nothing
  const int t0 = si * split;
  const int n_tok = max(0, min(split, len - t0));
  const int n_tiles = (n_tok + tile - 1) / tile;
  int fresh = -1;  // split-local row of the new token, if this split has it
  if constexpr (kQuant) {
    const int fa = fresh_at[b];
    fresh = fa >= 0 ? fa - t0 : -1;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);            // [16][LD]
  unsigned char* ring = smem + (size_t)kMmaRows * LD * 2;
  const size_t code_bytes = (size_t)tile * D;          // int8 codes of K
  const size_t tile_bytes = (size_t)tile * LD * 2;     // a bf16 K tile
  const size_t slot_bytes = kQuant ? 2 * code_bytes : 2 * tile_bytes;
  bf16* wide = reinterpret_cast<bf16*>(ring + (size_t)stages * slot_bytes);
  float* Sx = reinterpret_cast<float*>(
      ring + (size_t)stages * slot_bytes + (kQuant ? 2 * tile_bytes : 0));

  const size_t row0 = (size_t)b * H + (size_t)hk * G;  // first query head
  for (int i = tid; i < kMmaRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    cp_async16(Qs + r * LD + c * 8, q + (row0 + (r < G ? r : 0)) * D + c * 8,
               r < G);
  }
  cp_async_commit();

  const size_t tok_stride = (size_t)Hkv * D;
  const KV* kb = k + ((size_t)b * Smax + t0) * tok_stride + (size_t)hk * D;
  const KV* vb = v + ((size_t)b * Smax + t0) * tok_stride + (size_t)hk * D;
  // tile j's rows -> ring slot j % stages; rows past the split's tokens
  // are zero-filled (a zero V row times p = 0 adds nothing)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      unsigned char* kt = ring + (size_t)(j % stages) * slot_bytes;
      unsigned char* vt = kt + slot_bytes / 2;
      for (int i = tid; i < tile * CH; i += kThreads) {
        const int r = i / CH, c = i - r * CH, t = j * tile + r;
        const bool ok = t < n_tok;
        const size_t src = (size_t)(ok ? t : 0) * tok_stride + c * 16 /
                           sizeof(KV);
        const size_t dst = kQuant ? (size_t)r * D + c * 16
                                  : ((size_t)r * LD + c * 8) * 2;
        cp_async16(kt + dst, kb + src, ok);
        cp_async16(vt + dst, vb + src, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < stages; ++s) issue(s);

  uint32_t qf[KS][4];  // this warp's q fragments, loaded at the first tile
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float qk_scale = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    // this thread's copies of tile j (and q) landed: the groups committed
    // after it are those of tiles j + 1 .. j + stages - 1 (empty past the
    // split)
    cp_async_wait(stages - 1);
    const unsigned char* kt = ring + (size_t)(j % stages) * slot_bytes;
    const bf16* Kt = reinterpret_cast<const bf16*>(kt);
    const bf16* Vt = reinterpret_cast<const bf16*>(kt + slot_bytes / 2);
    if constexpr (kQuant) {
      // widen the chunks this thread copied: the codes, or the new row
      const bf16* fresh_row[2] = {new_k + ((size_t)b * Hkv + hk) * D,
                                  new_v + ((size_t)b * Hkv + hk) * D};
      for (int i = tid; i < tile * CH; i += kThreads) {
        const int r = i / CH, c = i - r * CH;
        const bool is_fresh = j * tile + r == fresh;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const int8_t* codes = reinterpret_cast<const int8_t*>(
              kt + kv * code_bytes + (size_t)r * D + c * 16);
          bf16* dst = wide + (size_t)kv * tile * LD + (size_t)r * LD + c * 16;
          uint4 lo, hi;
          if (is_fresh) {
            lo = *reinterpret_cast<const uint4*>(fresh_row[kv] + c * 16);
            hi = *reinterpret_cast<const uint4*>(fresh_row[kv] + c * 16 + 8);
          } else {
            const uint4 u = *reinterpret_cast<const uint4*>(codes);
            lo = make_uint4(widen2(u.x, 0), widen2(u.x, 16), widen2(u.y, 0),
                            widen2(u.y, 16));
            hi = make_uint4(widen2(u.z, 0), widen2(u.z, 16), widen2(u.w, 0),
                            widen2(u.w, 16));
          }
          *reinterpret_cast<uint4*>(dst) = lo;
          *reinterpret_cast<uint4*>(dst + 8) = hi;
        }
      }
      Kt = wide;
      Vt = wide + (size_t)tile * LD;
    }
    __syncthreads();  // tile j (widened) and q are everyone's
    // the tile's page scales (1 and 1 over bf16 pages) and its column of
    // the new row (none: -1)
    float ksc = 1.f, vsc = 1.f;
    int fcol = -1;
    if constexpr (kQuant) {
      const size_t at = ((size_t)b * (Smax / page) + (t0 + j * tile) / page)
                        * Hkv + hk;
      ksc = k_scale[at];
      vsc = v_scale[at];
      fcol = fresh - j * tile;
    }
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + (lane & 15) * LD + warp * DW + kk * 16 +
                                (lane >> 4) * 8);
    }

    // this warp's partial S = Q K^T over its columns; s[jb] holds keys
    // 8jb .. 8jb + 7 of rows gid and gid + 8
    float s[SB][4];
#pragma unroll
    for (int jb = 0; jb < SB; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < SB / 2; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 LD + warp * DW + kk * 16 +
                             ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // ... summed over the four warps in warp order
#pragma unroll
    for (int jb = 0; jb < SB; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Sx[((warp * SB + jb) * 4 + e) * 32 + lane] = s[jb][e];
    __syncthreads();
    const bool masked = (j + 1) * tile > n_tok;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int jb = 0; jb < SB; ++jb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = jb * 8 + tig * 2 + (e & 1);  // in the tile
        float d = Sx[((0 * SB + jb) * 4 + e) * 32 + lane];
#pragma unroll
        for (int w = 1; w < kMmaQuarters; ++w)
          d += Sx[((w * SB + jb) * 4 + e) * 32 + lane];
        if (kQuant && key != fcol) d *= ksc;
        float x = softcap > 0.f ? softcap_logit(d * scale, softcap) * kLog2e
                                : d * qk_scale;
        if (masked && j * tile + key >= n_tok)
          x = -INFINITY;
        s[jb][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // every tile holds a visible token of the split, so the max is finite
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int jb = 0; jb < SB; ++jb) {
      s[jb][0] = exp2f(s[jb][0] - mn_a);
      s[jb][1] = exp2f(s[jb][1] - mn_a);
      s[jb][2] = exp2f(s[jb][2] - mn_b);
      s[jb][3] = exp2f(s[jb][3] - mn_b);
      rs_a += s[jb][0] + s[jb][1];
      rs_b += s[jb][2] + s[jb][3];
    }
    l_a = l_a * al_a + rs_a;  // this thread's keys; summed over the quad
    l_b = l_b * al_b + rs_b;  // at the end
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V over this warp's columns: P (times each row's V scale)
    // from the S fragments of keys 16kk .. 16kk + 15 as the A operand, in a
    // bf16 high part and a bf16 low part; V by ldmatrix.trans
    if constexpr (kQuant) {
#pragma unroll
      for (int jb = 0; jb < SB; ++jb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (jb * 8 + tig * 2 + (e & 1) != fcol) s[jb][e] *= vsc;
    }
#pragma unroll
    for (int kk = 0; kk < SB / 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = s[2 * kk + (r >> 1)] + (r & 1) * 2;
        split_bf16(pr[0], pr[1], hi[r], lo[r]);
      }
#pragma unroll
      for (int n2 = 0; n2 < DW / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  warp * DW + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], hi, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], hi, vf[2], vf[3]);
        mma_bf16(o[2 * n2], lo, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], lo, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the slot, the widened tile and Sx are free again
    issue(j + stages);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }

  const bool single = n_active == 1;
  const size_t part0 = (size_t)(b * Hkv + hk) * n_splits;
  // this thread's rows gid, gid + 8 and columns warp DW + 8n + 2tig (+1)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int g = gid + 8 * hr;
    if (g >= G) continue;
    const float mx = hr ? m_b : m_a, lsum = hr ? l_b : l_a;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = warp * DW + n * 8 + tig * 2;
      const float a0 = o[n][2 * hr], a1 = o[n][2 * hr + 1];
      if (!single) {
        float* pa = part_acc + (part0 + si) * G * D + (size_t)g * D + col;
        pa[0] = a0;
        pa[1] = a1;
      } else if (out_f32 != nullptr) {
        out_f32[(row0 + g) * D + col] = a0 * inv;
        out_f32[(row0 + g) * D + col + 1] = a1 * inv;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + g) * D + col) =
            __floats2bfloat162_rn(a0 * inv, a1 * inv);
      }
    }
    if (warp == 0 && tig == 0) {
      if (!single) {
        part_ml[((part0 + si) * G + g) * 2] = mx;
        part_ml[((part0 + si) * G + g) * 2 + 1] = lsum;
      } else if (out_ml != nullptr) {
        out_ml[(row0 + g) * 2] = mx;
        out_ml[(row0 + g) * 2 + 1] = lsum;
      }
    }
  }
  if (single) return;

  // the last split of this (b, kv head) to finish merges all of them in
  // split order: each (split, row)'s m and l into shared memory, every
  // row's weights 2^(m - max) once, then each thread's float4s of the
  // output summed over the splits
  int* counter = counters + (size_t)b * Hkv + hk;
  __threadfence();
  __syncthreads();
  int last = 0;
  if (tid == 0) last = atomicAdd(counter, 1) == n_active - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  float* wt = Sx;                                 // [n_active][16]
  float* ls = Sx + (size_t)n_active * kMmaRows;   // [n_active][16]
  float* row_ml = ls + (size_t)n_active * kMmaRows;  // [16][3]
  for (int i = tid; i < n_active * G; i += kThreads) {
    const int sp = i / G, g = i - sp * G;
    const float* ml = part_ml + ((part0 + sp) * G + g) * 2;
    wt[sp * kMmaRows + g] = __ldcg(ml);
    ls[sp * kMmaRows + g] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int sp = 0; sp < n_active; ++sp)
      mx = fmaxf(mx, wt[sp * kMmaRows + tid]);
    float lsum = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {  // split order
      const float w = exp2f(wt[sp * kMmaRows + tid] - mx);
      wt[sp * kMmaRows + tid] = w;
      lsum += ls[sp * kMmaRows + tid] * w;
    }
    row_ml[tid * 3] = mx;
    row_ml[tid * 3 + 1] = lsum;
    row_ml[tid * 3 + 2] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  constexpr int kVecs = kMmaRows * D / 4 / kThreads;  // float4s a thread
  constexpr int kChunk = 4;   // of them summed together
  constexpr int kUnroll = 4;  // splits whose loads are in flight at once
  const int n_vec = G * D / 4;
  float4 acc[kVecs];
#pragma unroll
  for (int kv = 0; kv < kVecs; ++kv) acc[kv] = make_float4(0.f, 0.f, 0.f, 0.f);
  // kUnroll splits' loads first, then their sums in split order (loads
  // past the last split or the group read nothing and add 0)
#pragma unroll
  for (int kc = 0; kc < kVecs; kc += kChunk) {
    if (kc * kThreads >= n_vec) continue;  // the same for every thread
#pragma unroll 1
    for (int sp0 = 0; sp0 < n_active; sp0 += kUnroll) {
      float4 x[kUnroll][kChunk];
      float w[kUnroll][kChunk];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int sp = sp0 + u, v4 = tid + (kc + k) * kThreads;
          const bool ok = sp < n_active && v4 < n_vec;
          x[u][k] = ok ? __ldcg(reinterpret_cast<const float4*>(
                             part_acc + (part0 + sp) * G * D) + v4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          w[u][k] = ok ? wt[sp * kMmaRows + v4 * 4 / D] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // split order
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          acc[kc + k].x += x[u][k].x * w[u][k];
          acc[kc + k].y += x[u][k].y * w[u][k];
          acc[kc + k].z += x[u][k].z * w[u][k];
          acc[kc + k].w += x[u][k].w * w[u][k];
        }
      }
    }
  }
#pragma unroll
  for (int kv = 0; kv < kVecs; ++kv) {
    const int v4 = tid + kv * kThreads;
    if (v4 >= n_vec) continue;
    const int i = v4 * 4, g = i / D;
    const float inv = row_ml[g * 3 + 2];
    const float4 o4 = make_float4(acc[kv].x * inv, acc[kv].y * inv,
                                  acc[kv].z * inv, acc[kv].w * inv);
    if (out_f32 != nullptr) {
      *reinterpret_cast<float4*>(out_f32 + row0 * D + i) = o4;
      if (i % D == 0) {
        out_ml[(row0 + g) * 2] = row_ml[g * 3];
        out_ml[(row0 + g) * 2 + 1] = row_ml[g * 3 + 1];
      }
    } else {
      __nv_bfloat162* o2 =
          reinterpret_cast<__nv_bfloat162*>(out + row0 * D + i);
      o2[0] = __floats2bfloat162_rn(o4.x, o4.y);
      o2[1] = __floats2bfloat162_rn(o4.z, o4.w);
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// The plan from kernels/decode_attention/ops.py::plan, which owns the
// layout, bounds-checked against what the kernel instance it names (gm)
// can run; 0 if it holds. The group's cut is exactly the plan's: ceil(G/8)
// CTAs of ceil(G / CTAs) rows each, on the 2-row instance at <= 2 rows.
int check_plan(int kv_bytes, int G, int Smax, int page, int D, int split,
               int n_splits, int tile, int stages, int lanes, int gm,
               int group_rows, int smem) {
  if (G < 1) return cudaErrorInvalidValue;
  if (gm == kMmaRows) {  // the tensor-core instance: the whole group in
                         // one CTA, 32-token tiles inside a page
    if (group_rows != G || G > kMmaRows || (D != 128 && D != 256) ||
        page <= 0 || Smax % page != 0 || page % kMmaTile != 0 ||
        tile != kMmaTile || split <= 0 || split % kMmaTile != 0 ||
        n_splits != (Smax + split - 1) / split || stages < 1 ||
        stages > 2 || stages > split / kMmaTile ||
        (size_t)smem < mma_smem_needed(kv_bytes, D, stages, n_splits) ||
        smem > kMaxSmem)
      return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  const int n_gc = (G + kMaxGroup - 1) / kMaxGroup;
  const int rows = (G + n_gc - 1) / n_gc;
  if (group_rows != rows || gm != (rows <= 2 ? 2 : kMaxGroup) ||
      page <= 0 || Smax % page != 0 || split <= 0 || split % page != 0 ||
      n_splits != (Smax + split - 1) / split || tile <= 0 ||
      page % tile != 0 || stages < 2 || stages > 5 ||
      (D * kv_bytes) % 16 != 0)
    return cudaErrorInvalidValue;
  // a row's chunks on one power-of-two group of lanes inside a warp; a
  // tile's rows within kRowsPerThread per row slot
  const int n_chunks = D * kv_bytes / 16;
  if (n_chunks < 1 || lanes < n_chunks || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 ||
      tile > kRowsPerThread * (kThreads / lanes))
    return cudaErrorInvalidValue;
  if ((size_t)smem < smem_needed(kv_bytes, gm, D, tile, stages) ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// One call's tensors and plan, as the C entries take them.
struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const void *new_k, *new_v;
  const int *kv_len, *fresh;
  void* out;
  float *out_f32, *out_ml, *part_acc, *part_ml;
  int* counters;
  int B, H, Hkv, Smax, page, D, split, n_splits, tile, stages, lanes, gm,
      group_rows, smem;
  float scale, softcap;
};

template <typename T, typename KV, int GM>
cudaError_t launch_gm(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;  // the attribute as last set for this instance
  if (a.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // returned here; not left for a later launch
      return err;
    }
    smem_set = a.smem;
  }
  const int G = a.H / a.Hkv;
  const int n_gc = (G + a.group_rows - 1) / a.group_rows;
  dim3 grid(a.n_splits, a.Hkv * n_gc, a.B);
  paged_decode_kernel<T, KV, GM><<<grid, kThreads, a.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale,
      static_cast<const T*>(a.new_k), static_cast<const T*>(a.new_v),
      a.kv_len, a.fresh, static_cast<T*>(a.out), a.out_f32, a.out_ml,
      a.part_acc, a.part_ml, a.counters, a.H, a.Hkv, a.Smax, a.page, a.D,
      a.split, a.tile, a.stages, a.lanes, a.group_rows, a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename KV, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err =
      allow_smem(paged_decode_mma_kernel<KV, D>, a.smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(a.n_splits, a.Hkv, a.B);
  paged_decode_mma_kernel<KV, D><<<grid, kThreads, a.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale,
      static_cast<const __nv_bfloat16*>(a.new_k),
      static_cast<const __nv_bfloat16*>(a.new_v), a.kv_len, a.fresh,
      static_cast<__nv_bfloat16*>(a.out), a.out_f32, a.out_ml, a.part_acc,
      a.part_ml, a.counters, a.H, a.Hkv, a.Smax, a.page, a.split, a.stages,
      a.scale, a.softcap);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      (a.out_f32 == nullptr) != (a.out_ml == nullptr))
    return cudaErrorInvalidValue;
  const int rc = check_plan(sizeof(KV), a.H / a.Hkv, a.Smax, a.page, a.D,
                            a.split, a.n_splits, a.tile, a.stages, a.lanes,
                            a.gm, a.group_rows, a.smem);
  if (rc != cudaSuccess) return static_cast<cudaError_t>(rc);
  if (a.gm == kMmaRows) {  // bf16 q over bf16 or int8 pages only
    if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                  !std::is_same<KV, float>::value)
      return a.D == 256 ? launch_mma<KV, 256>(a, s)
                        : launch_mma<KV, 128>(a, s);
    return cudaErrorInvalidValue;
  }
  if (a.gm == 2) return launch_gm<T, KV, 2>(a, s);
  return launch_gm<T, KV, kMaxGroup>(a, s);
}

template <bool kQuant>
int dispatch(const Args& a, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16,
                  std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(a, s);
  if (dtype == kFloat32)
    return launch<float, std::conditional_t<kQuant, int8_t, float>>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// C entries (bound with ctypes). The launch plan (split, n_splits, tile,
// stages, lanes per token row, gm = the instance's padded rows, group_rows
// = the query heads a CTA takes, smem) comes from
// kernels/decode_attention/ops.py::plan and is bounds-checked here.
// Workspace, allocated once by the caller and reused: part_acc f32
// [B,Hkv,n_splits,G,D], part_ml f32 [B,Hkv,n_splits,G,2], counters int32
// [B,Hkv,ceil(G/group_rows)], zero before the first call (the kernel leaves
// them zero). out_f32 [B,1,H,D] and out_ml [B,H,2] (f32) are both null, or
// both given: then the output goes to out_f32 with each head's m and l.
extern "C" int repro_paged_decode(
    const void* q, const void* k, const void* v, const int* kv_len,
    void* out, float* out_f32, float* out_ml, float* part_acc,
    float* part_ml, int* counters, int B, int H, int Hkv, int Smax, int page,
    int D, int split, int n_splits, int tile, int stages, int lanes, int gm,
    int group_rows, int smem, int dtype, float scale, float softcap,
    void* stream) {
  const repro::Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, kv_len,
                      nullptr, out, out_f32, out_ml, part_acc, part_ml,
                      counters, B, H, Hkv, Smax, page, D, split, n_splits,
                      tile, stages, lanes, gm, group_rows, smem, scale,
                      softcap};
  return repro::dispatch<false>(a, dtype, stream);
}

// int8 mode: k/v int8 codes [B,P,page,Hkv,D], k_scale/v_scale f32
// [B,P,Hkv], new_k/new_v [B,1,Hkv,D] and out in `dtype`; kv_len and fresh
// int32 [B] (fresh: the row new_k/new_v stand at, < 0 for none).
extern "C" int repro_paged_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const void* new_k, const void* new_v,
    const int* kv_len, const int* fresh, void* out, float* out_f32,
    float* out_ml, float* part_acc, float* part_ml, int* counters, int B,
    int H, int Hkv, int Smax, int page, int D, int split, int n_splits,
    int tile, int stages, int lanes, int gm, int group_rows, int smem,
    int dtype, float scale, float softcap, void* stream) {
  const repro::Args a{q, k, v, k_scale, v_scale, new_k, new_v, kv_len,
                      fresh, out, out_f32, out_ml, part_acc, part_ml,
                      counters, B, H, Hkv, Smax, page, D, split, n_splits,
                      tile, stages, lanes, gm, group_rows, smem, scale,
                      softcap};
  return repro::dispatch<true>(a, dtype, stream);
}
