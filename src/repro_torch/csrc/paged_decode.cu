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
// the card's ~295 flop/byte ridge, and nothing for tensor cores to do. At
// qwen3-1.7b's decode tick (8 slots x 2048 tokens, Hkv 8, D 128, bf16) the
// visible K/V of chip_smoke.py's ragged lengths is 31.8 MB: 0.0095 ms at
// 3.35 TB/s, and 0.0048 ms for the int8 codes; this kernel takes ~3.6x
// and ~6x that on an H100 SXM at 700 W (chip_smoke.py; PERF.md), where the
// two-pass version it replaces took ~13x and ~22x. The design is about
// bytes in flight:
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

// The plan from kernels/decode_attention/ops.py::plan, which owns the
// layout, bounds-checked against what the kernel instance it names (gm)
// can run; 0 if it holds. The group's cut is exactly the plan's: ceil(G/8)
// CTAs of ceil(G / CTAs) rows each, on the 2-row instance at <= 2 rows.
int check_plan(int kv_bytes, int G, int Smax, int page, int D, int split,
               int n_splits, int tile, int stages, int lanes, int gm,
               int group_rows, int smem) {
  if (G < 1) return cudaErrorInvalidValue;
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

template <typename T, typename KV>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      (a.out_f32 == nullptr) != (a.out_ml == nullptr))
    return cudaErrorInvalidValue;
  const int rc = check_plan(sizeof(KV), a.H / a.Hkv, a.Smax, a.page, a.D,
                            a.split, a.n_splits, a.tile, a.stages, a.lanes,
                            a.gm, a.group_rows, a.smem);
  if (rc != cudaSuccess) return static_cast<cudaError_t>(rc);
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
