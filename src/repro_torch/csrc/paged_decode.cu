// Paged flash-decode: one new query token per slot against that slot's KV
// pages, with a per-slot length kv_len[b].
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// paged_flash_decode (body _decode_kernel), widened from its one scalar
// kv_len to kv_len[B] so that it serves the continuous-batching decode tick
// (the reference tick runs the jnp _flash_decode_partial,
// src/repro/models/attention.py:135, for that reason).
//
// Layout: q [B,1,H,D]; pages [B,P,page,Hkv,D] read in place as the flat
// [B,Smax,Hkv,D] view (no transposed copy); kv_len int32 [B]; out [B,1,H,D]
// in q's dtype. Softmax in f32; P.V multiplies f32 p by v widened to f32,
// as the serving path does (attention.py:173-174) -- the Pallas kernel
// casts p to v's dtype first (kernel.py:69).
//
// What bounds it on an H100: the K/V bytes it reads. Each (b, kv head)
// touches G query rows, so there are ~2G flops per K/V byte -- far below
// the card's ~295 flop/byte ridge. At the serving shapes (B=8 slots,
// Hkv=8) one CTA per (b, kv head) would occupy only 64 of 132 SMs, so the
// token axis is split across CTAs (`split` tokens each, one page at the
// path's shapes): pass 1 writes each split's online-softmax partials
// (acc, m, l), pass 2 merges them with the max/sum rescale of the
// reference's cross-rank combine (attention.py:387-394). Splits at or past
// kv_len[b] exit before reading a byte, so pages past a slot's length are
// never read. Still simple: 2-byte loads, no cp.async/TMA pipelining.
//
// The int8 mode (the Pallas kernel's quant=True, kernel.py:50-54) reads
// int8 codes [B,P,page,Hkv,D] in place and multiplies each code by its
// page's f32 scale [B,P,Hkv] -- the same product as the reference's
// dequantize_pages -- so only a byte per element crosses HBM. The serving
// step attends to the new token at full precision before it requantizes
// (src/repro/models/attention.py:322-347), so that row, at
// min(pos[b], Smax-1), comes from new_k/new_v [B,1,Hkv,D] in q's dtype,
// not from the codes; the kernel writes no page. Row b attends over
// [0, min(pos[b]+1, Smax)). Everything else is the bf16 instance's.
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads per kv head

// kQuant: KV is int8 codes scaled per (b, page, kv head), `len_or_pos` is
// pos[B] and the row at min(pos, Smax-1) comes from new_k/new_v. Else KV
// is T and `len_or_pos` is kv_len[B].
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q,
                      const std::conditional_t<kQuant, int8_t, T>* __restrict__ k,
                      const std::conditional_t<kQuant, int8_t, T>* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const T* __restrict__ new_k, const T* __restrict__ new_v,
                      const int* __restrict__ len_or_pos,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int H, int Hkv, int Smax,
                      int page, int D, int split, float scale,
                      float softcap) {
  using KV = std::conditional_t<kQuant, int8_t, T>;
  const int si = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / Hkv;
  extern __shared__ float smem[];
  float* s_q = smem;               // [G, D]
  float* s_p = smem + G * D;       // [G, split]: scores, then probabilities
  float* s_vsc = s_p + G * split;  // [split] V scale per token (kQuant)

  const int len = kQuant ? min(len_or_pos[b] + 1, Smax)
                         : min(len_or_pos[b], Smax);
  const int t0 = si * split;
  const int n_tok = max(0, min(split, len - t0));
  // split-local index of the token read from new_k/new_v (-1: none)
  const int fresh = kQuant ? min(len_or_pos[b], Smax - 1) - t0 : -1;
  const size_t part = (size_t)(b * Hkv + hk) * n_splits + si;
  float* acc_out = part_acc + part * G * D;
  float* ml_out = part_ml + part * G * 2;
  if (n_tok == 0) {  // nothing of this split is visible: read nothing
    for (int i = threadIdx.x; i < G * D; i += kThreads) acc_out[i] = 0.f;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      ml_out[2 * g] = -INFINITY;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }

  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) s_q[i] = to_f32(qb[i]);
  // per-token page scale of K (and V, kept for pass 1c)
  const size_t sc_row = ((size_t)b * (Smax / page)) * Hkv + hk;
  if (kQuant)
    for (int t = threadIdx.x; t < n_tok; t += kThreads)
      s_vsc[t] = v_scale[sc_row + (size_t)((t0 + t) / page) * Hkv];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t tok_stride = (size_t)Hkv * D;
  const size_t base = ((size_t)b * Smax + t0) * tok_stride + (size_t)hk * D;
  const KV* kb = k + base;
  const KV* vb = v + base;
  const size_t new_off = ((size_t)b * Hkv + hk) * D;

  // pass 1a: one warp per token, lanes across D, f32 dot per query head
  for (int t = warp; t < n_tok; t += kWarps) {
    const KV* kr = kb + (size_t)t * tok_stride;
    const float ksc =
        kQuant ? k_scale[sc_row + (size_t)((t0 + t) / page) * Hkv] : 1.f;
    float dot[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) dot[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kd = (t == fresh) ? to_f32(new_k[new_off + d])
                                    : (kQuant ? to_f32(kr[d]) * ksc
                                              : to_f32(kr[d]));
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) dot[g] += s_q[g * D + d] * kd;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float s = seg_sum(dot[g]);
        if (lane == 0) s_p[g * split + t] = softcap_logit(s * scale, softcap);
      }
    }
  }
  __syncthreads();

  // pass 1b: split-local max and exp-sum per query head
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int t = lane; t < n_tok; t += 32) m = fmaxf(m, s_p[g * split + t]);
    m = seg_max(m);
    float l = 0.f;
    for (int t = lane; t < n_tok; t += 32) {
      const float p = expf(s_p[g * split + t] - m);
      s_p[g * split + t] = p;
      l += p;
    }
    l = seg_sum(l);
    if (lane == 0) {
      ml_out[2 * g] = m;
      ml_out[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // pass 1c: unnormalised P.V, one thread per output column
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_tok; ++t) {
      const KV c = vb[(size_t)t * tok_stride + d];
      const float vd = (t == fresh) ? to_f32(new_v[new_off + d])
                                    : (kQuant ? to_f32(c) * s_vsc[t]
                                              : to_f32(c));
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += s_p[g * split + t] * vd;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc_out[g * D + d] = acc[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ out,
                      int H, int Hkv, int D, int n_splits) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const size_t base = (size_t)(b * Hkv + hk) * n_splits;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float m_all = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      m_all = fmaxf(m_all, part_ml[(base + s) * G * 2 + 2 * g]);
    float l = 0.f, acc = 0.f;
    if (m_all != -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {
        const float w = expf(part_ml[(base + s) * G * 2 + 2 * g] - m_all);
        l += part_ml[(base + s) * G * 2 + 2 * g + 1] * w;
        acc += part_acc[(base + s) * G * D + g * D + d] * w;
      }
    }
    store_f32(acc / fmaxf(l, 1e-30f),
              out + ((size_t)b * H + (size_t)hk * G + g) * D + d);
  }
}

template <typename T, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const void* new_k, const void* new_v,
                   const int* len_or_pos, void* out, float* part_acc,
                   float* part_ml, int B, int H, int Hkv, int Smax, int page,
                   int D, int split, int n_splits, float scale, float softcap,
                   cudaStream_t stream) {
  using KV = std::conditional_t<kQuant, int8_t, T>;
  const int G = H / Hkv;
  const size_t smem =
      (size_t)(G * D + G * split + (kQuant ? split : 0)) * sizeof(float);
  dim3 grid1(n_splits, Hkv, B);
  decode_partial_kernel<T, kQuant><<<grid1, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), k_scale, v_scale,
      static_cast<const T*>(new_k), static_cast<const T*>(new_v), len_or_pos,
      part_acc, part_ml, H, Hkv, Smax, page, D, split, scale, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(Hkv, B);
  decode_combine_kernel<T><<<grid2, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), H, Hkv, D, n_splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entries (bound with ctypes). part_acc: f32 [B,Hkv,n_splits,G,D];
// part_ml: f32 [B,Hkv,n_splits,G,2]; both allocated by the caller.
extern "C" int repro_paged_decode(const void* q, const void* k, const void* v,
                                  const int* kv_len, void* out,
                                  float* part_acc, float* part_ml, int B,
                                  int H, int Hkv, int Smax, int D, int split,
                                  int n_splits, int dtype, float scale,
                                  float softcap, void* stream) {
  if (H % Hkv != 0 || H / Hkv > repro::kMaxGroup) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // page only indexes scales, which this mode has none of
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, false>(
        q, k, v, nullptr, nullptr, nullptr, nullptr, kv_len, out, part_acc,
        part_ml, B, H, Hkv, Smax, Smax, D, split, n_splits, scale, softcap, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float, false>(
        q, k, v, nullptr, nullptr, nullptr, nullptr, kv_len, out, part_acc,
        part_ml, B, H, Hkv, Smax, Smax, D, split, n_splits, scale, softcap, s);
  return cudaErrorInvalidValue;
}

// int8 mode: k/v int8 codes [B,P,page,Hkv,D], k_scale/v_scale f32
// [B,P,Hkv], new_k/new_v [B,1,Hkv,D] and out in `dtype`, pos int32 [B].
extern "C" int repro_paged_decode_int8(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const void* new_k, const void* new_v,
    const int* pos, void* out, float* part_acc, float* part_ml, int B, int H,
    int Hkv, int Smax, int page, int D, int split, int n_splits, int dtype,
    float scale, float softcap, void* stream) {
  if (H % Hkv != 0 || H / Hkv > repro::kMaxGroup || page <= 0 ||
      Smax % page != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16, true>(
        q, k, v, k_scale, v_scale, new_k, new_v, pos, out, part_acc, part_ml,
        B, H, Hkv, Smax, page, D, split, n_splits, scale, softcap, s);
  if (dtype == repro::kFloat32)
    return repro::launch<float, true>(
        q, k, v, k_scale, v_scale, new_k, new_v, pos, out, part_acc, part_ml,
        B, H, Hkv, Smax, page, D, split, n_splits, scale, softcap, s);
  return cudaErrorInvalidValue;
}
