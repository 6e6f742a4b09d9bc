// Flash attention for chunked prefill against the paged cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention (body _attn_kernel), widened to what the serving path's
// chunk_prefill_attention (src/repro/models/attention.py:204) computes:
// query i of row b attends to cache positions kv_pos <= pos[b] + i (its
// prior context plus the chunk's own causal prefix), with ragged chunk
// length C and cache length Smax masked instead of asserted. At pos = 0 and
// C = Smax this is the Pallas kernel's causal attention.
//
// Layout: q [B,C,H,D]; caches [B,Smax,Hkv,D] (the flat view of the paged
// cache, read in place); pos int32 [B]; out [B,C,H,D] in q's dtype.
//
// What bounds it on an H100: counting each input read once, the bytes of q,
// the output and the visible K/V at the serving path's shapes (a 256-token
// chunk at offsets below ~1000); operations only once the prior context is
// several chunks long, since each K/V row serves C*G query rows (~512
// flop/byte at C=256, G=2, against the card's ~295 ridge). Either way the
// cost of this first version is its arithmetic: scalar f32 FMAs out of
// shared memory, not tensor cores. A CTA owns 64 (query, head) rows of
// one kv head, stages 64-key K/V tiles in shared memory as f32, and keeps
// the online-softmax state (m, l, acc) in registers, 4 rows x D/16 columns
// per thread. KV tiles wholly past the tile's last visible key
// (pos[b] + its last query) are never loaded, as the Pallas kernel skips
// blocks above the diagonal. mma.sync / wgmma tiles are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kKeys = 64;      // keys per KV tile
constexpr int kThreads = 256;  // 16 (rows/4) x 16 (keys, columns)

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * kRows * (D + 1) + kRows * (kKeys + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, void* out, int B, int C, int H, int Hkv,
                   int Smax, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int n_rows = C * (H / Hkv);
  dim3 grid((n_rows + kRows - 1) / kRows, Hkv, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), C, H, Hkv, Smax,
      scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int* pos, void* out, int B, int C, int H,
                       int Hkv, int Smax, int D, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    case 32: return launch<T, 32>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    case 64: return launch<T, 64>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    case 80: return launch<T, 80>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    case 128: return launch<T, 128>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    case 256: return launch<T, 256>(q, k, v, pos, out, B, C, H, Hkv, Smax, scale, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); head_dim D in {16, 32, 64, 80, 128, 256}.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   const int* pos, void* out, int B, int C,
                                   int H, int Hkv, int Smax, int D, int dtype,
                                   float scale, float softcap, void* stream) {
  if (H % Hkv != 0 || C < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::dispatch_d<__nv_bfloat16>(q, k, v, pos, out, B, C, H, Hkv,
                                            Smax, D, scale, softcap, s);
  if (dtype == repro::kFloat32)
    return repro::dispatch_d<float>(q, k, v, pos, out, B, C, H, Hkv, Smax, D,
                                    scale, softcap, s);
  return cudaErrorInvalidValue;
}
