// Chunked Mamba2 SSD scan with a carried f32 state.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan/kernel.py::ssd_scan
// (body _ssd_kernel), widened the way the serving prefill needs it: an
// optional initial state h0 (the Pallas kernel zeroes its scratch at the
// first chunk; a null h0 does the same), the final state h_last as a second
// output, and any token count S (the Pallas wrapper asserts S % chunk == 0).
//
// Layout (the model layout, read in place: no chunked copies):
//   xdt [B,S,H,P] f32   x * dt
//   bm, cm [B,S,N] f32  B and C, shared across heads
//   log_a [B,S,H] f32   per-step log decay (<= 0); the kernel takes the
//                       within-chunk cumsum itself
//   h0, h_last [B,H,P,N] f32; y [B,S,H,P] f32
//
// One CTA per (head, row) walks the tokens in sub-chunks of kQ = 64 in
// order, keeping h [P,N] in shared memory across them (the Pallas kernel's
// VMEM carry; its chunk of 256 was a VMEM size, and the SSD is the same
// function for any chunk). Per sub-chunk, with la the cumsum of log_a:
//   M    = (C B^T) . exp(la_i - la_j), causal (j <= i)
//   y    = M xdt + exp(la_i) (C h^T)
//   h   <- exp(la_last) h + sum_i exp(la_last - la_i) xdt_i (x) B_i
// Rows past S are staged as xdt = B = C = 0 and log_a = 0, which carries h
// through exactly, and are not stored.
//
// What bounds it on an H100: operations. The recurrence needs ~4 P N flops
// per (token, head), f32, against ~8 P N bytes of state per (row, head) and
// 2 P bytes of xdt/y per (token, head); the chunked form does ~4x the
// recurrence's flops to make them independent. This first version does
// them as scalar f32 FMAs from shared memory (padded rows: conflict-free
// column reads), 256 threads in a 16 x 16 grid owning 4-row x P/16-column
// tiles of M and y and P/16 x N/16 tiles of h. One CTA per (row, head)
// fills only 80 of 132 SMs at zamba2's 80 heads and B = 1; tensor cores,
// TMA and splitting the token axis across CTAs are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;         // tokens per sub-chunk
constexpr int kThreads = 256;  // 16 x 16

template <int P, int N>
constexpr size_t smem_bytes() {
  return (size_t)(P * (N + 1)         // h
                  + kQ * (P + 1)      // xdt
                  + 2 * kQ * (N + 1)  // B, C
                  + kQ * (kQ + 1)     // M
                  + 2 * kQ)           // la, exp(la_last - la)
         * sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                const float* __restrict__ cm,
                const float* __restrict__ log_a,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int H) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P, N: multiples of 16");
  constexpr int LDP = P + 1, LDN = N + 1, LDQ = kQ + 1;
  constexpr int RP = P / 16;  // y columns per thread; h rows per thread
  constexpr int RN = N / 16;  // h columns per thread
  const int hd = blockIdx.x, b = blockIdx.y;
  extern __shared__ float smem[];
  float* Hs = smem;            // [P][LDN]
  float* Xs = Hs + P * LDN;    // [kQ][LDP]
  float* Bs = Xs + kQ * LDP;   // [kQ][LDN]
  float* Cs = Bs + kQ * LDN;   // [kQ][LDN]
  float* Ms = Cs + kQ * LDN;   // [kQ][LDQ]
  float* La = Ms + kQ * LDQ;   // [kQ]
  float* Wd = La + kQ;         // [kQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const size_t h_off = ((size_t)b * H + hd) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    Hs[p * LDN + n] = h0 != nullptr ? h0[h_off + i] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int q = min(kQ, S - t0);
    __syncthreads();  // the previous sub-chunk is consumed, h is written
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      Xs[r * LDP + p] =
          r < q ? xdt[(((size_t)b * S + t0 + r) * H + hd) * P + p] : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      const size_t off = ((size_t)b * S + t0 + r) * N + n;
      Bs[r * LDN + n] = r < q ? bm[off] : 0.f;
      Cs[r * LDN + n] = r < q ? cm[off] : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum of log a: lane owns rows 2l, 2l+1
      const int r0 = 2 * tid, r1 = r0 + 1;
      const size_t base = ((size_t)b * S + t0) * H + hd;
      const float v0 = r0 < q ? log_a[base + (size_t)r0 * H] : 0.f;
      const float v1 = r1 < q ? log_a[base + (size_t)r1 * H] : 0.f;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      La[r0] = incl - v1;
      La[r1] = incl;
    }
    __syncthreads();
    const float la_last = La[kQ - 1];  // padded rows repeat the last value
    if (tid < kQ) Wd[tid] = expf(la_last - La[tid]);

    // M = (C B^T) . decay for rows ty*4+i, columns tx+16*j
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          Ms[r * LDQ + c] = c <= r ? s[i][j] * expf(La[r] - La[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M xdt + exp(la) (C h^T) for rows ty*4+i, columns tx+16*c
    {
      float acc[4][RP], ch[4][RP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[i][c] = ch[i][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        float mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = Ms[(ty * 4 + i) * LDQ + j];
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const float xv = Xs[j * LDP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += mv[i] * xv;
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LDN + n];
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const float hv = Hs[(tx + 16 * c) * LDN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i) ch[i][c] += cv[i] * hv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= q) continue;
        const float e = expf(La[r]);
        float* yr = y + (((size_t)b * S + t0 + r) * H + hd) * P;
#pragma unroll
        for (int c = 0; c < RP; ++c) yr[tx + 16 * c] = acc[i][c] + e * ch[i][c];
      }
    }
    __syncthreads();  // every read of h is done before it changes

    // h <- exp(la_last) h + sum_i (xdt_i w_i) (x) B_i, rows ty+16*a,
    // columns tx+16*c
    {
      float acc[RP][RN];
#pragma unroll
      for (int a = 0; a < RP; ++a)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int i = 0; i < kQ; ++i) {
        const float w = Wd[i];
        float xv[RP], bv[RN];
#pragma unroll
        for (int a = 0; a < RP; ++a) xv[a] = Xs[i * LDP + ty + 16 * a] * w;
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = Bs[i * LDN + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RP; ++a)
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[a][c] += xv[a] * bv[c];
      }
      const float e = expf(la_last);
#pragma unroll
      for (int a = 0; a < RP; ++a)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          float* hp = Hs + (ty + 16 * a) * LDN + tx + 16 * c;
          *hp = e * *hp + acc[a][c];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    h_last[h_off + i] = Hs[p * LDN + n];
  }
}

template <int P, int N>
cudaError_t launch(const float* xdt, const float* bm, const float* cm,
                   const float* log_a, const float* h0, float* y,
                   float* h_last, int B, int S, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<P, N><<<grid, kThreads, smem, stream>>>(
      xdt, bm, cm, log_a, h0, y, h_last, S, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); (P, N) in {(16,16), (64,64)} (the smoke and
// the full zamba2 widths); h0 may be null (zero initial state).
extern "C" int repro_ssd_scan(const float* xdt, const float* bm,
                              const float* cm, const float* log_a,
                              const float* h0, float* y, float* h_last, int B,
                              int S, int H, int P, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return repro::launch<16, 16>(xdt, bm, cm, log_a, h0, y, h_last, B, S, H, s);
  if (P == 64 && N == 64)
    return repro::launch<64, 64>(xdt, bm, cm, log_a, h0, y, h_last, B, S, H, s);
  return cudaErrorInvalidValue;
}
