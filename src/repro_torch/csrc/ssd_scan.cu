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
// With la the cumsum of log_a inside a sub-chunk of kQ = 64 tokens:
//   M    = (C B^T) . exp(la_i - la_j), causal (j <= i)
//   y    = M xdt + exp(la_i) (C h^T)
//   h   <- exp(la_last) h + sum_i exp(la_last - la_i) xdt_i (x) B_i
// Rows past S are staged as xdt = B = C = 0 and log_a = 0, which carries h
// through exactly, and are not stored.
//
// What bounds it on an H100: at zamba2's chunk (S 256, 80 heads, P = N =
// 64, B 1) each input read once and each output written once is ~13 MB
// (0.0039 ms at 3.35 TB/s); the recurrence's 4 P N operations per (token,
// head), 0.34 GFLOP, take 0.0021 ms as 3 TF32 products at 495 TFLOP/s, so
// bytes bound it. The first version (one CTA per (head, row) walking its
// sub-chunks in order with scalar f32 FMAs) took ~0.060 ms: 80 CTAs on 132
// SMs, four serial sub-chunks of three barriers each. This one takes ~0.03
// ms there on an H100 SXM at 700 W (chip_smoke.py, PERF.md): with one CTA
// a SM it is not much faster, so each CTA's chain of products, barriers
// and the wait sets the time, not the card's rates.
//
// The design, against the fill, the serial walk and the FMAs:
// - Grid (H, splits, B). The token axis is cut into `splits` spans of
//   whole sub-chunks (kernels/mamba2_scan/ops.py::plan: 4 splits of 64
//   tokens at zamba2's chunk, 320 CTAs of 4 warps, three a SM by shared
//   memory).
// - Phase 1, every CTA at once: scan the span from a zero state. This
//   gives the span's end state S_c [P,N], its log decay L_c and y_local.
//   The state update of a sub-chunk comes before its y_local, so S_c is
//   published before the last sub-chunk's y_local is computed.
// - Phase 2, the chain h_in(0) = h0, h_in(c+1) = exp(L_c) h_in(c) + S_c,
//   in split order inside the launch. A CTA's split index c is a ticket
//   from an atomic counter per (row, head), not blockIdx, so every split
//   before c has started whatever the residency. Split c publishes S_c and
//   L_c to a workspace with a release flag, waits (acquire) for the flags
//   of splits 0..c-1 and folds their states from h0 in split order itself,
//   the same fma sequence as a serial chain: one wait instead of c hops,
//   and the output is bit-identical run to run (h0 is read before the
//   wait). The last split writes h_last. The last CTA of a (row, head) to
//   finish resets its ticket and flags, so the workspace is made once per
//   shape.
// - Phase 3: y = y_local + exp(L_before + la_i) C_i h_in(c)^T, L_before the
//   log decay from the span's start to the sub-chunk's.
// - The four products (C B^T, M xdt, C h^T, (xdt w)^T B) run on tensor
//   cores in 3xTF32 (common.cuh), f32 in and out. Each warp owns 16 tokens:
//   its C B^T accumulator, scaled by the decay and masked, is the A operand
//   of M xdt as (c0, c2, c1, c3) with xdt's rows read as 2t, 2t + 1 (no
//   shared memory for M); the same token permutation serves (xdt w)^T B.
//   Causal blocks past a warp's last row are skipped.
// - xdt, B and C sub-chunks are staged by 16-byte cp.async (an xdt row of
//   one (token, head) is P contiguous floats, stride H P between tokens),
//   rows padded to P + 4 / N + 4 floats so that every fragment read is free
//   of bank conflicts. While the ticket's atomic is out, a CTA prefetches
//   into L2 the xdt rows of the span its blockIdx.y names.
// - Registers bound the residency: 320 CTAs need three a SM (at most 170
//   registers a thread), so h0 is read only just before the wait.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;        // tokens per sub-chunk
constexpr int kWarps = kQ / 16;  // 16 tokens each
constexpr int kThreads = 32 * kWarps;

template <int P, int N>
constexpr size_t smem_bytes() {
  return (size_t)(kQ * (P + 4)        // xdt
                  + 2 * kQ * (N + 4)  // B, C
                  + P * (N + 4)       // h (local state, then h_in)
                  + 2 * kQ)           // la, exp(la_last - la)
         * sizeof(float);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ bm,
                const float* __restrict__ cm,
                const float* __restrict__ log_a,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ part_h,
                float* __restrict__ part_l, int* __restrict__ sync, int S,
                int H, int splits, int span) {
  static_assert(P % 16 == 0 && N % 8 == 0, "P: multiple of 16, N: of 8");
  constexpr int LDP = P + 4, LDN = N + 4;
  constexpr int KB = kQ / 8;     // 8-token blocks of a sub-chunk
  constexpr int PB8 = P / 8;     // 8-column blocks of y
  constexpr int NK = N / 8;      // k-steps over the state
  constexpr int PB = P / 16;     // 16-row blocks of h
  static_assert(kWarps % PB == 0, "P: 16, 32 or 64");
  constexpr int WPR = kWarps / PB;            // warps sharing a row block
  constexpr int HT = (NK + WPR - 1) / WPR;    // h column blocks per warp
  const int hd = blockIdx.x, b = blockIdx.z;
  const size_t bh = (size_t)b * H + hd;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;            // [kQ][LDP]
  float* Bs = Xs + kQ * LDP;   // [kQ][LDN]
  float* Cs = Bs + kQ * LDN;   // [kQ][LDN]
  float* Hs = Cs + kQ * LDN;   // [P][LDN]
  float* La = Hs + P * LDN;    // [kQ]
  float* Wd = La + kQ;         // [kQ]
  __shared__ int s_split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  int* sy = sync + bh * (2 + splits);  // ticket, done, flags[splits]

  if (tid == 0) s_split = atomicAdd(sy, 1);
  {  // while the ticket is out, pull into L2 the xdt rows of the span that
     // blockIdx.y names, the one a CTA most often draws (only a hint: a CTA
     // that draws another span stages its own)
    const int g0 = blockIdx.y * span * kQ;
    for (int r = tid; r < span * kQ && g0 + r < S; r += kThreads)
      for (int o = 0; o < P; o += 32)  // 128-byte lines
        prefetch_l2(xdt + (((size_t)b * S + g0 + r) * H + hd) * P + o);
  }
  __syncthreads();
  const int c = s_split;
  if (c >= splits) __trap();  // counters not zero on entry: a shared workspace
  const int t_begin = c * span * kQ;
  const int n_sub = min(span, (S - t_begin + kQ - 1) / kQ);

  // Stage sub-chunk `sub` of the span (xdt too where `with_x`) and its
  // cumsum of log a; returns its token count.
  auto stage = [&](int sub, bool with_x) {
    const int t0 = t_begin + sub * kQ, q = min(kQ, S - t0);
    if (with_x) {
      for (int i = tid; i < kQ * (P / 4); i += kThreads) {
        const int r = i / (P / 4), cc = i - r * (P / 4);
        cp_async16(Xs + r * LDP + cc * 4,
                   xdt + (((size_t)b * S + t0 + min(r, q - 1)) * H + hd) * P +
                       cc * 4,
                   r < q);
      }
    }
    for (int i = tid; i < kQ * (N / 4); i += kThreads) {
      const int r = i / (N / 4), cc = i - r * (N / 4);
      const size_t off = ((size_t)b * S + t0 + min(r, q - 1)) * N + cc * 4;
      if (with_x) cp_async16(Bs + r * LDN + cc * 4, bm + off, r < q);
      cp_async16(Cs + r * LDN + cc * 4, cm + off, r < q);
    }
    cp_async_commit();
    if (warp == 0) {  // inclusive cumsum of log a: lane owns RL rows
      constexpr int RL = kQ / 32;
      const size_t base = ((size_t)b * S + t0) * H + hd;
      float v[RL], incl = 0.f;
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int row = lane * RL + r;
        v[r] = row < q ? log_a[base + (size_t)row * H] : 0.f;
        incl += v[r];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int r = RL - 1; r >= 0; --r) {  // back from the lane's last row
        La[lane * RL + r] = incl;
        Wd[lane * RL + r] = expf(last - incl);
        incl -= v[r];
      }
    }
    cp_async_wait(0);
    __syncthreads();
    return q;
  };

  // this warp's 16 tokens of a sub-chunk, and its C fragment at k-step kk
  const int i_a = warp * 16 + gid, i_b = i_a + 8;
  const int last_kb = 2 * warp + 1;  // causal: token blocks 0 .. last_kb
  auto c_frag = [&](int kk) {
    const float* ca = Cs + i_a * LDN + kk * 8 + tig;
    const float* cb = Cs + i_b * LDN + kk * 8 + tig;
    return split_frag(ca[0], cb[0], ca[4], cb[4]);
  };
  // acc[pb] += C (h in Hs)^T for this warp's tokens, all P columns
  auto c_h = [&](float (*acc)[4]) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const Tf32Frag ca = c_frag(kk);
#pragma unroll
      for (int pb = 0; pb < PB8; ++pb) {
        const float* hr = Hs + (pb * 8 + gid) * LDN + kk * 8 + tig;
        mma_3xtf32(acc[pb], ca, hr[0], hr[4]);
      }
    }
  };
  auto y_row = [&](int sub, int i) {
    return y + (((size_t)b * S + t_begin + sub * kQ + i) * H + hd) * P +
           2 * tig;
  };

  // this warp's h tiles k: row block warp % PB, column block nb_of(k)
  const int p_a = (warp % PB) * 16 + gid;  // and p_a + 8
  auto nb_of = [&](int k) { return warp / PB + WPR * k; };
  float hacc[HT][4];
#pragma unroll
  for (int k = 0; k < HT; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[k][e] = 0.f;
  // h[p][n] offsets of tile k's rows gid, gid + 8 and columns 2t, 2t + 1
  auto h_at = [&](int k, int half, int ld) {
    return (p_a + 8 * half) * ld + nb_of(k) * 8 + 2 * tig;
  };
  auto store_h = [&](float* dst, int ld, const float (*h)[4]) {
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      if (nb_of(k) >= NK) continue;
      *reinterpret_cast<float2*>(dst + h_at(k, 0, ld)) =
          make_float2(h[k][0], h[k][1]);
      *reinterpret_cast<float2*>(dst + h_at(k, 1, ld)) =
          make_float2(h[k][2], h[k][3]);
    }
  };

  // ---- phase 1: scan the span from a zero state. Per sub-chunk the state
  // update comes first, so that the span's end state is published before
  // the last sub-chunk's y_local is computed: the splits after this one
  // wait for it, not for y.
  float yacc[PB8][4];
  float L = 0.f, L_before = 0.f;  // log decay of the span / before the last
  int q = 0;
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub > 0) __syncthreads();  // the previous sub-chunk is consumed
    q = stage(sub, true);
    const float la_a = La[i_a], la_b = La[i_b], la_last = La[kQ - 1];

    // h <- exp(la_last) h + (xdt w)^T B; tokens 2t, 2t + 1 of each block
    const float e_last = expf(la_last);
#pragma unroll
    for (int k = 0; k < HT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[k][e] *= e_last;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int r0 = j * 8 + 2 * tig;
      const float w0 = Wd[r0], w1 = Wd[r0 + 1];
      const float* x0 = Xs + r0 * LDP + p_a;
      const Tf32Frag xa = split_frag(x0[0] * w0, x0[8] * w0, x0[LDP] * w1,
                                     x0[LDP + 8] * w1);
      const float* br = Bs + r0 * LDN + gid;
#pragma unroll
      for (int k = 0; k < HT; ++k) {
        if (nb_of(k) >= NK) continue;
        mma_3xtf32(hacc[k], xa, br[nb_of(k) * 8], br[nb_of(k) * 8 + LDN]);
      }
    }
    L_before = L;
    L += la_last;
    if (sub == n_sub - 1) {  // publish (S_c, L_c) for the later splits
      if (c < splits - 1) {
        store_h(part_h + (bh * splits + c) * P * N, N, hacc);
        if (tid == 0) part_l[bh * splits + c] = L;
        __threadfence();
      }
      __syncthreads();
      if (tid == 0 && c < splits - 1) st_release(sy + 2 + c, 1);
    }

    // y_local: G = C B^T (blocks 0 .. last_kb) and, past the first
    // sub-chunk, the local state's part C h^T
    float s[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int pb = 0; pb < PB8; ++pb)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const Tf32Frag ca = c_frag(kk);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j > last_kb) continue;
        const float* br = Bs + (j * 8 + gid) * LDN + kk * 8 + tig;
        mma_3xtf32(s[j], ca, br[0], br[4]);
      }
      if (sub > 0) {
#pragma unroll
        for (int pb = 0; pb < PB8; ++pb) {
          const float* hr = Hs + (pb * 8 + gid) * LDN + kk * 8 + tig;
          mma_3xtf32(yacc[pb], ca, hr[0], hr[4]);
        }
      }
    }
    if (sub > 0) {
      const float ea = expf(la_a), eb = expf(la_b);
#pragma unroll
      for (int pb = 0; pb < PB8; ++pb) {
        yacc[pb][0] *= ea;
        yacc[pb][1] *= ea;
        yacc[pb][2] *= eb;
        yacc[pb][3] *= eb;
      }
    }

    // M = G . exp(la_i - la_j), causal; y += M xdt with M's accumulator as
    // the A operand (c0, c2, c1, c3) and xdt's rows 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j > last_kb) continue;
      const int j0 = j * 8 + 2 * tig;
      const float l0 = La[j0], l1 = La[j0 + 1];
      s[j][0] = j0 <= i_a ? s[j][0] * expf(la_a - l0) : 0.f;
      s[j][1] = j0 + 1 <= i_a ? s[j][1] * expf(la_a - l1) : 0.f;
      s[j][2] = j0 <= i_b ? s[j][2] * expf(la_b - l0) : 0.f;
      s[j][3] = j0 + 1 <= i_b ? s[j][3] * expf(la_b - l1) : 0.f;
      const Tf32Frag ma = split_frag(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* xr = Xs + j0 * LDP + gid;
#pragma unroll
      for (int pb = 0; pb < PB8; ++pb)
        mma_3xtf32(yacc[pb], ma, xr[pb * 8], xr[pb * 8 + LDP]);
    }
    if (sub < n_sub - 1) {  // y_local of a sub-chunk before the last
#pragma unroll
      for (int pb = 0; pb < PB8; ++pb) {
        if (i_a < q)
          *reinterpret_cast<float2*>(y_row(sub, i_a) + pb * 8) =
              make_float2(yacc[pb][0], yacc[pb][1]);
        if (i_b < q)
          *reinterpret_cast<float2*>(y_row(sub, i_b) + pb * 8) =
              make_float2(yacc[pb][2], yacc[pb][3]);
      }
    }

    if (sub < n_sub - 1) {
      __syncthreads();  // every read of h is done before it changes
      store_h(Hs, LDN, hacc);
    }
  }

  // ---- phase 2: fold the earlier splits' (S_j, L_j) from h0, in order
  float hin[HT][4];  // h0, read before the wait
#pragma unroll
  for (int k = 0; k < HT; ++k) {
    float2 va = make_float2(0.f, 0.f), vb = va;
    if (h0 != nullptr && nb_of(k) < NK) {
      va = *reinterpret_cast<const float2*>(h0 + bh * P * N + h_at(k, 0, N));
      vb = *reinterpret_cast<const float2*>(h0 + bh * P * N + h_at(k, 1, N));
    }
    hin[k][0] = va.x;
    hin[k][1] = va.y;
    hin[k][2] = vb.x;
    hin[k][3] = vb.y;
  }
  if (tid == 0) {
    for (int j = 0; j < c; ++j)
      while (ld_acquire(sy + 2 + j) == 0) {
      }
  }
  __syncthreads();  // the flags are up; every read of Hs is done
  for (int j = 0; j < c; ++j) {
    const float a = expf(__ldcg(part_l + bh * splits + j));
    const float* sj = part_h + (bh * splits + j) * P * N;
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      if (nb_of(k) >= NK) continue;
      const float2 sa =
          __ldcg(reinterpret_cast<const float2*>(sj + h_at(k, 0, N)));
      const float2 sb =
          __ldcg(reinterpret_cast<const float2*>(sj + h_at(k, 1, N)));
      hin[k][0] = fmaf(a, hin[k][0], sa.x);
      hin[k][1] = fmaf(a, hin[k][1], sa.y);
      hin[k][2] = fmaf(a, hin[k][2], sb.x);
      hin[k][3] = fmaf(a, hin[k][3], sb.y);
    }
  }
  if (c == splits - 1) {  // h_last = exp(L_c) h_in + S_c
    const float a = expf(L);
    float hl[HT][4];
#pragma unroll
    for (int k = 0; k < HT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) hl[k][e] = fmaf(a, hin[k][e], hacc[k][e]);
    store_h(h_last + bh * P * N, N, hl);
  }
  store_h(Hs, LDN, hin);
  __syncthreads();  // h_in complete

  // ---- phase 3: y += exp(L_before + la_i) C_i h_in^T; the last
  // sub-chunk from shared memory and registers, then the earlier ones
  // restaged (C and log a) and added in place
  {
    float t3[PB8][4];
#pragma unroll
    for (int pb = 0; pb < PB8; ++pb)
#pragma unroll
      for (int e = 0; e < 4; ++e) t3[pb][e] = 0.f;
    c_h(t3);
    const float ea = expf(L_before + La[i_a]), eb = expf(L_before + La[i_b]);
    const int sub = n_sub - 1;
#pragma unroll
    for (int pb = 0; pb < PB8; ++pb) {
      if (i_a < q)
        *reinterpret_cast<float2*>(y_row(sub, i_a) + pb * 8) = make_float2(
            fmaf(ea, t3[pb][0], yacc[pb][0]), fmaf(ea, t3[pb][1], yacc[pb][1]));
      if (i_b < q)
        *reinterpret_cast<float2*>(y_row(sub, i_b) + pb * 8) = make_float2(
            fmaf(eb, t3[pb][2], yacc[pb][2]), fmaf(eb, t3[pb][3], yacc[pb][3]));
    }
  }
  float Lp = 0.f;
  for (int sub = 0; sub + 1 < n_sub; ++sub) {
    __syncthreads();  // C and la of the previous sub-chunk are consumed
    const int qs = stage(sub, false);
    float t3[PB8][4];
#pragma unroll
    for (int pb = 0; pb < PB8; ++pb)
#pragma unroll
      for (int e = 0; e < 4; ++e) t3[pb][e] = 0.f;
    c_h(t3);
    const float ea = expf(Lp + La[i_a]), eb = expf(Lp + La[i_b]);
#pragma unroll
    for (int pb = 0; pb < PB8; ++pb) {
      if (i_a < qs) {
        float2* ya = reinterpret_cast<float2*>(y_row(sub, i_a) + pb * 8);
        const float2 va = *ya;
        *ya = make_float2(fmaf(ea, t3[pb][0], va.x),
                          fmaf(ea, t3[pb][1], va.y));
      }
      if (i_b < qs) {
        float2* yb = reinterpret_cast<float2*>(y_row(sub, i_b) + pb * 8);
        const float2 vb = *yb;
        *yb = make_float2(fmaf(eb, t3[pb][2], vb.x),
                          fmaf(eb, t3[pb][3], vb.y));
      }
    }
    Lp += La[kQ - 1];
  }
  // every flag and partial read was done before the "h_in complete"
  // barrier: the last CTA of this (row, head) to get here resets
  if (tid == 0 && atomicAdd(sy + 1, 1) == splits - 1) {
    for (int j = 0; j < splits; ++j) sy[2 + j] = 0;
    sy[0] = 0;
    sy[1] = 0;
  }
}

template <int P, int N>
cudaError_t launch(const float* xdt, const float* bm, const float* cm,
                   const float* log_a, const float* h0, float* y,
                   float* h_last, float* part_h, float* part_l, int* sync,
                   int B, int S, int H, int splits, int span, int smem,
                   cudaStream_t stream) {
  if ((size_t)smem < smem_bytes<P, N>()) return cudaErrorInvalidValue;
  static int smem_set = 0;  // the attribute as last set for this instance
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // returned here; not left for a later launch
      return err;
    }
    smem_set = smem;
  }
  dim3 grid(H, splits, B);
  ssd_scan_kernel<P, N><<<grid, kThreads, smem, stream>>>(
      xdt, bm, cm, log_a, h0, y, h_last, part_h, part_l, sync, S, H, splits,
      span);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry (bound with ctypes); (P, N) in {(16,16), (64,64)} (the smoke and
// the full zamba2 widths); h0 may be null (zero initial state). `splits`
// spans of `span` sub-chunks of 64 tokens cover S, every span non-empty;
// part_h [B,H,splits,P,N], part_l [B,H,splits] (f32) and sync
// [B,H,2+splits] (int32, zero at the first call; the kernel leaves it at
// zero) are the workspace; smem is the plan's dynamic shared memory. The
// plan is kernels/mamba2_scan/ops.py::plan's, checked here.
extern "C" int repro_ssd_scan(const float* xdt, const float* bm,
                              const float* cm, const float* log_a,
                              const float* h0, float* y, float* h_last,
                              float* part_h, float* part_l, int* sync, int B,
                              int S, int H, int P, int N, int splits,
                              int span, int smem, void* stream) {
  const long long tokens = (long long)splits * span * repro::kQ;
  if (B < 1 || S < 1 || H < 1 || splits < 1 || span < 1 || tokens < S ||
      tokens - (long long)span * repro::kQ >= S || smem > 232448)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 16 && N == 16)
    return repro::launch<16, 16>(xdt, bm, cm, log_a, h0, y, h_last, part_h,
                                 part_l, sync, B, S, H, splits, span, smem, s);
  if (P == 64 && N == 64)
    return repro::launch<64, 64>(xdt, bm, cm, log_a, h0, y, h_last, part_h,
                                 part_l, sync, B, S, H, splits, span, smem, s);
  return cudaErrorInvalidValue;
}
