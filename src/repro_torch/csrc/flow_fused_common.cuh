// flow_fused_common.cuh — pieces shared by the strict-causal Flow-Attention
// kernels for Hopper (sm_90a): flow_fused.cu (K1) and flow_fused_bwd.cu (K2).
//
// Both split the work the way the chunked form of the paper's Alg. 2 allows:
//   * the flows (three levels of prefix sums of (D,) vectors and the flow
//     dot products, O((G + 1) D) per position) are the only ordered chain:
//     one block of 1024 threads per row walks it in super-chunks of T
//     positions, each level a block-wide segmented scan (every thread owns
//     one feature column of T D / 1024 consecutive positions; segment totals
//     are combined across the block) and the dot products warp reductions;
//     it writes per-position scalars, never (D,) vectors;
//   * the aggregation (2 (G + 1) D Dv of the 2 (G + 1) D Dv + 7 (G + 1) D
//     operations per position) runs chunk by chunk in parallel: chunk
//     states phi(k)^T (v e), an exclusive pass over the chunks, then
//     per-chunk products.
// Every product is fp32 FMA on the CUDA cores (no tensor cores, no TF32):
// a block of 256 threads owns an M x N output, each thread RM rows by four
// consecutive columns, from operands staged in shared memory as rows of
// W floats whose float4 chunks are XOR-swizzled by row (sw), so every
// read -- along a row or down a column -- is a conflict-free 16-byte load
// and no operand is transposed.  Every sum runs in a fixed order and
// nothing uses atomics: two calls on the same inputs are bitwise equal.
//
// The value width Dv may differ from D (MLA's heads: D = 192, Dv = 128) and
// D need not divide the flows' 1024 threads (D = 192: five segments of 192
// columns, the last 64 threads idle in the scans).  Where an output row of
// the products would hold more than 32 float4s, or its accumulators would
// crowd the registers (D = 192), the Dv axis is walked in panels of 64
// columns (panel_of).
//
// Head widths below the instantiations (the Table 7 harness's D = 24) run
// the D = 32 instantiation on rows stored 32 wide, zero past the real
// width dr (the wrapper pads them).  Every stage then treats the lanes at
// and past dr as absent: phi of q and k is exactly 0 there (phi(0) is 0.5
// for sigmoid and 1 for elu + 1, so padding alone would add to every
// flow), the flow dots skip their eps terms, and K2 writes zero
// gradients.  The real lanes' sums and their order are those of the
// instantiation's.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace ff {

// The stored row width of a real head width d: 32 for the padded d = 24.
__host__ __device__ constexpr int stored_width(int d) { return d == 24 ? 32 : d; }

constexpr int kFlowThreads = 1024;  // blocks of the flows and their pull-back
constexpr int kFlowWarps = kFlowThreads / 32;
constexpr int kThreads = 256;      // every other block

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Four consecutive elements of a row of T (16-byte aligned for fp32,
// 8-byte for bf16) as fp32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // bf16 is fp32's high half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v.x) | bf16_bits(v.y) << 16,
                                            bf16_bits(v.z) | bf16_bits(v.w) << 16);
}

// phi kinds: 0 sigmoid, 1 elu + 1, 2 relu
__device__ __forceinline__ float phi_fn(float x, int kind) {
  if (kind == 0) return 1.f / (1.f + expf(-x));
  if (kind == 1) return x > 0.f ? x + 1.f : expm1f(x) + 1.f;
  return fmaxf(x, 0.f);
}
__device__ __forceinline__ float4 phi4(float4 x, int kind) {
  return make_float4(phi_fn(x.x, kind), phi_fn(x.y, kind), phi_fn(x.z, kind),
                     phi_fn(x.w, kind));
}
// phi'(x) in terms of p = phi(x)
__device__ __forceinline__ float phi_grad(float p, int kind) {
  if (kind == 0) return p * (1.f - p);
  if (kind == 1) return p > 1.f ? 1.f : p;
  return p > 0.f ? 1.f : 0.f;
}

// --- the flows ---------------------------------------------------------------
//
// One block of kFlowThreads per (row, kv head) walks the row in super-chunks
// of T positions.  Shared memory of one super-chunk (floats, G runtime):
struct FlowSmem {
  float *pq;            // phi(q), zero past the length: G x T x D
  float *pk;            // phi(k): T x D
  float *kc, *qc;       // level 1: k and (group-summed) q prefix sums: T x D
  float *koc, *qic;     // level 2: ko and qi prefix sums: T x D
  float *sink, *alloc;  // per sink: sink_in, allocation: G x T
  float *src, *raw, *e, *z;  // per source: src_out, cons_src unclipped, e, z: T
  float *tot;           // segment totals of two scans: 2 x kFlowThreads
  float *run;           // carries: q, k, ko, qi sums (D each), z
};

template <int D>
__host__ __device__ constexpr size_t flow_smem_floats_at(int t, int g) {
  return (size_t)(g + 5) * t * D + 2 * (size_t)g * t + 4 * (size_t)t + 2 * kFlowThreads +
         4 * (size_t)D + 4;
}

template <int D, int T>
__host__ __device__ constexpr size_t flow_smem_floats(int g) {
  return flow_smem_floats_at<D>(T, g);
}

template <int D, int T>
__device__ FlowSmem carve_flows(float* p, int G) {
  FlowSmem m;
  m.pq = p;    p += G * T * D;
  m.pk = p;    p += T * D;
  m.kc = p;    p += T * D;
  m.qc = p;    p += T * D;
  m.koc = p;   p += T * D;
  m.qic = p;   p += T * D;
  m.sink = p;  p += G * T;
  m.alloc = p; p += G * T;
  m.src = p;   p += T;
  m.raw = p;   p += T;
  m.e = p;     p += T;
  m.z = p;     p += T;
  m.tot = p;   p += 2 * kFlowThreads;
  m.run = p;
  return m;
}

// Two block-wide segmented scans over the super-chunk's T positions, one
// per feature column d < D: out_k(t, d) = run_k[d] + sum of x_k(t', d) over
// t' <= t (REV false) or t' >= t (REV true).  Thread (s, d) owns the PS
// positions of segment s, sums them in order, then adds the carry and the
// totals of the segments before (after) it, in segment order; the NSEG x D
// threads hold every segment (where D does not divide the block, the rest
// only pass the barriers).  fx(k, t, d)
// gives the inputs, fu(k, t, d, out) takes each output (called by the
// owning thread, so it may rewrite that thread's (t, d) entries).  The
// carries run_k advance to the super-chunk's last (first) output after
// the second barrier: every reader of a carry must pass a barrier first.
template <int D, int T, bool REV, class FX, class FU>
__device__ __forceinline__ void seg_scan2(float* run0, float* run1, float* tot, FX fx, FU fu) {
  constexpr int NSEG = kFlowThreads / D, PS = T / NSEG;
  static_assert(PS >= 1 && PS * NSEG == T, "super-chunk");
  const int s = threadIdx.x / D, d = threadIdx.x % D;
  const bool on = NSEG * D == kFlowThreads || s < NSEG;
  float loc0[PS], loc1[PS];
  float a0 = 0.f, a1 = 0.f;
  if (on) {
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      const int t = REV ? s * PS + PS - 1 - i : s * PS + i;
      a0 += fx(0, t, d);
      a1 += fx(1, t, d);
      loc0[i] = a0;
      loc1[i] = a1;
    }
    tot[s * D + d] = a0;
    tot[kFlowThreads + s * D + d] = a1;
  }
  __syncthreads();
  if (on) {
    float o0 = run0[d], o1 = run1[d];
#pragma unroll
    for (int j = 0; j < NSEG; ++j) {
      const int s2 = REV ? NSEG - 1 - j : j;
      if (REV ? s2 > s : s2 < s) {
        o0 += tot[s2 * D + d];
        o1 += tot[kFlowThreads + s2 * D + d];
      }
    }
#pragma unroll
    for (int i = 0; i < PS; ++i) {
      const int t = REV ? s * PS + PS - 1 - i : s * PS + i;
      loc0[i] += o0;
      loc1[i] += o1;
      fu(0, t, d, loc0[i]);
      fu(1, t, d, loc1[i]);
    }
  }
  __syncthreads();
  if (s == (REV ? 0 : NSEG - 1)) {  // loc holds the carried outputs
    run0[d] = loc0[PS - 1];
    run1[d] = loc1[PS - 1];
  }
}

// Warp 0: out[t] = *run + sum of x[t'] over t' <= t (REV false) or t' >= t
// (REV true), t < T; *run advances to out[T - 1] (out[0]).  Each lane sums
// its ceil(T / 32) positions in order, then the lanes' totals are scanned
// with shuffles.
template <int T, bool REV, class FX, class FU>
__device__ __forceinline__ void warp_scan(float* run, FX fx, FU fu) {
  constexpr int PL = (T + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int L = REV ? 31 - lane : lane;  // the lane's rank in scan order
  float loc[PL], acc = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int u = L * PL + i;  // position in scan order
    const int t = REV ? T - 1 - u : u;
    acc += (u < T) ? fx(t) : 0.f;
    loc[i] = acc;
  }
  // inclusive scan of the lanes' totals in scan order
  float incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = REV ? __shfl_down_sync(0xffffffffu, incl, off)
                        : __shfl_up_sync(0xffffffffu, incl, off);
    if (L >= off) incl += o;
  }
  float excl = REV ? __shfl_down_sync(0xffffffffu, incl, 1) : __shfl_up_sync(0xffffffffu, incl, 1);
  if (L == 0) excl = 0.f;
  const float base = *run;
  const float last = __shfl_sync(0xffffffffu, incl, REV ? 0 : 31);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int u = L * PL + i;
    const int t = REV ? T - 1 - u : u;
    if (u < T) fu(t, base + (excl + loc[i]));
  }
  if (lane == 0) *run = base + last;
}

// Dot products over the feature axis, one warp each: for every row r <
// rows, done(r, sum_d f(r, d)).  A warp keeps kDotRows rows in flight (its
// rows r, r + kFlowWarps, ...), reduces them together with one butterfly,
// and lane b finishes the b-th.
constexpr int kDotRows = 8;

template <int D, class F, class Done>
__device__ __forceinline__ void warp_dots(int rows, F f, Done done) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < rows; r0 += kDotRows * kFlowWarps) {
    float acc[kDotRows];
#pragma unroll
    for (int b = 0; b < kDotRows; ++b) {
      const int r = r0 + b * kFlowWarps;
      acc[b] = 0.f;
      if (r < rows)
#pragma unroll
        for (int d = lane; d < D; d += 32) acc[b] += f(r, d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < kDotRows; ++b) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    float mine = acc[0];
#pragma unroll
    for (int b = 1; b < kDotRows; ++b) mine = lane == b ? acc[b] : mine;
    const int r = r0 + lane * kFlowWarps;
    if (lane < kDotRows && r < rows) done(r, mine);
  }
}

// Ask L2 for `bytes` of global memory from p (128-byte lines spread over
// the block's kFlowThreads threads); nothing is waited for.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
#if defined(__CUDA_ARCH__)
  for (size_t o = (size_t)threadIdx.x * 128; o < bytes; o += (size_t)kFlowThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"((const char*)p + o));
#endif
}

// phi(q) (G x T x D) and phi(k) (T x D) of the super-chunk at p0, zero at
// and past the row's length and at and past the real width dr.
template <typename TT, int D, int T>
__device__ __forceinline__ void load_phi(const FlowSmem& m, const TT* qrow, const TT* krow, int G,
                                         int N, int len, int p0, int phi, int dr) {
  constexpr int Q = D / 4;
  for (int i = threadIdx.x; i < G * T * Q; i += kFlowThreads) {
    const int g = i / (T * Q), r = i - g * T * Q, t = r / Q, d = (r - t * Q) * 4, n = p0 + t;
    st4(m.pq + (g * T + t) * D + d,
        n < len && d < dr ? phi4(load4(qrow + ((size_t)g * N + n) * D + d), phi) : zero4());
  }
  for (int i = threadIdx.x; i < T * Q; i += kFlowThreads) {
    const int t = i / Q, d = (i - t * Q) * 4, n = p0 + t;
    st4(m.pk + t * D + d,
        n < len && d < dr ? phi4(load4(krow + (size_t)n * D + d), phi) : zero4());
  }
}

// Prefetch the live rows of q (each group) and k of the super-chunk at p0.
template <typename TT, int D, int T>
__device__ __forceinline__ void prefetch_superchunk(const TT* qrow, const TT* krow, int G, int N,
                                                    int len, int p0) {
  const size_t rows = (size_t)min(T, len - p0);
  for (int g = 0; g < G; ++g) prefetch_l2(qrow + ((size_t)g * N + p0) * D, rows * D * sizeof(TT));
  prefetch_l2(krow + (size_t)p0 * D, rows * D * sizeof(TT));
}

// The super-chunk's three flow levels from the carries in m.run (which
// advance to its end):
//   1. k_cs, q_cs (q summed over the group) -> sink_in = pos / (phi(q) +
//      eps).(k_cs + eps), src_out = pos G / (phi(k) + eps).(q_cs + eps);
//   2. ko_cs over phi(k) src_out, qi_cs over the group's phi(q) sink_in ->
//      alloc = sigmoid((phi(q) + eps).(ko_cs + eps) / (pos G)) (or 1), raw
//      = (phi(k) + eps).(qi_cs + eps) / pos, e = exp(clip(raw, -1, 1)),
//      zero at and past the length;
//   3. z = z_in + cumsum(e).
// The dots run over the real lanes d < dr only.  Starts after a barrier
// that follows load_phi; ends with a barrier.
template <int D, int T>
__device__ void flow_levels(const FlowSmem& m, int G, int p0, int len, float eps, int use_alloc,
                            int dr) {
  const float fG = (float)G;
  float* q_run = m.run;
  float* k_run = m.run + D;
  float* ko_run = m.run + 2 * D;
  float* qi_run = m.run + 3 * D;
  float* z_run = m.run + 4 * D;
  // level 1
  seg_scan2<D, T, false>(
      k_run, q_run, m.tot,
      [&](int k, int t, int d) {
        if (k == 0) return m.pk[t * D + d];
        float x = 0.f;
        for (int g = 0; g < G; ++g) x += m.pq[(g * T + t) * D + d];
        return x;
      },
      [&](int k, int t, int d, float v) { (k == 0 ? m.kc : m.qc)[t * D + d] = v; });
  warp_dots<D>(
      (G + 1) * T,
      [&](int r, int d) {
        if (d >= dr) return 0.f;
        if (r < G * T) return (m.pq[r * D + d] + eps) * (m.kc[(r % T) * D + d] + eps);
        const int t = r - G * T;
        return (m.pk[t * D + d] + eps) * (m.qc[t * D + d] + eps);
      },
      [&](int r, float acc) {
        if (r < G * T) {
          m.sink[r] = (float)(p0 + r % T + 1) / acc;
        } else {
          const int t = r - G * T;
          m.src[t] = (float)(p0 + t + 1) * fG / acc;
        }
      });
  __syncthreads();
  // level 2
  seg_scan2<D, T, false>(
      ko_run, qi_run, m.tot,
      [&](int k, int t, int d) {
        if (k == 0) return m.pk[t * D + d] * m.src[t];
        float x = 0.f;
        for (int g = 0; g < G; ++g) x += m.pq[(g * T + t) * D + d] * m.sink[g * T + t];
        return x;
      },
      [&](int k, int t, int d, float v) { (k == 0 ? m.koc : m.qic)[t * D + d] = v; });
  warp_dots<D>(
      (G + 1) * T,
      [&](int r, int d) {
        if (d >= dr) return 0.f;
        if (r < G * T) return (m.pq[r * D + d] + eps) * (m.koc[(r % T) * D + d] + eps);
        const int t = r - G * T;
        return (m.pk[t * D + d] + eps) * (m.qic[t * D + d] + eps);
      },
      [&](int r, float acc) {
        if (r < G * T) {
          const float cons_sink = acc / ((float)(p0 + r % T + 1) * fG);
          m.alloc[r] = use_alloc ? 1.f / (1.f + expf(-cons_sink)) : 1.f;
        } else {
          const int t = r - G * T;
          const float raw = acc / (float)(p0 + t + 1);
          m.raw[t] = raw;
          m.e[t] = p0 + t < len ? expf(fminf(fmaxf(raw, -1.f), 1.f)) : 0.f;
        }
      });
  __syncthreads();
  // level 3
  if (threadIdx.x < 32)
    warp_scan<T, false>(
        z_run, [&](int t) { return m.e[t]; }, [&](int t, float v) { m.z[t] = v; });
  __syncthreads();
}

// Arguments of the flows stage.
template <typename TT>
struct FlowArgs {
  const TT *q, *k;
  const int* lens;
  float *sink, *scale, *e;  // (BH, G, N), (BH, G, N), (BH, N)
  float* carry;             // (BH, ceil(N / every), 4 D + 1) or null
  int every;                // positions between saved carries, a divisor of T
  float *q_sum, *k_sum, *ko_sum, *qi_sum, *z;  // (BH, D) x 4, (BH,) or null
  int G, N, phi, use_alloc;
  float eps;
  int dr;  // the real head width (D but on the padded route)
};

// Stage 1 (flow_fwd_flows, flow_bwd_flows): one block of kFlowThreads per
// (row, kv head) walks the live super-chunks and writes, at each live
// position n < N, sink_in, the output scale r alloc (both zero past the
// length) and e; where `carry` is set, the carry-in of every `every`
// positions (at a super-chunk's start its carries, inside it the prefix
// sums of the position before); the boundary sums where `q_sum` is set.
template <typename TT, int D, int T>
__device__ void flows_body(const FlowArgs<TT>& a, float* smem) {
  const FlowSmem m = carve_flows<D, T>(smem, a.G);
  const int row = blockIdx.x, G = a.G, N = a.N;
  const int len = min(a.lens[row], N);
  const int live = (len + T - 1) / T;
  const TT* qrow = a.q + (size_t)row * G * N * D;
  const TT* krow = a.k + (size_t)row * N * D;
  for (int i = threadIdx.x; i < 4 * D + 1; i += kFlowThreads) m.run[i] = 0.f;
  for (int it = 0; it < live; ++it) {
    const int p0 = it * T;
    load_phi<TT, D, T>(m, qrow, krow, G, N, len, p0, a.phi, a.dr);
    if (it + 1 < live) prefetch_superchunk<TT, D, T>(qrow, krow, G, N, len, p0 + T);
    __syncthreads();
    const size_t nev = (N + a.every - 1) / a.every;
    if (a.carry)
      for (int i = threadIdx.x; i < 4 * D + 1; i += kFlowThreads)
        a.carry[((size_t)row * nev + p0 / a.every) * (4 * D + 1) + i] = m.run[i];
    flow_levels<D, T>(m, G, p0, len, a.eps, a.use_alloc, a.dr);
    if (a.carry)  // the carries inside the super-chunk, from the level panels
      for (int j = a.every; j < T && p0 + j < N; j += a.every)
        for (int i = threadIdx.x; i < 4 * D + 1; i += kFlowThreads) {
          const int t = j - 1, c = i / D, d = i - c * D;
          const float* panel = c == 0 ? m.qc : c == 1 ? m.kc : c == 2 ? m.koc : m.qic;
          a.carry[((size_t)row * nev + (p0 + j) / a.every) * (4 * D + 1) + i] =
              c < 4 ? panel[t * D + d] : m.z[t];
        }
    for (int i = threadIdx.x; i < G * T; i += kFlowThreads) {
      const int g = i / T, t = i - g * T, n = p0 + t;
      if (n >= N) continue;
      const bool ok = n < len;
      const size_t o = ((size_t)row * G + g) * N + n;
      a.sink[o] = ok ? m.sink[i] : 0.f;
      a.scale[o] = ok ? (float)(n + 1) / m.z[t] * m.alloc[i] : 0.f;
    }
    for (int t = threadIdx.x; t < T; t += kFlowThreads)
      if (p0 + t < N) a.e[(size_t)row * N + p0 + t] = m.e[t];
    __syncthreads();
  }
  if (a.q_sum) {
    for (int d = threadIdx.x; d < D; d += kFlowThreads) {
      const size_t o = (size_t)row * D + d;
      a.q_sum[o] = m.run[d];
      a.k_sum[o] = m.run[D + d];
      a.ko_sum[o] = m.run[2 * D + d];
      a.qi_sum[o] = m.run[3 * D + d];
    }
    if (threadIdx.x == 0) a.z[row] = m.run[4 * D];
  }
}

// --- the products ------------------------------------------------------------
//
// A staged tile holds rows of W floats (W a multiple of 32); the float4
// chunk q of row r sits at chunk (q & ~7) | ((q ^ (r >> 2)) & 7).  A read
// of four consecutive floats of a row at column c (a multiple of 4) is
// one 16-byte load at sw<W>(r, c).

// The offset of column quad cq's chunk in a row of row quad rq, in floats.
__device__ __forceinline__ int sw_chunk(int rq, int cq) {
  return ((cq & ~7) | ((cq ^ rq) & 7)) << 2;
}

template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  static_assert(W % 32 == 0, "swizzled rows are multiples of 32 floats");
  return r * W + sw_chunk(r >> 2, c >> 2);
}

// Ownership of an M x N output by the kThreads threads of a block: thread
// (tm, tn) owns rows r0 .. r0 + RM - 1 (r0 = RM tm) and columns c0 .. c0 + 3
// (c0 = 4 tn).  The TN threads of a row are consecutive lanes.
template <int M, int N>
struct Own {
  static constexpr int TN = N / 4, TM = kThreads / TN, RM = M / TM;
  static_assert(TN <= 32 && 32 % TN == 0 && RM >= 1 && RM * TM == M, "layout");
  int r0, c0;
  __device__ __forceinline__ Own() : r0((threadIdx.x / TN) * RM), c0((threadIdx.x % TN) * 4) {}
};

// The products below walk k in aligned quads: within one, every row's
// swizzled chunk of a column quad is the same, so each operand's offsets
// are computed once per four k.

// acc[i][c] += sum_k A(k, r0 + i) B(k, c0 + c) for kmin <= k < kmax (kmax
// a multiple of 4; the k below kmin in its quad are summed too, so A must
// be zero there), A and B staged k-major (rows k, of WA and WB floats).
template <int RM, int WA, int WB>
__device__ __forceinline__ void mm_kk(float (&acc)[RM][4], const float* A, const float* B, int r0,
                                      int c0, int kmin, int kmax) {
  constexpr int RQ = RM >= 4 ? RM / 4 : 1;
  for (int k0 = kmin & ~3; k0 < kmax; k0 += 4) {
    const int kq = k0 >> 2, ob = sw_chunk(kq, c0 >> 2);
    int oa[RQ];
#pragma unroll
    for (int u = 0; u < RQ; ++u) oa[u] = sw_chunk(kq, (r0 >> 2) + u);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + kk;
      const float4 b = ld4(B + k * WB + ob);
      float a[RM];
      if constexpr (RM >= 4) {
#pragma unroll
        for (int u = 0; u < RQ; ++u) {
          const float4 a4 = ld4(A + k * WA + oa[u]);
          a[4 * u] = a4.x, a[4 * u + 1] = a4.y, a[4 * u + 2] = a4.z, a[4 * u + 3] = a4.w;
        }
      } else {
        const float4 a4 = ld4(A + k * WA + oa[0]);
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = get(a4, (r0 & 3) + i);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
  }
}

// acc[i][c] += sum_k A(r0 + i, k) B(k, c0 + c) for k < kmax (a multiple of
// 4), A staged m-major (rows m), B k-major.
template <int RM, int WA, int WB>
__device__ __forceinline__ void mm_mk(float (&acc)[RM][4], const float* A, const float* B, int r0,
                                      int c0, int kmax) {
  for (int k0 = 0; k0 < kmax; k0 += 4) {
    const int kq = k0 >> 2, ob = sw_chunk(kq, c0 >> 2);
    float4 a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = ld4(A + (r0 + i) * WA + sw_chunk((r0 + i) >> 2, kq));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = ld4(B + (k0 + kk) * WB + ob);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x = get(a[i], kk);
        acc[i][0] = fmaf(x, b.x, acc[i][0]);
        acc[i][1] = fmaf(x, b.y, acc[i][1]);
        acc[i][2] = fmaf(x, b.z, acc[i][2]);
        acc[i][3] = fmaf(x, b.w, acc[i][3]);
      }
    }
  }
}

// acc[i][c] += sum_k A(r0 + i, k) B(c0 + c, k) for k < K, both staged with
// the sum along their rows (A m-major, B n-major).
template <int RM, int K, int WA, int WB>
__device__ __forceinline__ void mm_mn(float (&acc)[RM][4], const float* A, const float* B, int r0,
                                      int c0) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 4) {
    const int kq = k0 >> 2, ob = sw_chunk(c0 >> 2, kq);
    float4 a[RM], b[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = ld4(A + (r0 + i) * WA + sw_chunk((r0 + i) >> 2, kq));
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = ld4(B + (c0 + c) * WB + ob);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[i][c] = fmaf(a[i].x, b[c].x,
                         fmaf(a[i].y, b[c].y, fmaf(a[i].z, b[c].z, fmaf(a[i].w, b[c].w, acc[i][c]))));
  }
}

template <int RM>
__device__ __forceinline__ void zero_acc(float (&acc)[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Write the owned block of acc to a staged tile of width W, zero where the
// column lies above the row (a causal panel) when CAUSAL.
template <int RM, int W, bool CAUSAL>
__device__ __forceinline__ void put_tile(float* dst, const float (&acc)[RM][4], int r0, int c0) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + i;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (CAUSAL) {
      v.x = c0 <= r ? v.x : 0.f;
      v.y = c0 + 1 <= r ? v.y : 0.f;
      v.z = c0 + 2 <= r ? v.z : 0.f;
      v.w = c0 + 3 <= r ? v.w : 0.f;
    }
    st4(dst + sw<W>(r, c0), v);
  }
}

// Stage rows t < R of a (rows x W) tile: row t is f(t, c) for each float4
// column chunk c, written swizzled.  Every thread of the block calls it.
template <int R, int W, class F>
__device__ __forceinline__ void stage(float* dst, F f) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < R * Q; i += kThreads) {
    const int t = i / Q, c = (i - t * Q) * 4;
    st4(dst + sw<W>(t, c), f(t, c));
  }
}

// The chunk length of the per-chunk stages: 64 positions, 32 at D >= 128
// (the backward's eight staged tiles must fit one block's shared memory).
template <int D>
__host__ __device__ constexpr int chunk_of() { return D >= 128 ? 32 : 64; }

// The columns of Dv one product pass owns: all of them up to D = 128, else
// panels of 64 (an Own<D, 64> of the chunk state holds 48 accumulators a
// thread at D = 192, an Own<D, 128> 96).
template <int D, int DV>
__host__ __device__ constexpr int panel_of() { return D <= 128 ? DV : 64; }

// Stage 2 (flow_fwd_state, flow_bwd_state): the chunk state, the sum over
// the chunk's positions j (and the group) of a_j^T b_j, D x Dv, of each
// live (row, chunk) into its slot.  Mode 0 (forward): a = phi(k), b = v e.
// Mode 1 (K2's cotangent state): a = q_in = phi(q) sink_in, b = dY = g_out
// scale, summed over the group.  Both zero at and past the length.  One
// block per (row, chunk).  Where Dv is walked in panels, mode 0 stages its
// operands once and stores each panel's sums in turn; mode 1 is one block
// per panel (`panel`), its accumulators carried over the group.
template <typename TT, int D>
struct StateArgs {
  const TT *q, *k, *v, *g_out;
  const int* lens;
  const float *sink, *scale, *e;
  float *states, *dstates;  // (BH, nc, D, Dv) each
  int G, N, phi, dr;
};

template <typename TT, int D, int DV = D>
__device__ __forceinline__ void state_block(const StateArgs<TT, D>& a, int mode, int row,
                                            int ci, float* smem, int panel = 0) {
  constexpr int C = chunk_of<D>(), PW = panel_of<D, DV>(), NP = DV / PW;
  static_assert(NP * PW == DV, "panels");
  using O = Own<D, PW>;
  const int G = a.G, N = a.N, len = min(a.lens[row], N), c0 = ci * C;
  if (c0 >= len) return;  // a dead chunk: the pass never reads its slot
  float* A = smem;           // C x D
  float* B = smem + C * D;   // C x DV
  const O o;
  float acc[O::RM][4];
  const int nc = (N + C - 1) / C;
  float* out = (mode == 0 ? a.states : a.dstates) + ((size_t)row * nc + ci) * D * DV;
  if constexpr (NP > 1) {
    if (mode == 1) {  // one panel of the cotangent state, summed over the group
      const int cp = panel * PW;
      zero_acc(acc);
      for (int g = 0; g < G; ++g) {
        const size_t rg = (size_t)row * G + g;
        const TT* qr = a.q + rg * N * D;
        const TT* gr = a.g_out + rg * N * DV;
        stage<C, D>(A, [&](int t, int c) {
          const int n = c0 + t;
          return n < len && c < a.dr
                     ? scale4(phi4(load4(qr + (size_t)n * D + c), a.phi), a.sink[rg * N + n])
                     : zero4();
        });
        stage<C, PW>(B, [&](int t, int c) {
          const int n = c0 + t;
          return n < len ? scale4(load4(gr + (size_t)n * DV + cp + c), a.scale[rg * N + n])
                         : zero4();
        });
        __syncthreads();
        mm_kk<O::RM, D, PW>(acc, A, B, o.r0, o.c0, 0, C);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < O::RM; ++i)
        st4(out + (o.r0 + i) * DV + cp + o.c0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      return;
    }
    // mode 0: one staging, the panels in turn
    const TT* kr = a.k + (size_t)row * N * D;
    const TT* vr = a.v + (size_t)row * N * DV;
    stage<C, D>(A, [&](int t, int c) {
      const int n = c0 + t;
      return n < len && c < a.dr ? phi4(load4(kr + (size_t)n * D + c), a.phi) : zero4();
    });
    stage<C, DV>(B, [&](int t, int c) {
      const int n = c0 + t;
      return n < len ? scale4(load4(vr + (size_t)n * DV + c), a.e[(size_t)row * N + n])
                     : zero4();
    });
    __syncthreads();
    for (int p = 0; p < NP; ++p) {
      const int cp = p * PW + o.c0;
      zero_acc(acc);
      mm_kk<O::RM, D, DV>(acc, A, B, o.r0, cp, 0, C);
#pragma unroll
      for (int i = 0; i < O::RM; ++i)
        st4(out + (o.r0 + i) * DV + cp, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
    return;
  }
  zero_acc(acc);
  const int gs = mode == 0 ? 1 : G;
  for (int g = 0; g < gs; ++g) {
    if (mode == 0) {
      const TT* kr = a.k + (size_t)row * N * D;
      const TT* vr = a.v + (size_t)row * N * DV;
      stage<C, D>(A, [&](int t, int c) {
        const int n = c0 + t;
        return n < len && c < a.dr ? phi4(load4(kr + (size_t)n * D + c), a.phi) : zero4();
      });
      stage<C, DV>(B, [&](int t, int c) {
        const int n = c0 + t;
        return n < len ? scale4(load4(vr + (size_t)n * DV + c), a.e[(size_t)row * N + n])
                       : zero4();
      });
    } else {
      const size_t rg = (size_t)row * G + g;
      const TT* qr = a.q + rg * N * D;
      const TT* gr = a.g_out + rg * N * DV;
      stage<C, D>(A, [&](int t, int c) {
        const int n = c0 + t;
        return n < len && c < a.dr
                   ? scale4(phi4(load4(qr + (size_t)n * D + c), a.phi), a.sink[rg * N + n])
                   : zero4();
      });
      stage<C, DV>(B, [&](int t, int c) {
        const int n = c0 + t;
        return n < len ? scale4(load4(gr + (size_t)n * DV + c), a.scale[rg * N + n]) : zero4();
      });
    }
    __syncthreads();
    mm_kk<O::RM, D, DV>(acc, A, B, o.r0, o.c0, 0, C);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < O::RM; ++i)
    st4(out + (o.r0 + i) * DV + o.c0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
}

template <int D, int DV = D>
constexpr int state_smem_floats() { return chunk_of<D>() * (D + DV); }

// The (row, chunk) of block b of a chunk-major grid over `rows` rows: the
// blocks in flight share their chunk's positions.
__device__ __forceinline__ int2 row_chunk(int b, int rows) { return make_int2(b % rows, b / rows); }

// Stage 3 (flow_fwd_pass, flow_bwd_pass): the pass over each row's live
// chunks, one thread per float4 of a row's D x Dv state.  Forward, slot c
// becomes the sum of the slots before it (from zero, in chunk order) and
// s_out, where set, the sum of all live slots; reversed, slot c becomes
// the seed plus the sum of the slots after it (from the last live chunk
// down).
struct PassArgs {
  const int* lens;
  float *states, *dstates;  // (BH, nc, D, Dv)
  float* s_out;             // (BH, D, Dv) or null
  const float* seed;        // (BH, D, Dv): the cotangent of S
  int rows, N, C, q4;       // q4 = D Dv / 4
};

__device__ __forceinline__ void pass_body(const PassArgs& a, bool rev) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)a.rows * a.q4) return;
  const int row = (int)(idx / a.q4), q = (int)(idx % a.q4);
  const int nc = (a.N + a.C - 1) / a.C;
  const int live = (min(a.lens[row], a.N) + a.C - 1) / a.C;
  float4* base = reinterpret_cast<float4*>(rev ? a.dstates : a.states) + (long long)row * nc * a.q4 + q;
  float4 h = rev ? reinterpret_cast<const float4*>(a.seed)[(long long)row * a.q4 + q] : zero4();
  // eight slots' loads in flight before their stores
  constexpr int B = 8;
  for (int j0 = 0; j0 < live; j0 += B) {
    float4 x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j = j0 + u;
      x[u] = j < live ? base[(long long)(rev ? live - 1 - j : j) * a.q4] : zero4();
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int j = j0 + u;
      if (j >= live) break;
      base[(long long)(rev ? live - 1 - j : j) * a.q4] = h;
      h = make_float4(h.x + x[u].x, h.y + x[u].y, h.z + x[u].z, h.w + x[u].w);
    }
  }
  if (!rev && a.s_out) reinterpret_cast<float4*>(a.s_out)[(long long)row * a.q4 + q] = h;
}

// Super-chunk of the flows: 8 segments of the scans' layout a segment
// (kFlowThreads / D of them; 8192 / D positions where D divides the block)
// where the block's shared memory holds them, else 4 or 2; 0 where none
// fits.
template <int D>
constexpr int flow_segs() { return kFlowThreads / D; }

template <int D>
int flows_tile(int g, int limit) {
  for (int t = 8 * flow_segs<D>(); t >= 2 * flow_segs<D>(); t /= 2)
    if (flow_smem_floats_at<D>(t, g) * sizeof(float) <= (size_t)limit) return t;
  return 0;
}

inline long long align4(long long n) { return (n + 3) / 4 * 4; }

template <class K>
cudaError_t allow_smem(K kern, size_t floats) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

inline cudaError_t smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace ff
