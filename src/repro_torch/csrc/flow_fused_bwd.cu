// flow_fused_bwd.cu — backward of the strict-causal Flow-Attention kernel
// (flow_fused.cu) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_fused/bwd.py::
// flow_fused_bwd_call (the pl.pallas_call at :178).  Given q, k, v, the
// per-row `lens`, the state total S the forward returned (each row's carry
// after its last position), the cotangent of `out` and the six state
// cotangents, it writes dq, dk and dv in the primal dtype; positions past
// `lens` get exact zeros.
//
// What bounds it on the H100: the arithmetic.  Per position and head it
// recomputes the forward (about 2(G+1) D Dv + 8 (G+1) D operations) and
// pulls the cotangents back through it (about twice that again), all fp32
// FMA on the CUDA cores (no tensor cores, no TF32), against one read of
// q, k, v, g_out and one write of dq, dk, dv.
//
// Design.  The TPU kernel walked its sequential chunk axis back to front
// with the suffix sums and the carried cotangent in VMEM, rebuilt each
// chunk's carry-in as "total - suffix - own increment", and called jax.vjp
// of the forward's chunk step.  Here one CTA owns one (row, kv head) and
// walks tiles of kTile positions (the kernel's own tile, independent of
// the caller's chunk: any padded N works), in two passes:
//   * forward pre-pass over the flows only: the four (D,) flow sums and z
//     are carried front to back exactly as K1 carries them, and each
//     tile's carry-in (4 D + 1 floats) is written to a scratch buffer in
//     device memory (1 KB per tile at D = 64).  Rebuilding these by
//     subtraction from the totals, as the TPU kernel does, leaves an
//     absolute error of a few ulp of the total (~1e-4 at N = 512) in
//     carries that are near 0 at the first positions, where pos is small:
//     fp32 parity with the plain version then failed by up to 4x its
//     tolerance (PERF.md, K2 findings).  The pre-pass costs the flows' O(D) work
//     per position once more, against the O(D Dv) work below;
//   * reverse pass, back to front: the tile's small carry-in is read back;
//     S (D x Dv) is rebuilt in shared memory by subtraction, S_in = S_out -
//     phi(k)^T (v e), starting from the total (its error is relative to
//     its own size, and parity holds); the carried cotangents of the six
//     carries, dS (D x Dv) included, stay in shared memory, starting from
//     the six state cotangents.
// K1's interface is unchanged.  Within a tile the forward quantities are
// recomputed from the carry-in, then the VJP is written out by hand, in
// reverse:
//   out = Y * r * alloc with Y = tril(q_in k^T) (v e) + q_in S, r = pos / z;
//   z = z_in + cumsum(e);  e = exp(clip(raw, -1, 1)), zero gradient where
//   raw lies outside [-1, 1];  alloc = sigmoid(cons_sink);
//   cons_sink / raw are (phi + eps).(ko / qi prefix sums + eps) over
//   pos G / pos;  q_in = phi(q) sink_in, sink_in = pos / den, src_out =
//   pos G / den, den = (phi + eps).(k / q prefix sums + eps).
// The pull-back of each in-tile inclusive prefix sum is a suffix sum
// within the tile plus the carried cotangent, run as a serial scan per
// feature column (one thread per column); dot products over a feature
// axis are warp reductions; the tile's matrix products are plain loops
// with one output element per thread, with S, dS, phi(k), v and v e rows
// padded by one float against bank conflicts.  Tiles wholly past the
// row's length are skipped: their increments and contributions are
// exactly zero, and their gradients are written as zeros.  One CTA per
// (row, kv head) gives B * Hkv CTAs, about one wave on 132 SMs at 16 rows
// x 8 heads.  Tensor-core products, TMA and splitting Dv across CTAs are
// left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// phi kinds: 0 sigmoid, 1 elu + 1, 2 relu
__device__ __forceinline__ float phi_fn(float x, int kind) {
  if (kind == 0) return 1.f / (1.f + expf(-x));
  if (kind == 1) return x > 0.f ? x + 1.f : expm1f(x) + 1.f;
  return fmaxf(x, 0.f);
}

// phi'(x) in terms of p = phi(x)
__device__ __forceinline__ float phi_grad(float p, int kind) {
  if (kind == 0) return p * (1.f - p);
  if (kind == 1) return p > 1.f ? 1.f : p;
  return p > 0.f ? 1.f : 0.f;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int tile, int g, int d, int dv) {
  return 2 * (size_t)d * (dv + 1)          // S (carry-in), dS (carried cotangent)
         + 2 * (size_t)g * tile * d        // phi(q); d q_in, then d phi(q)
         + 2 * (size_t)tile * (d + 1)      // phi(k), d phi(k)
         + 2 * (size_t)tile * (dv + 1)     // v, v e
         + (size_t)g * tile * dv           // g_out, then dY
         + (size_t)tile * dv               // d(v e)
         + 5 * (size_t)tile * d            // k/q/ko/qi prefix sums, ko suffix
         + 2 * (size_t)g * tile * tile     // scores, their cotangents
         + 5 * (size_t)g * tile            // per sink scalars
         + 9 * (size_t)tile                // per source scalars
         + 2 * (4 * (size_t)d + 1);        // small carries and their cotangents
}

// One CTA's shared-memory working set (see smem_floats for the sizes).
struct Smem {
  float *S, *dS, *pq, *dqin, *pk, *dpk, *vf, *vw, *gy, *dvw, *kc, *qc, *koc, *qic, *uko;
  float *sc, *dsc, *sink, *alloc, *odot, *dcs, *dsd, *src, *ev, *rr, *zz, *rawv, *dr, *de,
      *draw, *dsrc, *run, *dc;
};

template <int D, int DV, int TILE>
__device__ Smem carve(float* p, int G) {
  Smem m;
  m.S = p;                     p += D * (DV + 1);
  m.dS = p;                    p += D * (DV + 1);
  m.pq = p;                    p += G * TILE * D;
  m.dqin = p;                  p += G * TILE * D;
  m.pk = p;                    p += TILE * (D + 1);
  m.dpk = p;                   p += TILE * (D + 1);
  m.vf = p;                    p += TILE * (DV + 1);
  m.vw = p;                    p += TILE * (DV + 1);
  m.gy = p;                    p += G * TILE * DV;
  m.dvw = p;                   p += TILE * DV;
  m.kc = p;                    p += TILE * D;
  m.qc = p;                    p += TILE * D;
  m.koc = p;                   p += TILE * D;
  m.qic = p;                   p += TILE * D;
  m.uko = p;                   p += TILE * D;
  m.sc = p;                    p += G * TILE * TILE;
  m.dsc = p;                   p += G * TILE * TILE;
  m.sink = p;                  p += G * TILE;
  m.alloc = p;                 p += G * TILE;
  m.odot = p;                  p += G * TILE;
  m.dcs = p;                   p += G * TILE;
  m.dsd = p;                   p += G * TILE;
  m.src = p;                   p += TILE;
  m.ev = p;                    p += TILE;
  m.rr = p;                    p += TILE;
  m.zz = p;                    p += TILE;
  m.rawv = p;                  p += TILE;
  m.dr = p;                    p += TILE;
  m.de = p;                    p += TILE;
  m.draw = p;                  p += TILE;
  m.dsrc = p;                  p += TILE;
  m.run = p;                   p += 4 * D + 1;  // q, k, ko, qi carries (D each), z
  m.dc = p;                                      // their carried cotangents
  return m;
}

// phi(q) and phi(k) of the tile at p0, zero past the row's length
template <typename T, int D, int TILE>
__device__ void load_phi(const Smem& m, const T* qrow, const T* krow, int G, int N, int len,
                         int p0, int phi) {
  constexpr int PK = D + 1;
  for (int i = threadIdx.x; i < G * TILE * D; i += kThreads) {
    const int g = i / (TILE * D), r = i - g * TILE * D, t = r / D, d = r - t * D;
    const int n = p0 + t;
    m.pq[i] = n < len ? phi_fn(to_f32(qrow[((size_t)g * N + n) * D + d]), phi) : 0.f;
  }
  for (int i = threadIdx.x; i < TILE * D; i += kThreads) {
    const int t = i / D, d = i - t * D, n = p0 + t;
    m.pk[t * PK + d] = n < len ? phi_fn(to_f32(krow[(size_t)n * D + d]), phi) : 0.f;
  }
}

// The tile's flows from the small carries in m.run, as K1 computes them:
// prefix sums of the k/q and ko/qi sums (m.run advances to the tile's
// end), sink_in, src_out, the allocation, the unclipped cons_src and e.
// Starts after and ends with a __syncthreads.
template <int D, int TILE>
__device__ void flows(const Smem& m, int G, int p0, int len, float eps, int use_alloc) {
  constexpr int PK = D + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float fG = (float)G;
  float* q_run = m.run; float* k_run = m.run + D;
  float* ko_run = m.run + 2 * D; float* qi_run = m.run + 3 * D;
  // (1) inclusive prefix sums of phi(k) and of phi(q) summed over the group
  if (tid < D) {
    float acc = k_run[tid];
    for (int t = 0; t < TILE; ++t) { acc += m.pk[t * PK + tid]; m.kc[t * D + tid] = acc; }
    k_run[tid] = acc;
  } else if (tid < 2 * D) {
    const int d = tid - D;
    float acc = q_run[d];
    for (int t = 0; t < TILE; ++t) {
      float x = 0.f;
      for (int g = 0; g < G; ++g) x += m.pq[(g * TILE + t) * D + d];
      acc += x;
      m.qc[t * D + d] = acc;
    }
    q_run[d] = acc;
  }
  __syncthreads();
  // (2) incoming flow per sink, outgoing flow per source
  for (int r = warp; r < (G + 1) * TILE; r += kWarps) {
    const bool is_q = r < G * TILE;
    const int t = is_q ? r % TILE : r - G * TILE;
    const float* a = is_q ? m.pq + r * D : m.pk + t * PK;
    const float* c = is_q ? m.kc + t * D : m.qc + t * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
    acc = warp_sum(acc);
    if (lane == 0) {
      const float pos = (float)(p0 + t + 1);
      if (is_q) m.sink[r] = pos / acc;
      else m.src[t] = pos * fG / acc;
    }
  }
  __syncthreads();
  // (3) conservation prefix sums: ko over sources, qi over sinks
  if (tid < D) {
    float acc = ko_run[tid];
    for (int t = 0; t < TILE; ++t) {
      acc += m.pk[t * PK + tid] * m.src[t];
      m.koc[t * D + tid] = acc;
    }
    ko_run[tid] = acc;
  } else if (tid < 2 * D) {
    const int d = tid - D;
    float acc = qi_run[d];
    for (int t = 0; t < TILE; ++t) {
      float x = 0.f;
      for (int g = 0; g < G; ++g) x += m.pq[(g * TILE + t) * D + d] * m.sink[g * TILE + t];
      acc += x;
      m.qic[t * D + d] = acc;
    }
    qi_run[d] = acc;
  }
  __syncthreads();
  // (4) conserved flows: allocation per sink, competition weight per source
  for (int r = warp; r < (G + 1) * TILE; r += kWarps) {
    const bool is_q = r < G * TILE;
    const int t = is_q ? r % TILE : r - G * TILE;
    const float* a = is_q ? m.pq + r * D : m.pk + t * PK;
    const float* c = is_q ? m.koc + t * D : m.qic + t * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
    acc = warp_sum(acc);
    if (lane == 0) {
      const float pos = (float)(p0 + t + 1);
      if (is_q) {
        const float cons_sink = acc / (pos * fG);
        m.alloc[r] = use_alloc ? 1.f / (1.f + expf(-cons_sink)) : 1.f;
      } else {
        const float raw = acc / pos;
        m.rawv[t] = raw;
        m.ev[t] = p0 + t < len ? expf(fminf(fmaxf(raw, -1.f), 1.f)) : 0.f;
      }
    }
  }
  __syncthreads();
}

template <typename T, int D, int DV, int TILE>
__global__ void __launch_bounds__(kThreads)
flow_fused_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lens,
                      const float* __restrict__ ts, const T* __restrict__ g_out,
                      const float* __restrict__ gq, const float* __restrict__ gk,
                      const float* __restrict__ gko, const float* __restrict__ gqi,
                      const float* __restrict__ gz, const float* __restrict__ gs,
                      T* __restrict__ dq_o, T* __restrict__ dk_o, T* __restrict__ dv_o,
                      float* __restrict__ carry, int carry_stride, int G, int N, int phi,
                      int use_alloc, float eps) {
  static_assert(2 * D <= kThreads, "one thread per feature column for each of two scans");
  constexpr int SP = DV + 1;  // padded rows of S and dS
  constexpr int PK = D + 1;   // padded rows of phi(k) and d phi(k)
  constexpr int VP = DV + 1;  // padded rows of v and v e
  constexpr int NC = 4 * D + 1;  // small carries per tile
  extern __shared__ float smem[];
  const Smem m = carve<D, DV, TILE>(smem, G);
  float* S = m.S; float* dS = m.dS; float* pq = m.pq; float* dqin = m.dqin;
  float* pk = m.pk; float* dpk = m.dpk; float* vf = m.vf; float* vw = m.vw;
  float* gy = m.gy; float* dvw = m.dvw; float* kc = m.kc; float* qc = m.qc;
  float* koc = m.koc; float* qic = m.qic; float* uko = m.uko; float* sc = m.sc;
  float* dsc = m.dsc; float* sink = m.sink; float* alloc = m.alloc; float* odot = m.odot;
  float* dcs = m.dcs; float* dsd = m.dsd; float* src = m.src; float* ev = m.ev;
  float* rr = m.rr; float* zz = m.zz; float* rawv = m.rawv; float* dr = m.dr;
  float* de = m.de; float* draw = m.draw; float* dsrc = m.dsrc; float* run = m.run;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lens[row], N);
  const float fG = (float)G;
  const size_t qoff = (size_t)row * G * N * D, koff = (size_t)row * N * D;
  const size_t voff = (size_t)row * N * DV, goff = (size_t)row * G * N * DV;
  float* crow = carry + (size_t)row * carry_stride;

  for (int i = tid; i < D * DV; i += kThreads) {
    const int d = i / DV, e = i - d * DV;
    S[d * SP + e] = ts[(size_t)row * D * DV + i];
    dS[d * SP + e] = gs[(size_t)row * D * DV + i];
  }
  for (int d = tid; d < D; d += kThreads) {
    const size_t o = (size_t)row * D + d;
    m.dc[d] = gq[o]; m.dc[D + d] = gk[o]; m.dc[2 * D + d] = gko[o]; m.dc[3 * D + d] = gqi[o];
  }
  for (int i = tid; i < NC; i += kThreads) run[i] = 0.f;
  if (tid == 0) m.dc[4 * D] = gz[row];

  // positions in tiles wholly past the row's length: exactly zero gradients
  const int live_tiles = (len + TILE - 1) / TILE;
  const int n0 = live_tiles * TILE;
  for (int n = n0 + tid / D; n < N; n += kThreads / D)
    for (int g = 0; g < G; ++g) dq_o[qoff + ((size_t)g * N + n) * D + tid % D] = from_f32<T>(0.f);
  for (int i = n0 * D + tid; i < N * D; i += kThreads) dk_o[koff + i] = from_f32<T>(0.f);
  for (int i = n0 * DV + tid; i < N * DV; i += kThreads) dv_o[voff + i] = from_f32<T>(0.f);
  __syncthreads();

  // forward pre-pass: each tile's small carry-in, carried front to back
  for (int tile = 0; tile < live_tiles; ++tile) {
    const int p0 = tile * TILE;
    for (int i = tid; i < NC; i += kThreads) crow[tile * NC + i] = run[i];
    load_phi<T, D, TILE>(m, q + qoff, k + koff, G, N, len, p0, phi);
    __syncthreads();
    flows<D, TILE>(m, G, p0, len, eps, use_alloc);
    if (tid == 0) {
      float acc = run[4 * D];
      for (int t = 0; t < TILE; ++t) acc += ev[t];
      run[4 * D] = acc;
    }
    __syncthreads();
  }

  float* dq_c = m.dc; float* dk_c = m.dc + D; float* dko_c = m.dc + 2 * D;
  float* dqi_c = m.dc + 3 * D; float* dz_c = m.dc + 4 * D;

  for (int tile = live_tiles - 1; tile >= 0; --tile) {
    const int p0 = tile * TILE;
    // (0) load: the tile's small carry-in; phi of q and k; v; g_out
    for (int i = tid; i < NC; i += kThreads) run[i] = crow[tile * NC + i];
    load_phi<T, D, TILE>(m, q + qoff, k + koff, G, N, len, p0, phi);
    for (int i = tid; i < TILE * DV; i += kThreads) {
      const int t = i / DV, e = i - t * DV, n = p0 + t;
      vf[t * VP + e] = n < N ? to_f32(v[voff + (size_t)n * DV + e]) : 0.f;
    }
    for (int i = tid; i < G * TILE * DV; i += kThreads) {
      const int g = i / (TILE * DV), r = i - g * TILE * DV, t = r / DV, e = r - t * DV;
      const int n = p0 + t;
      gy[i] = n < N ? to_f32(g_out[goff + ((size_t)g * N + n) * DV + e]) : 0.f;
    }
    __syncthreads();

    // (1)-(4) the tile's flows, recomputed from its carry-in
    flows<D, TILE>(m, G, p0, len, eps, use_alloc);

    // (5) z prefix sums from its carry-in; v e; S's carry-in by
    // subtraction; causal in-tile scores q_in[i] . phi(k)[j], j <= i
    if (tid == 0) {
      float acc = run[4 * D];
      for (int t = 0; t < TILE; ++t) {
        acc += ev[t];
        zz[t] = acc;
        rr[t] = (float)(p0 + t + 1) / acc;
      }
    }
    for (int i = tid; i < TILE * DV; i += kThreads) {
      const int t = i / DV, e = i - t * DV;
      vw[t * VP + e] = vf[t * VP + e] * ev[t];
    }
    for (int i = tid; i < D * DV; i += kThreads) {
      const int d = i / DV, e = i - d * DV;
      float acc = 0.f;
      for (int t = 0; t < TILE; ++t) acc += pk[t * PK + d] * (vf[t * VP + e] * ev[t]);
      S[d * SP + e] -= acc;
    }
    for (int i = tid; i < G * TILE * TILE; i += kThreads) {
      const int gi = i / TILE, j = i - gi * TILE, a = gi % TILE;
      float acc = 0.f;
      if (j <= a) {
        const float* x = pq + gi * D;
        const float* y = pk + j * PK;
        for (int d = 0; d < D; ++d) acc += x[d] * y[d];
        acc *= sink[gi];
      }
      sc[i] = acc;
    }
    __syncthreads();

    // (6) g_out . Y per sink, Y = intra + inter recomputed from the carry-in
    for (int gi = warp; gi < G * TILE; gi += kWarps) {
      const int a = gi % TILE;
      const float* srow = sc + gi * TILE;
      const float* x = pq + gi * D;
      const float s_in = sink[gi];
      float acc = 0.f;
      for (int e = lane; e < DV; e += 32) {
        float intra = 0.f;
        for (int j = 0; j <= a; ++j) intra += srow[j] * vw[j * VP + e];
        float inter = 0.f;
        for (int d = 0; d < D; ++d) inter += x[d] * S[d * SP + e];
        acc += gy[gi * DV + e] * (intra + inter * s_in);
      }
      acc = warp_sum(acc);
      if (lane == 0) odot[gi] = acc;
    }
    __syncthreads();

    // (7) out = Y r alloc: d r, d cons_sink, dY
    for (int t = tid; t < TILE; t += kThreads) {
      float acc = 0.f;
      for (int g = 0; g < G; ++g) acc += alloc[g * TILE + t] * odot[g * TILE + t];
      dr[t] = acc;
    }
    for (int gi = tid; gi < G * TILE; gi += kThreads) {
      const int t = gi % TILE;
      const float al = alloc[gi];
      const float pg = (float)(p0 + t + 1) * fG;
      dcs[gi] = use_alloc ? rr[t] * odot[gi] * al * (1.f - al) / pg : 0.f;
    }
    for (int i = tid; i < G * TILE * DV; i += kThreads) {
      const int gi = i / DV, t = gi % TILE;
      gy[i] *= rr[t] * alloc[gi];
    }
    __syncthreads();

    // (8) d e from z (suffix sums plus the carried dz); score cotangents
    if (tid == 0) {
      float acc = dz_c[0];
      for (int t = TILE - 1; t >= 0; --t) {
        acc += -dr[t] * rr[t] / zz[t];
        de[t] = acc;
      }
      dz_c[0] = acc;
    }
    for (int i = tid; i < G * TILE * TILE; i += kThreads) {
      const int gi = i / TILE, j = i - gi * TILE, a = gi % TILE;
      float acc = 0.f;
      if (j <= a) {
        const float* x = gy + gi * DV;
        const float* y = vw + j * VP;
        for (int e = 0; e < DV; ++e) acc += x[e] * y[e];
      }
      dsc[i] = acc;
    }
    __syncthreads();

    // (9) cotangents of v e, q_in and phi(k) from Y and the carried dS
    for (int i = tid; i < TILE * DV; i += kThreads) {
      const int j = i / DV, e = i - j * DV;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += pk[j * PK + d] * dS[d * SP + e];
      for (int g = 0; g < G; ++g)
        for (int a = j; a < TILE; ++a)
          acc += sc[(g * TILE + a) * TILE + j] * gy[(g * TILE + a) * DV + e];
      dvw[i] = acc;
    }
    for (int i = tid; i < G * TILE * D; i += kThreads) {
      const int gi = i / D, d = i - gi * D, a = gi % TILE;
      float acc = 0.f;
      const float* y = gy + gi * DV;
      for (int e = 0; e < DV; ++e) acc += y[e] * S[d * SP + e];
      const float* c = dsc + gi * TILE;
      for (int j = 0; j <= a; ++j) acc += c[j] * pk[j * PK + d];
      dqin[i] = acc;
    }
    for (int i = tid; i < TILE * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      float acc = 0.f;
      for (int e = 0; e < DV; ++e) acc += dS[d * SP + e] * vw[j * VP + e];
      for (int g = 0; g < G; ++g)
        for (int a = j; a < TILE; ++a) {
          const int gi = g * TILE + a;
          acc += dsc[gi * TILE + j] * (pq[gi * D + d] * sink[gi]);
        }
      dpk[j * PK + d] = acc;
    }
    __syncthreads();

    // (10) carried dS += q_in^T dY; d e from v e; dv; d raw
    for (int i = tid; i < D * DV; i += kThreads) {
      const int d = i / DV, e = i - d * DV;
      float acc = 0.f;
      for (int gi = 0; gi < G * TILE; ++gi) acc += (pq[gi * D + d] * sink[gi]) * gy[gi * DV + e];
      dS[d * SP + e] += acc;
    }
    for (int j = warp; j < TILE; j += kWarps) {
      const int n = p0 + j;
      float acc = 0.f;
      for (int e = lane; e < DV; e += 32) {
        acc += dvw[j * DV + e] * vf[j * VP + e];
        if (n < N) dv_o[voff + (size_t)n * DV + e] =
            from_f32<T>(n < len ? dvw[j * DV + e] * ev[j] : 0.f);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const float d_e = de[j] + acc;
        const float raw = rawv[j];
        const bool in_range = raw >= -1.f && raw <= 1.f;
        draw[j] = in_range ? d_e * ev[j] / (float)(n + 1) : 0.f;
      }
    }
    __syncthreads();

    // (11) suffix scans: qi (d raw . (phi(k) + eps)) and ko (d cons_sink)
    if (tid < D) {
      float acc = dqi_c[tid];
      for (int t = TILE - 1; t >= 0; --t) {
        acc += draw[t] * (pk[t * PK + tid] + eps);
        for (int g = 0; g < G; ++g) dqin[(g * TILE + t) * D + tid] += acc;
        dpk[t * PK + tid] += draw[t] * (qic[t * D + tid] + eps);
      }
      dqi_c[tid] = acc;
    } else if (tid < 2 * D) {
      const int d = tid - D;
      float acc = dko_c[d];
      for (int t = TILE - 1; t >= 0; --t) {
        for (int g = 0; g < G; ++g)
          acc += dcs[g * TILE + t] * (pq[(g * TILE + t) * D + d] + eps);
        uko[t * D + d] = acc;
      }
      dko_c[d] = acc;
    }
    __syncthreads();

    // (12) d src_out and d sink_in through their denominators; ko into phi(k)
    for (int r = warp; r < (G + 1) * TILE; r += kWarps) {
      const bool is_q = r < G * TILE;
      const int t = is_q ? r % TILE : r - G * TILE;
      const float* a = is_q ? dqin + r * D : uko + t * D;
      const float* c = is_q ? pq + r * D : pk + t * PK;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += a[d] * c[d];
      acc = warp_sum(acc);
      if (lane == 0) {
        const float pos = (float)(p0 + t + 1);
        if (is_q) dsd[r] = -acc * sink[r] * sink[r] / pos;
        else dsrc[t] = -acc * src[t] * src[t] / (pos * fG);
      }
    }
    for (int i = tid; i < TILE * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      dpk[t * PK + d] += uko[i] * src[t];
    }
    __syncthreads();

    // (13) d phi(q) = d q_in sink_in + the ko and k-sum denominators' terms
    for (int i = tid; i < G * TILE * D; i += kThreads) {
      const int gi = i / D, d = i - gi * D, t = gi % TILE;
      dqin[i] = dqin[i] * sink[gi] + dcs[gi] * (koc[t * D + d] + eps)
                + dsd[gi] * (kc[t * D + d] + eps);
    }
    for (int i = tid; i < TILE * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      dpk[t * PK + d] += dsrc[t] * (qc[i] + eps);
    }
    __syncthreads();

    // (14) suffix scans of the k and q prefix sums' cotangents
    if (tid < D) {
      float acc = dk_c[tid];
      for (int t = TILE - 1; t >= 0; --t) {
        for (int g = 0; g < G; ++g)
          acc += dsd[g * TILE + t] * (pq[(g * TILE + t) * D + tid] + eps);
        dpk[t * PK + tid] += acc;
      }
      dk_c[tid] = acc;
    } else if (tid < 2 * D) {
      const int d = tid - D;
      float acc = dq_c[d];
      for (int t = TILE - 1; t >= 0; --t) {
        acc += dsrc[t] * (pk[t * PK + d] + eps);
        for (int g = 0; g < G; ++g) dqin[(g * TILE + t) * D + d] += acc;
      }
      dq_c[d] = acc;
    }
    __syncthreads();

    // (15) through phi; zero past the length
    for (int i = tid; i < G * TILE * D; i += kThreads) {
      const int g = i / (TILE * D), r = i - g * TILE * D, t = r / D, d = r - t * D;
      const int n = p0 + t;
      if (n < N)
        dq_o[qoff + ((size_t)g * N + n) * D + d] =
            from_f32<T>(n < len ? dqin[i] * phi_grad(pq[i], phi) : 0.f);
    }
    for (int i = tid; i < TILE * D; i += kThreads) {
      const int t = i / D, d = i - t * D, n = p0 + t;
      if (n < N)
        dk_o[koff + (size_t)n * D + d] =
            from_f32<T>(n < len ? dpk[t * PK + d] * phi_grad(pk[t * PK + d], phi) : 0.f);
    }
    __syncthreads();
  }
}

template <typename T, int D, int TILE>
cudaError_t launch(const void* const* in, void* dq, void* dk, void* dv, void* carry,
                   int carry_stride, int bh, int g, int n, int phi, int use_alloc,
                   float eps, cudaStream_t stream) {
  auto kern = flow_fused_bwd_kernel<T, D, D, TILE>;
  const size_t bytes = smem_floats(TILE, g, D, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const int*)in[3],
      (const float*)in[4], (const T*)in[5], (const float*)in[6], (const float*)in[7],
      (const float*)in[8], (const float*)in[9], (const float*)in[10],
      (const float*)in[11], (T*)dq, (T*)dk, (T*)dv, (float*)carry, carry_stride, g, n,
      phi, use_alloc, eps);
  return cudaGetLastError();
}

// the largest tile whose shared memory fits the card's per-block limit;
// the scratch holds ceil(n / 8) tiles per row, enough for either
template <typename T, int D>
cudaError_t pick_tile(const void* const* in, void* dq, void* dk, void* dv, void* carry,
                      int bh, int g, int n, int phi, int use_alloc, float eps,
                      cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int stride = (n + 7) / 8 * (4 * D + 1);
  if (smem_floats(32, g, D, D) * sizeof(float) <= (size_t)limit)
    return launch<T, D, 32>(in, dq, dk, dv, carry, stride, bh, g, n, phi, use_alloc, eps,
                            stream);
  if (smem_floats(8, g, D, D) * sizeof(float) <= (size_t)limit)
    return launch<T, D, 8>(in, dq, dk, dv, carry, stride, bh, g, n, phi, use_alloc, eps,
                           stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int d, const void* const* in, void* dq, void* dk, void* dv,
                     void* carry, int bh, int g, int n, int phi, int use_alloc, float eps,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return pick_tile<T, 32>(in, dq, dk, dv, carry, bh, g, n, phi, use_alloc, eps, stream);
    case 64:
      return pick_tile<T, 64>(in, dq, dk, dv, carry, bh, g, n, phi, use_alloc, eps, stream);
    case 128:
      return pick_tile<T, 128>(in, dq, dk, dv, carry, bh, g, n, phi, use_alloc, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) and g_out (BH, G, N, Dv) in
// `dtype` (0 fp32, 1 bf16); lens (BH,) int32 with 1 <= lens <= N; the
// forward's state total ts (BH, D, Dv) and the cotangents of the six state
// outputs gq/gk/gko/gqi (BH, D), gz (BH,), gs (BH, D, Dv), fp32; carry a
// scratch of BH * ceil(N / 8) * (4 D + 1) fp32.  Writes dq, dk, dv with the
// shapes and dtype of q, k, v.  D == Dv in {32, 64, 128}.  Returns a
// cudaError_t.
extern "C" int flow_fused_bwd(const void* q, const void* k, const void* v, const void* lens,
                              const void* ts, const void* g_out, const void* gq,
                              const void* gk, const void* gko, const void* gqi,
                              const void* gz, const void* gs, void* dq, void* dk, void* dv,
                              void* carry, int bh, int g, int n, int d, int dv_dim,
                              int dtype, int phi, int use_alloc, float eps, void* stream) {
  if (d != dv_dim || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  const void* in[12] = {q, k, v, lens, ts, g_out, gq, gk, gko, gqi, gz, gs};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, in, dq, dk, dv, carry, bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, in, dq, dk, dv, carry, bh, g, n, phi, use_alloc,
                                        eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_fused_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
