// flow_fused_bwd.cu — backward of the strict-causal Flow-Attention kernel
// (flow_fused.cu) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_fused/bwd.py::
// flow_fused_bwd_call (the pl.pallas_call at :178).  Given q, k, v, the
// per-row `lens`, the cotangent of `out` and the six state cotangents, it
// writes dq, dk and dv in the primal dtype; positions past `lens` get
// exact zeros.
//
// What bounds it on the H100: operations.  Per live position it recomputes
// the forward (2 (G + 1) D Dv + ~7 (G + 1) D operations) and pulls the
// cotangents back (4 (G + 1) D Dv more for dY S^T, q_in^T dY, dS^T phi(k)
// and dS (v e), and ~14 (G + 1) D for the flows), all fp32 FMA on the CUDA
// cores (no tensor cores, no TF32) at 67 TFLOP/s, against one read of q,
// k, v, g_out and one write of dq, dk, dv.
//
// Design: the forward's decomposition run in reverse, five launches per
// call (the pieces shared with K1 are in flow_fused_common.cuh).
//   flow_bwd_flows: K1's flows again (its super-chunk), saving the carry-in
//     of the five small sums (4 D + 1 floats) at every super-chunk of the
//     pull-back: at its own super-chunks' starts the carries, inside them
//     the level panels' rows.  Nothing is rebuilt by subtraction: "total -
//     suffix - own increment" carries fail fp32 parity at small positions,
//     where the sums are near 0.
//   flow_bwd_state: per (row, chunk) the chunk state phi(k)^T (v e) and the
//     cotangent state q_in^T dY, dY = g_out r alloc, summed over the group
//     (grid y = which).
//   flow_bwd_pass: S_<c by the forward pass; dS_>c by a reverse pass from
//     the last live chunk down, seeded with the S cotangent (grid y).
//   flow_bwd_chunk: per (row, chunk), for each group, the causal panels
//     tril(q_in phi(k)^T) and tril(dY (v e)^T), then g_out . Y (Y
//     recomputed), d q_in = panel' phi(k) + dY S_<c^T, and, summed over
//     the group in registers, d phi(k) = panel'^T q_in + (v e) dS_>c^T and
//     d(v e) = panel^T dY + phi(k) dS_>c; writes dv = d(v e) e and, for
//     the flows, d q_in, d phi(k), g_out . Y and d(v e) . v to scratch.
//   flow_bwd_pull: one block of 1024 threads per row walks its live
//     super-chunks (T = 4096 / D, 2048 / D where its shared memory needs
//     it) back to front, recomputes their flows from the saved carry-ins
//     and pulls the three levels back: the z chain (a warp scan), then the
//     qi/ko and k/q prefix sums as block-wide segmented suffix scans seeded
//     at the row's boundary with the cotangents of the four sums and z;
//     then dq, dk through phi, zero past the length.  Like the flows it is
//     a chain of latencies, one block per row.
// The chunk is K1's (C = 64, 32 at D = 128).  Shared memory per block at
// D = 64, G = 1: 204 KB (flows), 32 KB (state), 112 KB (chunk: dS_>c's
// tile holds the panels once the group loop starts, so two blocks fit an
// SM), 141 KB (pull).
//
// D = 24 runs the D = 32 instantiation on zero-padded rows, as K1 does
// (flow_fused_common.cuh): phi of q and k is 0 on lanes 24-31, and dq and
// dk are written 0 there.
#include "flow_fused_common.cuh"

namespace {

using namespace ff;

template <typename TT, int D, int T>
__global__ void __launch_bounds__(kFlowThreads) flow_bwd_flows(FlowArgs<TT> a) {
  extern __shared__ float smem[];
  flows_body<TT, D, T>(a, smem);
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads) flow_bwd_state(StateArgs<TT, D> a, int rows) {
  extern __shared__ float smem[];
  const int2 rc = row_chunk(blockIdx.x, rows);
  state_block<TT, D>(a, blockIdx.y, rc.x, rc.y, smem);
}

__global__ void __launch_bounds__(kThreads) flow_bwd_pass(PassArgs a) {
  pass_body(a, blockIdx.y == 1);
}

template <typename TT>
struct ChunkArgs {
  const TT *q, *k, *v, *g_out;
  const int* lens;
  const float *sink, *scale, *e, *states, *dstates;
  TT* dv;
  float *dqin, *dpk, *odot, *dvv;  // (BH, G, N, D), (BH, N, D), (BH, G, N), (BH, N)
  int G, N, phi, rows, dr;
};

template <int D>
constexpr int chunk_smem_floats() {
  constexpr int C = chunk_of<D>();
  return 4 * C * D + D * D + (D * D > 2 * C * C ? D * D : 2 * C * C);
}

// Sum over the TN consecutive lanes that share an output row.
template <int TN>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TN / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads, 2) flow_bwd_chunk(ChunkArgs<TT> a) {
  constexpr int C = chunk_of<D>(), DV = D;
  extern __shared__ float smem[];
  float* Q = smem;          // C x D: q_in of one group
  float* K = Q + C * D;     // C x D: phi(k)
  float* V = K + C * D;     // C x DV: v e
  float* Y = V + C * DV;    // C x DV: dY of one group
  float* S = Y + C * DV;    // D x DV: S_<c
  float* dS = S + D * DV;   // D x DV: dS_>c, read only before the group loop,
  float* P = dS;            // then C x C: tril(q_in phi(k)^T)
  float* dP = P + C * C;    // and C x C: tril(dY (v e)^T)
  const int2 rc = row_chunk(blockIdx.x, a.rows);
  const int row = rc.x, ci = rc.y, G = a.G, N = a.N, c0 = ci * C;
  const int len = min(a.lens[row], N);
  TT* dvr = a.dv + (size_t)row * N * DV;
  if (c0 >= len) {  // a dead chunk: dv is zero; the flows never read it
    constexpr int Q4 = DV / 4;
    for (int i = threadIdx.x; i < C * Q4; i += kThreads) {
      const int t = i / Q4, c = (i - t * Q4) * 4;
      if (c0 + t < N) store4(dvr + (size_t)(c0 + t) * DV + c, zero4());
    }
    return;
  }
  const TT* kr = a.k + (size_t)row * N * D;
  const TT* vr = a.v + (size_t)row * N * DV;
  const float* er = a.e + (size_t)row * N;
  stage<C, D>(K, [&](int t, int c) {
    const int n = c0 + t;
    return n < len && c < a.dr ? phi4(load4(kr + (size_t)n * D + c), a.phi) : zero4();
  });
  stage<C, DV>(V, [&](int t, int c) {
    const int n = c0 + t;
    return n < len ? scale4(load4(vr + (size_t)n * DV + c), er[n]) : zero4();
  });
  const int nc = (N + C - 1) / C;
  const size_t slot = ((size_t)row * nc + ci) * D * DV;
  stage<D, DV>(S, [&](int t, int c) { return ld4(a.states + slot + t * DV + c); });
  stage<D, DV>(dS, [&](int t, int c) { return ld4(a.dstates + slot + t * DV + c); });
  __syncthreads();
  using O = Own<C, D>;  // every C x D and C x DV output (D == DV)
  using OP = Own<C, C>;
  const O o;
  const OP op;
  const int kmax = min(C, (o.r0 + O::RM + 3) & ~3);  // the panels' causal extent
  float gk[O::RM][4], gv[O::RM][4];  // d phi(k), d(v e)
  zero_acc(gk);
  zero_acc(gv);
  mm_mn<O::RM, DV, DV, DV>(gk, V, dS, o.r0, o.c0);
  mm_mk<O::RM, D, DV>(gv, K, dS, o.r0, o.c0, D);
  for (int g = 0; g < G; ++g) {
    const size_t rg = (size_t)row * G + g;
    const TT* qr = a.q + rg * N * D;
    const TT* gr = a.g_out + rg * N * DV;
    stage<C, D>(Q, [&](int t, int c) {
      const int n = c0 + t;
      return n < len && c < a.dr
                 ? scale4(phi4(load4(qr + (size_t)n * D + c), a.phi), a.sink[rg * N + n])
                 : zero4();
    });
    stage<C, DV>(Y, [&](int t, int c) {
      const int n = c0 + t;
      return n < len ? scale4(load4(gr + (size_t)n * DV + c), a.scale[rg * N + n]) : zero4();
    });
    __syncthreads();
    {
      float acc[OP::RM][4];
      zero_acc(acc);
      mm_mn<OP::RM, D, D, D>(acc, Q, K, op.r0, op.c0);
      put_tile<OP::RM, C, true>(P, acc, op.r0, op.c0);
      zero_acc(acc);
      mm_mn<OP::RM, DV, DV, DV>(acc, Y, V, op.r0, op.c0);
      put_tile<OP::RM, C, true>(dP, acc, op.r0, op.c0);
    }
    __syncthreads();
    {  // g_out . Y, Y = panel (v e) + q_in S_<c
      float acc[O::RM][4];
      zero_acc(acc);
      mm_mk<O::RM, C, DV>(acc, P, V, o.r0, o.c0, kmax);
      mm_mk<O::RM, D, DV>(acc, Q, S, o.r0, o.c0, D);
#pragma unroll
      for (int i = 0; i < O::RM; ++i) {
        const int n = c0 + o.r0 + i;
        const float4 go = n < len ? load4(gr + (size_t)min(n, N - 1) * DV + o.c0) : zero4();
        const float dot = row_sum<O::TN>(go.x * acc[i][0] + go.y * acc[i][1] +
                                         go.z * acc[i][2] + go.w * acc[i][3]);
        if (o.c0 == 0 && n < N) a.odot[rg * N + n] = dot;
      }
    }
    {  // d q_in = panel' phi(k) + dY S_<c^T
      float acc[O::RM][4];
      zero_acc(acc);
      mm_mk<O::RM, C, D>(acc, dP, K, o.r0, o.c0, kmax);
      mm_mn<O::RM, DV, DV, DV>(acc, Y, S, o.r0, o.c0);
#pragma unroll
      for (int i = 0; i < O::RM; ++i) {
        const int n = c0 + o.r0 + i;
        if (n < N)
          st4(a.dqin + (rg * N + n) * D + o.c0,
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    mm_kk<O::RM, C, D>(gk, dP, Q, o.r0, o.c0, o.r0, C);
    mm_kk<O::RM, C, DV>(gv, P, Y, o.r0, o.c0, o.r0, C);
    __syncthreads();  // Q, Y and the panels are restaged for the next group
  }
#pragma unroll
  for (int i = 0; i < O::RM; ++i) {
    const int n = c0 + o.r0 + i;
    const bool ok = n < len;
    const int nn = min(n, N - 1);
    const float4 vv = ok ? load4(vr + (size_t)nn * DV + o.c0) : zero4();
    const float dot = row_sum<O::TN>(gv[i][0] * vv.x + gv[i][1] * vv.y + gv[i][2] * vv.z +
                                     gv[i][3] * vv.w);
    if (n >= N) continue;
    st4(a.dpk + ((size_t)row * N + n) * D + o.c0,
        make_float4(gk[i][0], gk[i][1], gk[i][2], gk[i][3]));
    const float ev = ok ? er[n] : 0.f;
    store4(dvr + (size_t)n * DV + o.c0,
           make_float4(gv[i][0] * ev, gv[i][1] * ev, gv[i][2] * ev, gv[i][3] * ev));
    if (o.c0 == 0) a.dvv[(size_t)row * N + n] = dot;
  }
}

template <typename TT>
struct PullArgs {
  const TT *q, *k;
  const int* lens;
  const float* carry;
  const float *gq, *gk, *gko, *gqi, *gz;
  const float *dqin, *dpk, *odot, *dvv;
  TT *dq, *dk;
  int G, N, phi, use_alloc;
  float eps;
  int dr;
};

template <int D, int T>
__host__ __device__ constexpr size_t pull_smem_floats(int g) {
  return flow_smem_floats<D, T>(g) + (size_t)(g + 1) * T * D + 3 * (size_t)g * T +
         4 * (size_t)T + 4 * (size_t)D + 4;
}

template <typename TT, int D, int T>
__global__ void __launch_bounds__(kFlowThreads) flow_bwd_pull(PullArgs<TT> a) {
  extern __shared__ float smem[];
  const int G = a.G, N = a.N, row = blockIdx.x;
  const FlowSmem m = carve_flows<D, T>(smem, G);
  float* p = smem + flow_smem_floats<D, T>(G);
  float* dq = p;   p += G * T * D;  // d q_in, then d phi(q)
  float* dk = p;   p += T * D;      // d phi(k)
  float* od = p;   p += G * T;      // g_out . Y
  float* dcs = p;  p += G * T;      // d cons_sink / (pos G), through the sigmoid
  float* dsd = p;  p += G * T;      // d of sink_in's denominator
  float* xz = p;   p += T;          // d z
  float* draw = p; p += T;          // d of cons_src's dot
  float* dso = p;  p += T;          // d of src_out's denominator
  float* dvv = p;  p += T;          // d(v e) . v
  float* dc = p;                    // carried cotangents: q, k, ko, qi sums, z
  float* dq_c = dc;
  float* dk_c = dc + D;
  float* dko_c = dc + 2 * D;
  float* dqi_c = dc + 3 * D;
  float* dz_c = dc + 4 * D;
  const float eps = a.eps, fG = (float)G;
  const int len = min(a.lens[row], N);
  const int live = (len + T - 1) / T, nt = (N + T - 1) / T;
  const TT* qrow = a.q + (size_t)row * G * N * D;
  const TT* krow = a.k + (size_t)row * N * D;
  TT* dqrow = a.dq + (size_t)row * G * N * D;
  TT* dkrow = a.dk + (size_t)row * N * D;
  for (int d = threadIdx.x; d < D; d += kFlowThreads) {
    const size_t o = (size_t)row * D + d;
    dq_c[d] = a.gq[o];
    dk_c[d] = a.gk[o];
    dko_c[d] = a.gko[o];
    dqi_c[d] = a.gqi[o];
  }
  if (threadIdx.x == 0) *dz_c = a.gz[row];
  // positions in super-chunks wholly past the length: exactly zero
  const int n0 = live * T;
  if (n0 < N) {
    for (int i = threadIdx.x; i < G * (N - n0) * D; i += kFlowThreads) {
      const int g = i / ((N - n0) * D), r = i - g * (N - n0) * D;
      dqrow[((size_t)g * N + n0) * D + r] = from_f32<TT>(0.f);
    }
    for (int i = threadIdx.x; i < (N - n0) * D; i += kFlowThreads)
      dkrow[(size_t)n0 * D + i] = from_f32<TT>(0.f);
  }
  constexpr int Q4 = D / 4;
  for (int it = live - 1; it >= 0; --it) {
    const int p0 = it * T;
    // (0) the carry-in, phi of q and k, and what flow_bwd_chunk left
    for (int i = threadIdx.x; i < 4 * D + 1; i += kFlowThreads)
      m.run[i] = a.carry[((size_t)row * nt + it) * (4 * D + 1) + i];
    load_phi<TT, D, T>(m, qrow, krow, G, N, len, p0, a.phi, a.dr);
    if (it > 0) {  // the super-chunk before this one is next
      const int p1 = p0 - T;
      prefetch_superchunk<TT, D, T>(qrow, krow, G, N, len, p1);
      for (int g = 0; g < G; ++g)
        prefetch_l2(a.dqin + (((size_t)row * G + g) * N + p1) * D, (size_t)T * D * 4);
      prefetch_l2(a.dpk + ((size_t)row * N + p1) * D, (size_t)T * D * 4);
    }
    for (int i = threadIdx.x; i < G * T * Q4; i += kFlowThreads) {
      const int g = i / (T * Q4), r = i - g * T * Q4, t = r / Q4, d = (r - t * Q4) * 4;
      const int n = p0 + t;
      st4(dq + (g * T + t) * D + d,
          n < len ? ld4(a.dqin + (((size_t)row * G + g) * N + n) * D + d) : zero4());
    }
    for (int i = threadIdx.x; i < T * Q4; i += kFlowThreads) {
      const int t = i / Q4, d = (i - t * Q4) * 4, n = p0 + t;
      st4(dk + t * D + d, n < len ? ld4(a.dpk + ((size_t)row * N + n) * D + d) : zero4());
    }
    for (int i = threadIdx.x; i < G * T; i += kFlowThreads) {
      const int g = i / T, n = p0 + i - g * T;
      od[i] = n < len ? a.odot[((size_t)row * G + g) * N + n] : 0.f;
    }
    for (int t = threadIdx.x; t < T; t += kFlowThreads)
      dvv[t] = p0 + t < len ? a.dvv[(size_t)row * N + p0 + t] : 0.f;
    __syncthreads();
    // (1) the super-chunk's flows, recomputed
    flow_levels<D, T>(m, G, p0, len, eps, a.use_alloc, a.dr);
    // (2) out = Y r alloc, r = pos / z: d z and d cons_sink
    for (int t = threadIdx.x; t < T; t += kFlowThreads) {
      const float r = (float)(p0 + t + 1) / m.z[t];
      float d_r = 0.f;
      for (int g = 0; g < G; ++g) d_r += m.alloc[g * T + t] * od[g * T + t];
      xz[t] = -d_r * r / m.z[t];
    }
    for (int i = threadIdx.x; i < G * T; i += kFlowThreads) {
      const int t = i % T;
      const float pos = (float)(p0 + t + 1), al = m.alloc[i];
      dcs[i] = a.use_alloc ? pos / m.z[t] * od[i] * al * (1.f - al) / (pos * fG) : 0.f;
    }
    __syncthreads();
    // (3) z = z_in + cumsum(e): d e by a suffix scan from the carried d z;
    // e = exp(clip(raw)) masked, and v e
    if (threadIdx.x < 32)
      warp_scan<T, true>(
          dz_c, [&](int t) { return xz[t]; },
          [&](int t, float de) {
            const float raw = m.raw[t];
            draw[t] = (raw >= -1.f && raw <= 1.f)
                          ? (de + dvv[t]) * m.e[t] / (float)(p0 + t + 1) : 0.f;
          });
    __syncthreads();
    // (4) level 2: qi_cs (cons_src's dot) and ko_cs (cons_sink's dot)
    seg_scan2<D, T, true>(
        dqi_c, dko_c, m.tot,
        [&](int k, int t, int d) {
          if (k == 0) return draw[t] * (m.pk[t * D + d] + eps);
          float x = 0.f;
          for (int g = 0; g < G; ++g) x += dcs[g * T + t] * (m.pq[(g * T + t) * D + d] + eps);
          return x;
        },
        [&](int k, int t, int d, float u) {
          if (k == 0) {  // qi_cs sums q_in over the group
            for (int g = 0; g < G; ++g) dq[(g * T + t) * D + d] += u;
            dk[t * D + d] += draw[t] * (m.qic[t * D + d] + eps);
          } else {  // ko_cs sums phi(k) src_out; keep u for src_out's dot
            dk[t * D + d] += u * m.src[t];
            m.qic[t * D + d] = u;
          }
        });
    // (5) sink_in = pos / den and src_out = pos G / den: their denominators
    warp_dots<D>(
        (G + 1) * T,
        [&](int r, int d) {
          if (r < G * T) return dq[r * D + d] * m.pq[r * D + d];
          const int t = r - G * T;
          return m.qic[t * D + d] * m.pk[t * D + d];
        },
        [&](int r, float acc) {
          if (r < G * T) {
            const float s = m.sink[r];
            dsd[r] = -acc * s * s / (float)(p0 + r % T + 1);
          } else {
            const int t = r - G * T;
            const float s = m.src[t];
            dso[t] = -acc * s * s / ((float)(p0 + t + 1) * fG);
          }
        });
    __syncthreads();
    // (6) level 1: k_cs and q_cs; then through phi, zero past the length
    seg_scan2<D, T, true>(
        dk_c, dq_c, m.tot,
        [&](int k, int t, int d) {
          if (k == 1) return dso[t] * (m.pk[t * D + d] + eps);
          float x = 0.f;
          for (int g = 0; g < G; ++g) x += dsd[g * T + t] * (m.pq[(g * T + t) * D + d] + eps);
          return x;
        },
        [&](int k, int t, int d, float u) {
          const int n = p0 + t;
          if (n >= N) return;
          const bool ok = n < len && d < a.dr;
          if (k == 0) {
            const float x = dk[t * D + d] + u + dso[t] * (m.qc[t * D + d] + eps);
            dkrow[(size_t)n * D + d] =
                from_f32<TT>(ok ? x * phi_grad(m.pk[t * D + d], a.phi) : 0.f);
          } else {
            for (int g = 0; g < G; ++g) {
              const int i = g * T + t;
              const float x = dq[i * D + d] * m.sink[i] + dcs[i] * (m.koc[t * D + d] + eps) +
                              dsd[i] * (m.kc[t * D + d] + eps) + u;
              dqrow[((size_t)g * N + n) * D + d] =
                  from_f32<TT>(ok ? x * phi_grad(m.pq[i * D + d], a.phi) : 0.f);
            }
          }
        });
  }
}

// Super-chunk of the pull-back, and so the spacing of the carries the flows
// save: 4096 / D positions where its block's shared memory holds them,
// else 2048 / D; 0 where neither fits.
template <int D>
int bwd_tile(int g, int limit) {
  if (pull_smem_floats<D, 4096 / D>(g) * sizeof(float) <= (size_t)limit) return 4096 / D;
  if (pull_smem_floats<D, 2048 / D>(g) * sizeof(float) <= (size_t)limit) return 2048 / D;
  return 0;
}

struct Work {
  float *sink, *scale, *e, *carry, *states, *dstates, *dqin, *dpk, *odot, *dvv;
};

// Floats of scratch for (bh, g, n, d) with carries saved every t positions.
long long work_floats(int bh, int g, int n, int d, int t, Work& w, float* base) {
  const int c = d >= 128 ? 32 : 64;
  const long long nc = (n + c - 1) / c, nt = (n + t - 1) / t;
  const long long bgn = (long long)bh * g * n, bn = (long long)bh * n;
  const long long sizes[10] = {align4(bgn), align4(bgn), align4(bn),
                               align4(bh * nt * (4LL * d + 1)), bh * nc * d * d,
                               bh * nc * d * d, bgn * d, bn * d, align4(bgn), align4(bn)};
  float** slots[10] = {&w.sink, &w.scale, &w.e, &w.carry, &w.states,
                       &w.dstates, &w.dqin, &w.dpk, &w.odot, &w.dvv};
  long long off = 0;
  for (int i = 0; i < 10; ++i) {
    if (base) *slots[i] = base + off;
    off += sizes[i];
  }
  return off;
}

int tile_of(int g, int d) {
  int limit = 0;
  if (smem_limit(&limit) != cudaSuccess) return 0;
  switch (d) {
    case 24:
    case 32: return bwd_tile<32>(g, limit);
    case 64: return bwd_tile<64>(g, limit);
    case 128: return bwd_tile<128>(g, limit);
    default: return 0;
  }
}

template <typename TT, int D, int T>
cudaError_t flows_at(const FlowArgs<TT>& fa, int bh, cudaStream_t st) {
  const size_t f = flow_smem_floats<D, T>(fa.G);
  cudaError_t err = allow_smem(flow_bwd_flows<TT, D, T>, f);
  if (err != cudaSuccess) return err;
  flow_bwd_flows<TT, D, T><<<bh, kFlowThreads, f * sizeof(float), st>>>(fa);
  return cudaGetLastError();
}

template <typename TT, int D, int T>
cudaError_t pull_at(const PullArgs<TT>& pa, int bh, cudaStream_t st) {
  const size_t f = pull_smem_floats<D, T>(pa.G);
  cudaError_t err = allow_smem(flow_bwd_pull<TT, D, T>, f);
  if (err != cudaSuccess) return err;
  flow_bwd_pull<TT, D, T><<<bh, kFlowThreads, f * sizeof(float), st>>>(pa);
  return cudaGetLastError();
}

template <typename TT, int D>
cudaError_t launch(const void* const* in, void* dq, void* dk, void* dv, void* work, int bh,
                   int g, int n, int phi, int use_alloc, float eps, int dr, cudaStream_t st) {
  constexpr int C = chunk_of<D>();
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int T = bwd_tile<D>(g, limit), TF = flows_tile<D>(g, limit);
  if (T == 0 || TF < T) return cudaErrorInvalidValue;
  Work w;
  work_floats(bh, g, n, D, T, w, (float*)work);
  const TT *q = (const TT*)in[0], *k = (const TT*)in[1], *v = (const TT*)in[2];
  const TT* g_out = (const TT*)in[4];
  const int* lens = (const int*)in[3];
  const float* gs = (const float*)in[10];

  FlowArgs<TT> fa{q, k, lens, w.sink, w.scale, w.e, w.carry, T, nullptr, nullptr, nullptr,
                  nullptr, nullptr, g, n, phi, use_alloc, eps, dr};
  PullArgs<TT> pa{q, k, lens, w.carry, (const float*)in[5], (const float*)in[6],
                  (const float*)in[7], (const float*)in[8], (const float*)in[9], w.dqin, w.dpk,
                  w.odot, w.dvv, (TT*)dq, (TT*)dk, g, n, phi, use_alloc, eps, dr};
  err = TF == 8192 / D   ? flows_at<TT, D, 8192 / D>(fa, bh, st)
        : TF == 4096 / D ? flows_at<TT, D, 4096 / D>(fa, bh, st)
                         : flows_at<TT, D, 2048 / D>(fa, bh, st);
  if (err != cudaSuccess) return err;

  const int nc = (n + C - 1) / C;
  StateArgs<TT, D> sa{q, k, v, g_out, lens, w.sink, w.scale, w.e, w.states, w.dstates, g, n,
                      phi, dr};
  constexpr int fs = state_smem_floats<D>();
  if ((err = allow_smem(flow_bwd_state<TT, D>, fs)) != cudaSuccess) return err;
  flow_bwd_state<TT, D><<<dim3(bh * nc, 2), kThreads, fs * sizeof(float), st>>>(sa, bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  PassArgs pa3{lens, w.states, w.dstates, nullptr, gs, bh, n, C, D * D / 4};
  const long long q4 = (long long)bh * D * D / 4;
  flow_bwd_pass<<<dim3((unsigned)((q4 + kThreads - 1) / kThreads), 2), kThreads, 0, st>>>(pa3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ChunkArgs<TT> ca{q, k, v, g_out, lens, w.sink, w.scale, w.e, w.states, w.dstates, (TT*)dv,
                   w.dqin, w.dpk, w.odot, w.dvv, g, n, phi, bh, dr};
  constexpr int fc = chunk_smem_floats<D>();
  if ((err = allow_smem(flow_bwd_chunk<TT, D>, fc)) != cudaSuccess) return err;
  flow_bwd_chunk<TT, D><<<bh * nc, kThreads, fc * sizeof(float), st>>>(ca);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  return T == 4096 / D ? pull_at<TT, D, 4096 / D>(pa, bh, st) : pull_at<TT, D, 2048 / D>(pa, bh, st);
}

template <typename TT>
cudaError_t dispatch(int d, const void* const* in, void* dq, void* dk, void* dv, void* work,
                     int bh, int g, int n, int phi, int use_alloc, float eps, cudaStream_t st) {
  switch (d) {
    case 24:  // rows stored 32 wide, zero past 24
    case 32: return launch<TT, 32>(in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, d, st);
    case 64: return launch<TT, 64>(in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, d, st);
    case 128:
      return launch<TT, 128>(in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, d, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch flow_fused_bwd needs for these shapes (16-byte aligned
// slices); -1 for shapes it refuses.
extern "C" long long flow_fused_bwd_workspace(int bh, int g, int n, int d) {
  if (bh < 0 || g < 1 || n < 1) return -1;
  const int t = tile_of(g, d);
  if (t == 0) return -1;
  Work dummy;
  return work_floats(bh, g, n, stored_width(d), t, dummy, nullptr);
}

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) and g_out (BH, G, N, Dv) in
// `dtype` (0 fp32, 1 bf16); lens (BH,) int32 with 1 <= lens <= N; the
// cotangents of the six state outputs gq/gk/gko/gqi (BH, D), gz (BH,), gs
// (BH, D, Dv), fp32; work flow_fused_bwd_workspace floats.  Writes dq, dk,
// dv with the shapes and dtype of q, k, v.  D == Dv in {24, 32, 64, 128};
// at D = 24 every row (and gs) is stored 32 wide, zero past 24, and dq,
// dk and dv are written 0 there.  Five launches on `stream`; returns a
// cudaError_t.
extern "C" int flow_fused_bwd(const void* q, const void* k, const void* v, const void* lens,
                              const void* g_out, const void* gq, const void* gk,
                              const void* gko, const void* gqi, const void* gz, const void* gs,
                              void* dq, void* dk, void* dv, void* work, int bh, int g, int n,
                              int d, int dv_dim, int dtype, int phi, int use_alloc, float eps,
                              void* stream) {
  if (d != dv_dim || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  const void* in[11] = {q, k, v, lens, g_out, gq, gk, gko, gqi, gz, gs};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps,
                                        st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_fused_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
