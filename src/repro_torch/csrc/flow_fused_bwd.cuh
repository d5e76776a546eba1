// flow_fused_bwd.cuh — backward of the strict-causal Flow-Attention kernel
// (flow_fused.cu) for Hopper (sm_90a): the kernels and their launches,
// instantiated by flow_fused_bwd.cu (D == Dv in {24, 32, 64, 128}) and
// flow_fused_bwd_wide.cu (the wide pairs), two libraries that nvcc builds
// at once.
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
//     it; see below for D = 192, 256) back to front, recomputes their flows
//     from the saved carry-ins and pulls the three levels back: the z
//     chain (a warp scan), then the qi/ko and k/q prefix sums as
//     block-wide segmented suffix scans seeded at the row's boundary with the cotangents of the four sums and z;
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
//
// The wide pairs (D, Dv) = (192, 128), (192, 192) (DeepSeek-V2's MLA heads,
// Nemotron-4-340B's) and (256, 256) (RecurrentGemma's) run instantiations
// of their own, chunks of C = 32 as in K1:
//   * the flows and the pull-back walk super-chunks that are multiples of
//     the scans' segments (five positions at D = 192, four at 256);
//   * the cotangent state is one block per panel of 64 columns of Dv (grid
//     y), its accumulators carried over the group;
//   * flow_bwd_chunk_wide streams S_<c and dS_>c through one D x 64 panel
//     buffer (each is 256 KB fp32 at (256, 256)) and owns its outputs in
//     panels of 64 columns: 139, 152 and 200 KB of shared memory, one block
//     an SM;
//   * the pull-back holds K1's flows plus (G + 1) T D + 3 G T floats, so at
//     Nemotron's G = 12 and RecurrentGemma's G = 16 no super-chunk of 2 or
//     4 segments fits: it walks one segment (T = 5 at D = 192, 4 at 256;
//     128 KB at G = 12, D = 192; 169 KB at G = 16, D = 256).  The other
//     design, the group's panels in the workspace, would send every level's
//     scan through device memory; a short super-chunk only lengthens the
//     chain of barriers, and the pull-back code stays one.
// The group a block's shared memory takes: 9 at D = 32, 10 at 64 and 128,
// 23 at 192, 21 at 256 (the flows' smallest super-chunk binds there).  A
// larger one is refused by flow_fused_bwd_workspace (-1).
#pragma once

#include "flow_fused_common.cuh"

namespace {

using namespace ff;

template <typename TT, int D, int T>
__global__ void __launch_bounds__(kFlowThreads) flow_bwd_flows(FlowArgs<TT> a) {
  extern __shared__ float smem[];
  flows_body<TT, D, T>(a, smem);
}

// grid y: 0 the chunk state (every panel), 1 + p panel p of the cotangent
// state (one panel, p = 0, where Dv is not walked in panels)
template <typename TT, int D, int DV>
__global__ void __launch_bounds__(kThreads) flow_bwd_state(StateArgs<TT, D> a, int rows) {
  extern __shared__ float smem[];
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int y = blockIdx.y;
  state_block<TT, D, DV>(a, y == 0 ? 0 : 1, rc.x, rc.y, smem, y == 0 ? 0 : y - 1);
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

// The chunk stage at the wide pairs (D = 192 beside Dv = 128 or 192, D = Dv
// = 256): S_<c and dS_>c (D x Dv each, 256 KB fp32 at (256, 256)) do not
// fit a block's shared memory, so both stream through one D x 64 panel
// buffer from L2 -- dS_>c once before the group loop, S_<c once per group
// -- and every C x D and C x Dv output is owned in panels of 64 columns
// (Own<C, 64>: two rows by four columns a thread, every panel of d phi(k),
// d(v e) and one group's d q_in held in registers).  The products and their
// order are the narrow kernel's, each sum over Dv split at the panels.
constexpr int kWidePanel = 64;

template <int D, int DV>
constexpr int chunk_wide_smem_floats() {
  constexpr int C = chunk_of<D>();
  return 2 * C * D + 2 * C * DV + 2 * C * C + D * kWidePanel;
}

template <typename TT, int D, int DV>
__global__ void __launch_bounds__(kThreads, 1) flow_bwd_chunk_wide(ChunkArgs<TT> a) {
  constexpr int C = chunk_of<D>(), PW = kWidePanel, ND = D / PW, NV = DV / PW;
  static_assert(ND * PW == D && NV * PW == DV, "panels");
  extern __shared__ float smem[];
  float* Q = smem;          // C x D: q_in of one group
  float* K = Q + C * D;     // C x D: phi(k)
  float* V = K + C * D;     // C x DV: v e
  float* Y = V + C * DV;    // C x DV: dY of one group
  float* P = Y + C * DV;    // C x C: tril(q_in phi(k)^T)
  float* dP = P + C * C;    // C x C: tril(dY (v e)^T)
  float* SP = dP + C * C;   // D x PW: one panel of dS_>c, then of S_<c
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
  using O = Own<C, PW>;  // one panel of every C x D and C x DV output
  using OP = Own<C, C>;
  const O o;
  const OP op;
  const int kmax = min(C, (o.r0 + O::RM + 3) & ~3);  // the panels' causal extent
  float gk[ND][O::RM][4], gv[NV][O::RM][4];  // d phi(k), d(v e)
#pragma unroll
  for (int p = 0; p < ND; ++p) zero_acc(gk[p]);
#pragma unroll
  for (int p = 0; p < NV; ++p) zero_acc(gv[p]);
  // (v e) dS_>c^T and phi(k) dS_>c, a panel of dS_>c's columns at a time
#pragma unroll
  for (int pv = 0; pv < NV; ++pv) {
    stage<D, PW>(SP, [&](int t, int c) { return ld4(a.dstates + slot + t * DV + pv * PW + c); });
    __syncthreads();
    mm_mk<O::RM, D, PW>(gv[pv], K, SP, o.r0, o.c0, D);
#pragma unroll
    for (int pd = 0; pd < ND; ++pd) mm_mn<O::RM, PW, DV, PW>(gk[pd], V + pv * PW, SP, o.r0, pd * PW + o.c0);
    __syncthreads();
  }
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
    // d q_in = panel' phi(k) + dY S_<c^T; g_out . Y, Y = panel (v e) + q_in S_<c
    float dq[ND][O::RM][4], od[O::RM];
#pragma unroll
    for (int pd = 0; pd < ND; ++pd) {
      zero_acc(dq[pd]);
      mm_mk<O::RM, C, D>(dq[pd], dP, K, o.r0, pd * PW + o.c0, kmax);
    }
#pragma unroll
    for (int i = 0; i < O::RM; ++i) od[i] = 0.f;
#pragma unroll
    for (int pv = 0; pv < NV; ++pv) {
      stage<D, PW>(SP, [&](int t, int c) { return ld4(a.states + slot + t * DV + pv * PW + c); });
      __syncthreads();
      float y[O::RM][4];
      zero_acc(y);
      mm_mk<O::RM, C, DV>(y, P, V, o.r0, pv * PW + o.c0, kmax);
      mm_mk<O::RM, D, PW>(y, Q, SP, o.r0, o.c0, D);
#pragma unroll
      for (int i = 0; i < O::RM; ++i) {
        const int n = c0 + o.r0 + i;
        const float4 go =
            n < len ? load4(gr + (size_t)min(n, N - 1) * DV + pv * PW + o.c0) : zero4();
        od[i] += row_sum<O::TN>(go.x * y[i][0] + go.y * y[i][1] + go.z * y[i][2] +
                                go.w * y[i][3]);
      }
#pragma unroll
      for (int pd = 0; pd < ND; ++pd) mm_mn<O::RM, PW, DV, PW>(dq[pd], Y + pv * PW, SP, o.r0, pd * PW + o.c0);
      __syncthreads();  // SP is restaged for the next panel
    }
#pragma unroll
    for (int i = 0; i < O::RM; ++i) {
      const int n = c0 + o.r0 + i;
      if (n >= N) continue;
      if (o.c0 == 0) a.odot[rg * N + n] = od[i];
#pragma unroll
      for (int pd = 0; pd < ND; ++pd)
        st4(a.dqin + (rg * N + n) * D + pd * PW + o.c0,
            make_float4(dq[pd][i][0], dq[pd][i][1], dq[pd][i][2], dq[pd][i][3]));
    }
#pragma unroll
    for (int pd = 0; pd < ND; ++pd) mm_kk<O::RM, C, D>(gk[pd], dP, Q, o.r0, pd * PW + o.c0, o.r0, C);
#pragma unroll
    for (int pv = 0; pv < NV; ++pv) mm_kk<O::RM, C, DV>(gv[pv], P, Y, o.r0, pv * PW + o.c0, o.r0, C);
    __syncthreads();  // Q, Y and the panels are restaged for the next group
  }
#pragma unroll
  for (int i = 0; i < O::RM; ++i) {
    const int n = c0 + o.r0 + i;
    const bool ok = n < len;
    const int nn = min(n, N - 1);
    float dot = 0.f;
#pragma unroll
    for (int pv = 0; pv < NV; ++pv) {
      const float4 vv = ok ? load4(vr + (size_t)nn * DV + pv * PW + o.c0) : zero4();
      dot += row_sum<O::TN>(gv[pv][i][0] * vv.x + gv[pv][i][1] * vv.y + gv[pv][i][2] * vv.z +
                            gv[pv][i][3] * vv.w);
    }
    if (n >= N) continue;
#pragma unroll
    for (int pd = 0; pd < ND; ++pd)
      st4(a.dpk + ((size_t)row * N + n) * D + pd * PW + o.c0,
          make_float4(gk[pd][i][0], gk[pd][i][1], gk[pd][i][2], gk[pd][i][3]));
    const float ev = ok ? er[n] : 0.f;
#pragma unroll
    for (int pv = 0; pv < NV; ++pv)
      store4(dvr + (size_t)n * DV + pv * PW + o.c0,
             make_float4(gv[pv][i][0] * ev, gv[pv][i][1] * ev, gv[pv][i][2] * ev,
                         gv[pv][i][3] * ev));
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
// save: a multiple of the scans' segments S = kFlowThreads / D, 4 S where
// its block's shared memory holds it, else 2 S (4096 / D and 2048 / D where
// D divides the block), and at the wide widths (D = 192, 256) S itself
// (five or four positions); 0 where none fits.  D <= 128 keeps 4 S and 2 S
// (a larger group there stays refused).
template <int D>
int bwd_tile(int g, int limit) {
  constexpr int S = flow_segs<D>();
  if (pull_smem_floats<D, 4 * S>(g) * sizeof(float) <= (size_t)limit) return 4 * S;
  if (pull_smem_floats<D, 2 * S>(g) * sizeof(float) <= (size_t)limit) return 2 * S;
  if constexpr (D > 128)
    if (pull_smem_floats<D, S>(g) * sizeof(float) <= (size_t)limit) return S;
  return 0;
}

struct Work {
  float *sink, *scale, *e, *carry, *states, *dstates, *dqin, *dpk, *odot, *dvv;
};

// Floats of scratch for (bh, g, n, d, dv), d and dv the stored widths, with
// carries saved every t positions.
long long work_floats(int bh, int g, int n, int d, int dv, int t, Work& w, float* base) {
  const int c = d >= 128 ? 32 : 64;
  const long long nc = (n + c - 1) / c, nt = (n + t - 1) / t;
  const long long bgn = (long long)bh * g * n, bn = (long long)bh * n;
  const long long sizes[10] = {align4(bgn), align4(bgn), align4(bn),
                               align4(bh * nt * (4LL * d + 1)), bh * nc * d * dv,
                               bh * nc * d * dv, bgn * d, bn * d, align4(bgn), align4(bn)};
  float** slots[10] = {&w.sink, &w.scale, &w.e, &w.carry, &w.states,
                       &w.dstates, &w.dqin, &w.dpk, &w.odot, &w.dvv};
  long long off = 0;
  for (int i = 0; i < 10; ++i) {
    if (base) *slots[i] = base + off;
    off += sizes[i];
  }
  return off;
}

// The (D, Dv) pairs with an instantiation: K1's (flow_fused.cu).
inline bool takes(int d, int dv) {
  if (d == 192) return dv == 128 || dv == 192;
  if (d == 256) return dv == 256;
  return d == dv && (d == 24 || d == 32 || d == 64 || d == 128);
}

// The pull-back's super-chunk at stored width d and group g on this device
// (0 where none fits a block's shared memory); the flows' must fit too.
int tile_of(int g, int d) {
  int limit = 0;
  if (smem_limit(&limit) != cudaSuccess) return 0;
  int t = 0, tf = 0;
  switch (d) {
    case 32: t = bwd_tile<32>(g, limit), tf = flows_tile<32>(g, limit); break;
    case 64: t = bwd_tile<64>(g, limit), tf = flows_tile<64>(g, limit); break;
    case 128: t = bwd_tile<128>(g, limit), tf = flows_tile<128>(g, limit); break;
    case 192: t = bwd_tile<192>(g, limit), tf = flows_tile<192>(g, limit); break;
    case 256: t = bwd_tile<256>(g, limit), tf = flows_tile<256>(g, limit); break;
    default: return 0;
  }
  return tf >= t ? t : 0;
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

template <typename TT, int D, int DV>
cudaError_t launch(const void* const* in, void* dq, void* dk, void* dv, void* work, int bh,
                   int g, int n, int phi, int use_alloc, float eps, int dr, cudaStream_t st) {
  constexpr int C = chunk_of<D>(), S = flow_segs<D>();
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int T = bwd_tile<D>(g, limit), TF = flows_tile<D>(g, limit);
  if (T == 0 || TF < T) return cudaErrorInvalidValue;
  Work w;
  work_floats(bh, g, n, D, DV, T, w, (float*)work);
  const TT *q = (const TT*)in[0], *k = (const TT*)in[1], *v = (const TT*)in[2];
  const TT* g_out = (const TT*)in[4];
  const int* lens = (const int*)in[3];
  const float* gs = (const float*)in[10];

  FlowArgs<TT> fa{q, k, lens, w.sink, w.scale, w.e, w.carry, T, nullptr, nullptr, nullptr,
                  nullptr, nullptr, g, n, phi, use_alloc, eps, dr};
  PullArgs<TT> pa{q, k, lens, w.carry, (const float*)in[5], (const float*)in[6],
                  (const float*)in[7], (const float*)in[8], (const float*)in[9], w.dqin, w.dpk,
                  w.odot, w.dvv, (TT*)dq, (TT*)dk, g, n, phi, use_alloc, eps, dr};
  err = TF == 8 * S   ? flows_at<TT, D, 8 * S>(fa, bh, st)
        : TF == 4 * S ? flows_at<TT, D, 4 * S>(fa, bh, st)
                      : flows_at<TT, D, 2 * S>(fa, bh, st);
  if (err != cudaSuccess) return err;

  const int nc = (n + C - 1) / C;
  StateArgs<TT, D> sa{q, k, v, g_out, lens, w.sink, w.scale, w.e, w.states, w.dstates, g, n,
                      phi, dr};
  constexpr int fs = state_smem_floats<D, DV>();
  constexpr int NPS = DV / panel_of<D, DV>();  // panels of the cotangent state
  if ((err = allow_smem(flow_bwd_state<TT, D, DV>, fs)) != cudaSuccess) return err;
  flow_bwd_state<TT, D, DV><<<dim3(bh * nc, 1 + NPS), kThreads, fs * sizeof(float), st>>>(sa, bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  PassArgs pa3{lens, w.states, w.dstates, nullptr, gs, bh, n, C, D * DV / 4};
  const long long q4 = (long long)bh * D * DV / 4;
  flow_bwd_pass<<<dim3((unsigned)((q4 + kThreads - 1) / kThreads), 2), kThreads, 0, st>>>(pa3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ChunkArgs<TT> ca{q, k, v, g_out, lens, w.sink, w.scale, w.e, w.states, w.dstates, (TT*)dv,
                   w.dqin, w.dpk, w.odot, w.dvv, g, n, phi, bh, dr};
  if constexpr (D <= 128) {
    constexpr int fc = chunk_smem_floats<D>();
    if ((err = allow_smem(flow_bwd_chunk<TT, D>, fc)) != cudaSuccess) return err;
    flow_bwd_chunk<TT, D><<<bh * nc, kThreads, fc * sizeof(float), st>>>(ca);
  } else {
    constexpr int fc = chunk_wide_smem_floats<D, DV>();
    if ((err = allow_smem(flow_bwd_chunk_wide<TT, D, DV>, fc)) != cudaSuccess) return err;
    flow_bwd_chunk_wide<TT, D, DV><<<bh * nc, kThreads, fc * sizeof(float), st>>>(ca);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (T == 4 * S) return pull_at<TT, D, 4 * S>(pa, bh, st);
  if constexpr (D > 128)
    if (T == S) return pull_at<TT, D, S>(pa, bh, st);
  return pull_at<TT, D, 2 * S>(pa, bh, st);
}

// One library's dispatch over (D, Dv) and dtype.
using Dispatch = cudaError_t (*)(int d, int dv, const void* const* in, void* dq, void* dk,
                                 void* dvp, void* work, int bh, int g, int n, int phi,
                                 int use_alloc, float eps, cudaStream_t st);

// Floats of scratch for these shapes (16-byte aligned slices); -1 for
// shapes refused: a (D, Dv) `ok` rejects, or a group whose pull-back (or
// flows) does not fit a block's shared memory at the smallest super-chunk.
inline long long workspace_floats(bool ok, int bh, int g, int n, int d, int dv) {
  if (!ok || bh < 0 || g < 1 || n < 1) return -1;
  const int t = tile_of(g, stored_width(d));
  if (t == 0) return -1;
  Work dummy;
  return work_floats(bh, g, n, stored_width(d), stored_width(dv), t, dummy, nullptr);
}

// The C entry's body: arguments checked, then the dtype's dispatch.
inline int run_bwd(bool ok, Dispatch f32, Dispatch bf16, const void* const* in, void* dq,
                   void* dk, void* dv, void* work, int bh, int g, int n, int d, int dv_dim,
                   int dtype, int phi, int use_alloc, float eps, void* stream) {
  if (!ok || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)f32(d, dv_dim, in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)bf16(d, dv_dim, in, dq, dk, dv, work, bh, g, n, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
