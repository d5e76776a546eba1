// flow_nc_fused.cu — the whole non-causal Flow-Attention pair (K6) for
// Hopper (sm_90a), one thread-block cluster per (batch * kv head).
//
// Replaces the TPU kernel repro/kernels/flow_nc/fused.py::flow_nc_fused_call
// (the pl.pallas_call at :159, body _kernel :48-123).  Per (batch * kv head),
// with sigmoid phi and allocation as there:
//
//   A  k_sum = sum_j phi(k_j);  q_sum = sum_i phi(q_i)
//   B  ko_sum = sum_j phi(k_j) / ((phi(k_j)+eps).(q_sum+eps))
//      qi_sum = sum_i phi(q_i) / ((phi(q_i)+eps).(k_sum+eps))
//   C  e_j = exp(clip((phi(k_j)+eps).(qi_sum+eps), -1, 1))  (1 without
//      competition);  z = sum_j e_j;  kv = sum_j phi(k_j)^T (v_j e_j)
//   D  out_i = sigmoid(I_hat_i * NQ/M) * ((phi(q_i) / I_i) @ kv) * (M / z)
//
// The softmax normalizer is deferred to phase D (exact, since the clipped
// exponent needs no max subtraction).  The NQ = G*N rows of q form one sink
// population (shared GQA).
//
// What bounds it on the H100: the arithmetic (0.137 ms of fp32 operations at
// the LRA shape, 32 x 4 heads, N = M = 4,096, D = 64, against 0.080 ms to
// read q, k and v once and write out).  Most of the operations are the two
// D x D products (phase C's phi(k)^T (v e), phase D's phi(q) @ kv); the
// rest is elementwise: four sigmoids per element of k and three per element
// of q (every phase recomputes phi from the raw rows: an fp32 copy of phi
// would not fit beside them), the flow dots and the column sums.
//
// Design.  The TPU ran the four phases as one sequential grid axis with the
// sums in VMEM scratch.  Here each (batch * kv head) is split over a cluster
// of cb blocks (the grid is (cb, BH); the wrapper takes cb = 16, the card's
// non-portable cluster size, so that at the LRA shape a block's rows take
// ~100 KB and two blocks of 128 registers a thread share an SM), and the
// phases' totals travel through distributed shared memory:
//
//  * block r owns sink rows [r rq, (r+1) rq) and source rows [r rk,
//    (r+1) rk), rq = ceil(NQ / cb), rk = ceil(M / cb) (trailing blocks may
//    own none).  Where its q, k and v rows fit in shared memory (bf16 at the
//    LRA shape: 3 x 32 KB) it copies them in once with cp.async, k first,
//    then q, then v, each row's 16-byte chunks XOR-swizzled by the row so
//    that the streaming and the fragment reads below are free of bank
//    conflicts; all four phases then read shared memory, and q, k and v are
//    read from device memory once per call.  Otherwise (fp32 or D = 128 at
//    long rows: the parity path) each phase streams its rows from device
//    memory.
//  * each phase's totals (k_sum and q_sum; ko_sum and qi_sum; z and kv) are
//    per-block partials in shared memory.  After cluster.sync() every block
//    reads all cb partials of the D-vectors through map_shared_rank, in
//    rank order, so every block holds bitwise the same totals; kv (D x D,
//    kept in the accumulators' order so that a warp's stores are
//    consecutive) is reduced in rank order by slices of 16-byte reads
//    (block r sums slice r), gathered from the slices' owners, then laid
//    out in phase D's fragment order.  No atomics and no second launch;
//    every sum runs in a fixed order, so two calls give the same bits.
//  * the products run on the tensor cores as 3xTF32 (mma.sync m16n8k8:
//    a_hi b_hi + a_hi b_lo + a_lo b_hi with fp32 accumulation, kv split
//    once after its exchange), whose error is that of fp32 FMA's order;
//    phi and every sum stay fp32.  Phase C's warps each own two of its
//    8-row k-steps' interleaved quarters and half of kv's columns, with the
//    full D rows of phi(k) in a warp's fragments, so e_j is a row dot
//    reduced over the warp's lanes; e_j scales phi(k) (the A side), so
//    that bf16 v is exact in tf32 and two products do.  Phase D's warps
//    each own 16-row tiles of q, whose flow dots come from the same
//    fragments.  Both products permute their reduction index so that each
//    thread's operands are contiguous in a row (one or two 16-byte reads).
//
// The small head dims of the vision and time-series encoders (D = 6, 8, 12,
// 16, 24, 48: a bf16 row of 12 or 24 bytes is no whole number of 16-byte
// loads, and 8-wide tensor-core steps would be mostly padding) take a second
// kernel, flow_nc_fused_kernel_small, over the same cluster split and the
// same rank-order totals, with one row a thread and fp32 FMA (see its
// section below); the C entry picks it by D, and the wrapper gives it as
// many blocks a cluster as its rows need (ops.py::cluster_blocks: one at
// 196 or 49 tokens).
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include "flow_nc_common.cuh"
#include "tensor_core.cuh"

namespace {

namespace cgrp = cooperative_groups;
using namespace flow_nc;
using namespace tc;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;

// ---- small helpers ----------------------------------------------------------

__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// row r's 16-byte chunk c lives at chunk c ^ swizzle(r) of the staged row
__device__ __forceinline__ int swizzle(int r) { return ((r & 3) << 1) | (r & 1); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// N consecutive elements from a register copy of a row's bytes
template <typename T, int N, typename W>
__device__ __forceinline__ void unpack(const W& w, float* x) {
  T e[N];
  memcpy(e, &w, sizeof(e));
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
}

// The rows of one block: staged in shared memory (RES, swizzled) or in
// device memory.  load<N>(r, e0, x) reads elements e0 .. e0 + N - 1 of row
// r (N * sizeof(T) is 4, 8 or a multiple of 16; e0 a multiple of N).
template <typename T, int D, bool RES>
struct Rows {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int CH = D / VEC;  // 16-byte chunks per row
  const T* base;

  __device__ __forceinline__ const char* chunk(int r, int c) const {
    const int pos = RES ? (c ^ (swizzle(r) & (CH - 1))) : c;
    return reinterpret_cast<const char*>(base) + ((size_t)r * CH + pos) * 16;
  }

  template <int N>
  __device__ __forceinline__ void load(int r, int e0, float* x) const {
    constexpr int BYTES = N * (int)sizeof(T);
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i)
        unpack<T, VEC>(*reinterpret_cast<const uint4*>(chunk(r, e0 / VEC + i)), x + i * VEC);
    } else {
      const char* p = chunk(r, e0 / VEC) + (e0 % VEC) * (int)sizeof(T);
      if constexpr (BYTES == 8)
        unpack<T, N>(*reinterpret_cast<const uint2*>(p), x);
      else
        unpack<T, N>(*reinterpret_cast<const uint32_t*>(p), x);
    }
  }
};

// copy `rows` rows of D elements from device memory into a swizzled stage
// (one cp.async group)
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    cp_async16(d + r * CH + (c ^ (swizzle(r) & (CH - 1))), s + i);
  }
  cp_async_commit();
}

// dst[c] (c < D) = the column sums x[] (VEC columns cg * VEC.. of this
// thread's rows) of every thread, summed over the block in a fixed order:
// over the warp's row groups by a butterfly, then over the warps in order.
// red holds kWarps * D floats; the block is synchronized inside, and dst is
// written by threads c < D after it.
template <int D, int VEC>
__device__ __forceinline__ void block_col_sum(float* x, float* red, float* dst) {
  constexpr int LG = D / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = LG; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
  if (lane < LG)
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[warp * D + lane * VEC + i] = x[i];
  __syncthreads();
  if (threadIdx.x < D) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * D + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// ---- shared memory ----------------------------------------------------------
//
// floats: tot[4 D] (k_sum, q_sum, ko_sum, qi_sum), partA[2 D], partB[2 D],
// red[2 kWarps D], zw[kWarps], zpart; then the rows: q's stage, and
// k's and v's, overlaid after phase C by kv's block partial P and total KV
// (in the accumulators' order, acc_slot) and L (D * D floats each); phase D
// reads kv's hi part from P and its lo part from L, both in its fragment
// order.  At D = 128 phase C walks the rows again after writing part of P,
// so P, KV and L follow the stages.  Without staged rows only P, KV and L
// follow the floats.
template <int D>
struct Floats {
  static constexpr int kTot = 0, kPartA = 4 * D, kPartB = 6 * D, kRed = 8 * D;
  static constexpr int kZw = kRed + 2 * kWarps * D, kZpart = kZw + kWarps;
  static constexpr int kCount = kZpart + 4;  // zpart, padded to 16 bytes
  static constexpr bool kOverlay = D <= 64;  // P, KV and L over the k and v stages
};

template <typename T, int D>
size_t smem_bytes(bool res, int rq, int rk) {
  const size_t head = Floats<D>::kCount * sizeof(float);
  const size_t kv = 3 * (size_t)D * D * sizeof(float);
  if (!res) return head + kv;
  const size_t row = (size_t)D * sizeof(T);
  const size_t kvrows = 2 * (size_t)rk * row;
  const size_t tail = !Floats<D>::kOverlay ? kvrows + kv : kvrows > kv ? kvrows : kv;
  return head + (size_t)rq * row + tail;
}

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  int nq, m, rq, rk;  // rows; rows per block
  int use_comp;       // 1 competition, 0 without
  float eps, sink_scale, m_f;
};

// kv[d][e] of phase D's B fragment slot i = ((tt NT + nt) 32 + lane) 2 + c
// (k-step tt, n-tile nt, the lane's b_c)
template <int D>
__device__ __forceinline__ void kv_of_slot(int i, int& d, int& e) {
  constexpr int Q = D / 4, NT = D / 8;
  const int c = i & 1, lane = (i >> 1) & 31, tt = (i >> 6) / NT, nt = (i >> 6) % NT;
  const int gg = lane >> 2, tq = lane & 3;
  d = tq * Q + 2 * tt + c;
  e = (gg >> 1) * Q + 2 * nt + (gg & 1);
}

// where phase C's accumulators keep kv[d][e]: slot (((eh MT + mt) NC + nt) 4
// + c) 32 + lane, so that a warp's stores of one accumulator are 32
// consecutive floats
template <int D>
__device__ __forceinline__ int acc_slot(int d, int e) {
  constexpr int NE = D / 8, NC = D / 16, MT = D / 16;
  const int eh = e / (D / 2), er = e % (D / 2), gg = er / NC, nt = er % NC;
  const int g = d / NE, mt = (d % NE) >> 1, c = ((d & 1) << 1) | (gg & 1);
  return ((((eh * MT + mt) * NC + nt) * 4 + c) * 32) + 4 * g + (gg >> 1);
}

template <typename T, int D, bool RES>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flow_nc_fused_kernel(const Args<T> a) {
  using F = Floats<D>;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int LG = D / VEC, RP = kThreads / LG;
  constexpr int MT = D / 16;  // phase C: m-tiles over d (per warp, all of them)
  constexpr int NC = D / 16;  // phase C: n-tiles over e (per warp, half of e)
  constexpr int PASSES = MT * NC > 16 ? MT * NC / 16 : 1, MTP = MT / PASSES;
  constexpr int NE = D / 8;   // phase C: elements of a k row per thread
  constexpr int KD = D / 8;   // phase D: k-steps over d; n-tiles over e
  constexpr int QE = D / 4;   // phase D: elements of a q row per thread
  static_assert(LG <= 32, "a streamed row spans at most one warp");

  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank(), cb = (int)cluster.num_blocks();
  const int use_comp = a.use_comp;
  const float eps = a.eps;
  const size_t bh = blockIdx.y;
  const int q0 = rank * a.rq, k0 = rank * a.rk;
  const int nqb = max(0, min(a.nq - q0, a.rq)), nkb = max(0, min(a.m - k0, a.rk));
  const T* qg = a.q + (bh * a.nq + q0) * D;
  const T* kg = a.k + (bh * a.m + k0) * D;
  const T* vg = a.v + (bh * a.m + k0) * D;

  extern __shared__ float4 smem4[];
  float* fs = reinterpret_cast<float*>(smem4);
  float* tot = fs + F::kTot;
  float* red = fs + F::kRed;
  char* rows = reinterpret_cast<char*>(fs + F::kCount);
  T* q_s = reinterpret_cast<T*>(rows);
  char* kvrows = RES ? rows + (size_t)a.rq * D * sizeof(T) : rows;
  T* k_s = reinterpret_cast<T*>(kvrows);
  T* v_s = k_s + (size_t)a.rk * D;
  char* after = RES && !F::kOverlay ? reinterpret_cast<char*>(v_s + (size_t)a.rk * D) : kvrows;
  float* P = reinterpret_cast<float*>(after);
  float* KV = P + D * D;
  float* L = KV + D * D;

  Rows<T, D, RES> Q{RES ? q_s : qg}, K{RES ? k_s : kg}, V{RES ? v_s : vg};
  if constexpr (RES) {
    stage_rows<T, D>(k_s, kg, nkb);
    stage_rows<T, D>(q_s, qg, nqb);
    stage_rows<T, D>(v_s, vg, nkb);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % LG, rg = tid / LG;

  // ---- phase A: plain sums ------------------------------------------------
  {
    float ks[VEC] = {}, qs[VEC] = {};
    cp_async_wait<2>();
    __syncthreads();
#pragma unroll 4
    for (int r = rg; r < nkb; r += RP) {
      float x[VEC];
      K.template load<VEC>(r, cg * VEC, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ks[i] += fast_sigmoid(x[i]);
    }
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 4
    for (int r = rg; r < nqb; r += RP) {
      float x[VEC];
      Q.template load<VEC>(r, cg * VEC, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) qs[i] += fast_sigmoid(x[i]);
    }
    block_col_sum<D, VEC>(ks, red, fs + F::kPartA);
    block_col_sum<D, VEC>(qs, red + kWarps * D, fs + F::kPartA + D);
    cluster.sync();
    if (tid < 2 * D) {
      float s = 0.f;
      for (int j = 0; j < cb; ++j) s += cluster.map_shared_rank(fs + F::kPartA, j)[tid];
      tot[tid] = s;  // k_sum, q_sum
    }
    __syncthreads();
  }

  // ---- phase B: conservation sums (need the phase-A totals) ---------------
  {
    const float* ksum = tot;
    const float* qsum = tot + D;
    float kos[VEC] = {}, qis[VEC] = {};
#pragma unroll 4
    for (int r0 = 0; r0 < nkb; r0 += RP) {
      const int r = r0 + rg;
      float x[VEC] = {};
      if (r < nkb) K.template load<VEC>(r, cg * VEC, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = fast_sigmoid(x[i]);
        dot = fmaf(x[i] + eps, qsum[cg * VEC + i] + eps, dot);
      }
      dot = group_sum<LG>(dot);
      if (r < nkb) {
        const float src_out = __fdividef(1.f, dot);
#pragma unroll
        for (int i = 0; i < VEC; ++i) kos[i] = fmaf(x[i], src_out, kos[i]);
      }
    }
#pragma unroll 4
    for (int r0 = 0; r0 < nqb; r0 += RP) {
      const int r = r0 + rg;
      float x[VEC] = {};
      if (r < nqb) Q.template load<VEC>(r, cg * VEC, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = fast_sigmoid(x[i]);
        dot = fmaf(x[i] + eps, ksum[cg * VEC + i] + eps, dot);
      }
      dot = group_sum<LG>(dot);
      if (r < nqb) {
        const float sink_in = __fdividef(1.f, dot);
#pragma unroll
        for (int i = 0; i < VEC; ++i) qis[i] = fmaf(x[i], sink_in, qis[i]);
      }
    }
    block_col_sum<D, VEC>(kos, red, fs + F::kPartB);
    block_col_sum<D, VEC>(qis, red + kWarps * D, fs + F::kPartB + D);
    cluster.sync();
    if (tid < 2 * D) {
      float s = 0.f;
      for (int j = 0; j < cb; ++j) s += cluster.map_shared_rank(fs + F::kPartB, j)[tid];
      tot[2 * D + tid] = s;  // ko_sum, qi_sum
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // ---- phase C: competition-weighted kv and the deferred normalizer -------
  // warp (jg, eh): 8-row k-steps jg, jg + 4, ...; kv columns of half eh.
  // Fragments: a (m = d, k = j): thread (g, t) holds e_j phi(k_j)_d, d =
  // g NE + 2 mt + {0, 1}, of rows 8 s + t and 8 s + t + 4; b (k = j, n = e):
  // v_je, e = eh D/2 + g NC + nt, exact in tf32 for bf16 v (two products).
  // At D = 128 the m-tiles take PASSES walks over the rows (registers).
  float z = 0.f;
  {
    const float* qisum = tot + 3 * D;
    const int g = lane >> 2, t = lane & 3, jg = warp >> 1, eh = warp & 1;
    float zacc = 0.f;
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      float acc[MTP][NC][4] = {};
      for (int s = jg; 8 * s < nkb; s += kWarps / 2) {
        float pk[2][NE], vv[2][NC], e[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * s + t + 4 * h;
          const bool live = r < nkb;
          float dot = 0.f;
          if (live) {
            K.template load<NE>(r, g * NE, pk[h]);
            V.template load<NC>(r, eh * (D / 2) + g * NC, vv[h]);
          }
#pragma unroll
          for (int i = 0; i < NE; ++i) {
            pk[h][i] = live ? fast_sigmoid(pk[h][i]) : 0.f;
            dot = fmaf(pk[h][i] + eps, qisum[g * NE + i] + eps, dot);
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 4);
          dot += __shfl_xor_sync(0xffffffffu, dot, 8);
          dot += __shfl_xor_sync(0xffffffffu, dot, 16);
          e[h] = !live ? 0.f : use_comp ? __expf(fminf(fmaxf(dot, -1.f), 1.f)) : 1.f;
#pragma unroll
          for (int i = 0; i < NE; ++i) pk[h][i] *= e[h];
#pragma unroll
          for (int i = 0; i < NC; ++i) vv[h][i] = live ? vv[h][i] : 0.f;
        }
        if (pass == 0) {
          zacc += e[0];
          zacc += e[1];
        }
        uint32_t bh_[NC][2], bl_[NC][2];
#pragma unroll
        for (int nt = 0; nt < NC; ++nt) {
          split_tf32(vv[0][nt], bh_[nt][0], bl_[nt][0]);
          split_tf32(vv[1][nt], bh_[nt][1], bl_[nt][1]);
        }
#pragma unroll
        for (int i = 0; i < MTP; ++i) {
          const int mt = pass * MTP + i;
          uint32_t ah[4], al[4];
          split_tf32(pk[0][2 * mt], ah[0], al[0]);
          split_tf32(pk[0][2 * mt + 1], ah[1], al[1]);
          split_tf32(pk[1][2 * mt], ah[2], al[2]);
          split_tf32(pk[1][2 * mt + 1], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NC; ++nt)
            mma_3xtf32<sizeof(T) == 2>(acc[i][nt], ah, al, bh_[nt], bl_[nt]);
        }
      }
      // kv's block partial P, in the accumulators' order (acc_slot): the
      // j-groups added in order (k's and v's stages, which P overlays, are
      // read no more once every warp is past its first turn's barrier)
      for (int turn = 0; turn < kWarps / 2; ++turn) {
        __syncthreads();
        if (jg == turn) {
#pragma unroll
          for (int i = 0; i < MTP; ++i)
#pragma unroll
            for (int nt = 0; nt < NC; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int mt = pass * MTP + i;
                float* p = P + (((eh * MT + mt) * NC + nt) * 4 + c) * 32 + lane;
                *p = turn == 0 ? acc[i][nt][c] : *p + acc[i][nt][c];
              }
        }
      }
    }
    // z: this warp's rows (every lane holds the same e's), then warp order
    zacc += __shfl_xor_sync(0xffffffffu, zacc, 1);
    zacc += __shfl_xor_sync(0xffffffffu, zacc, 2);
    if (lane == 0 && eh == 0) fs[F::kZw + jg] = zacc;
    __syncthreads();
    if (tid == 0) {
      float zb = 0.f;
      for (int w = 0; w < kWarps / 2; ++w) zb += fs[F::kZw + w];
      fs[F::kZpart] = zb;
    }
    cluster.sync();
    // kv: block `rank` sums slice `rank` of the partials over the blocks in
    // rank order (16-byte remote reads) ...
    constexpr int N4 = D * D / 4;
    const int slice = (N4 + cb - 1) / cb;
    const int lo = rank * slice, hi = min(N4, lo + slice);
    const float4* P4 = reinterpret_cast<const float4*>(P);
    float4* KV4 = reinterpret_cast<float4*>(KV);
    for (int i = lo + tid; i < hi; i += kThreads) {
      float4 part[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cb) part[j] = cluster.map_shared_rank(P4, j)[i];
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < cb) {
          sum.x += part[j].x;
          sum.y += part[j].y;
          sum.z += part[j].z;
          sum.w += part[j].w;
        }
      KV4[i] = sum;
    }
    for (int j = 0; j < cb; ++j) z += cluster.map_shared_rank(fs + F::kZpart, j)[0];
    cluster.sync();
    // ... and gathers the other slices from their owners, kGather loads in
    // flight per thread
    constexpr int kGather = 4;
    for (int i0 = 0; i0 < N4; i0 += kGather * kThreads) {
      float4 got[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads + tid, owner = i / slice;
        if (i < N4 && owner != rank) got[u] = cluster.map_shared_rank(KV4, owner)[i];
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads + tid, owner = i / slice;
        if (i < N4 && owner != rank) KV4[i] = got[u];
      }
    }
    cluster.sync();
    // kv into phase D's fragment order, split once: hi in P, lo in L
    for (int i = tid; i < D * D; i += kThreads) {
      int d, e;
      kv_of_slot<D>(i, d, e);
      uint32_t h, l;
      split_tf32(KV[acc_slot<D>(d, e)], h, l);
      P[i] = __uint_as_float(h);
      L[i] = __uint_as_float(l);
    }
    __syncthreads();
  }

  // ---- phase D: sink side over the finished kv ----------------------------
  // warp w: 16-row tiles w, w + kWarps, ...; a (m = row, k = d): thread
  // (g, t) holds d = t QE + 2 tt + {0, 1} of rows g and g + 8; b from KV.
  {
    const float* ksum = tot;
    const float* kosum = tot + 2 * D;
    const int g = lane >> 2, t = lane & 3;
    const float out_scale = a.m_f / z;
    const float2* kvh = reinterpret_cast<const float2*>(P);
    const float2* kvl = reinterpret_cast<const float2*>(L);
    for (int tile = warp; 16 * tile < nqb; tile += kWarps) {
      float pq[2][QE], scale[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * tile + g + 8 * h;
        const bool live = r < nqb;
        if (live) Q.template load<QE>(r, t * QE, pq[h]);
        float inc = 0.f, con = 0.f;
#pragma unroll
        for (int i = 0; i < QE; ++i) {
          pq[h][i] = live ? fast_sigmoid(pq[h][i]) : 0.f;
          inc = fmaf(pq[h][i] + eps, ksum[t * QE + i] + eps, inc);
          con = fmaf(pq[h][i] + eps, kosum[t * QE + i] + eps, con);
        }
        inc += __shfl_xor_sync(0xffffffffu, inc, 1);
        inc += __shfl_xor_sync(0xffffffffu, inc, 2);
        con += __shfl_xor_sync(0xffffffffu, con, 1);
        con += __shfl_xor_sync(0xffffffffu, con, 2);
        scale[h] = sigmoid(con * a.sink_scale) / inc * out_scale;
      }
      float acc[KD][4] = {};
#pragma unroll
      for (int tt = 0; tt < KD; ++tt) {
        uint32_t ah[4], al[4];
        split_tf32(pq[0][2 * tt], ah[0], al[0]);
        split_tf32(pq[1][2 * tt], ah[1], al[1]);
        split_tf32(pq[0][2 * tt + 1], ah[2], al[2]);
        split_tf32(pq[1][2 * tt + 1], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < KD; ++nt) {
          const float2 h2 = kvh[(tt * KD + nt) * 32 + lane];
          const float2 l2 = kvl[(tt * KD + nt) * 32 + lane];
          const uint32_t bh_[2] = {__float_as_uint(h2.x), __float_as_uint(h2.y)};
          const uint32_t bl_[2] = {__float_as_uint(l2.x), __float_as_uint(l2.y)};
          mma_3xtf32(acc[nt], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * tile + g + 8 * h;
        if (r >= nqb) continue;
        float y[QE];
#pragma unroll
        for (int nt = 0; nt < KD; ++nt) {
          y[2 * nt] = acc[nt][2 * h] * scale[h];
          y[2 * nt + 1] = acc[nt][2 * h + 1] * scale[h];
        }
        T* dst = a.out + (bh * a.nq + q0 + r) * D + t * QE;
#pragma unroll
        for (int i = 0; i < QE; i += 4) store4(dst + i, y + i);
      }
    }
  }
}

// ---- the small-head route (D = 6, 8, 12, 16, 24, 48) ------------------------
//
// The same four steps over the same cluster split (block r owns sink rows
// [r rq, (r+1) rq) and source rows [r rk, (r+1) rk); every total is the
// blocks' partials summed in rank order through map_shared_rank), with one
// row a thread and fp32 FMA (flow_nc_common.cuh, "the small-head route").
// Each step reads its rows from device memory again (L2 holds a cluster's
// rows between steps at the vision shapes).  phi, e and every division
// take the accurate sigmoid, expf and IEEE division (K7b's chain), not the
// tensor-core kernel's fast intrinsics: with those, a vision step's
// stage-2 wq and wk gradients (D = 12) came out 8.2e-5 and 8.8e-5 of their
// size off an fp64 run, against 2.0e-5 and 2.6e-5 for the plain path
// (tools/nc_grad_precision.py on an H100).  The e-weighted kv is a sum over
// the source rows of phi(k_j)^T (v_j e_j): tiles of THREADS rows land in
// shared memory as fp32 phi(k) e and v, then the D x D entries are summed
// over the tile by their owners (Owners: row groups where D x D is smaller
// than the block), in registers across the tiles.

// shared memory, in floats: the block's partials of the four D-sums, their
// totals, the column-sum scratch, z's, kv's partial and total, the row
// groups' scratch, then the tile of phi(k) e and v (tr rows each)
template <int D>
struct SmallSmem {
  static constexpr int THREADS = Small<D>::THREADS, WARPS = Small<D>::WARPS;
  static constexpr int kPartA = 0, kPartB = 2 * D, kTot = 4 * D, kRed = 8 * D;
  static constexpr int kZw = kRed + 2 * WARPS * D, kZpart = kZw + WARPS;
  static constexpr int kKvPart = (kZpart + 4) & ~3, kKv = kKvPart + D * D;
  static constexpr int kGrp = kKv + D * D, kTile = kGrp + THREADS;
  static size_t bytes(int tr) { return ((size_t)kTile + 2 * (size_t)tr * D) * sizeof(float); }
};

template <typename T, int D>
__global__ void __launch_bounds__(Small<D>::THREADS, Small<D>::MIN_BLOCKS)
    flow_nc_fused_kernel_small(const Args<T> a, int tr) {
  using S = SmallSmem<D>;
  constexpr int THREADS = S::THREADS, WARPS = S::WARPS, NP = D * D;

  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank(), cb = (int)cluster.num_blocks();
  const float eps = a.eps;
  const size_t bh = blockIdx.y;
  const int q0 = rank * a.rq, k0 = rank * a.rk, tid = threadIdx.x;
  const int nqb = max(0, min(a.nq - q0, a.rq)), nkb = max(0, min(a.m - k0, a.rk));
  const T* qg = a.q + (bh * a.nq + q0) * D;
  const T* kg = a.k + (bh * a.m + k0) * D;
  const T* vg = a.v + (bh * a.m + k0) * D;

  extern __shared__ float4 smem4[];
  float* fs = reinterpret_cast<float*>(smem4);
  float* tot = fs + S::kTot;
  float* red = fs + S::kRed;

  // -- A: k_sum, q_sum (one D-vector of sums live at a time)
  {
    float ks[D] = {};
    for (int r = tid; r < nkb; r += THREADS) {
      float x[D];
      load_row<T, D>(kg + (size_t)r * D, x);
#pragma unroll
      for (int i = 0; i < D; ++i) ks[i] += sigmoid(x[i]);
    }
    block_sum<D, WARPS>(ks, red, fs + S::kPartA);
    float qs[D] = {};
    for (int r = tid; r < nqb; r += THREADS) {
      float x[D];
      load_row<T, D>(qg + (size_t)r * D, x);
#pragma unroll
      for (int i = 0; i < D; ++i) qs[i] += sigmoid(x[i]);
    }
    block_sum<D, WARPS>(qs, red + WARPS * D, fs + S::kPartA + D);
    cluster.sync();
    if (tid < 2 * D) {
      float s = 0.f;
      for (int j = 0; j < cb; ++j) s += cluster.map_shared_rank(fs + S::kPartA, j)[tid];
      tot[tid] = s;  // k_sum, q_sum
    }
    __syncthreads();
  }

  // -- B: ko_sum, qi_sum
  {
    const float* ksum = tot;
    const float* qsum = tot + D;
    float kos[D] = {};
    for (int r = tid; r < nkb; r += THREADS) {
      float x[D];
      load_row<T, D>(kg + (size_t)r * D, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        x[i] = sigmoid(x[i]);
        dot = fmaf(x[i] + eps, qsum[i] + eps, dot);
      }
      const float src_out = 1.f / dot;
#pragma unroll
      for (int i = 0; i < D; ++i) kos[i] = fmaf(x[i], src_out, kos[i]);
    }
    block_sum<D, WARPS>(kos, red, fs + S::kPartB);
    float qis[D] = {};
    for (int r = tid; r < nqb; r += THREADS) {
      float x[D];
      load_row<T, D>(qg + (size_t)r * D, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        x[i] = sigmoid(x[i]);
        dot = fmaf(x[i] + eps, ksum[i] + eps, dot);
      }
      const float sink_in = 1.f / dot;
#pragma unroll
      for (int i = 0; i < D; ++i) qis[i] = fmaf(x[i], sink_in, qis[i]);
    }
    block_sum<D, WARPS>(qis, red + WARPS * D, fs + S::kPartB + D);
    cluster.sync();
    if (tid < 2 * D) {
      float s = 0.f;
      for (int j = 0; j < cb; ++j) s += cluster.map_shared_rank(fs + S::kPartB, j)[tid];
      tot[2 * D + tid] = s;  // ko_sum, qi_sum
    }
    __syncthreads();
  }

  // -- C: e_j, z and kv = sum_j phi(k_j)^T (v_j e_j), tile by tile
  float z = 0.f;
  float* kv = fs + S::kKv;
  {
    const float* qisum = tot + 3 * D;
    float* pk = fs + S::kTile;  // tr x D: phi(k) e
    float* vt = pk + tr * D;    // tr x D: v
    const Owners<NP, THREADS> own;
    float acc[Owners<NP, THREADS>::EPT] = {};
    float zacc[1] = {0.f};
    for (int t0 = 0; t0 < nkb; t0 += tr) {
      const int rows = min(tr, nkb - t0);
      if (tid < rows) {
        float x[D], y[D];
        load_row<T, D>(kg + (size_t)(t0 + tid) * D, x);
        load_row<T, D>(vg + (size_t)(t0 + tid) * D, y);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          x[i] = sigmoid(x[i]);
          dot = fmaf(x[i] + eps, qisum[i] + eps, dot);
        }
        const float e = a.use_comp ? expf(fminf(fmaxf(dot, -1.f), 1.f)) : 1.f;
        zacc[0] += e;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          pk[tid * D + i] = x[i] * e;
          vt[tid * D + i] = y[i];
        }
      }
      __syncthreads();
      if (own.active())
#pragma unroll
        for (int i = 0; i < Owners<NP, THREADS>::EPT; ++i) {
          const int p = own.entry(i);
          if (p >= NP) continue;
          const int d = p / D, c = p % D;
          for (int r = own.grp; r < rows; r += Owners<NP, THREADS>::G)
            acc[i] = fmaf(pk[r * D + d], vt[r * D + c], acc[i]);
        }
      __syncthreads();  // the tile is read: the next may land
    }
    float* kvp = fs + S::kKvPart;
    group_total(own, acc, fs + S::kGrp, [&](int p, float s) { kvp[p] = s; });
    block_sum<1, WARPS>(zacc, fs + S::kZw, fs + S::kZpart);
    cluster.sync();
    for (int p = tid; p < NP; p += THREADS) {
      float s = 0.f;
      for (int j = 0; j < cb; ++j) s += cluster.map_shared_rank(kvp, j)[p];
      kv[p] = s;
    }
    for (int j = 0; j < cb; ++j) z += cluster.map_shared_rank(fs + S::kZpart, j)[0];
    // every block has read the others' partials (none leaves while another
    // reads its shared memory), and kv is whole in this block
    cluster.sync();
  }

  // -- D: the sink rows over the finished kv
  {
    const float* ksum = tot;
    const float* kosum = tot + 2 * D;
    const float out_scale = a.m_f / z;
    for (int r = tid; r < nqb; r += THREADS) {
      float x[D], y[D];
      load_row<T, D>(qg + (size_t)r * D, x);
      float inc = 0.f, con = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        x[i] = sigmoid(x[i]);
        inc = fmaf(x[i] + eps, ksum[i] + eps, inc);
        con = fmaf(x[i] + eps, kosum[i] + eps, con);
      }
      const float scale = sigmoid(con * a.sink_scale) / inc * out_scale;
      row_times_mat<D>(x, kv, y);
#pragma unroll
      for (int i = 0; i < D; ++i) y[i] *= scale;
      store_row<T, D>(a.out + (bh * a.nq + q0 + r) * D, y);
    }
  }
}

// one launch of `kern` as clusters of cb blocks per (batch * kv head)
template <typename Kern, typename... Xs>
cudaError_t launch_cluster(Kern kern, int threads, int bh, int cb, size_t bytes,
                           cudaStream_t stream, Xs... xs) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess && cb > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cb, bh, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, xs...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D, bool RES>
cudaError_t launch(const Args<T>& a, int bh, int cb, size_t bytes, cudaStream_t stream) {
  return launch_cluster(flow_nc_fused_kernel<T, D, RES>, kThreads, bh, cb, bytes, stream, a);
}

template <typename T, int D>
cudaError_t dispatch_res(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                         int m, int cb, int use_comp, float eps, cudaStream_t stream) {
  Args<T> a{(const T*)q, (const T*)k, (const T*)v, (T*)out, nq, m, (nq + cb - 1) / cb,
            (m + cb - 1) / cb, use_comp, eps, (float)((double)nq / (double)m), (float)m};
  if constexpr (small_dim<D>()) {
    // tile rows: no more than a block owns
    const int tr = a.rk < Small<D>::THREADS ? a.rk : Small<D>::THREADS;
    return launch_cluster(flow_nc_fused_kernel_small<T, D>, Small<D>::THREADS, bh, cb,
                          SmallSmem<D>::bytes(tr), stream, a, tr);
  } else {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const size_t staged = smem_bytes<T, D>(true, a.rq, a.rk);
    if (staged <= (size_t)optin) return launch<T, D, true>(a, bh, cb, staged, stream);
    return launch<T, D, false>(a, bh, cb, smem_bytes<T, D>(false, a.rq, a.rk), stream);
  }
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* out, int bh,
                     int nq, int m, int cb, int use_comp, float eps, cudaStream_t stream) {
  switch (d) {
    case 6: return dispatch_res<T, 6>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 8: return dispatch_res<T, 8>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 12: return dispatch_res<T, 12>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 16: return dispatch_res<T, 16>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 24: return dispatch_res<T, 24>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 48: return dispatch_res<T, 48>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 32: return dispatch_res<T, 32>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 64: return dispatch_res<T, 64>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    case 128: return dispatch_res<T, 128>(q, k, v, out, bh, nq, m, cb, use_comp, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, NQ, D), k (BH, M, D), v (BH, M, Dv) in `dtype` (0 fp32, 1 bf16),
// contiguous, 16-byte aligned at their bases (a row may be any whole number
// of element pairs); out (BH, NQ, Dv) in `dtype`.  D == Dv in {6, 8, 12, 16,
// 24, 48} (the small-head route) or {32, 64, 128}; NQ, M >= 1; cb in [1, 16]
// blocks per cluster (above 8 the card must allow non-portable cluster
// sizes).  Returns a cudaError_t.
extern "C" int flow_nc_fused_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                                 int nq, int m, int d, int dv, int dtype, int cb, int use_comp,
                                 float eps, void* stream) {
  if (d != dv || nq < 1 || m < 1 || cb < 1 || cb > kMaxCluster || bh > 65535)
    return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(d, q, k, v, out, bh, nq, m, cb, use_comp, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, out, bh, nq, m, cb, use_comp, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_nc_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
