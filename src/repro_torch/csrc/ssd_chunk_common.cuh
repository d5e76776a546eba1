// ssd_chunk_common.cuh — pieces shared by the SSD chunk-scan kernels for
// Hopper (sm_90a): ssd_chunk.cu (K10a) and ssd_chunk_bwd.cu (K10b).
//
// Both run the chunk axis in parallel (the SSD paper's GPU algorithm,
// arXiv:2405.21060 §6): chunk-local states per (row, chunk), a pass over
// the chunks that carries the (P, S) state, then the per-chunk products.
// B and C are shared by the heads of a batch row, so c b^T is formed once
// per (batch, chunk).  A chunk of C <= 128 positions is padded to 128 rows
// (rows past C are staged as zeros and never written).
//
// Every product is fp32 FMA on the CUDA cores (no tensor cores, no TF32)
// through tile_fma: the block's 256 threads own an M x N output, each
// thread MQ quads of 4 rows by NG float4 groups of columns (4 x 8 or
// 8 x 4 outputs, 8 x 8 for the C x C panels), reading both operands with
// 16-byte shared loads from tiles of kK = 32 k.  Every operand is staged
// as the rows lie in memory (m-major A, n-major swizzled B where the sum
// runs along a row), with cp.async, one tile in flight while the last one
// is consumed.  Every sum runs in a fixed order and nothing uses atomics,
// so results are deterministic run to run.
#pragma once

#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;  // longest chunk; chunk panels are padded to it
constexpr int kK = 32;          // rows of a staged k-tile
constexpr int kPad = 4;         // floats of padding per staged row
constexpr int kLM = kMaxChunk + kPad;  // row stride of a 128-wide tile

// B or C, shared by the heads of a batch row: row t of batch i at
// p + i * sb + t * sn (strides in floats, multiples of 4).
struct BC {
  const float* p;
  long long sb, sn;
  __device__ __forceinline__ const float* at(int batch, int t) const {
    return p + batch * sb + (long long)t * sn;
  }
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float get(float4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// cum[i] = a[0] + ... + a[i] for i < chunk (<= 128), by the calling warp:
// each lane sums its four positions in order, then the lanes' totals are
// scanned (Hillis-Steele, shuffles).  The warp syncs before returning.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ a, int chunk, float* cum) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    run += i < chunk ? a[i] : 0.f;
    v[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    if (i < chunk) cum[i] = excl + v[q];
  }
  __syncwarp();
}

// The in-chunk decay exp(cum_i - cum_j) of positions i, j < chunk on or
// below the diagonal, else 0.  Masked before exp, so the upper triangle
// never overflows (inf * 0 is NaN).  The TPU kernel clamps with
// min(., 0) instead: the same values (cum never rises), but its derivative
// is 1/2 where rounding makes cum_i == cum_j for j < i, which depends on
// the order the cumsum was summed in; masked, the derivative is 1 on the
// whole lower triangle, so K10b and its plain version (kernels/ssd_chunk/
// ref.py::chunk_terms) agree whatever their summation orders.
__device__ __forceinline__ float decay(const float* cum, int i, int j, int chunk) {
  return (j <= i && i < chunk) ? expf(cum[i] - cum[j]) : 0.f;
}

// Sum over the TX consecutive lanes (a power of two <= 32) that share one
// output row; every lane of the warp must call it.
template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Ownership of an M x N output: thread (tm, tn) owns MQ quads of rows and
// NG float4 groups of columns.  With MQ == 2 the quads pair tm with
// M / 4 - 1 - tm, so every thread holds one quad from each end of the
// chunk and a causal (triangular) product gives all threads equal work.
// Column group g starts at g * N / NG + 4 tn: the TN >= 8 consecutive
// lanes of a row read contiguous float4s.  Threads past TN * TM own
// nothing (`on` false) but stage tiles and meet every barrier.
template <int M, int N, int MQ, int NG>
struct Own {
  static constexpr int TN = N / (4 * NG);
  static constexpr int TM = M / (4 * MQ);
  static_assert(TN * TM <= kThreads && TN <= 32 && 32 % TN == 0, "thread layout");
  static_assert((TN * TM) % 32 == 0, "whole warps own outputs");
  int tm, tn;
  bool on;
  __device__ __forceinline__ Own()
      : tm(threadIdx.x / TN), tn(threadIdx.x % TN), on(threadIdx.x < TN * TM) {}
  __device__ __forceinline__ int row(int u) const { return u == 0 ? 4 * tm : M - 4 - 4 * tm; }
  __device__ __forceinline__ int col(int g) const { return g * (N / NG) + 4 * tn; }
};

// acc[4u + r][4g + c] += sum_{k < kK} A(k, ar[u] + r) B(k, bc[g] + c)
// over one staged tile, skipping the (u, g) blocks whose bit u * NG + g
// is set in SKIP.  Operand layouts in shared memory:
//   A: k-major, A(k, m) = A[k * LA + m] (AM false), or m-major,
//      A(k, m) = A[m * LA + k] (AM true: rows as they lie in memory);
//   B: k-major, B(k, n) = B[k * LB + n] (BN false), or n-major with
//      swizzled float4 chunks, B(k, n) = B[n * kK + swz(n, k)] (BN true).
// Either way MQ + NG 16-byte loads per 4 MQ NG FMAs (four k at a time
// where a layout is m- or n-major).  The lanes of a quarter warp share
// their row quad (A loads broadcast) and read consecutive column groups:
// contiguous float4s (B k-major), or rows 4 apart whose chunks the
// swizzle spreads over all banks (B n-major).

// Offset of the float4 chunk holding element k (a multiple of 4, < kK)
// in row n of an n-major tile.
__device__ __forceinline__ int swz(int n, int k) { return (((k >> 2) ^ (n >> 2)) & 7) * 4; }

template <int MQ, int NG, int LA, int LB, bool AM, bool BN, unsigned SKIP, int KB>
__device__ __forceinline__ void fma_step(float (&acc)[4 * MQ][4 * NG], const float* A,
                                         const float* B, const int (&ar)[MQ],
                                         const int (&bc)[NG], int k0) {
  // n-major B holds four k in a float4: loaded once; m-major A likewise,
  // one row quad at a time; k-major operands one k at a time -- so few
  // fragments are live at once
  float4 fb[NG][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (BN) fb[g][q] = ld4(B + (bc[g] + q) * kK + swz(bc[g] + q, k0));
  auto fma = [&](int u, int g, const float4& a4, const float4& b4) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[4 * u + r][4 * g + c] =
            fmaf(get(a4, r), get(b4, c), acc[4 * u + r][4 * g + c]);
  };
  auto skip = [](int u, int g) { return (SKIP >> (u * NG + g)) & 1u; };
  if constexpr (AM) {
#pragma unroll
    for (int u = 0; u < MQ; ++u) {
      float4 fa[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) fa[q] = ld4(A + (ar[u] + q) * LA + k0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 a4 = make_float4(get(fa[0], kk), get(fa[1], kk), get(fa[2], kk),
                                      get(fa[3], kk));
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (skip(u, g)) continue;
          const float4 b4 = BN ? make_float4(get(fb[g][0], kk), get(fb[g][1], kk),
                                             get(fb[g][2], kk), get(fb[g][3], kk))
                               : ld4(B + (k0 + kk) * LB + bc[g]);
          fma(u, g, a4, b4);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      float4 ka[MQ];
#pragma unroll
      for (int u = 0; u < MQ; ++u) ka[u] = ld4(A + (k0 + kk) * LA + ar[u]);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 b4 = BN ? make_float4(get(fb[g][0], kk), get(fb[g][1], kk),
                                           get(fb[g][2], kk), get(fb[g][3], kk))
                             : ld4(B + (k0 + kk) * LB + bc[g]);
#pragma unroll
        for (int u = 0; u < MQ; ++u)
          if (!skip(u, g)) fma(u, g, ka[u], b4);
      }
    }
  }
}

template <int MQ, int NG, int LA, int LB, bool AM, bool BN, unsigned SKIP = 0u>
__device__ __forceinline__ void tile_fma(float (&acc)[4 * MQ][4 * NG], const float* A,
                                         const float* B, const int (&ar)[MQ],
                                         const int (&bc)[NG]) {
  if constexpr (AM || BN) {
#pragma unroll 2
    for (int k0 = 0; k0 < kK; k0 += 4)
      fma_step<MQ, NG, LA, LB, AM, BN, SKIP, 4>(acc, A, B, ar, bc, k0);
  } else {
#pragma unroll 8
    for (int k0 = 0; k0 < kK; ++k0)
      fma_step<MQ, NG, LA, LB, AM, BN, SKIP, 1>(acc, A, B, ar, bc, k0);
  }
}

// tile_fma with MQ == 2 on k-major operands where each quad of rows runs
// only if its flag is set (a causal product: quads wholly past the
// diagonal skip the tile).
template <int NG, int LA, int LB>
__device__ __forceinline__ void tile_fma_pair(float (&acc)[8][4 * NG], const float* A,
                                              const float* B, const int (&ar)[2],
                                              const int (&bc)[NG], bool lo, bool hi) {
  constexpr unsigned kLo = (1u << NG) - 1u, kHi = kLo << NG;
  if (lo && hi) tile_fma<2, NG, LA, LB, false, false, 0u>(acc, A, B, ar, bc);
  else if (hi) tile_fma<2, NG, LA, LB, false, false, kLo>(acc, A, B, ar, bc);
  else if (lo) tile_fma<2, NG, LA, LB, false, false, kHi>(acc, A, B, ar, bc);
}

// --- staging tiles with cp.async -------------------------------------------
//
// A tile of R rows, each W floats from src + r * ld (rows at or past
// `valid` are zeros), is copied to shared memory in 16-byte cp.async
// chunks, row stride W + kPad, or W == kK with the n-major swizzle (SWZ).
// Thread t always copies the chunks it + i * kThreads, so once its copies
// have landed it may rewrite them (land_rows) before the block's barrier.
// A warp copies whole 128-byte lines.
template <int W, int R = kK>
struct Rows {
  static constexpr int Q = W / 4, NV = R * Q / kThreads;
  static_assert(NV >= 1 && R * Q % kThreads == 0, "row tile");
};

template <int W, bool SWZ>
__device__ __forceinline__ int tile_at(int r, int c) {
  static_assert(!SWZ || W == kK, "swizzled tiles are kK wide");
  return SWZ ? r * kK + swz(r, c) : r * (W + kPad) + c;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
#else
  st4(dst, valid ? ld4(src) : zero4());
#endif
}

__device__ __forceinline__ void cp_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait for all of this thread's copies.
__device__ __forceinline__ void cp_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

template <int W, int R = kK, bool SWZ = false>
__device__ __forceinline__ void issue_rows(float* dst, const float* src, long long ld, int valid) {
#pragma unroll
  for (int i = 0; i < Rows<W, R>::NV; ++i) {
    const int it = threadIdx.x + i * kThreads, r = it / Rows<W, R>::Q;
    const int c = (it % Rows<W, R>::Q) * 4;
    cp16(dst + tile_at<W, SWZ>(r, c), r < valid ? src + r * ld + c : src, r < valid);
  }
}

// Rewrite this thread's landed chunks: dst[r][c..c+3] = f(r, c, them).
template <int W, int R = kK, bool SWZ = false, class F>
__device__ __forceinline__ void land_rows(float* dst, F f) {
#pragma unroll
  for (int i = 0; i < Rows<W, R>::NV; ++i) {
    const int it = threadIdx.x + i * kThreads, r = it / Rows<W, R>::Q;
    const int c = (it % Rows<W, R>::Q) * 4;
    float* d = dst + tile_at<W, SWZ>(r, c);
    st4(d, f(r, c, ld4(d)));
  }
}

// Load this thread's chunks of a tile synchronously as the sum of ng
// matrices gstride floats apart, in order (no cp.async: a sum).
template <int W, int R = kK>
__device__ __forceinline__ void load_rows_sum(float* dst, const float* src, long long ld,
                                              int ng, long long gstride) {
#pragma unroll
  for (int i = 0; i < Rows<W, R>::NV; ++i) {
    const int it = threadIdx.x + i * kThreads, r = it / Rows<W, R>::Q;
    const int c = (it % Rows<W, R>::Q) * 4;
    const float* p = src + r * ld + c;
    float4 s = ldg4(p);
    for (int g = 1; g < ng; ++g) {
      const float4 t = ldg4(p + g * gstride);
      s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
    }
    st4(dst + tile_at<W, false>(r, c), s);
  }
}

// Wait until at most n groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Stages of the tile pipelines (shared buffers in a ring).
constexpr int kStages = 2;

// Run nt tiles through kStages shared buffers of `stage` floats from buf:
// issue(kt, b) starts tile kt's copies into b, land(kt, b) finishes this
// thread's part of it once its copies have landed, compute(kt, b)
// consumes it.  kStages - 1 tiles are in flight while one is computed.
// Every thread of the block must call it.
template <class Issue, class Land, class Compute>
__device__ __forceinline__ void run_tiles(int nt, float* buf, int stage, Issue&& issue,
                                          Land&& land, Compute&& compute) {
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt) issue(t, buf + t * stage);
    cp_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    const int nx = kt + kStages - 1;
    if (nx < nt) issue(nx, buf + (nx % kStages) * stage);
    cp_commit();
    cp_wait<kStages - 1>();
    float* cur = buf + (kt % kStages) * stage;
    land(kt, cur);
    __syncthreads();
    compute(kt, cur);
    __syncthreads();  // cur is free for tile kt + kStages
  }
}

// --- blocks shared by K10a and K10b -----------------------------------------

// out[m][n] = sum_s a_m . b_n over the chunk's positions m, n < 128 (rows
// past the chunk are zeros), for one (batch, chunk): the C x C panel that
// every head of the batch row shares.  K10a passes (a, b) = (B, C), so out
// is G^T (out[j][i] = c_i . b_j); K10b passes (C, B), so out is G.
template <int S>
__device__ __forceinline__ void gram_block(BC a, BC b, int batch, int t0, int chunk,
                                           float* __restrict__ out, float* smem) {
  constexpr int LA = kK + kPad, kB = kMaxChunk * LA, kStage = kB + kMaxChunk * kK;
  using O = Own<kMaxChunk, kMaxChunk, 2, 2>;
  const O o;
  const int ar[2] = {o.row(0), o.row(1)}, bc[2] = {o.col(0), o.col(1)};
  const float *pa = a.at(batch, t0), *pb = b.at(batch, t0);
  float acc[8][8] = {};
  run_tiles(
      S / kK, smem, kStage,
      [&](int kt, float* buf) {
        issue_rows<kK, kMaxChunk>(buf, pa + kt * kK, a.sn, chunk);
        issue_rows<kK, kMaxChunk, true>(buf + kB, pb + kt * kK, b.sn, chunk);
      },
      [&](int, float*) {},
      [&](int, float* buf) { tile_fma<2, 2, LA, kK, true, true>(acc, buf, buf + kB, ar, bc); });
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        st4(out + (ar[u] + r) * kMaxChunk + bc[g],
            make_float4(acc[4 * u + r][4 * g], acc[4 * u + r][4 * g + 1],
                        acc[4 * u + r][4 * g + 2], acc[4 * u + r][4 * g + 3]));
}

template <int S>
constexpr int gram_smem_floats() {
  return kStages * kMaxChunk * (2 * kK + kPad);
}

// The staged tiles of ssd_fwd_out and ssd_bwd_dx: the inter-chunk k-tile
// of S (A: 128 rows of c or b, m-major; B: P rows of h or gh, n-major) or
// the intra-chunk k-tile of positions (A: 32 rows of the panel, k-major;
// B: 32 rows of x or gy).
template <int P>
struct PanelTiles {
  static constexpr int LA = kK + kPad, LP = P + kPad;
  static constexpr int kInterB = kMaxChunk * LA, kIntraB = kK * kLM;
  static constexpr int kInter = kInterB + P * kK, kIntra = kIntraB + kK * LP;
  static constexpr int kStage = kInter > kIntra ? kInter : kIntra;
  static constexpr int kFloats = kStages * kStage + 2 * kMaxChunk;
};

// The chunk-local state out[p][s] = sum_k w_k u[k][p] v[k][s] of one
// (row, chunk): u is the row's x (K10a) or gy (K10b), C x P from up; v is
// the batch row's b or c, from vp with row stride vn; w is seg =
// exp(cum_last - cum) (K10a, SEG) or exp(cum) (K10b).  Also writes
// exp(cum_last) to *e and, where given, seg and exp(cum) of each position
// to wseg and wecum.  smem: the stages, then 2 x 128 floats.
template <int P, int S, bool SEG>
__device__ __forceinline__ void local_block(const float* __restrict__ up,
                                            const float* __restrict__ vp, long long vn,
                                            const float* __restrict__ dta, int chunk,
                                            float* __restrict__ out, float* __restrict__ e,
                                            float* smem, float* __restrict__ wseg = nullptr,
                                            float* __restrict__ wecum = nullptr) {
  constexpr int LP = P + kPad, LS = S + kPad, kStage = kK * (LP + LS);
  constexpr int NG = S >= 64 ? 2 : 1;
  using O = Own<P, S, 1, NG>;
  float* cum = smem + kStages * kStage;
  float* w = cum + kMaxChunk;
  if (threadIdx.x < 32) warp_cumsum(dta, chunk, cum);
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxChunk; i += kThreads) {
    w[i] = i < chunk ? expf(SEG ? cum[chunk - 1] - cum[i] : cum[i]) : 0.f;
    if (wseg && i < chunk) {
      wseg[i] = expf(cum[chunk - 1] - cum[i]);
      wecum[i] = expf(cum[i]);
    }
  }
  if (threadIdx.x == 0) *e = expf(cum[chunk - 1]);
  __syncthreads();
  const O o;
  int ar[1] = {o.row(0)}, bc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) bc[g] = o.col(g);
  float acc[4][4 * NG] = {};
  run_tiles(
      (chunk + kK - 1) / kK, smem, kStage,
      [&](int kt, float* buf) {
        const int k0 = kt * kK;
        issue_rows<P>(buf, up + (long long)k0 * P, P, chunk - k0);
        issue_rows<S>(buf + kK * LP, vp + k0 * vn, vn, chunk - k0);
      },
      [&](int kt, float* buf) {
        const int k0 = kt * kK;
        land_rows<P>(buf, [&](int r, int, float4 x) { return scale4(x, w[k0 + r]); });
      },
      [&](int, float* buf) {
        if (o.on) tile_fma<1, NG, LP, LS, false, false>(acc, buf, buf + kK * LP, ar, bc);
      });
  if (!o.on) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      st4(out + (ar[0] + r) * S + bc[g],
          make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]));
}

template <int P, int S>
constexpr int local_smem_floats() {
  return kStages * kK * (P + S + 2 * kPad) + 2 * kMaxChunk;
}

// The pass over the chunks: buf[r][k] (P x S) holds local states and is
// replaced by the sum entering slot k, h <- e[k] h + buf[k] from zero in
// slot order.  K10a's slots are its chunks (each ends as the chunk's
// carry-in); K10b stores its chunks last first, so each slot ends as the
// cotangent of its chunk's carry-out.  One thread per float4 of a row's
// P x S state, sequential over the slots, the next slot's load issued
// before the current store.
__device__ __forceinline__ void state_pass(float* __restrict__ buf, const float* __restrict__ e,
                                           int rows, int nc, int q4) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)rows * q4) return;
  const int r = (int)(idx / q4);
  float4* base = reinterpret_cast<float4*>(buf) + (long long)r * nc * q4 + (idx % q4);
  const float* er = e + (long long)r * nc;
  float4 h = zero4();
  float4 v = base[0];
  for (int k = 0; k < nc; ++k) {
    const float4 vn = k + 1 < nc ? base[(long long)(k + 1) * q4] : zero4();
    base[(long long)k * q4] = h;
    const float ec = er[k];
    h = make_float4(h.x * ec + v.x, h.y * ec + v.y, h.z * ec + v.z, h.w * ec + v.w);
    v = vn;
  }
}

// Heads summed by one K10b dM block: the largest of 8, 4, 2, 1 dividing
// `heads`.
__host__ __device__ inline int group_heads(int heads) {
  return heads % 8 == 0 ? 8 : heads % 4 == 0 ? 4 : heads % 2 == 0 ? 2 : 1;
}

inline long long align4(long long n) { return (n + 3) / 4 * 4; }

}  // namespace ssd
