// flow_chunk.cu — the chunked causal dot (K5a) for Hopper (sm_90a).
//
// Replaces repro/kernels/flow_chunk/flow_chunk.py::flow_chunk_call (the
// pl.pallas_call at :72, body _kernel :34-61):
//
//   out[g, i] = q[g, i] . S_i,   S_i = sum_{j<=i} k_j^T v_j
//
// for q (BH, G, N, Dk), k (BH, N, Dk), v (BH, N, Dv), fp32; the G grouped
// queries of a row share one (Dk, Dv) state.  The same entry computes the
// backward's dq with k and v swapped (attention/vjp.py::FlowChunkDot).
//
// What bounds it on the H100: 2 (G+1) Dk Dv operations per position
// against 4 ((G+1) Dk + (G+1) Dv) bytes -- 16 operations per byte at
// G = 1, Dk = Dv = 64, under the ~20 per byte at which the card's fp32 FMA
// rate (67 TFLOP/s) meets its memory (3.35 TB/s): the bytes bound it, as
// the recurrent form counts.  The chunked form below does ~1.4 times those
// operations at that shape (the causal panel) and moves the chunk states
// through the workspace, for parallel work.
//
// Design: the TPU carried S in VMEM along a sequential grid axis; a GPU
// grid has no ordered axis, so the chunk axis runs in parallel, in three
// launches (the pattern of flow_fused.cu and ssd_chunk.cu):
//   chunk_fwd_state: per (row, chunk c < nc - 1) the chunk state
//     H_c = k_c^T v_c (Dk x Dv) into the workspace (the last chunk's state
//     is never read), its positions copied in four cp.async groups and
//     summed as each lands;
//   chunk_fwd_pass: per row, in chunk order and in place, slot c becomes
//     H_0 + ... + H_c = S_{c+1}, one thread per float4 of a state with
//     eight slots' loads in flight;
//   chunk_fwd_out: per (row, chunk), for each group, out = q_c S_c (none
//     at c = 0) + tril(q_c k_c^T) v_c over the whole Dv; the panel is formed
//     once, only its tiles that reach the causal triangle, and stays in
//     registers; q_c with k_c, S_c and v_c are three cp.async groups, each
//     product starting as its operands land.
// Chunks of C = 64 positions, 32 at Dk or Dv = 128 (shared memory).  Blocks
// of 128 threads (4 warps), each warp owning 16-row blocks of its output.
// The products run on the tensor cores in 3xTF32 (mma.sync m16n8k8: each
// operand split into a tf32 head and an fp32 rest, three products summed in
// fp32).  The tensor cores drop the rest's low bits and do not round to
// nearest as they accumulate, so the error is several times that of the
// same sums in fp32 FMA, but within the causal dot's unchanged fp32
// tolerance, which one plain TF32 product fails (PERF.md).  A first
// version with fp32 FMA on the CUDA cores (8 x 4 outputs a thread from
// XOR-swizzled tiles) ran at a third of the card's fp32 rate.  72 KB of shared memory a block at Dk = Dv
// = 64, three blocks an SM.  Every sum runs in a fixed order and nothing
// uses atomics, so two calls are bitwise equal.  Rows at or past N are
// staged as zeros and never written, so any N >= 1 works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int DK, int DV>
__host__ __device__ constexpr int chunk_of() {
  return DK >= 128 || DV >= 128 ? 32 : 64;
}

// --- staging with cp.async ----------------------------------------------------

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
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

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The (row, chunk) of block b of a chunk-major grid over `rows` rows.
__device__ __forceinline__ int2 row_chunk(int b, int rows) { return make_int2(b % rows, b / rows); }

// --- the products ------------------------------------------------------------
//
// Both per-chunk kernels multiply on the tensor cores in 3xTF32 (mma.sync
// m16n8k8: a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulation; x =
// hi + lo, hi x cut to tf32).  Each product permutes its reduction index
// within every 8: a thread's A values (g, t) and (g, t + 4) are elements
// 2t and 2t + 1 of the reduction, with B's rows taken to match, so an A
// read along a row is one 8-byte load, and the panel's accumulators (g, 2t),
// (g, 2t + 1) are already the A fragment of its product with v_c: the panel
// never leaves registers.  Tiles read along their rows (q_c, k_c in
// chunk_fwd_out) are staged with a stride of W + 8 floats, tiles read down
// their columns with W + 4, so every fragment load is free of bank
// conflicts.

// x = hi + lo: hi is x cut to tf32 (its top 10 mantissa bits), lo the
// exact rest, whose low bits the tensor cores drop (a relative error of
// ~2^-21 of x in lo * b, and nothing in hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile (fragments as the PTX ISA lays them out:
// g = lane / 4, t = lane % 4; a: (g, t), (g+8, t), (g, t+4), (g+8, t+4);
// b: (t, g), (t+4, g); c: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1))
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  // the same product gathered with warp shuffles (host-side builds), each
  // operand cut to tf32 as the tensor cores read it
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  for (int kk = 0; kk < 8; ++kk) {
    const int hi = kk >= 4, src = kk & 3;
    const float a0 = tf32(__shfl_sync(0xffffffffu, a[hi ? 2 : 0], g * 4 + src));
    const float a1 = tf32(__shfl_sync(0xffffffffu, a[hi ? 3 : 1], g * 4 + src));
    const float b0 = tf32(__shfl_sync(0xffffffffu, b[hi], (2 * t) * 4 + src));
    const float b1 = tf32(__shfl_sync(0xffffffffu, b[hi], (2 * t + 1) * 4 + src));
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
#endif
}

// c += a b in 3xTF32: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The A fragment of k-step ks from a row-major tile of stride LD at row r0
// (this warp's 16 rows), the reduction index permuted within the step.
template <int LD>
__device__ __forceinline__ void a_frag(const float* A, int r0, int ks, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(A + (r0 + g) * LD + 8 * ks + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(A + (r0 + g + 8) * LD + 8 * ks + 2 * t);
  split_tf32(x0.x, ah[0], al[0]);  // (g, t): element 2t
  split_tf32(x1.x, ah[1], al[1]);  // (g + 8, t)
  split_tf32(x0.y, ah[2], al[2]);  // (g, t + 4): element 2t + 1
  split_tf32(x1.y, ah[3], al[3]);  // (g + 8, t + 4)
}

// B of k-step ks, n-tile columns n0..n0+7, from a k-major tile (rows k) of
// stride LD, rows permuted as a_frag's: (t, g) is row 2t, (t + 4, g) 2t + 1.
template <int LD>
__device__ __forceinline__ void b_frag_kmajor(const float* B, int ks, int n0, uint32_t (&bh)[2],
                                              uint32_t (&bl)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_tf32(B[(8 * ks + 2 * t) * LD + n0 + g], bh[0], bl[0]);
  split_tf32(B[(8 * ks + 2 * t + 1) * LD + n0 + g], bh[1], bl[1]);
}

// The same from an n-major tile (rows n, the reduction along a row).
template <int LD>
__device__ __forceinline__ void b_frag_nmajor(const float* B, int ks, int n0, uint32_t (&bh)[2],
                                              uint32_t (&bl)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(B + (n0 + g) * LD + 8 * ks + 2 * t);
  split_tf32(x.x, bh[0], bl[0]);
  split_tf32(x.y, bh[1], bl[1]);
}

// Copy rows t0 <= t < t1 of a row-major (rows, W) matrix at src into a tile
// of stride LD; rows at or past `valid` become zeros.  No commit, no wait.
template <int W, int LD>
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ src, int t0,
                                           int t1, int valid) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < (t1 - t0) * Q; i += kThreads) {
    const int t = t0 + i / Q, c = (i % Q) * 4;
    const bool ok = t < valid;
    cp16(dst + t * LD + c, ok ? src + (size_t)t * W + c : src, ok);
  }
}

// The A fragment of k-step ks for rows m0.. of A = X^T, X a k-major tile
// (rows k) of stride LD, the reduction index permuted as a_frag's.
template <int LD>
__device__ __forceinline__ void a_frag_kmajor(const float* X, int m0, int ks, uint32_t (&ah)[4],
                                              uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* x = X + (8 * ks + 2 * t) * LD + m0 + g;
  split_tf32(x[0], ah[0], al[0]);       // (g, t): k = 2t
  split_tf32(x[8], ah[1], al[1]);       // (g + 8, t)
  split_tf32(x[LD], ah[2], al[2]);      // (g, t + 4): k = 2t + 1
  split_tf32(x[LD + 8], ah[3], al[3]);  // (g + 8, t + 4)
}

// --- chunk_fwd_state -----------------------------------------------------------
//
// H_c = k_c^T v_c: warp w owns the 16-row blocks w, w + 4, ... of H (rows
// are features of k) and all DV columns; A is k_c read down its columns
// (the reduction runs over positions), so both tiles are staged with a
// stride of W + 4 floats.

template <int DK, int DV>
struct StateTiles {
  static constexpr int C = chunk_of<DK, DV>();
  static constexpr int LK = DK + 4, LV = DV + 4;
  static constexpr int MB = DK / 16;              // 16-row blocks of H
  static constexpr int PASSES = (MB + kWarps - 1) / kWarps;
  static constexpr int NT = DV / 8;               // 8-column tiles
  static constexpr int FLOATS = C * LK + C * LV;
  static constexpr int NS = 4, TS = C / NS;      // copy groups of TS positions
  static_assert(TS % 8 == 0, "whole k-steps per copy group");
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
chunk_fwd_state(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ states, int rows, int n) {
  using ST = StateTiles<DK, DV>;
  constexpr int C = ST::C, LK = ST::LK, LV = ST::LV, NT = ST::NT, NS = ST::NS, TS = ST::TS;
  extern __shared__ float smem[];
  float* K = smem;         // C x DK
  float* V = K + C * LK;   // C x DV
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, ci = rc.y, nst = (n + C - 1) / C - 1;
  const size_t p0 = (size_t)row * n + (size_t)ci * C;  // a full chunk: ci < nc - 1
  // four groups of C / 4 positions in flight; each is summed once it lands
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    issue_rows<DK, LK>(K, k + p0 * DK, st * TS, (st + 1) * TS, C);
    issue_rows<DV, LV>(V, v + p0 * DV, st * TS, (st + 1) * TS, C);
    cp_commit();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  float acc[ST::PASSES][NT][4];
#pragma unroll
  for (int p = 0; p < ST::PASSES; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    if (st == 0) cp_wait<NS - 1>();
    else if (st == 1) cp_wait<NS - 2>();
    else if (st == 2) cp_wait<NS - 3>();
    else cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int p = 0; p < ST::PASSES; ++p) {
      const int mb = warp + kWarps * p;
      if (mb < ST::MB) {
#pragma unroll
        for (int ks = st * TS / 8; ks < (st + 1) * TS / 8; ++ks) {
          uint32_t ah[4], al[4];
          a_frag_kmajor<LK>(K, 16 * mb, ks, ah, al);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bh[2], bl[2];
            b_frag_kmajor<LV>(V, ks, 8 * j, bh, bl);
            mma_3xtf32(acc[p][j], ah, al, bh, bl);
          }
        }
      }
    }
  }
  float* slot = states + ((size_t)row * nst + ci) * DK * DV;
#pragma unroll
  for (int p = 0; p < ST::PASSES; ++p) {
    const int mb = warp + kWarps * p;
    if (mb < ST::MB)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* h = slot + (size_t)(16 * mb + g8) * DV + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(h) = make_float2(acc[p][j][0], acc[p][j][1]);
        *reinterpret_cast<float2*>(h + 8 * DV) = make_float2(acc[p][j][2], acc[p][j][3]);
      }
  }
}

// --- chunk_fwd_pass ------------------------------------------------------------

// Per row, slot c <- slot 0 + ... + slot c for c < nst, in chunk order; one
// thread per float4 of a row's DK x DV state (q4 of them).
__global__ void __launch_bounds__(256)
chunk_fwd_pass(float* __restrict__ states, int rows, int nst, int q4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * q4) return;
  const long long row = idx / q4, q = idx % q4;
  float4* base = reinterpret_cast<float4*>(states) + row * nst * q4 + q;
  float4 h = zero4();
  constexpr int B = 8;  // slots' loads in flight before their stores
  for (int j0 = 0; j0 < nst; j0 += B) {
    float4 x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) x[u] = j0 + u < nst ? base[(long long)(j0 + u) * q4] : zero4();
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (j0 + u >= nst) break;
      h = make_float4(h.x + x[u].x, h.y + x[u].y, h.z + x[u].z, h.w + x[u].w);
      base[(long long)(j0 + u) * q4] = h;
    }
  }
}

// --- chunk_fwd_out -------------------------------------------------------------

template <int DK, int DV>
struct OutTiles {
  static constexpr int C = chunk_of<DK, DV>();
  static constexpr int LQ = DK + 8, LV = DV + 4;  // strides: q_c and k_c; S_c and v_c
  static constexpr int RBS = C / 16;              // 16-row blocks
  static constexpr int NCG = kWarps / RBS;        // warps sharing a row block
  static constexpr int NT = DV / 8 / NCG;         // a warp's 8-column output tiles
  static constexpr int FLOATS = 2 * C * LQ + C * LV + DK * LV;
  static_assert(RBS * NCG == kWarps && NT * NCG * 8 == DV, "warp layout");
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 3)
chunk_fwd_out(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ states,
              float* __restrict__ out, int rows, int grp, int n) {
  using OT = OutTiles<DK, DV>;
  constexpr int C = OT::C, LQ = OT::LQ, LV = OT::LV, NT = OT::NT;
  extern __shared__ float smem[];
  float* Q = smem;            // C x DK: q_c of one group
  float* K = Q + C * LQ;      // C x DK
  float* V = K + C * LQ;      // C x DV
  float* S = V + C * LV;      // DK x DV: S_c
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, ci = rc.y, c0 = ci * C;
  const int valid = min(C, n - c0), nst = (n + C - 1) / C - 1;
  const size_t p0 = (size_t)row * n + c0;
  // three copy groups: q_c and k_c (the panel), S_c (q_c S_c), v_c
  issue_rows<DK, LQ>(Q, q + ((size_t)row * grp * n + c0) * DK, 0, C, valid);
  issue_rows<DK, LQ>(K, k + p0 * DK, 0, C, valid);
  cp_commit();
  if (ci > 0) issue_rows<DV, LV>(S, states + ((size_t)row * nst + ci - 1) * DK * DV, 0, DK, DK);
  cp_commit();
  issue_rows<DV, LV>(V, v + p0 * DV, 0, C, valid);
  cp_commit();
  // warp w: the 16-row block w % (C / 16), the (w / (C / 16))-th share of
  // the columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rb = warp % OT::RBS, r0 = 16 * rb, n0 = (warp / OT::RBS) * NT * 8;
  const int npt = 2 * (rb + 1);  // the panel's live 8-column tiles: columns < 16 (rb + 1)
  for (int gi = 0; gi < grp; ++gi) {
    const size_t rg = (size_t)row * grp + gi;
    if (gi > 0) {  // the next group's q_c; k_c, S_c and v_c stay
      issue_rows<DK, LQ>(Q, q + (rg * n + c0) * DK, 0, C, valid);
      cp_commit();
      cp_wait<0>();
    } else {
      cp_wait<2>();
    }
    __syncthreads();
    // the causal panel q_c k_c^T of this warp's rows, in registers
    float pacc[C / 8][4];
#pragma unroll
    for (int j = 0; j < C / 8; ++j) pacc[j][0] = pacc[j][1] = pacc[j][2] = pacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      uint32_t ah[4], al[4];
      a_frag<LQ>(Q, r0, ks, ah, al);
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        if (j < npt) {
          uint32_t bh[2], bl[2];
          b_frag_nmajor<LQ>(K, ks, 8 * j, bh, bl);
          mma_3xtf32(pacc[j], ah, al, bh, bl);
        }
    }
    if (gi == 0) {
      cp_wait<1>();
      __syncthreads();
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (ci > 0) {  // q_c S_c
#pragma unroll
      for (int ks = 0; ks < DK / 8; ++ks) {
        uint32_t ah[4], al[4];
        a_frag<LQ>(Q, r0, ks, ah, al);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[2], bl[2];
          b_frag_kmajor<LV>(S, ks, n0 + 8 * j, bh, bl);
          mma_3xtf32(acc[j], ah, al, bh, bl);
        }
      }
    }
    if (gi == 0) {
      cp_wait<0>();
      __syncthreads();
    }
    // + tril(panel) v_c: the panel's accumulators are the A fragments
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      if (j < npt) {
        const int ra = r0 + g8, cb = 8 * j + 2 * t4;  // rows ra, ra + 8; columns cb, cb + 1
        const float p[4] = {cb <= ra ? pacc[j][0] : 0.f, cb + 1 <= ra ? pacc[j][1] : 0.f,
                            cb <= ra + 8 ? pacc[j][2] : 0.f, cb + 1 <= ra + 8 ? pacc[j][3] : 0.f};
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);  // (g, t): column 2t
        split_tf32(p[2], ah[1], al[1]);  // (g + 8, t)
        split_tf32(p[1], ah[2], al[2]);  // (g, t + 4): column 2t + 1
        split_tf32(p[3], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          uint32_t bh[2], bl[2];
          b_frag_kmajor<LV>(V, j, n0 + 8 * jn, bh, bl);
          mma_3xtf32(acc[jn], ah, al, bh, bl);
        }
      }
    float* orow = out + (rg * n + c0) * DV;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (r0 + g8 < valid)
        *reinterpret_cast<float2*>(orow + (size_t)(r0 + g8) * DV + col) =
            make_float2(acc[j][0], acc[j][1]);
      if (r0 + g8 + 8 < valid)
        *reinterpret_cast<float2*>(orow + (size_t)(r0 + g8 + 8) * DV + col) =
            make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();  // q_c is read: the next group's may land
  }
}

template <class K>
cudaError_t allow_smem(K kern, int floats) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int DK, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* work,
                   int bh, int grp, int n, cudaStream_t st) {
  constexpr int C = chunk_of<DK, DV>();
  const int nc = (n + C - 1) / C, nst = nc - 1;
  cudaError_t err;
  if (nst > 0) {
    constexpr int fs = StateTiles<DK, DV>::FLOATS;
    if ((err = allow_smem(chunk_fwd_state<DK, DV>, fs)) != cudaSuccess) return err;
    chunk_fwd_state<DK, DV><<<bh * nst, kThreads, fs * sizeof(float), st>>>(k, v, work, bh, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int q4 = DK * DV / 4;
    const long long threads = (long long)bh * q4;
    chunk_fwd_pass<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(work, bh, nst, q4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  constexpr int fo = OutTiles<DK, DV>::FLOATS;
  if ((err = allow_smem(chunk_fwd_out<DK, DV>, fo)) != cudaSuccess) return err;
  chunk_fwd_out<DK, DV><<<bh * nc, kThreads, fo * sizeof(float), st>>>(q, k, v, work, out, bh,
                                                                       grp, n);
  return cudaGetLastError();
}

bool width_ok(int d) { return d == 32 || d == 64 || d == 128; }

}  // namespace

// Floats of scratch flow_chunk_fwd needs for these shapes: one Dk x Dv
// state per row and chunk but the last; -1 for shapes it refuses.
extern "C" long long flow_chunk_workspace(int bh, int grp, int n, int dk, int dv) {
  if (bh < 0 || grp < 1 || n < 1 || !width_ok(dk) || !width_ok(dv)) return -1;
  const int c = dk >= 128 || dv >= 128 ? 32 : 64;
  return (long long)bh * ((n + c - 1) / c - 1) * dk * dv;
}

// q (BH, G, N, Dk), k (BH, N, Dk), v (BH, N, Dv) and out (BH, G, N, Dv),
// fp32, contiguous and 16-byte aligned; work flow_chunk_workspace floats;
// Dk and Dv in {32, 64, 128}; G, N >= 1.  Three launches on `stream` (one
// where N fits one chunk).  Returns a cudaError_t.
extern "C" int flow_chunk_fwd(const void* q, const void* k, const void* v, void* out, void* work,
                              int bh, int grp, int n, int dk, int dv, void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float *fo = (float*)out, *fw = (float*)work;
#define FLOW_CHUNK_DV(DK)                                                               \
  if (dv == 32) return (int)launch<DK, 32>(fq, fk, fv, fo, fw, bh, grp, n, st);         \
  if (dv == 64) return (int)launch<DK, 64>(fq, fk, fv, fo, fw, bh, grp, n, st);         \
  if (dv == 128) return (int)launch<DK, 128>(fq, fk, fv, fo, fw, bh, grp, n, st);
  if (dk == 32) { FLOW_CHUNK_DV(32) }
  if (dk == 64) { FLOW_CHUNK_DV(64) }
  if (dk == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
