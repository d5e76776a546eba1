// flow_chunk_common.cuh — pieces shared by the chunked causal-dot kernels
// for Hopper (sm_90a): flow_chunk.cu (K5a, the forward and dq) and
// flow_chunk_bwd.cu (K5b, dk and dv).
//
// Both run the chunk axis in parallel in three launches over one workspace
// of per-(row, chunk) D x Dv states: a state kernel (the body
// `chunk_state` below: K5a's H_c = k_c^T v_c, K5b's U_c = sum_g
// q_{c,g}^T g_{c,g}), a pass that turns the states into running sums in
// place (`chunk_pass`: K5a's prefix in chunk order, K5b's suffix in
// reverse order), and a per-chunk output kernel of each source's own.
// Every product runs on the tensor cores in 3xTF32 (tensor_core.cuh), every
// sum in a fixed order and without atomics, so two calls are bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace flow_chunk {

using namespace tc;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

constexpr int kThreads = 128;  // the state kernels and K5a's output kernel
constexpr int kWarps = kThreads / 32;

// Positions per chunk: 64, 32 where a width is 128 (shared memory).
template <int DK, int DV>
__host__ __device__ constexpr int chunk_of() {
  return DK >= 128 || DV >= 128 ? 32 : 64;
}

// The (row, chunk) of block b of a chunk-major grid over `rows` rows.
__device__ __forceinline__ int2 row_chunk(int b, int rows) { return make_int2(b % rows, b / rows); }

// --- fragments ------------------------------------------------------------------
//
// Each product permutes its reduction index within every 8: a thread's A
// values (g, t) and (g, t + 4) are elements 2t and 2t + 1 of the
// reduction, with B's rows taken to match, so an A read along a row is one
// 8-byte load, and an accumulator tile (g, 2t), (g, 2t + 1) is already the A
// fragment of a product that reduces over its columns.  K5a's tiles read
// along their rows are staged with a stride of W + 8 floats, those read
// down their columns with W + 4, so every fragment load is free of bank
// conflicts.

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

// Copy rows t0 <= t < t1 of a row-major (rows, W) matrix at src into a tile
// of stride LD, NT threads sharing the copies; rows at or past `valid`
// become zeros.  No commit, no wait.
template <int W, int LD, int NT = kThreads>
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ src, int t0,
                                           int t1, int valid) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < (t1 - t0) * Q; i += NT) {
    const int t = t0 + i / Q, c = (i % Q) * 4;
    const bool ok = t < valid;
    cp_async16(dst + t * LD + c, ok ? src + (size_t)t * W + c : src, ok);
  }
}

// --- the state kernels' body ----------------------------------------------------
//
// slot = sum_{gi < grp} A_gi^T B_gi over one chunk, A_gi the (C, DK) rows at
// a + gi a_step and B_gi the (C, DV) rows at b + gi b_step (rows at or past
// `valid` read as zeros).  Warp w owns the 16-row blocks w, w + 4, ... of
// the DK x DV state and all its columns; A is read down its columns (the
// reduction runs over positions), so both tiles are staged with a stride
// of W + 4 floats, each group's positions in four cp.async groups summed
// as each lands.

template <int DK, int DV>
struct StateTiles {
  static constexpr int C = chunk_of<DK, DV>();
  static constexpr int LK = DK + 4, LV = DV + 4;
  static constexpr int MB = DK / 16;              // 16-row blocks of the state
  static constexpr int PASSES = (MB + kWarps - 1) / kWarps;
  static constexpr int NT = DV / 8;               // 8-column tiles
  static constexpr int FLOATS = C * LK + C * LV;
  static constexpr int NS = 4, TS = C / NS;      // copy groups of TS positions
  static_assert(TS % 8 == 0, "whole k-steps per copy group");
};

template <int DK, int DV>
__device__ __forceinline__ void chunk_state(const float* __restrict__ a,
                                            const float* __restrict__ b, size_t a_step,
                                            size_t b_step, int grp, int valid,
                                            float* __restrict__ slot) {
  using ST = StateTiles<DK, DV>;
  constexpr int LK = ST::LK, LV = ST::LV, NT = ST::NT, NS = ST::NS, TS = ST::TS;
  extern __shared__ float smem[];
  float* K = smem;              // C x DK
  float* V = K + ST::C * LK;    // C x DV
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  float acc[ST::PASSES][NT][4];
#pragma unroll
  for (int p = 0; p < ST::PASSES; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
  for (int gi = 0; gi < grp; ++gi) {
    if (gi > 0) __syncthreads();  // the last group's tiles are read
    // four groups of C / 4 positions in flight; each is summed once it lands
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      issue_rows<DK, LK>(K, a + gi * a_step, st * TS, (st + 1) * TS, valid);
      issue_rows<DV, LV>(V, b + gi * b_step, st * TS, (st + 1) * TS, valid);
      cp_async_commit();
    }
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      if (st == 0) cp_async_wait<NS - 1>();
      else if (st == 1) cp_async_wait<NS - 2>();
      else if (st == 2) cp_async_wait<NS - 3>();
      else cp_async_wait<0>();
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
  }
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

// --- the pass kernels' body -----------------------------------------------------
//
// Per row, the nst slots become running sums in place, one thread per float4
// of a row's state (q4 of them): slot c <- slot 0 + ... + slot c in chunk
// order, or with REVERSE slot c <- slot c + ... + slot nst - 1, summed from
// the last slot down.
template <bool REVERSE>
__device__ __forceinline__ void chunk_pass(float* __restrict__ states, int rows, int nst, int q4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * q4) return;
  const long long row = idx / q4, q = idx % q4;
  float4* base = reinterpret_cast<float4*>(states) + row * nst * q4 + q;
  float4 h = zero4();
  constexpr int B = 8;  // slots' loads in flight before their stores
  for (int j0 = 0; j0 < nst; j0 += B) {
    float4 x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int s = REVERSE ? nst - 1 - (j0 + u) : j0 + u;
      x[u] = j0 + u < nst ? base[(long long)s * q4] : zero4();
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (j0 + u >= nst) break;
      const int s = REVERSE ? nst - 1 - (j0 + u) : j0 + u;
      h = make_float4(h.x + x[u].x, h.y + x[u].y, h.z + x[u].z, h.w + x[u].w);
      base[(long long)s * q4] = h;
    }
  }
}

inline bool width_ok(int d) { return d == 32 || d == 64 || d == 128; }

// Floats of workspace the three launches need: one DK x DV state per row
// and chunk but one; -1 for shapes the kernels refuse.
inline long long workspace_floats(int bh, int grp, int n, int dk, int dv) {
  if (bh < 0 || grp < 1 || n < 1 || !width_ok(dk) || !width_ok(dv)) return -1;
  const int c = dk >= 128 || dv >= 128 ? 32 : 64;
  return (long long)bh * ((n + c - 1) / c - 1) * dk * dv;
}

}  // namespace flow_chunk
