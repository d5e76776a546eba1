// flow_chunk_common.cuh — pieces shared by the chunked causal-dot kernels
// for Hopper (sm_90a): flow_chunk.cu (K5a) and flow_chunk_bwd.cu (K5b).
//
// Both kernels stage 64-position tiles of their (N, width) operands in
// shared memory, one row per position with a row stride of width + 1
// floats, and form every product with `mm`: a 256-thread block where
// thread (ty, tx) owns the contiguous rows ty*RM .. ty*RM + RM - 1 and the
// strided columns tx, tx + TX, tx + 2 TX, tx + 3 TX of an M x N output.
// With the odd row stride, the lanes of a warp read distinct banks (or
// one address) in every operand layout used, so scalar loads run without
// conflicts.  Every product is fp32 FMA on the CUDA cores (no tensor
// cores, no TF32), each sum in a fixed order: results are deterministic
// and match the plain PyTorch versions to fp32 reassociation.
#pragma once

#include <cuda_runtime.h>

namespace flow_chunk {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // positions per staged tile

// Ownership of an M x N output among the block's threads.
template <int M, int N>
struct Own {
  static constexpr int TX = N / 4;          // threads along the columns
  static constexpr int TY = kThreads / TX;  // threads along the rows
  static constexpr int RM = M / TY;         // rows per thread
  static_assert(N % 4 == 0 && TX <= 32 && kThreads % TX == 0, "column layout");
  static_assert(M % TY == 0 && RM >= 1, "row layout");
};

// acc[r][c] += sum_{t in [t0, t1)} A(m0 + r, t) * B(t, n0 + c * nstride), with
//   A(m, t) = TA ? A[t * lda + m] : A[m * lda + t]
//   B(t, n) = TB ? B[n * ldb + t] : B[t * ldb + n]
// all in shared memory.
template <int RM, int RN, bool TA, bool TB>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], const float* A, int lda, const float* B,
                                   int ldb, int m0, int n0, int nstride, int t0, int t1) {
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    float a[RM], b[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = TA ? A[t * lda + m0 + r] : A[(m0 + r) * lda + t];
#pragma unroll
    for (int c = 0; c < RN; ++c)
      b[c] = TB ? B[(n0 + c * nstride) * ldb + t] : B[t * ldb + n0 + c * nstride];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Stage rows [t0, t0 + kTile) and columns [c0, c0 + W) of a row-major
// (n, ld) matrix in device memory into dst (row stride W + 1), with zeros
// for rows at or past n.  16-byte loads: src, ld and c0 are multiples of 4
// floats.  No synchronization.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int ld,
                                          int c0, int t0, int n) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < kTile * Q; i += kThreads) {
    const int r = i / Q, c = (i % Q) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < n) x = __ldg(reinterpret_cast<const float4*>(src + (size_t)(t0 + r) * ld + c0 + c));
    float* d = dst + r * (W + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Write the thread's rows m0.. (below n - t0) of an owned output tile to
// rows t0 + m0.. of a row-major device matrix with row stride ld, columns
// c0 + n0 + c * nstride.
template <int RM>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int ld, int c0, int t0, int n,
                                           const float (&acc)[RM][4], int m0, int n0, int nstride) {
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = t0 + m0 + r;
    if (row < n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[(size_t)row * ld + c0 + n0 + c * nstride] = acc[r][c];
    }
  }
}

// dst[i][j] = acc for j <= i (the causal triangle of a tile), else 0: the
// thread's owned block of a kTile x kTile score panel, row stride kTile + 1.
template <int RM>
__device__ __forceinline__ void store_tril(float* dst, const float (&acc)[RM][4], int m0, int n0,
                                           int nstride) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = m0 + r, j = n0 + c * nstride;
      dst[i * (kTile + 1) + j] = j <= i ? acc[r][c] : 0.f;
    }
}

}  // namespace flow_chunk
