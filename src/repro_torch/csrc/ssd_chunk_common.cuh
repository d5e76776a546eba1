// ssd_chunk_common.cuh — pieces shared by the SSD chunk-scan kernels for
// Hopper (sm_90a): ssd_chunk.cu (K10a) and ssd_chunk_bwd.cu (K10b).
//
// Both kernels give one 256-thread block one (batch, head) row and walk
// its chunks in order (K10a) or in reverse (K10b) with the (P, S) fp32
// carry in shared memory.  Inside a chunk of C <= 128 positions they work
// on 32-row sub-tiles (rows past C are staged as zeros and never
// written).  Every product is fp32 FMA on the CUDA cores through
// flow_chunk::mm (no tensor cores, no TF32), each sum in a fixed order,
// so results are deterministic.  Shared-memory rows have an odd stride
// (width + 1 floats), so the lanes of a warp read distinct banks.
#pragma once

#include "flow_chunk_common.cuh"

namespace ssd {

using flow_chunk::kThreads;
using flow_chunk::mm;
using flow_chunk::Own;

constexpr int kT = 32;          // rows of a sub-tile
constexpr int kMaxChunk = 128;  // longest chunk the kernels take

// B or C of one (batch, head) row: element (t, s) of row r lives at
// p + (r / heads) * sb + (r % heads) * sh + t * sn + s.  A (B, H, N, S)
// view with head stride 0 reads the shared (B, N, S) rows in place.
struct Strided {
  const float* p;
  long long sb, sh, sn;
  int heads;
  __device__ __forceinline__ const float* row(int r, int t) const {
    return p + (r / heads) * sb + (r % heads) * sh + (long long)t * sn;
  }
};

// Stage `rows` rows of width W (row stride ld floats, 16-byte aligned)
// into dst with row stride W + 1, zeros for rows at or past `valid`.  No
// synchronization.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, long long ld,
                                          int rows, int valid) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < rows * Q; i += kThreads) {
    const int r = i / Q, c = (i % Q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = __ldg(reinterpret_cast<const float4*>(src + r * ld + c));
    float* d = dst + r * (W + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// cum[i] = a[0] + ... + a[i] for i < chunk (<= 128), by warp 0: each lane
// sums its four positions in order, then the lanes' totals are scanned
// (Hillis-Steele, shuffles).  The caller synchronizes before reading.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a, int chunk, float* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
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

// Sum over the TX lanes (a power of two <= 32) that own one output row in
// an Own<M, N> layout; every lane of the warp must call it.
template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ssd
