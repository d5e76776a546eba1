// flow_chunk.cu — the chunked causal dot (K5a) for Hopper (sm_90a).
//
// Replaces repro/kernels/flow_chunk/flow_chunk.py::flow_chunk_call (the
// pl.pallas_call at :72, body _kernel :35-61):
//
//   out[g, i] = q[g, i] . S_i,   S_i = sum_{j<=i} k_j^T v_j
//
// for q (BH, G, N, Dk), k (BH, N, Dk), v (BH, N, Dv), fp32; the G grouped
// queries of a row share one (Dk, Dv) state.  The same kernel computes the
// backward's dq with k and v swapped (repro/attention/vjp.py:87).
//
// What bounds it on the H100: 2 (G+1) Dk Dv operations per position
// against 4 ((G+1) Dk + (G+1) Dv) bytes -- 16 operations per byte at
// G = 1, Dk = Dv = 64, under the ~20 per byte at which the card's fp32 FMA
// rate (67 TFLOP/s) meets its memory (3.35 TB/s): the bytes bound it, as
// the recurrent form counts.  The chunked form below does about 2.3 times
// those operations at that shape (the 64 x 64 intra-tile panel, computed
// whole and once per Dv slice) in exchange for parallel work in a tile.
//
// Design.  The TPU carried S in VMEM along a sequential grid axis; a GPU
// grid has no ordered axis.  So one 256-thread block owns one (row, kv
// head) and a 32-wide slice of Dv (out[:, :, e] depends only on v[:, e]
// and S[:, e]: Dv / 32 blocks per row, 256 at the training shape) and
// loops over 64-position tiles with its Dk x 32 slice of S in shared
// memory; no atomics, so every sum is taken in one fixed order.  Per tile
// it stages k and the v slice, then per query group the q tile, the
// masked panel P = tril(q k^T) (computed whole, stored masked), and
// out = P v + q S (the P v sum stops at the thread's last row: the causal
// triangle); last S += k^T v.  Shared memory: 2 x 64 (Dk+1) + 64 x 33 +
// 64 x 65 + Dk x 33 floats (65 KB at Dk = 64, 106 KB at 128), any G.
// Rows at or past N are read as zeros and not written, so any N >= 1
// works.  Simple first: scalar FMA from shared memory, no tensor cores,
// no asynchronous copies.
#include "flow_chunk_common.cuh"

namespace {

using namespace flow_chunk;

constexpr int kSlice = 32;  // value columns per block

template <int DK>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * kTile * (DK + 1) + kTile * (kSlice + 1) + kTile * (kTile + 1) +
                          DK * (kSlice + 1));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flow_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int grp, int n) {
  constexpr int LK = DK + 1, LS = kSlice + 1, LP = kTile + 1;
  using P = Own<kTile, kTile>;   // the score panel
  using O = Own<kTile, kSlice>;  // the output tile
  using S = Own<DK, kSlice>;     // the carried state
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LK;
  float* v_s = k_s + kTile * LK;
  float* p_s = v_s + kTile * LS;
  float* s_s = p_s + kTile * LP;

  const size_t bh = blockIdx.x;
  const int e0 = blockIdx.y * kSlice;
  const int tid = threadIdx.x;
  const int px = tid % P::TX, py = tid / P::TX;
  const int ox = tid % O::TX, oy = tid / O::TX;
  const int sx = tid % S::TX, sy = tid / S::TX;
  const float* kb = k + bh * n * DK;
  const float* vb = v + bh * n * DV;

  for (int i = tid; i < DK * LS; i += kThreads) s_s[i] = 0.f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    load_tile<DK>(k_s, kb, DK, 0, t0, n);
    load_tile<kSlice>(v_s, vb, DV, e0, t0, n);
    for (int g = 0; g < grp; ++g) {
      const size_t row = bh * grp + g;
      load_tile<DK>(q_s, q + row * n * DK, DK, 0, t0, n);
      __syncthreads();
      {  // P = tril(q k^T)
        float acc[P::RM][4] = {};
        mm<P::RM, 4, false, true>(acc, q_s, LK, k_s, LK, py * P::RM, px, P::TX, 0, DK);
        store_tril<P::RM>(p_s, acc, py * P::RM, px, P::TX);
      }
      __syncthreads();
      {  // out = P v + q S over the thread's rows and slice columns
        const int m0 = oy * O::RM;
        float acc[O::RM][4] = {};
        mm<O::RM, 4, false, false>(acc, p_s, LP, v_s, LS, m0, ox, O::TX, 0, m0 + O::RM);
        mm<O::RM, 4, false, false>(acc, q_s, LK, s_s, LS, m0, ox, O::TX, 0, DK);
        store_rows<O::RM>(out + row * n * DV, DV, e0, t0, n, acc, m0, ox, O::TX);
      }
      __syncthreads();
    }
    {  // S += k^T v, each thread on its own entries
      float acc[S::RM][4] = {};
      mm<S::RM, 4, true, false>(acc, k_s, LK, v_s, LS, sy * S::RM, sx, S::TX, 0, kTile);
#pragma unroll
      for (int r = 0; r < S::RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s_s[(sy * S::RM + r) * LS + sx + c * S::TX] += acc[r][c];
    }
    __syncthreads();
  }
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int grp, int n,
                   cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem_bytes<DK>();
  auto kern = flow_chunk_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(bh, DV / kSlice), kThreads, bytes, stream>>>((const float*)q, (const float*)k,
                                                          (const float*)v, (float*)out, grp, n);
  return cudaGetLastError();
}

}  // namespace

// q (BH, G, N, Dk), k (BH, N, Dk), v (BH, N, Dv) and out (BH, G, N, Dv),
// fp32, contiguous and 16-byte aligned; Dk and Dv in {32, 64, 128};
// G, N >= 1.  One launch on `stream`.  Returns a cudaError_t.
extern "C" int flow_chunk_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                              int grp, int n, int dk, int dv, void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_CHUNK_DV(DK)                                                    \
  if (dv == 32) return (int)launch<DK, 32>(q, k, v, out, bh, grp, n, st);   \
  if (dv == 64) return (int)launch<DK, 64>(q, k, v, out, bh, grp, n, st);   \
  if (dv == 128) return (int)launch<DK, 128>(q, k, v, out, bh, grp, n, st);
  if (dk == 32) { FLOW_CHUNK_DV(32) }
  if (dk == 64) { FLOW_CHUNK_DV(64) }
  if (dk == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
