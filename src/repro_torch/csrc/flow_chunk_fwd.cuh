// flow_chunk_fwd.cuh — the chunked causal dot (K5a) for Hopper (sm_90a):
// its kernels and their launch, instantiated by flow_chunk.cu (Dk and Dv
// in {32, 64, 128}) and flow_chunk_wide.cu (the wide pairs), two libraries
// that nvcc builds at once.
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
// launches (the pattern of flow_fused.cu and ssd_chunk.cu; the state and
// pass bodies are shared with K5b in flow_chunk_common.cuh):
//   chunk_fwd_state: per (row, chunk c < nc - 1) the chunk state
//     H_c = k_c^T v_c (Dk x Dv) into the workspace (the last chunk's state
//     is never read), its positions copied in four cp.async groups and
//     summed as each lands;
//   chunk_fwd_pass: per row, in chunk order and in place, slot c becomes
//     H_0 + ... + H_c = S_{c+1}, one thread per float4 of a state with
//     eight slots' loads in flight;
//   chunk_fwd_out: per (row, chunk), for each group, out = q_c S_c (none
//     at c = 0) + tril(q_c k_c^T) v_c over the block's output columns; the
//     panel is formed only in its tiles that reach the causal triangle, and
//     stays in registers; q_c with k_c, S_c and v_c are three cp.async
//     groups, each product starting as its operands land.
// Chunks of C = 64 positions, 32 at Dk or Dv >= 128 (shared memory).  Blocks
// of 128 threads (4 warps), each warp owning 16-row blocks of its output.
// The products run on the tensor cores in 3xTF32 (mma.sync m16n8k8: each
// operand split into a tf32 head and an fp32 rest, three products summed in
// fp32).  The tensor cores drop the rest's low bits and do not round to
// nearest as they accumulate, so the error is several times that of the
// same sums in fp32 FMA, but within the causal dot's unchanged fp32
// tolerance, which one plain TF32 product fails (PERF.md).  A first
// version with fp32 FMA on the CUDA cores (8 x 4 outputs a thread from
// XOR-swizzled tiles) ran at a third of the card's fp32 rate.  72 KB of
// shared memory a block at Dk = Dv = 64, three blocks an SM.
//
// The wide pairs (Dk, Dv) = (192, 128), (128, 192), (192, 192) and
// (256, 256) tile the output columns across blocks: grid y is a 64-column
// tile (col_tile), so chunk_fwd_state accumulates a Dk x 64 slice of H_c
// (at most 128 accumulators a thread, as at (128, 128)), and chunk_fwd_out
// holds q_c and k_c whole but only S_c[:, tile] and v_c[:, tile], forming
// the causal panel q_c k_c^T again for each tile.  Shared memory a block
// (and blocks an SM by it): chunk_fwd_out 112,128 B at Dk = 192 (two),
// 78,336 B at (128, 192) (two), 145,920 B at (256, 256) (one); the state
// kernel 33,792 B at Dk = 192, 25,600 B at 128, 41,984 B at 256.
//
// Every sum runs in a fixed order and nothing uses atomics, so two calls
// are bitwise equal.  Rows at or past N are staged as zeros and never
// written, so any N >= 1 works.
#pragma once

#include "flow_chunk_common.cuh"

namespace {

using namespace flow_chunk;

// --- chunk_fwd_state: H_c = k_c^T v_c (chunk_state) for c < nc - 1 ---------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
chunk_fwd_state(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ states, int rows, int n) {
  constexpr int C = chunk_of<DK, DV>(), TN = col_tile<DK, DV>();
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, ci = rc.y, nst = (n + C - 1) / C - 1, col0 = blockIdx.y * TN;
  const size_t p0 = (size_t)row * n + (size_t)ci * C;  // a full chunk: ci < nc - 1
  chunk_state<DK, DV, TN>(k + p0 * DK, v + p0 * DV + col0, 0, 0, 1, C,
                          states + ((size_t)row * nst + ci) * DK * DV + col0);
}

// --- chunk_fwd_pass: slot c <- slot 0 + ... + slot c (chunk_pass) ----------------

__global__ void __launch_bounds__(256)
chunk_fwd_pass(float* __restrict__ states, int rows, int nst, int q4) {
  chunk_pass<false>(states, rows, nst, q4);
}

// --- chunk_fwd_out -------------------------------------------------------------

template <int DK, int DV>
struct OutTiles {
  static constexpr int C = chunk_of<DK, DV>();
  static constexpr int TN = col_tile<DK, DV>();   // the block's output columns
  static constexpr int LQ = DK + 8, LV = TN + 4;  // strides: q_c and k_c; S_c and v_c
  static constexpr int RBS = C / 16;              // 16-row blocks
  static constexpr int NCG = kWarps / RBS;        // warps sharing a row block
  static constexpr int NT = TN / 8 / NCG;         // a warp's 8-column output tiles
  static constexpr int FLOATS = 2 * C * LQ + C * LV + DK * LV;
  static_assert(RBS * NCG == kWarps && NT * NCG * 8 == TN, "warp layout");
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 3)
chunk_fwd_out(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ states,
              float* __restrict__ out, int rows, int grp, int n) {
  using OT = OutTiles<DK, DV>;
  constexpr int C = OT::C, TN = OT::TN, LQ = OT::LQ, LV = OT::LV, NT = OT::NT;
  extern __shared__ float smem[];
  float* Q = smem;            // C x DK: q_c of one group
  float* K = Q + C * LQ;      // C x DK
  float* V = K + C * LQ;      // C x TN: v_c[:, tile]
  float* S = V + C * LV;      // DK x TN: S_c[:, tile]
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, ci = rc.y, c0 = ci * C, col0 = blockIdx.y * TN;
  const int valid = min(C, n - c0), nst = (n + C - 1) / C - 1;
  const size_t p0 = (size_t)row * n + c0;
  // three copy groups: q_c and k_c (the panel), S_c (q_c S_c), v_c
  issue_rows<DK, LQ>(Q, q + ((size_t)row * grp * n + c0) * DK, 0, C, valid);
  issue_rows<DK, LQ>(K, k + p0 * DK, 0, C, valid);
  cp_async_commit();
  if (ci > 0)
    issue_rows<TN, LV, kThreads, DV>(S, states + ((size_t)row * nst + ci - 1) * DK * DV + col0, 0,
                                     DK, DK);
  cp_async_commit();
  issue_rows<TN, LV, kThreads, DV>(V, v + p0 * DV + col0, 0, C, valid);
  cp_async_commit();
  // warp w: the 16-row block w % (C / 16), the (w / (C / 16))-th share of
  // the tile's columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int rb = warp % OT::RBS, r0 = 16 * rb, n0 = (warp / OT::RBS) * NT * 8;
  const int npt = 2 * (rb + 1);  // the panel's live 8-column tiles: columns < 16 (rb + 1)
  for (int gi = 0; gi < grp; ++gi) {
    const size_t rg = (size_t)row * grp + gi;
    if (gi > 0) {  // the next group's q_c; k_c, S_c and v_c stay
      issue_rows<DK, LQ>(Q, q + (rg * n + c0) * DK, 0, C, valid);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<2>();
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
      cp_async_wait<1>();
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
      cp_async_wait<0>();
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
    float* orow = out + (rg * n + c0) * DV + col0;
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
  constexpr int C = chunk_of<DK, DV>(), TILES = DV / col_tile<DK, DV>();
  const int nc = (n + C - 1) / C, nst = nc - 1;
  cudaError_t err;
  if (nst > 0) {
    constexpr int fs = StateTiles<DK, DV, col_tile<DK, DV>()>::FLOATS;
    if ((err = allow_smem(chunk_fwd_state<DK, DV>, fs)) != cudaSuccess) return err;
    chunk_fwd_state<DK, DV><<<dim3(bh * nst, TILES), kThreads, fs * sizeof(float), st>>>(
        k, v, work, bh, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int q4 = DK * DV / 4;
    const long long threads = (long long)bh * q4;
    chunk_fwd_pass<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(work, bh, nst, q4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  constexpr int fo = OutTiles<DK, DV>::FLOATS;
  if ((err = allow_smem(chunk_fwd_out<DK, DV>, fo)) != cudaSuccess) return err;
  chunk_fwd_out<DK, DV><<<dim3(bh * nc, TILES), kThreads, fo * sizeof(float), st>>>(
      q, k, v, work, out, bh, grp, n);
  return cudaGetLastError();
}

}  // namespace
