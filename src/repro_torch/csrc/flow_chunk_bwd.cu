// flow_chunk_bwd.cu — dk and dv of the chunked causal dot (K5b) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_call (the
// pl.pallas_call at :114, body _dkv_kernel :42-96).  For the forward
// out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j (flow_chunk.cu, K5a) and the
// cotangent g (BH, G, N, Dv), with the positions cut into chunks c of C:
//
//   dk_c = v_c U_{>c}^T + sum_g tril(g_{c,g} v_c^T)^T q_{c,g}
//   dv_c = k_c U_{>c}   + sum_g tril(q_{c,g} k_c^T)^T g_{c,g}
//   U_c  = sum_g q_{c,g}^T g_{c,g}  (D x Dv),  U_{>c} = U_{c+1} + ... + U_{nc-1}
//
// What bounds it on the H100: 2 (G+2) D Dv operations per position (the
// recurrent form: U v_j, U^T k_j and U += q^T g) against 4 ((G+1) D +
// (G+1) Dv + D + Dv) bytes -- 16 operations per byte at G = 1, D = Dv =
// 64, under the card's fp32-rate-to-memory balance of ~20: the bytes bound
// it.  The chunked form below does ~2.3 times those operations at that
// shape (the two causal panels and their products) and moves the chunk
// states through the workspace, for parallel work.  It takes ~0.124 ms
// there, 0.089 of it in chunk_bwd_out, whose copies and products overlap
// little at two blocks an SM (PERF.md).
//
// Design: the TPU walked its sequential grid axis last-to-first with U in
// VMEM; a GPU grid has no ordered axis, so K5a's three launches run with
// the chunk order reversed, on one workspace of states (the state and pass
// bodies are K5a's, flow_chunk_common.cuh):
//   chunk_bwd_state: per (row, chunk c >= 1) U_c into slot c - 1, summed
//     over the groups (chunk 0's state is never read);
//   chunk_bwd_pass: per row, from the last slot down and in place, slot c
//     becomes U_{c+1} + ... + U_{nc-1} = U_{>c}; the last chunk reads none;
//   chunk_bwd_out: per (row, chunk), 8 warps: warps 0-3 own 16-row blocks
//     of dk_c (key positions j), warps 4-7 of dv_c (at C = 32 two warps
//     share a row block, each half of the columns).  Per group a warp forms
//     its rows of the transposed panel (S1 = v_c g_c^T for dk, S2 = k_c
//     q_c^T for dv: rows j, columns i, kept where i >= j), only the tiles
//     that reach the causal triangle, in registers, and multiplies it by
//     q_c (g_c) straight from the accumulators; then it adds the chunk's
//     inter-chunk term v_c U^T (k_c U).  k, v, q and g land in one cp.async
//     group and U in a second, so the panels start before U has landed.
//     The tiles have a stride of W + 8 floats with columns swapped in 8s by
//     bit 2 of the row, so that reads along a row (q and g as panel
//     operands, U for dk) and down a column (q and g as product operands,
//     U for dv) are both free of bank conflicts.
// Chunks of C = 64 positions, 32 at D or Dv = 128 (shared memory: 92 KB a
// block at D = Dv = 64, two blocks an SM).  The products run on the tensor
// cores in 3xTF32 (tensor_core.cuh).  Every sum runs in a fixed order and
// nothing uses atomics, so two calls are bitwise equal.  Rows at or past N
// are staged as zeros and never written, so any N >= 1 works.
#include "flow_chunk_common.cuh"

namespace {

using namespace flow_chunk;

constexpr int kOutThreads = 256;

// --- chunk_bwd_state, chunk_bwd_pass ----------------------------------------------

// U_c = sum_g q_{c,g}^T g_{c,g} for chunk c = slot + 1 (chunk_state)
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
chunk_bwd_state(const float* __restrict__ q, const float* __restrict__ g,
                float* __restrict__ states, int rows, int grp, int n) {
  constexpr int C = chunk_of<DK, DV>();
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, slot = rc.y, nst = (n + C - 1) / C - 1, c0 = (slot + 1) * C;
  const size_t p0 = (size_t)row * grp * n + c0;
  chunk_state<DK, DV>(q + p0 * DK, g + p0 * DV, (size_t)n * DK, (size_t)n * DV, grp,
                      min(C, n - c0), states + ((size_t)row * nst + slot) * DK * DV);
}

// slot c <- slot c + ... + slot nst - 1 (chunk_pass)
__global__ void __launch_bounds__(256)
chunk_bwd_pass(float* __restrict__ states, int rows, int nst, int q4) {
  chunk_pass<true>(states, rows, nst, q4);
}

// --- chunk_bwd_out -------------------------------------------------------------

// Float offset of (row r, column c) in a tile of stride LD (LD = 8 mod 32):
// columns are swapped in 8s by bit 2 of the row.
template <int LD>
__device__ __forceinline__ int at(int r, int c) { return r * LD + (c ^ ((r & 4) << 1)); }

// The A fragment of k-step ks at rows r0.. of a swizzled row-major tile.
template <int LD>
__device__ __forceinline__ void a_frag_sw(const float* A, int r0, int ks, uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 x0 = *reinterpret_cast<const float2*>(A + at<LD>(r0 + g, 8 * ks + 2 * t));
  const float2 x1 = *reinterpret_cast<const float2*>(A + at<LD>(r0 + g + 8, 8 * ks + 2 * t));
  split_tf32(x0.x, ah[0], al[0]);  // (g, t): element 2t
  split_tf32(x1.x, ah[1], al[1]);  // (g + 8, t)
  split_tf32(x0.y, ah[2], al[2]);  // (g, t + 4): element 2t + 1
  split_tf32(x1.y, ah[3], al[3]);  // (g + 8, t + 4)
}

// B of k-step ks, columns n0.., from a swizzled k-major tile (rows k).
template <int LD>
__device__ __forceinline__ void b_frag_k_sw(const float* B, int ks, int n0, uint32_t (&bh)[2],
                                            uint32_t (&bl)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  split_tf32(B[at<LD>(8 * ks + 2 * t, n0 + g)], bh[0], bl[0]);
  split_tf32(B[at<LD>(8 * ks + 2 * t + 1, n0 + g)], bh[1], bl[1]);
}

// The same from a swizzled n-major tile (rows n, the reduction along a row).
template <int LD>
__device__ __forceinline__ void b_frag_n_sw(const float* B, int ks, int n0, uint32_t (&bh)[2],
                                            uint32_t (&bl)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(B + at<LD>(n0 + g, 8 * ks + 2 * t));
  split_tf32(x.x, bh[0], bl[0]);
  split_tf32(x.y, bh[1], bl[1]);
}

// Copy `rows` rows of a row-major (rows, W) matrix into a swizzled tile of
// stride LD; rows at or past `valid` become zeros.  No commit, no wait.
template <int W, int LD>
__device__ __forceinline__ void issue_sw(float* dst, const float* __restrict__ src, int rows,
                                         int valid) {
  constexpr int Q = W / 4;
  for (int i = threadIdx.x; i < rows * Q; i += kOutThreads) {
    const int t = i / Q, c = (i % Q) * 4;
    const bool ok = t < valid;
    cp_async16(dst + at<LD>(t, c), ok ? src + (size_t)t * W + c : src, ok);
  }
}

template <int DK, int DV>
struct BwdTiles {
  static constexpr int C = chunk_of<DK, DV>();
  static constexpr int LK = DK + 8, LV = DV + 8;  // strides: k_c, q_c; v_c, g_c and U
  static constexpr int RBS = C / 16;              // 16-row blocks of an output
  static constexpr int NCG = 4 / RBS;             // warps sharing a row block
  static constexpr int NTK = DK / 8 / NCG, NTV = DV / 8 / NCG;  // a warp's 8-column tiles
  static constexpr int NTM = NTK > NTV ? NTK : NTV;
  static constexpr int FLOATS = 2 * C * LK + 2 * C * LV + DK * LV;
  static_assert(RBS * NCG == 4 && NTK * NCG * 8 == DK && NTV * NCG * 8 == DV, "warp layout");
};

// acc[0..NT) (this warp's rows r0.. of dk_c or dv_c, 8-column tiles from
// n0) += S P: S the rows r0.. of A B^T (A, B: (C, RED) tiles), kept where
// column i >= row j, only its tiles that reach that triangle; P a (C, W)
// tile read k-major.  The panel's accumulators are the A fragments of S P.
template <int C, int RED, int LDA, int LDB, int LDP, int NT, int NTM>
__device__ __forceinline__ void add_intra(float (&acc)[NTM][4], const float* A, const float* B,
                                          const float* P, int r0, int n0) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int jt0 = r0 / 8;  // the first 8-column tile with a column i >= r0
  float s[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < RED / 8; ++ks) {
    uint32_t ah[4], al[4];
    a_frag_sw<LDA>(A, r0, ks, ah, al);
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      if (j >= jt0) {
        uint32_t bh[2], bl[2];
        b_frag_n_sw<LDB>(B, ks, 8 * j, bh, bl);
        mma_3xtf32(s[j], ah, al, bh, bl);
      }
  }
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
    if (j >= jt0) {
      const int ra = r0 + g8, cb = 8 * j + 2 * t4;  // rows ra, ra + 8; columns cb, cb + 1
      const float p[4] = {cb >= ra ? s[j][0] : 0.f, cb + 1 >= ra ? s[j][1] : 0.f,
                          cb >= ra + 8 ? s[j][2] : 0.f, cb + 1 >= ra + 8 ? s[j][3] : 0.f};
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);  // (g, t): column 2t
      split_tf32(p[2], ah[1], al[1]);  // (g + 8, t)
      split_tf32(p[1], ah[2], al[2]);  // (g, t + 4): column 2t + 1
      split_tf32(p[3], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        b_frag_k_sw<LDP>(P, j, n0 + 8 * nt, bh, bl);
        mma_3xtf32(acc[nt], ah, al, bh, bl);
      }
    }
}

// acc[0..NT) += rows r0.. of X Y: X a (C, RED) tile, Y = U (D x Dv, read
// k-major) or, with TRANS, U^T (U read n-major).
template <int RED, int LDX, int LDU, int NT, int NTM, bool TRANS>
__device__ __forceinline__ void add_inter(float (&acc)[NTM][4], const float* X, const float* U,
                                          int r0, int n0) {
#pragma unroll
  for (int ks = 0; ks < RED / 8; ++ks) {
    uint32_t ah[4], al[4];
    a_frag_sw<LDX>(X, r0, ks, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      if (TRANS) b_frag_n_sw<LDU>(U, ks, n0 + 8 * nt, bh, bl);
      else b_frag_k_sw<LDU>(U, ks, n0 + 8 * nt, bh, bl);
      mma_3xtf32(acc[nt], ah, al, bh, bl);
    }
  }
}

// rows r0.. (below `valid`) of acc[0..NT) into a row-major (C, W) chunk
template <int W, int NT, int NTM>
__device__ __forceinline__ void store_out(float* __restrict__ dst, const float (&acc)[NTM][4],
                                          int r0, int n0, int valid) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + 8 * nt + 2 * t4;
    if (r0 + g8 < valid)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g8) * W + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + g8 + 8 < valid)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g8 + 8) * W + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kOutThreads, 2)
chunk_bwd_out(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ states, float* __restrict__ dk,
              float* __restrict__ dv, int rows, int grp, int n) {
  using BT = BwdTiles<DK, DV>;
  constexpr int C = BT::C, LK = BT::LK, LV = BT::LV, NTK = BT::NTK, NTV = BT::NTV;
  extern __shared__ float smem[];
  float* K = smem;        // C x DK: k_c
  float* Q = K + C * LK;  // C x DK: q_c of one group
  float* V = Q + C * LK;  // C x DV: v_c
  float* G = V + C * LV;  // C x DV: g_c of one group
  float* U = G + C * LV;  // DK x DV: U_{>c}
  const int2 rc = row_chunk(blockIdx.x, rows);
  const int row = rc.x, ci = rc.y, c0 = ci * C;
  const int valid = min(C, n - c0), nst = (n + C - 1) / C - 1;
  const bool later = ci < nst;  // U_{>c} is non-zero
  const size_t p0 = (size_t)row * n + c0, pq = (size_t)row * grp * n + c0;
  // two copy groups: the panels' operands, then U_{>c}
  issue_sw<DK, LK>(K, k + p0 * DK, C, valid);
  issue_sw<DV, LV>(V, v + p0 * DV, C, valid);
  issue_sw<DK, LK>(Q, q + pq * DK, C, valid);
  issue_sw<DV, LV>(G, g + pq * DV, C, valid);
  cp_async_commit();
  if (later) issue_sw<DV, LV>(U, states + ((size_t)row * nst + ci) * DK * DV, DK, DK);
  cp_async_commit();
  // warps 0-3: dk_c, 4-7: dv_c; warp w & 3 owns the row block (w & 3) % RBS
  // and the ((w & 3) / RBS)-th share of the columns
  const int warp = threadIdx.x >> 5, w4 = warp & 3;
  const bool dk_side = warp < 4;
  const int r0 = 16 * (w4 % BT::RBS), share = w4 / BT::RBS;
  const int n0 = share * 8 * (dk_side ? NTK : NTV);
  float acc[BT::NTM][4];
#pragma unroll
  for (int j = 0; j < BT::NTM; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int gi = 0; gi < grp; ++gi) {
    if (gi > 0) {  // the next group's q_c and g_c; k_c, v_c and U stay
      __syncthreads();
      issue_sw<DK, LK>(Q, q + (pq + (size_t)gi * n) * DK, C, valid);
      issue_sw<DV, LV>(G, g + (pq + (size_t)gi * n) * DV, C, valid);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if (dk_side)  // sum_{i >= j} (g_i . v_j) q_i
      add_intra<C, DV, LV, LV, LK, NTK>(acc, V, G, Q, r0, n0);
    else  // sum_{i >= j} (q_i . k_j) g_i
      add_intra<C, DK, LK, LK, LV, NTV>(acc, K, Q, G, r0, n0);
  }
  if (later) {
    cp_async_wait<0>();
    __syncthreads();
    if (dk_side) add_inter<DV, LV, LV, NTK, BT::NTM, true>(acc, V, U, r0, n0);   // v_c U^T
    else add_inter<DK, LK, LV, NTV, BT::NTM, false>(acc, K, U, r0, n0);         // k_c U
  }
  if (dk_side) store_out<DK, NTK>(dk + p0 * DK, acc, r0, n0, valid);
  else store_out<DV, NTV>(dv + p0 * DV, acc, r0, n0, valid);
}

template <class K>
cudaError_t allow_smem(K kern, int floats) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int DK, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, const float* g, float* dk,
                   float* dv, float* work, int bh, int grp, int n, cudaStream_t st) {
  constexpr int C = chunk_of<DK, DV>();
  const int nc = (n + C - 1) / C, nst = nc - 1;
  cudaError_t err;
  if (nst > 0) {
    constexpr int fs = StateTiles<DK, DV>::FLOATS;
    if ((err = allow_smem(chunk_bwd_state<DK, DV>, fs)) != cudaSuccess) return err;
    chunk_bwd_state<DK, DV><<<bh * nst, kThreads, fs * sizeof(float), st>>>(q, g, work, bh, grp,
                                                                           n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int q4 = DK * DV / 4;
    const long long threads = (long long)bh * q4;
    chunk_bwd_pass<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(work, bh, nst, q4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  constexpr int fo = BwdTiles<DK, DV>::FLOATS;
  if ((err = allow_smem(chunk_bwd_out<DK, DV>, fo)) != cudaSuccess) return err;
  chunk_bwd_out<DK, DV><<<bh * nc, kOutThreads, fo * sizeof(float), st>>>(q, k, v, g, work, dk,
                                                                         dv, bh, grp, n);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch flow_chunk_dkv needs for these shapes: one D x Dv state
// per row and chunk but the first; -1 for shapes it refuses.
extern "C" long long flow_chunk_dkv_workspace(int bh, int grp, int n, int d, int dv) {
  return workspace_floats(bh, grp, n, d, dv);
}

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv), g (BH, G, N, Dv); dk
// (BH, N, D) and dv (BH, N, Dv) out.  fp32, contiguous and 16-byte aligned;
// work flow_chunk_dkv_workspace floats; D and Dv in {32, 64, 128}; G,
// N >= 1.  Three launches on `stream` (one where N fits one chunk).
// Returns a cudaError_t.
extern "C" int flow_chunk_dkv(const void* q, const void* k, const void* v, const void* g,
                              void* dk, void* dv, void* work, int bh, int grp, int n, int d,
                              int dv_dim, void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float* fg = (const float*)g;
  float *fdk = (float*)dk, *fdv = (float*)dv, *fw = (float*)work;
#define FLOW_CHUNK_DV(D)                                                                   \
  if (dv_dim == 32) return (int)launch<D, 32>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);   \
  if (dv_dim == 64) return (int)launch<D, 64>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);   \
  if (dv_dim == 128) return (int)launch<D, 128>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);
  if (d == 32) { FLOW_CHUNK_DV(32) }
  if (d == 64) { FLOW_CHUNK_DV(64) }
  if (d == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
