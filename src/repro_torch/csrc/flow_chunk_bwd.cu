// flow_chunk_bwd.cu — dk and dv of the chunked causal dot (K5b) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_call (the
// pl.pallas_call at :114, body _dkv_kernel :42-96).  For the forward
// out[g, i] = q[g, i] . sum_{j<=i} k_j^T v_j (flow_chunk.cu, K5a) and the
// cotangent g (BH, G, N, Dv):
//
//   dk[j] = sum_{g, i>=j} (g[g, i] . v_j) q[g, i] = intra + U v_j
//   dv[j] = sum_{g, i>=j} (q[g, i] . k_j) g[g, i] = intra + U^T k_j
//   U     = sum_{g, i in later tiles} q[g, i]^T g[g, i]      (D x Dv)
//
// What bounds it on the H100: 2 (G+2) D Dv operations per position (the
// recurrent form: U v_j, U^T k_j and U += q^T g) against 4 ((G+1) D +
// (G+1) Dv + D + Dv) bytes -- 16 operations per byte at G = 1, D = Dv =
// 64, under the card's fp32-rate-to-memory balance of ~20: the bytes bound
// it.  The tiled form below does about twice those operations at that
// shape (two 64 x 64 score panels per tile, computed whole).
//
// Design.  The TPU walked its sequential grid axis last-to-first through
// reversed index maps, with U in VMEM; a GPU grid has no ordered axis.  So
// one 256-thread block owns one (row, kv head) -- dk needs all of Dv and dv
// all of D, so the block is not split -- and loops over 64-position tiles
// from the last to the first with U in shared memory: no atomics, every
// sum in one fixed order.  Per tile it stages k and v and starts dk and
// dv (registers) from the inter-tile terms v U^T and k U; per query group
// it stages q and g, forms the masked panels P1 = tril(g v^T) and P2 =
// tril(q k^T), adds P1^T q to dk and P2^T g to dv (each sum starting at
// the thread's first row: the causal triangle), and folds q^T g into U,
// each thread into its own entries, after every thread has read U for the
// tile.  Shared memory: 2 x 64 (D+1) + 2 x 64 (Dv+1) + 2 x 64 x 65 +
// D (Dv+1) floats (114 KB at D = Dv = 64, 226 KB at 128), any G.  Rows at
// or past N are read as zeros and not written, so any N >= 1 works.
#include "flow_chunk_common.cuh"

namespace {

using namespace flow_chunk;

template <int D, int DV>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kTile * (D + 1) + 2 * kTile * (DV + 1) + 2 * kTile * (kTile + 1) +
                          D * (DV + 1));
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flow_chunk_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ gr,
                      float* __restrict__ dk, float* __restrict__ dv, int grp, int n) {
  constexpr int LK = D + 1, LV = DV + 1, LP = kTile + 1;
  using P = Own<kTile, kTile>;  // the score panels
  using K = Own<kTile, D>;      // the dk tile
  using V = Own<kTile, DV>;     // the dv tile
  using U = Own<D, DV>;         // the carried U
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LK;
  float* g_s = k_s + kTile * LK;
  float* v_s = g_s + kTile * LV;
  float* p1_s = v_s + kTile * LV;
  float* p2_s = p1_s + kTile * LP;
  float* u_s = p2_s + kTile * LP;

  const size_t bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = tid % P::TX, py = tid / P::TX;
  const int kx = tid % K::TX, km0 = (tid / K::TX) * K::RM;
  const int vx = tid % V::TX, vm0 = (tid / V::TX) * V::RM;
  const int ux = tid % U::TX, um0 = (tid / U::TX) * U::RM;
  const float* kb = k + bh * n * D;
  const float* vb = v + bh * n * DV;

  for (int i = tid; i < D * LV; i += kThreads) u_s[i] = 0.f;
  for (int t0 = (n - 1) / kTile * kTile; t0 >= 0; t0 -= kTile) {
    load_tile<D>(k_s, kb, D, 0, t0, n);
    load_tile<DV>(v_s, vb, DV, 0, t0, n);
    __syncthreads();
    // inter-tile terms from the later tiles' U: dk[j] = U v_j, dv[j] = U^T k_j
    float dk_acc[K::RM][4] = {}, dv_acc[V::RM][4] = {};
    mm<K::RM, 4, false, true>(dk_acc, v_s, LV, u_s, LV, km0, kx, K::TX, 0, DV);
    mm<V::RM, 4, false, false>(dv_acc, k_s, LK, u_s, LV, vm0, vx, V::TX, 0, D);
    for (int g = 0; g < grp; ++g) {
      const size_t row = bh * grp + g;
      load_tile<D>(q_s, q + row * n * D, D, 0, t0, n);
      load_tile<DV>(g_s, gr + row * n * DV, DV, 0, t0, n);
      __syncthreads();
      {  // P1 = tril(g v^T), P2 = tril(q k^T): rows i, columns j <= i
        float acc[P::RM][4] = {};
        mm<P::RM, 4, false, true>(acc, g_s, LV, v_s, LV, py * P::RM, px, P::TX, 0, DV);
        store_tril<P::RM>(p1_s, acc, py * P::RM, px, P::TX);
      }
      {
        float acc[P::RM][4] = {};
        mm<P::RM, 4, false, true>(acc, q_s, LK, k_s, LK, py * P::RM, px, P::TX, 0, D);
        store_tril<P::RM>(p2_s, acc, py * P::RM, px, P::TX);
      }
      __syncthreads();
      // intra-tile terms: dk[j] += sum_{i>=j} P1[i][j] q_i, dv[j] += sum_{i>=j} P2[i][j] g_i
      mm<K::RM, 4, true, false>(dk_acc, p1_s, LP, q_s, LK, km0, kx, K::TX, km0, kTile);
      mm<V::RM, 4, true, false>(dv_acc, p2_s, LP, g_s, LV, vm0, vx, V::TX, vm0, kTile);
      {  // U += q^T g: every thread read U for this tile before the last barrier
        float acc[U::RM][4] = {};
        mm<U::RM, 4, true, false>(acc, q_s, LK, g_s, LV, um0, ux, U::TX, 0, kTile);
#pragma unroll
        for (int r = 0; r < U::RM; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) u_s[(um0 + r) * LV + ux + c * U::TX] += acc[r][c];
      }
      __syncthreads();
    }
    store_rows<K::RM>(dk + bh * n * D, D, 0, t0, n, dk_acc, km0, kx, K::TX);
    store_rows<V::RM>(dv + bh * n * DV, DV, 0, t0, n, dv_acc, vm0, vx, V::TX);
  }
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dk, void* dv,
                   int bh, int grp, int n, cudaStream_t stream) {
  constexpr size_t bytes = bwd_smem_bytes<D, DV>();
  auto kern = flow_chunk_dkv_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                        (const float*)g, (float*)dk, (float*)dv, grp, n);
  return cudaGetLastError();
}

}  // namespace

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv), g (BH, G, N, Dv); dk
// (BH, N, D) and dv (BH, N, Dv) out.  fp32, contiguous and 16-byte aligned;
// D and Dv in {32, 64, 128}; G, N >= 1.  One launch on `stream`.  Returns a
// cudaError_t.
extern "C" int flow_chunk_dkv(const void* q, const void* k, const void* v, const void* g,
                              void* dk, void* dv, int bh, int grp, int n, int d, int dv_dim,
                              void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_CHUNK_DV(D)                                                               \
  if (dv_dim == 32) return (int)launch<D, 32>(q, k, v, g, dk, dv, bh, grp, n, st);    \
  if (dv_dim == 64) return (int)launch<D, 64>(q, k, v, g, dk, dv, bh, grp, n, st);    \
  if (dv_dim == 128) return (int)launch<D, 128>(q, k, v, g, dk, dv, bh, grp, n, st);
  if (d == 32) { FLOW_CHUNK_DV(32) }
  if (d == 64) { FLOW_CHUNK_DV(64) }
  if (d == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
