// flow_nc_fused.cu — the whole non-causal Flow-Attention pair (K6) for
// Hopper (sm_90a).
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
// What bounds it on the H100: the arithmetic.  Phases C and D are each a
// (D x M) by (M x Dv) or (NQ x D) by (D x Dv) product, 2*D*Dv operations
// per row, done here in fp32 FMA on the CUDA cores (67 TFLOP/s) for parity
// with the plain version; q, k and v are read once each per phase that
// needs them (q in A, B, D; k in A, B, C; v in C), which at the LRA shape
// moves less than the products take.
//
// Design: the TPU ran the four phases as one sequential grid axis with the
// sums in VMEM scratch.  A GPU grid has no ordered axis and each phase needs
// the previous phase's totals over all rows, so here one block of 256
// threads owns one (batch * kv head) and loops over the phases, keeping the
// four D-vectors, z and kv (D x Dv fp32, 16 KB at 64 x 64) in shared memory.
// Phases A and B stream rows with 16-byte loads and reduce row dot products
// with shuffles; C and D stage 64-row tiles in shared memory and multiply
// them with kv (flow_nc_common.cuh).  One block per (batch * kv head): 128
// blocks at the LRA shape (32 x 4 heads) on 132 SMs, one wave; splitting a
// head over blocks would need a grid-wide barrier between the phases.
#include "flow_nc_common.cuh"

namespace {

using namespace flow_nc;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)D * D          // kv
         + 2 * (size_t)kTile * D  // phi(k) and v * e tiles; phi(q) tile; reductions
         + 4 * (size_t)D          // k, q, ko, qi sums
         + kTile                  // per-row scale of the output
         + 64;                    // per-row-group z partials (RP <= 64)
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flow_nc_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int nq, int m,
                     float eps, int use_comp) {
  using L = Layout<T, D>;
  constexpr int VEC = L::VEC;
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);
  float* pk_s = kv_s + D * D;
  float* ve_s = pk_s + kTile * D;
  float* ksum_s = ve_s + kTile * D;
  float* qsum_s = ksum_s + D;
  float* kosum_s = qsum_s + D;
  float* qisum_s = kosum_s + D;
  float* rs_s = qisum_s + D;
  float* zred_s = rs_s + kTile;
  float* red_s = pk_s;  // RP x D column partials, between the tile phases

  const size_t bh = blockIdx.x;
  const T* qb = q + bh * nq * D;
  const T* kb = k + bh * m * D;
  const T* vb = v + bh * m * D;
  const int tid = threadIdx.x;
  const int cg = tid % L::LG, rg = tid / L::LG, col0 = cg * VEC;
  const int tx = tid % L::TX, ty = tid / L::TX;

  // ---- phase A: plain sums ----------------------------------------------
  {
    float ks[VEC] = {}, qs[VEC] = {};
#pragma unroll 4
    for (int r = rg; r < m; r += L::RP) {
      float x[VEC];
      load16(kb + (size_t)r * D + col0, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ks[i] += sigmoid(x[i]);
    }
#pragma unroll 4
    for (int r = rg; r < nq; r += L::RP) {
      float x[VEC];
      load16(qb + (size_t)r * D + col0, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) qs[i] += sigmoid(x[i]);
    }
    reduce_cols<T, D>(ks, red_s, ksum_s);
    reduce_cols<T, D>(qs, red_s, qsum_s);
  }

  // ---- phase B: conservation sums (need the phase-A totals) -------------
  {
    float kos[VEC] = {}, qis[VEC] = {};
    for (int r0 = 0; r0 < m; r0 += L::RP) {
      const int r = r0 + rg;
      float x[VEC] = {};
      if (r < m) load16(kb + (size_t)r * D + col0, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = sigmoid(x[i]);
        dot = fmaf(x[i] + eps, qsum_s[col0 + i] + eps, dot);
      }
      dot = group_sum<L::LG>(dot);
      if (r < m) {
        const float src_out = 1.f / dot;
#pragma unroll
        for (int i = 0; i < VEC; ++i) kos[i] = fmaf(x[i], src_out, kos[i]);
      }
    }
    for (int r0 = 0; r0 < nq; r0 += L::RP) {
      const int r = r0 + rg;
      float x[VEC] = {};
      if (r < nq) load16(qb + (size_t)r * D + col0, x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = sigmoid(x[i]);
        dot = fmaf(x[i] + eps, ksum_s[col0 + i] + eps, dot);
      }
      dot = group_sum<L::LG>(dot);
      if (r < nq) {
        const float sink_in = 1.f / dot;
#pragma unroll
        for (int i = 0; i < VEC; ++i) qis[i] = fmaf(x[i], sink_in, qis[i]);
      }
    }
    reduce_cols<T, D>(kos, red_s, kosum_s);
    reduce_cols<T, D>(qis, red_s, qisum_s);
  }

  // ---- phase C: competition-weighted kv and the deferred normalizer -----
  float acc[L::RA][4] = {};
  float zp = 0.f;  // this row group's share of z, in row order
  for (int t0 = 0; t0 < m; t0 += kTile) {
    for (int p = 0; p < kTile; p += L::RP) {
      const int tr = p + rg, r = t0 + tr;
      float x[VEC] = {}, y[VEC] = {};
      if (r < m) {
        load16(kb + (size_t)r * D + col0, x);
        load16(vb + (size_t)r * D + col0, y);
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = sigmoid(x[i]);
        dot = fmaf(x[i] + eps, qisum_s[col0 + i] + eps, dot);
      }
      dot = group_sum<L::LG>(dot);
      float e = use_comp ? expf(fminf(fmaxf(dot, -1.f), 1.f)) : 1.f;
      if (r >= m) {
        e = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] *= e;
      store_smem<VEC>(pk_s + tr * D + col0, x);
      store_smem<VEC>(ve_s + tr * D + col0, y);
      if (cg == 0) zp += e;
    }
    __syncthreads();
    tile_t_times_tile<D, L::RA>(pk_s, ve_s, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < L::RA; ++i) store_smem<4>(kv_s + (ty * L::RA + i) * D + tx * 4, acc[i]);
  if (cg == 0) zred_s[rg] = zp;
  __syncthreads();
  float z = 0.f;
  for (int j = 0; j < L::RP; ++j) z += zred_s[j];

  // ---- phase D: sink side over the finished kv --------------------------
  sink_rows<T, D>(qb, out + bh * nq * D, 0, nq, kv_s, ksum_s, kosum_s, pk_s, rs_s, eps,
                  (float)((double)nq / (double)m), (float)m / z);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int nq,
                   int m, int use_comp, float eps, cudaStream_t stream) {
  auto kern = flow_nc_fused_kernel<T, D>;
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, nq, m,
                                        eps, use_comp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* out, int bh,
                     int nq, int m, int use_comp, float eps, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, bh, nq, m, use_comp, eps, stream);
    case 64: return launch<T, 64>(q, k, v, out, bh, nq, m, use_comp, eps, stream);
    case 128: return launch<T, 128>(q, k, v, out, bh, nq, m, use_comp, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, NQ, D), k (BH, M, D), v (BH, M, Dv) in `dtype` (0 fp32, 1 bf16),
// contiguous and 16-byte aligned; out (BH, NQ, Dv) in `dtype`.  D == Dv in
// {32, 64, 128}; NQ, M >= 1.  Returns a cudaError_t.
extern "C" int flow_nc_fused_fwd(const void* q, const void* k, const void* v, void* out, int bh,
                                 int nq, int m, int d, int dv, int dtype, int use_comp,
                                 float eps, void* stream) {
  if (d != dv || nq < 1 || m < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(d, q, k, v, out, bh, nq, m, use_comp, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, out, bh, nq, m, use_comp, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_nc_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
