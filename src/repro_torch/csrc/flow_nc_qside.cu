// flow_nc_qside.cu — the non-causal sink side (K7a) and its backward (K7b)
// for Hopper (sm_90a).
//
// K7a replaces repro/kernels/flow_nc/flow_nc.py::flow_nc_qside_call (the
// pl.pallas_call at :64, body _kernel :35-49): from the key-side reductions
// k_sum, ko_sum (D,) and kv (D x Dv), per sink row i
//
//   phi = sigmoid(q_i);  I = (phi+eps).(k_sum+eps);  I_hat = (phi+eps).(ko_sum+eps)
//   out_i = sigmoid(I_hat * n/m) * ((phi / I) @ kv)
//
// K7b replaces repro/kernels/flow_nc/bwd.py::flow_nc_qside_bwd_call (the
// pl.pallas_call at :107, body _bwd_kernel :36-85): it recomputes that chain
// from the same inputs and pulls the output cotangent g back,
//
//   u = g * alloc / I                          (the cotangent of agg, over I)
//   dalloc = g . agg;  w = u @ kv^T            (= dq_in / I)
//   dI = -(w . phi) / I;  dI_hat = dalloc * alloc (1 - alloc) * n/m
//   dq = (w + dI (k_sum+eps) + dI_hat (ko_sum+eps)) * phi (1 - phi)
//   dk_sum = sum_i dI phi_eps;  dko_sum = sum_i dI_hat phi_eps;  dkv = sum_i phi^T u
//
// with phi_eps = phi + eps.  The three reductions run over all N rows.  The
// TPU accumulated them in revisited output blocks along its sequential grid
// axis; a GPU grid has no ordered axis, and float atomics would sum in a
// different order on every run.  So K7b splits the rows of each (batch *
// head) into `splits` contiguous chunks, one block each, writes each
// block's partial sums to a scratch (BH, splits, 2 D + D Dv) the wrapper
// allocates, and a second launch adds the partials in split order: a fixed
// order of summation, so the result is the same on every run.
//
// What bounds them on the H100: K7a does 2 D Dv operations per row against
// 2 (D + Dv) bytes (bf16), K7b 6 D Dv against 2 (2 D + Dv): both above the
// fp32 FMA rate's balance point with the card's memory (about 20
// operations per byte), so the products bound them, done in fp32 FMA on the
// CUDA cores for parity with the plain versions.
//
// Design: rows are independent, so both kernels stream 64-row tiles of q
// (and g) through shared memory with kv (and, for K7b, its transpose, so
// that u @ kv^T reads rows too) resident beside them; K7a spreads each head
// over blocks of 256 rows.
#include "flow_nc_common.cuh"

namespace {

using namespace flow_nc;

constexpr int kRowsPerBlock = 256;  // K7a rows per block

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flow_nc_qside_kernel(const T* __restrict__ q, const float* __restrict__ k_sum,
                     const float* __restrict__ ko_sum, const float* __restrict__ kv,
                     T* __restrict__ out, int n, float eps, float sink_scale) {
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);
  float* tile_s = kv_s + D * D;
  float* ksum_s = tile_s + kTile * D;
  float* kosum_s = ksum_s + D;
  float* rs_s = kosum_s + D;

  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid * 4; i < D * D; i += kThreads * 4)
    *reinterpret_cast<float4*>(kv_s + i) = __ldg(reinterpret_cast<const float4*>(kv + bh * D * D + i));
  if (tid < D) {
    ksum_s[tid] = k_sum[bh * D + tid];
    kosum_s[tid] = ko_sum[bh * D + tid];
  }
  __syncthreads();
  const int r_begin = blockIdx.x * kRowsPerBlock;
  sink_rows<T, D>(q + bh * n * D, out + bh * n * D, r_begin, min(n, r_begin + kRowsPerBlock),
                  kv_s, ksum_s, kosum_s, tile_s, rs_s, eps, sink_scale, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flow_nc_qside_bwd_kernel(const T* __restrict__ q, const float* __restrict__ k_sum,
                         const float* __restrict__ ko_sum, const float* __restrict__ kv,
                         const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ part,
                         int n, int rows_per_block, float eps, float sink_scale) {
  using L = Layout<T, D>;
  constexpr int VEC = L::VEC;
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);
  float* kvt_s = kv_s + D * D;      // kv transposed
  float* phi_s = kvt_s + D * D;     // phi(q) tile; then the reduction buffer
  float* u_s = phi_s + kTile * D;   // g tile, then u = g * alloc / I
  float* ksum_s = u_s + kTile * D;
  float* kosum_s = ksum_s + D;
  float* inc_s = kosum_s + D;       // I per tile row
  float* alloc_s = inc_s + kTile;   // alloc per tile row

  const size_t bh = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int cg = tid % L::LG, rg = tid / L::LG, col0 = cg * VEC;
  const int tx = tid % L::TX, ty = tid / L::TX;
  const T* qb = q + bh * n * D;
  const T* gb = g + bh * n * D;
  T* dqb = dq + bh * n * D;

  for (int i = tid; i < D * D; i += kThreads) {
    const float x = kv[bh * D * D + i];
    kv_s[i] = x;
    kvt_s[(i % D) * D + i / D] = x;
  }
  if (tid < D) {
    ksum_s[tid] = k_sum[bh * D + tid];
    kosum_s[tid] = ko_sum[bh * D + tid];
  }
  __syncthreads();

  float dkv[L::RA][4] = {};
  float dks[4] = {}, dkos[4] = {};  // columns tx*4.. over this thread's rows
  const int r_begin = split * rows_per_block;
  const int r_end = min(n, r_begin + rows_per_block);
  for (int t0 = r_begin; t0 < r_end; t0 += kTile) {
    // stage phi(q) and g; the row flows I and alloc
    for (int p = 0; p < kTile; p += L::RP) {
      const int tr = p + rg, r = t0 + tr;
      const bool valid = r < r_end;
      float x[VEC] = {}, y[VEC] = {};
      if (valid) {
        load16(qb + (size_t)r * D + col0, x);
        load16(gb + (size_t)r * D + col0, y);
      }
      float inc = 0.f, con = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[i] = sigmoid(x[i]);
        inc = fmaf(x[i] + eps, ksum_s[col0 + i] + eps, inc);
        con = fmaf(x[i] + eps, kosum_s[col0 + i] + eps, con);
      }
      inc = group_sum<L::LG>(inc);
      con = group_sum<L::LG>(con);
      if (!valid) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[i] = 0.f;
      }
      store_smem<VEC>(phi_s + tr * D + col0, x);
      store_smem<VEC>(u_s + tr * D + col0, y);
      if (cg == 0) {
        inc_s[tr] = valid ? inc : 1.f;
        alloc_s[tr] = valid ? sigmoid(con * sink_scale) : 0.f;
      }
    }
    __syncthreads();

    // agg * I = phi @ kv; dalloc = g . agg; then u = g * alloc / I in place
    float acc[L::RT][4] = {};
    rows_times_mat<D, L::RT>(phi_s, kv_s, ty, tx, acc);
    float dalloc[L::RT];
#pragma unroll
    for (int i = 0; i < L::RT; ++i) {
      const int t = ty * L::RT + i;
      float* up = u_s + t * D + tx * 4;
      const float4 gv = ld4(up);
      float s = gv.x * acc[i][0];
      s = fmaf(gv.y, acc[i][1], s);
      s = fmaf(gv.z, acc[i][2], s);
      s = fmaf(gv.w, acc[i][3], s);
      const float inc = inc_s[t];
      dalloc[i] = group_sum<L::TX>(s) / inc;
      const float c = alloc_s[t] / inc;
      const float u[4] = {gv.x * c, gv.y * c, gv.z * c, gv.w * c};
      store_smem<4>(up, u);
    }
    __syncthreads();

    // w = u @ kv^T; dI, dI_hat; dq; the dk_sum / dko_sum partials
    float w[L::RT][4] = {};
    rows_times_mat<D, L::RT>(u_s, kvt_s, ty, tx, w);
#pragma unroll
    for (int i = 0; i < L::RT; ++i) {
      const int t = ty * L::RT + i, r = t0 + t;
      const float4 ph = ld4(phi_s + t * D + tx * 4);
      const float phv[4] = {ph.x, ph.y, ph.z, ph.w};
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s = fmaf(w[i][j], phv[j], s);
      const float d_inc = -group_sum<L::TX>(s) / inc_s[t];
      const float al = alloc_s[t];
      const float d_con = dalloc[i] * al * (1.f - al) * sink_scale;
      if (r < r_end) {
        float dqv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = tx * 4 + j;
          const float dphi = w[i][j] + d_inc * (ksum_s[a] + eps) + d_con * (kosum_s[a] + eps);
          dqv[j] = dphi * phv[j] * (1.f - phv[j]);
          dks[j] = fmaf(d_inc, phv[j] + eps, dks[j]);
          dkos[j] = fmaf(d_con, phv[j] + eps, dkos[j]);
        }
        store4(dqb + (size_t)r * D + tx * 4, dqv);
      }
    }

    // dkv += phi^T u
    tile_t_times_tile<D, L::RA>(phi_s, u_s, ty, tx, dkv);
    __syncthreads();
  }

  // this block's partial sums: dk_sum and dko_sum over the row owners (ty),
  // then dkv, into part[bh][split]
  float* red_s = phi_s;  // 2 x TY x D
  store_smem<4>(red_s + ty * D + tx * 4, dks);
  store_smem<4>(red_s + (L::TY + ty) * D + tx * 4, dkos);
  __syncthreads();
  float* pb = part + (bh * gridDim.x + split) * (size_t)(2 * D + D * D);
  if (tid < D) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < L::TY; ++j) {
      a += red_s[j * D + tid];
      b += red_s[(L::TY + j) * D + tid];
    }
    pb[tid] = a;
    pb[D + tid] = b;
  }
#pragma unroll
  for (int i = 0; i < L::RA; ++i) store_smem<4>(pb + 2 * D + (ty * L::RA + i) * D + tx * 4, dkv[i]);
}

// dk_sum, dko_sum, dkv of each (batch * head): its `splits` partials added
// in split order
__global__ void __launch_bounds__(kThreads)
flow_nc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk_sum,
                      float* __restrict__ dko_sum, float* __restrict__ dkv, int splits, int d) {
  const size_t bh = blockIdx.x;
  const int width = 2 * d + d * d;
  const float* pb = part + bh * splits * (size_t)width;
  for (int e = threadIdx.x; e < width; e += kThreads) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += pb[(size_t)j * width + e];
    if (e < d) dk_sum[bh * d + e] = s;
    else if (e < 2 * d) dko_sum[bh * d + e - d] = s;
    else dkv[bh * d * d + e - 2 * d] = s;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k_sum, const void* ko_sum, const void* kv,
                       void* out, int bh, int n, float sink_scale, float eps,
                       cudaStream_t stream) {
  auto kern = flow_nc_qside_kernel<T, D>;
  const size_t bytes = ((size_t)D * D + (size_t)kTile * D + 2 * D + kTile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  kern<<<grid, kThreads, bytes, stream>>>((const T*)q, (const float*)k_sum,
                                          (const float*)ko_sum, (const float*)kv, (T*)out, n,
                                          eps, sink_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k_sum, const void* ko_sum, const void* kv,
                       const void* g, void* dq, void* part, void* dk_sum, void* dko_sum,
                       void* dkv, int bh, int n, int splits, float sink_scale, float eps,
                       cudaStream_t stream) {
  auto kern = flow_nc_qside_bwd_kernel<T, D>;
  const size_t bytes =
      (2 * (size_t)D * D + 2 * (size_t)kTile * D + 2 * D + 2 * kTile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int rows = (n + splits - 1) / splits;
  const int rows_per_block = (rows + kTile - 1) / kTile * kTile;
  const dim3 grid(splits, bh);
  kern<<<grid, kThreads, bytes, stream>>>((const T*)q, (const float*)k_sum,
                                          (const float*)ko_sum, (const float*)kv, (const T*)g,
                                          (T*)dq, (float*)part, n, rows_per_block, eps,
                                          sink_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flow_nc_reduce_kernel<<<bh, kThreads, 0, stream>>>((const float*)part, (float*)dk_sum,
                                                     (float*)dko_sum, (float*)dkv, splits, D);
  return cudaGetLastError();
}

}  // namespace

// q (BH, N, D) in `dtype` (0 fp32, 1 bf16); k_sum, ko_sum (BH, D) and kv
// (BH, D, Dv) fp32; out (BH, N, Dv) in `dtype`.  All contiguous and 16-byte
// aligned; D == Dv in {32, 64, 128}; N >= 1.  sink_scale = n_sinks /
// m_sources.  Returns a cudaError_t.
extern "C" int flow_nc_qside_fwd(const void* q, const void* k_sum, const void* ko_sum,
                                 const void* kv, void* out, int bh, int n, int d, int dv,
                                 int dtype, float sink_scale, float eps, void* stream) {
  if (d != dv || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_NC_FWD(T, D) launch_fwd<T, D>(q, k_sum, ko_sum, kv, out, bh, n, sink_scale, eps, st)
  if (dtype == 0) {
    if (d == 32) return (int)FLOW_NC_FWD(float, 32);
    if (d == 64) return (int)FLOW_NC_FWD(float, 64);
    if (d == 128) return (int)FLOW_NC_FWD(float, 128);
  } else if (dtype == 1) {
    if (d == 32) return (int)FLOW_NC_FWD(__nv_bfloat16, 32);
    if (d == 64) return (int)FLOW_NC_FWD(__nv_bfloat16, 64);
    if (d == 128) return (int)FLOW_NC_FWD(__nv_bfloat16, 128);
  }
#undef FLOW_NC_FWD
  return (int)cudaErrorInvalidValue;
}

// The cotangents of flow_nc_qside_fwd for g (BH, N, Dv) in `dtype`: dq
// (BH, N, D) in `dtype`, dk_sum, dko_sum (BH, D) and dkv (BH, D, Dv) fp32;
// part is a fp32 scratch of BH * splits * (2 D + D Dv) floats, 1 <= splits
// <= N.  Two launches on `stream`.  Returns a cudaError_t.
extern "C" int flow_nc_qside_bwd(const void* q, const void* k_sum, const void* ko_sum,
                                 const void* kv, const void* g, void* dq, void* part,
                                 void* dk_sum, void* dko_sum, void* dkv, int bh, int n, int d,
                                 int dv, int splits, int dtype, float sink_scale, float eps,
                                 void* stream) {
  if (d != dv || n < 1 || splits < 1 || splits > n) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_NC_BWD(T, D)                                                                    \
  launch_bwd<T, D>(q, k_sum, ko_sum, kv, g, dq, part, dk_sum, dko_sum, dkv, bh, n, splits, \
                   sink_scale, eps, st)
  if (dtype == 0) {
    if (d == 32) return (int)FLOW_NC_BWD(float, 32);
    if (d == 64) return (int)FLOW_NC_BWD(float, 64);
    if (d == 128) return (int)FLOW_NC_BWD(float, 128);
  } else if (dtype == 1) {
    if (d == 32) return (int)FLOW_NC_BWD(__nv_bfloat16, 32);
    if (d == 64) return (int)FLOW_NC_BWD(__nv_bfloat16, 64);
    if (d == 128) return (int)FLOW_NC_BWD(__nv_bfloat16, 128);
  }
#undef FLOW_NC_BWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_nc_qside_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
