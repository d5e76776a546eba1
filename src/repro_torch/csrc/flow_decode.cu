// flow_decode.cu — one batched Flow-Attention decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_decode/flow_decode.py::
// flow_decode_call (the pl.pallas_call at :137, body _kernel :49-102).  It
// advances every (slot, kv head) of the serving pool by one token: phi of
// the token, flows normalized by the slot's count t, the four flow sums, z
// and the (D, Dv) state S updated IN PLACE (the TPU kernel aliased them with
// input_output_aliases), and the (G, Dv) output row.
//
// What bounds it on the H100: device-memory bytes.  Each (slot, head) reads
// and writes its D x Dv fp32 state once (16 KB each way at D = Dv = 64) and
// does about 2*D*Dv*(G+1) flops on it, far below the card's 295 flops/byte
// balance point.  At 16 slots x 8 heads one launch moves about 2.1 MB each
// way, about 1.3 us at 3.35 TB/s, so the launch itself, not the bytes,
// dominates one step; capturing the decode loop in a CUDA graph is later work.
//
// Design: one CTA of 256 threads per (slot, kv head).  The token's phi(q),
// phi(k), v and the small sums go through shared memory; the state panel S
// is streamed once, coalesced along Dv: each thread owns one Dv column and
// a slice of D rows, updates S in registers, writes it back in place, and
// accumulates its share of q_in @ S_new; the slices' partial outputs are
// summed through shared memory.  Nothing is allocated per token except the
// output, which the wrapper allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// phi kinds: 0 sigmoid, 1 elu + 1, 2 relu
__device__ __forceinline__ float phi_fn(float x, int kind) {
  if (kind == 0) return 1.f / (1.f + expf(-x));
  if (kind == 1) return x > 0.f ? x + 1.f : expm1f(x) + 1.f;
  return fmaxf(x, 0.f);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr size_t smem_floats(int g, int d, int dv) {
  return (size_t)g * d + d + dv      // phi(q) then q_in, phi(k), v then v * e
         + 4 * (size_t)d             // updated k/q/ko/qi sums
         + 2 * (size_t)g + 4         // sink_in, alloc, src_out / ratio
         + (size_t)(kThreads / dv) * g * dv;  // per-slice partial outputs
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flow_decode_kernel(const int* __restrict__ t, const T* __restrict__ q,
                   const T* __restrict__ k, const T* __restrict__ v,
                   float* __restrict__ k_sum, float* __restrict__ q_sum,
                   float* __restrict__ ko_sum, float* __restrict__ qi_sum,
                   float* __restrict__ z, float* __restrict__ s,
                   T* __restrict__ out, int hkv, int G, int phi, int use_alloc,
                   float eps) {
  static_assert(kThreads % DV == 0 && D % (kThreads / DV) == 0, "slice layout");
  static_assert(D <= kThreads, "one thread per feature");
  constexpr int NS = kThreads / DV;  // slices of D rows
  constexpr int RS = D / NS;         // rows per slice
  extern __shared__ float sm[];
  float* pq = sm;
  float* pk = pq + G * D;
  float* vv = pk + D;
  float* ks = vv + DV;
  float* qs = ks + D;
  float* kos = qs + D;
  float* qis = kos + D;
  float* sink = qis + D;
  float* alloc = sink + G;
  float* scal = alloc + G;  // [0] src_out, [1] e, [2] t / z
  float* part = scal + 4;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float tf = (float)t[row / hkv];  // count after this token
  const float fG = (float)G;

  for (int i = tid; i < G * D; i += kThreads)
    pq[i] = phi_fn(to_f32(q[(size_t)row * G * D + i]), phi);
  for (int i = tid; i < D; i += kThreads) pk[i] = phi_fn(to_f32(k[(size_t)row * D + i]), phi);
  for (int i = tid; i < DV; i += kThreads) vv[i] = to_f32(v[(size_t)row * DV + i]);
  __syncthreads();

  if (tid < D) {
    float x = 0.f;
    for (int g = 0; g < G; ++g) x += pq[g * D + tid];
    ks[tid] = k_sum[(size_t)row * D + tid] + pk[tid];
    qs[tid] = q_sum[(size_t)row * D + tid] + x;
  }
  __syncthreads();

  // incoming flow per sink, outgoing flow of the token
  for (int r = warp; r <= G; r += kWarps) {
    const float* a = r < G ? pq + r * D : pk;
    const float* c = r < G ? ks : qs;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (r < G) sink[r] = tf / acc;
      else scal[0] = tf * fG / acc;
    }
  }
  __syncthreads();

  if (tid < D) {
    float x = 0.f;
    for (int g = 0; g < G; ++g) x += pq[g * D + tid] * sink[g];
    kos[tid] = ko_sum[(size_t)row * D + tid] + pk[tid] * scal[0];
    qis[tid] = qi_sum[(size_t)row * D + tid] + x;
  }
  __syncthreads();

  // conserved flows: allocation per sink, competition weight of the token
  for (int r = warp; r <= G; r += kWarps) {
    const float* a = r < G ? pq + r * D : pk;
    const float* c = r < G ? kos : qis;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (r < G) {
        const float cons_sink = acc / (tf * fG);
        alloc[r] = use_alloc ? 1.f / (1.f + expf(-cons_sink)) : 1.f;
      } else {
        const float e = expf(fminf(fmaxf(acc / tf, -1.f), 1.f));
        const float zn = z[row] + e;
        z[row] = zn;
        scal[1] = e;
        scal[2] = tf / zn;
      }
    }
  }
  __syncthreads();

  // write the four sums back in place; q_in = phi(q) * sink_in; v * e
  if (tid < D) {
    k_sum[(size_t)row * D + tid] = ks[tid];
    q_sum[(size_t)row * D + tid] = qs[tid];
    ko_sum[(size_t)row * D + tid] = kos[tid];
    qi_sum[(size_t)row * D + tid] = qis[tid];
  }
  for (int i = tid; i < G * D; i += kThreads) pq[i] *= sink[i / D];
  for (int i = tid; i < DV; i += kThreads) vv[i] *= scal[1];
  __syncthreads();

  // S += phi(k) (v e)^T in place, and this slice's share of q_in @ S
  const int e = tid % DV, sl = tid / DV;
  float sn[RS];
  float* srow = s + (size_t)row * D * DV + (size_t)sl * RS * DV + e;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    sn[i] = srow[(size_t)i * DV] + pk[sl * RS + i] * vv[e];
    srow[(size_t)i * DV] = sn[i];
  }
  for (int g = 0; g < G; ++g) {
    const float* x = pq + g * D + sl * RS;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < RS; ++i) acc += x[i] * sn[i];
    part[(sl * G + g) * DV + e] = acc;
  }
  __syncthreads();

  for (int i = tid; i < G * DV; i += kThreads) {
    const int g = i / DV, ee = i - g * DV;
    float acc = 0.f;
    for (int j = 0; j < NS; ++j) acc += part[(j * G + g) * DV + ee];
    out[(size_t)row * G * DV + i] = from_f32<T>(acc * scal[2] * alloc[g]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* t, const void* q, const void* k, const void* v, void* k_sum,
                   void* q_sum, void* ko_sum, void* qi_sum, void* z, void* s, void* out,
                   int bh, int hkv, int g, int phi, int use_alloc, float eps,
                   cudaStream_t stream) {
  auto kern = flow_decode_kernel<T, D, D>;
  const size_t bytes = smem_floats(g, D, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(
      (const int*)t, (const T*)q, (const T*)k, (const T*)v, (float*)k_sum, (float*)q_sum,
      (float*)ko_sum, (float*)qi_sum, (float*)z, (float*)s, (T*)out, hkv, g, phi,
      use_alloc, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* t, const void* q, const void* k, const void* v,
                     void* k_sum, void* q_sum, void* ko_sum, void* qi_sum, void* z, void* s,
                     void* out, int bh, int hkv, int g, int phi, int use_alloc, float eps,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh,
                                  hkv, g, phi, use_alloc, eps, stream);
    case 64: return launch<T, 64>(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh,
                                  hkv, g, phi, use_alloc, eps, stream);
    case 128: return launch<T, 128>(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh,
                                    hkv, g, phi, use_alloc, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// t (B,) int32: each slot's count AFTER this token; q (BH, G, D), k (BH, D),
// v (BH, Dv) in `dtype` (0 fp32, 1 bf16) with BH = B * hkv; the fp32 state
// k/q/ko/qi sums (BH, D), z (BH,), s (BH, D, Dv) is updated in place; out
// (BH, G, Dv) in `dtype`.  D == Dv in {32, 64, 128}.  Returns a cudaError_t.
extern "C" int flow_decode_fwd(const void* t, const void* q, const void* k, const void* v,
                               void* k_sum, void* q_sum, void* ko_sum, void* qi_sum,
                               void* z, void* s, void* out, int bh, int hkv, int g, int d,
                               int dv, int dtype, int phi, int use_alloc, float eps,
                               void* stream) {
  if (d != dv || g < 1 || hkv < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh,
                                hkv, g, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s,
                                        out, bh, hkv, g, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
