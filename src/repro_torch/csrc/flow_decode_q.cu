// flow_decode_q.cu — one batched Flow-Attention decode step on an int8
// FlowState pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_decode/quant.py::
// flow_decode_q_call (the pl.pallas_call at :158, body _kernel :56-128,
// _requant :44-53).  For every (slot, kv head) it dequantizes the pool's
// int8 payloads with their fp32 scales (payload * scale): the four flow
// sums (1, D) and S (D, Dv); runs the fp32 recurrence of flow_decode.cu
// (K3) from phi of the token to the (G, Dv) output row, with out taken from
// the fp32 S before requantization; then requantizes each of the five
// leaves with a fresh amax (scale = max(amax, 1e-12) / 127, payload =
// rint(clamp(x / scale)), IEEE division, round half to even) and writes
// payload and scale back IN PLACE (the TPU kernel aliased 11 inputs to
// outputs).  z stays raw fp32 and is updated in place; t advances in the
// wrapper.
//
// What bounds it on the H100: device-memory bytes.  Per (slot, head) it
// reads and writes D*Dv + 4*D payload bytes (4.4 KB at D = Dv = 64) plus
// ~50 B of scales and z, against K3's ~17 KB of fp32, and does about
// 2*D*Dv*(G+1) flops.  At 16 slots x 8 heads one launch moves ~1.2 MB,
// ~0.36 us at 3.35 TB/s: the launch's latency, not the bytes, is what a
// step pays.
//
// Design: K3's, one CTA of 256 threads per (slot, kv head).  Each thread
// owns one Dv column and a slice of D rows of S: it dequantizes its int8
// elements, updates them in registers, accumulates its share of q_in @ S,
// and takes their amax; the block's amax goes through warp shuffles, then
// shared memory.  Every thread reads the five old scales at the start;
// they are overwritten only after several __syncthreads, so no thread can
// read a new scale as an old one.  A payload element is read and written by
// the same thread.  Nothing is allocated except the output, which the
// wrapper allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kQmax = 127.f;
constexpr float kScaleEps = 1e-12f;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the reference's _requant of one value, given its leaf's new scale
__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return (int8_t)rintf(fminf(fmaxf(x / scale, -kQmax), kQmax));
}

__device__ __forceinline__ float new_scale(float amax) {
  return fmaxf(amax, kScaleEps) / kQmax;
}

__host__ __device__ constexpr size_t smem_floats(int g, int d, int dv) {
  return (size_t)g * d + d + dv      // phi(q) then q_in, phi(k), v then v * e
         + 4 * (size_t)d             // updated k/q/ko/qi sums, fp32
         + 2 * (size_t)g + 4         // sink_in, alloc, src_out / e / ratio
         + 4 + kWarps                // the sums' new scales, S's per-warp amax
         + (size_t)(kThreads / dv) * g * dv;  // per-slice partial outputs
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flow_decode_q_kernel(const int* __restrict__ t, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     int8_t* __restrict__ k_pay, int8_t* __restrict__ q_pay,
                     int8_t* __restrict__ ko_pay, int8_t* __restrict__ qi_pay,
                     int8_t* __restrict__ s_pay, float* __restrict__ k_sc,
                     float* __restrict__ q_sc, float* __restrict__ ko_sc,
                     float* __restrict__ qi_sc, float* __restrict__ s_sc,
                     float* __restrict__ z, T* __restrict__ out, int hkv, int G,
                     int phi, int use_alloc, float eps) {
  static_assert(kThreads % DV == 0 && D % (kThreads / DV) == 0, "slice layout");
  static_assert(D <= kThreads && D >= 32, "one thread per feature");
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
  float* nsc = scal + 4;    // new scales of k/q/ko/qi sums
  float* red = nsc + 4;     // per-warp amax of S
  float* part = red + kWarps;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float tf = (float)t[row / hkv];  // count after this token
  const float fG = (float)G;
  // the old scales: read here, overwritten only after the last barrier
  const float k_old = k_sc[row], q_old = q_sc[row], ko_old = ko_sc[row];
  const float qi_old = qi_sc[row], s_old = s_sc[row];

  for (int i = tid; i < G * D; i += kThreads)
    pq[i] = phi_fn(to_f32(q[(size_t)row * G * D + i]), phi);
  for (int i = tid; i < D; i += kThreads) pk[i] = phi_fn(to_f32(k[(size_t)row * D + i]), phi);
  for (int i = tid; i < DV; i += kThreads) vv[i] = to_f32(v[(size_t)row * DV + i]);
  __syncthreads();

  if (tid < D) {
    float x = 0.f;
    for (int g = 0; g < G; ++g) x += pq[g * D + tid];
    ks[tid] = (float)k_pay[(size_t)row * D + tid] * k_old + pk[tid];
    qs[tid] = (float)q_pay[(size_t)row * D + tid] * q_old + x;
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
    kos[tid] = (float)ko_pay[(size_t)row * D + tid] * ko_old + pk[tid] * scal[0];
    qis[tid] = (float)qi_pay[(size_t)row * D + tid] * qi_old + x;
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

  // each of warps 0-3 takes one sum's amax; q_in = phi(q) * sink_in; v * e
  if (warp < 4) {
    const float* x = warp == 0 ? ks : warp == 1 ? qs : warp == 2 ? kos : qis;
    float m = 0.f;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(x[d]));
    m = warp_max(m);
    if (lane == 0) nsc[warp] = new_scale(m);
  }
  for (int i = tid; i < G * D; i += kThreads) pq[i] *= sink[i / D];
  for (int i = tid; i < DV; i += kThreads) vv[i] *= scal[1];
  __syncthreads();

  // requantized sums, in place
  if (tid < D) {
    const size_t o = (size_t)row * D + tid;
    k_pay[o] = quantize(ks[tid], nsc[0]);
    q_pay[o] = quantize(qs[tid], nsc[1]);
    ko_pay[o] = quantize(kos[tid], nsc[2]);
    qi_pay[o] = quantize(qis[tid], nsc[3]);
  }
  if (tid == 0) {
    k_sc[row] = nsc[0];
    q_sc[row] = nsc[1];
    ko_sc[row] = nsc[2];
    qi_sc[row] = nsc[3];
  }

  // S = deq(S) + phi(k) (v e)^T in registers, this slice's share of
  // q_in @ S, and the amax of this thread's elements
  const int e = tid % DV, sl = tid / DV;
  float sn[RS];
  int8_t* srow = s_pay + (size_t)row * D * DV + (size_t)sl * RS * DV + e;
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    sn[i] = (float)srow[(size_t)i * DV] * s_old + pk[sl * RS + i] * vv[e];
    m = fmaxf(m, fabsf(sn[i]));
  }
  for (int g = 0; g < G; ++g) {
    const float* x = pq + g * D + sl * RS;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < RS; ++i) acc += x[i] * sn[i];
    part[(sl * G + g) * DV + e] = acc;
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();

  float amax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float sc = new_scale(amax);
#pragma unroll
  for (int i = 0; i < RS; ++i) srow[(size_t)i * DV] = quantize(sn[i], sc);
  if (tid == 0) s_sc[row] = sc;

  for (int i = tid; i < G * DV; i += kThreads) {
    const int g = i / DV, ee = i - g * DV;
    float acc = 0.f;
    for (int j = 0; j < NS; ++j) acc += part[(j * G + g) * DV + ee];
    out[(size_t)row * G * DV + i] = from_f32<T>(acc * scal[2] * alloc[g]);
  }
}

struct Args {
  const void *t, *q, *k, *v;
  void *k_pay, *q_pay, *ko_pay, *qi_pay, *s_pay;
  void *k_sc, *q_sc, *ko_sc, *qi_sc, *s_sc, *z, *out;
};

template <typename T, int D>
cudaError_t launch(const Args& a, int bh, int hkv, int g, int phi, int use_alloc, float eps,
                   cudaStream_t stream) {
  auto kern = flow_decode_q_kernel<T, D, D>;
  const size_t bytes = smem_floats(g, D, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(
      (const int*)a.t, (const T*)a.q, (const T*)a.k, (const T*)a.v, (int8_t*)a.k_pay,
      (int8_t*)a.q_pay, (int8_t*)a.ko_pay, (int8_t*)a.qi_pay, (int8_t*)a.s_pay,
      (float*)a.k_sc, (float*)a.q_sc, (float*)a.ko_sc, (float*)a.qi_sc, (float*)a.s_sc,
      (float*)a.z, (T*)a.out, hkv, g, phi, use_alloc, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Args& a, int bh, int hkv, int g, int phi, int use_alloc,
                     float eps, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, bh, hkv, g, phi, use_alloc, eps, stream);
    case 64: return launch<T, 64>(a, bh, hkv, g, phi, use_alloc, eps, stream);
    case 128: return launch<T, 128>(a, bh, hkv, g, phi, use_alloc, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// t (B,) int32: each slot's count AFTER this token; q (BH, G, D), k (BH, D),
// v (BH, Dv) in `dtype` (0 fp32, 1 bf16) with BH = B * hkv; the int8
// payloads of the k/q/ko/qi sums (BH, D) and of S (BH, D, Dv), their fp32
// scales (BH,) each and the raw fp32 z (BH,) are updated in place; out
// (BH, G, Dv) in `dtype`.  D == Dv in {32, 64, 128}.  Returns a cudaError_t.
extern "C" int flow_decode_q_fwd(const void* t, const void* q, const void* k, const void* v,
                                 void* k_pay, void* q_pay, void* ko_pay, void* qi_pay,
                                 void* s_pay, void* k_sc, void* q_sc, void* ko_sc,
                                 void* qi_sc, void* s_sc, void* z, void* out, int bh,
                                 int hkv, int g, int d, int dv, int dtype, int phi,
                                 int use_alloc, float eps, void* stream) {
  if (d != dv || g < 1 || hkv < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  const Args a{t, q, k, v, k_pay, q_pay, ko_pay, qi_pay, s_pay,
               k_sc, q_sc, ko_sc, qi_sc, s_sc, z, out};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(d, a, bh, hkv, g, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, a, bh, hkv, g, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_decode_q_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
