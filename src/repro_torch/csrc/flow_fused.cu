// flow_fused.cu — strict-causal Flow-Attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_fused/flow_fused.py::
// flow_fused_call (the pl.pallas_call at :207, math in _chunk_step :56-141).
// It computes, per (row * kv head), the whole strict-causal Flow-Attention
// of paper Alg. 2 with per-row `lens` masking, and writes the boundary
// FlowState (four (D,) flow sums, z, and the (D, Dv) state S) once at the end.
//
// What bounds it on the H100: the arithmetic.  The work is a chain of small
// fp32 dot products and prefix sums (about 4*G*D*Dv + 2*D*Dv multiply-adds
// per position for the aggregation, plus O((G+1)*D) for the flows); q, k, v
// are read once and `out` written once, so at serving shapes the bytes take
// less time than fp32 FMA at 67 TFLOP/s.  The kernel keeps fp32 FMA on the
// CUDA cores (no tensor cores, no TF32), so the sums match the plain
// PyTorch version to fp32 reassociation.
//
// Design: the TPU ran the chunk axis as a sequential grid axis with the six
// running sums in VMEM scratch and "fixed" output blocks rewritten every
// chunk.  A GPU grid has no sequential axis, so here one CTA owns one
// (row, kv head) and loops over the sequence in tiles of kTile positions,
// with S (D x Dv fp32) and the running sums resident in shared memory for
// the whole sequence; nothing of the carry goes to device memory.  Per tile:
// phi and masking on load, in-tile prefix sums (a plain sequential scan per
// feature column; the reference's tril matmuls existed only so jax.vjp could
// differentiate them), warp-reduced flow dot products, the causal in-tile
// scores, the output rows, then S += K^T (V e).  Tiles wholly past the row's
// length are not computed: their outputs are exactly zero and the sums are
// frozen, so the kernel writes zeros there.  The tile is independent of the
// wrapper's chunk size: any padded N works, since chunking only changes the
// order of fp32 sums.  One CTA per (row, kv head) gives B*Hkv CTAs, about
// one wave on 132 SMs at 16 rows x 8 heads; splitting Dv across CTAs (the
// flows do not depend on V) is left for later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
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
  return (size_t)d * dv              // S
         + (size_t)g * kTile * d     // phi(q), then q_in
         + (size_t)kTile * (d + 1)   // phi(k), rows padded against bank conflicts
         + (size_t)kTile * dv        // v, then v * e
         + 2 * (size_t)kTile * d     // two prefix-sum panels
         + (size_t)g * kTile * kTile // causal scores
         + 4 * (size_t)d + 4         // q/k/ko/qi running sums, z
         + 2 * (size_t)g * kTile     // sink_in, alloc
         + 2 * (size_t)kTile;        // src_out then e, pos / z
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flow_fused_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lens,
                      T* __restrict__ out, float* __restrict__ q_sum_o,
                      float* __restrict__ k_sum_o, float* __restrict__ ko_sum_o,
                      float* __restrict__ qi_sum_o, float* __restrict__ z_o,
                      float* __restrict__ s_o, int G, int N, int phi,
                      int use_alloc, float eps) {
  static_assert(2 * D <= kThreads, "one thread per feature column for each of two scans");
  constexpr int PK = D + 1;
  extern __shared__ float smem[];
  float* S = smem;
  float* pq = S + D * DV;
  float* pk = pq + G * kTile * D;
  float* vw = pk + kTile * PK;
  float* csA = vw + kTile * DV;
  float* csB = csA + kTile * D;
  float* sc = csB + kTile * D;
  float* runs = sc + G * kTile * kTile;
  float* sink = runs + 4 * D + 4;
  float* alloc = sink + G * kTile;
  float* rowT = alloc + G * kTile;
  float* ratio = rowT + kTile;
  float* q_run = runs;
  float* k_run = runs + D;
  float* ko_run = runs + 2 * D;
  float* qi_run = runs + 3 * D;
  float* z_run = runs + 4 * D;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lens[row], N);
  const float fG = (float)G;
  const T* qrow = q + (size_t)row * G * N * D;
  const T* krow = k + (size_t)row * N * D;
  const T* vrow = v + (size_t)row * N * DV;
  T* orow = out + (size_t)row * G * N * DV;

  for (int i = tid; i < D * DV; i += kThreads) S[i] = 0.f;
  for (int i = tid; i < 4 * D + 4; i += kThreads) runs[i] = 0.f;
  __syncthreads();

  const int live_tiles = (len + kTile - 1) / kTile;
  for (int tile = 0; tile < live_tiles; ++tile) {
    const int p0 = tile * kTile;
    // (0) phi on load; positions past the row's length contribute zero
    for (int i = tid; i < G * kTile * D; i += kThreads) {
      const int g = i / (kTile * D), r = i - g * kTile * D, t = r / D, d = r - t * D;
      const int n = p0 + t;
      pq[i] = n < len ? phi_fn(to_f32(qrow[((size_t)g * N + n) * D + d]), phi) : 0.f;
    }
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D, d = i - t * D, n = p0 + t;
      pk[t * PK + d] = n < len ? phi_fn(to_f32(krow[(size_t)n * D + d]), phi) : 0.f;
    }
    for (int i = tid; i < kTile * DV; i += kThreads) {
      const int t = i / DV, e = i - t * DV, n = p0 + t;
      vw[i] = n < N ? to_f32(vrow[(size_t)n * DV + e]) : 0.f;
    }
    __syncthreads();

    // (1) inclusive prefix sums of phi(k) and of phi(q) summed over the group
    if (tid < D) {
      float acc = k_run[tid];
      for (int t = 0; t < kTile; ++t) { acc += pk[t * PK + tid]; csA[t * D + tid] = acc; }
      k_run[tid] = acc;
    } else if (tid < 2 * D) {
      const int d = tid - D;
      float acc = q_run[d];
      for (int t = 0; t < kTile; ++t) {
        float x = 0.f;
        for (int g = 0; g < G; ++g) x += pq[(g * kTile + t) * D + d];
        acc += x;
        csB[t * D + d] = acc;
      }
      q_run[d] = acc;
    }
    __syncthreads();

    // (2) incoming flow per sink, outgoing flow per source
    for (int r = warp; r < (G + 1) * kTile; r += kWarps) {
      const bool is_q = r < G * kTile;
      const int t = is_q ? r % kTile : r - G * kTile;
      const float* a = is_q ? pq + r * D : pk + t * PK;
      const float* c = is_q ? csA + t * D : csB + t * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float pos = (float)(p0 + t + 1);
        if (is_q) sink[r] = pos / acc;
        else rowT[t] = pos * fG / acc;
      }
    }
    __syncthreads();

    // (3) conservation prefix sums: ko over sources, qi over sinks
    if (tid < D) {
      float acc = ko_run[tid];
      for (int t = 0; t < kTile; ++t) { acc += pk[t * PK + tid] * rowT[t]; csA[t * D + tid] = acc; }
      ko_run[tid] = acc;
    } else if (tid < 2 * D) {
      const int d = tid - D;
      float acc = qi_run[d];
      for (int t = 0; t < kTile; ++t) {
        float x = 0.f;
        for (int g = 0; g < G; ++g) x += pq[(g * kTile + t) * D + d] * sink[g * kTile + t];
        acc += x;
        csB[t * D + d] = acc;
      }
      qi_run[d] = acc;
    }
    __syncthreads();

    // (4) conserved flows: allocation per sink, competition weight per source
    for (int r = warp; r < (G + 1) * kTile; r += kWarps) {
      const bool is_q = r < G * kTile;
      const int t = is_q ? r % kTile : r - G * kTile;
      const float* a = is_q ? pq + r * D : pk + t * PK;
      const float* c = is_q ? csA + t * D : csB + t * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += (a[d] + eps) * (c[d] + eps);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float pos = (float)(p0 + t + 1);
        if (is_q) {
          const float cons_sink = acc / (pos * fG);
          alloc[r] = use_alloc ? 1.f / (1.f + expf(-cons_sink)) : 1.f;
        } else {
          const float cons_src = fminf(fmaxf(acc / pos, -1.f), 1.f);
          rowT[t] = p0 + t < len ? expf(cons_src) : 0.f;  // e, bounded in [1/e, e]
        }
      }
    }
    __syncthreads();

    // (5) cumulative competition normalizer; q_in = phi(q) * sink_in; v * e
    if (tid == 0) {
      float acc = z_run[0];
      for (int t = 0; t < kTile; ++t) { acc += rowT[t]; ratio[t] = (float)(p0 + t + 1) / acc; }
      z_run[0] = acc;
    }
    for (int i = tid; i < G * kTile * D; i += kThreads) pq[i] *= sink[i / D];
    for (int i = tid; i < kTile * DV; i += kThreads) vw[i] *= rowT[i / DV];
    __syncthreads();

    // (6) causal in-tile scores q_in[i] . phi(k)[j], j <= i
    for (int i = tid; i < G * kTile * kTile; i += kThreads) {
      const int g = i / (kTile * kTile), r = i - g * kTile * kTile, a = r / kTile, b = r - a * kTile;
      float acc = 0.f;
      if (b <= a) {
        const float* x = pq + (g * kTile + a) * D;
        const float* y = pk + b * PK;
        for (int d = 0; d < D; ++d) acc += x[d] * y[d];
      }
      sc[i] = acc;
    }
    __syncthreads();

    // (7) out = (intra-tile + carried-state aggregation) * (pos / z) * alloc
    for (int i = tid; i < G * kTile * DV; i += kThreads) {
      const int g = i / (kTile * DV), r = i - g * kTile * DV, a = r / DV, e = r - a * DV;
      const int n = p0 + a;
      if (n >= N) continue;
      const float* srow = sc + (g * kTile + a) * kTile;
      float intra = 0.f;
      for (int b = 0; b <= a; ++b) intra += srow[b] * vw[b * DV + e];
      const float* x = pq + (g * kTile + a) * D;
      float inter = 0.f;
      for (int d = 0; d < D; ++d) inter += x[d] * S[d * DV + e];
      orow[((size_t)g * N + n) * DV + e] =
          from_f32<T>((intra + inter) * ratio[a] * alloc[g * kTile + a]);
    }
    __syncthreads();

    // (8) carried state: S += phi(k)^T (v * e)
    for (int i = tid; i < D * DV; i += kThreads) {
      const int d = i / DV, e = i - d * DV;
      float acc = 0.f;
      for (int t = 0; t < kTile; ++t) acc += pk[t * PK + d] * vw[t * DV + e];
      S[i] += acc;
    }
    __syncthreads();
  }

  // positions in tiles wholly past the row's length: exactly zero output
  const int n0 = live_tiles * kTile;
  if (n0 < N) {
    const int rest = N - n0;
    for (int i = tid; i < G * rest * DV; i += kThreads) {
      const int g = i / (rest * DV), r = i - g * rest * DV;
      orow[((size_t)g * N + n0) * DV + r] = from_f32<T>(0.f);
    }
  }
  // the boundary FlowState, written once
  for (int d = tid; d < D; d += kThreads) {
    q_sum_o[(size_t)row * D + d] = q_run[d];
    k_sum_o[(size_t)row * D + d] = k_run[d];
    ko_sum_o[(size_t)row * D + d] = ko_run[d];
    qi_sum_o[(size_t)row * D + d] = qi_run[d];
  }
  if (tid == 0) z_o[row] = z_run[0];
  for (int i = tid; i < D * DV; i += kThreads) s_o[(size_t)row * D * DV + i] = S[i];
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens, void* out,
                   void* q_sum, void* k_sum, void* ko_sum, void* qi_sum, void* z, void* s,
                   int bh, int g, int n, int phi, int use_alloc, float eps,
                   cudaStream_t stream) {
  auto kern = flow_fused_fwd_kernel<T, D, D>;
  const size_t bytes = smem_floats(g, D, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lens, (T*)out,
      (float*)q_sum, (float*)k_sum, (float*)ko_sum, (float*)qi_sum, (float*)z,
      (float*)s, g, n, phi, use_alloc, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* lens,
                     void* out, void* q_sum, void* k_sum, void* ko_sum, void* qi_sum,
                     void* z, void* s, int bh, int g, int n, int phi, int use_alloc,
                     float eps, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                  bh, g, n, phi, use_alloc, eps, stream);
    case 64: return launch<T, 64>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                  bh, g, n, phi, use_alloc, eps, stream);
    case 128: return launch<T, 128>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                    bh, g, n, phi, use_alloc, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) in `dtype` (0 fp32, 1 bf16);
// lens (BH,) int32 with 1 <= lens <= N.  Writes out (BH, G, N, Dv) in `dtype`,
// q/k/ko/qi sums (BH, D), z (BH,) and s (BH, D, Dv) in fp32.  D == Dv in
// {32, 64, 128}.  Returns a cudaError_t.
extern "C" int flow_fused_fwd(const void* q, const void* k, const void* v, const void* lens,
                              void* out, void* q_sum, void* k_sum, void* ko_sum,
                              void* qi_sum, void* z, void* s, int bh, int g, int n, int d,
                              int dv, int dtype, int phi, int use_alloc, float eps,
                              void* stream) {
  if (d != dv || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum,
                                        z, s, bh, g, n, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
