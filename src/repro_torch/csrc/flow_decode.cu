// flow_decode.cu — one batched Flow-Attention decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_decode/flow_decode.py::
// flow_decode_call (the pl.pallas_call at :137, body _kernel :49-102).  It
// advances every (slot, kv head) of the serving pool by one token: phi of
// the token, flows normalized by the slot's count t, the four flow sums, z
// and the (D, Dv) state S updated IN PLACE (the TPU kernel aliased them with
// input_output_aliases), and the (G, Dv) output row.
//
// What bounds it on the H100: device-memory bytes at large pools, one CTA's
// chain of dependent steps at the serving shape.  Each (slot, head) reads
// and writes its D x Dv fp32 state once (16 KB each way at D = Dv = 64) and
// does about 2*D*Dv*(G+1) flops on it, far below the card's 295 flops/byte
// balance point.  At 16 slots x 8 heads one launch moves about 2.1 MB each
// way, ~1.35 us at 3.35 TB/s, so a launch pays its floor and the wait of
// one CTA: its first bytes, then the flow chain.
//
// Design (the shape of flow_decode_q.cu, K4, without the int8 payloads):
// one CTA per (slot, kv head) of a chain warp and SW "S warps" (8 at
// D <= 64, 16 at D = 128 so that a thread holds 32 floats of S, not 64),
// ONE block barrier.
//   * Every global read is issued at entry, as vector loads.  Warp 0 reads
//     the four sums (D/32 floats a lane), z, t and the token's q and k; the
//     S warps read S (16 bytes a load: one load a thread at D = 32, four at
//     64, eight at 128), phi(k) and phi(q) at their rows and v at their
//     columns.  S's bytes are in flight while the chain runs.
//   * Warp 0 runs the flow chain with shuffles only (lane l owns features
//     l*D/32 ..): the k and q sums, the inflow/outflow dots with
//     phi(q) . phi(k) in one interleaved butterfly, ko and qi, the
//     conserved dots, alloc, e and z; the scalar divisions of a step run on
//     separate lanes at once.  It writes the four sums and z in place with
//     vector stores and leaves sink, alloc, phi(q) . phi(k), e and t / z in
//     shared memory.
//   * Meanwhile each S warp forms its share of phi(q) @ S from the OLD S: a
//     thread's rows summed in registers, the warp's rows by a shuffle
//     reduce-scatter, one partial per warp in shared memory.
//   * Barrier.  The S warps form S_new = S + phi(k) (v e)^T elementwise,
//     each product and sum rounded once as the plain version rounds them
//     (no contraction into an FMA), and write it back with 16-byte stores;
//     then they sum the warps' partials in warp order and write
//       out_g = sink_g (phi(q)_g @ S + (phi(q)_g . phi(k)) (v e)) (t/z) alloc_g,
//     q_in_g @ S_new in another fp32 order (kernels/flow_decode/ref.py::
//     flow_decode_split is its plain twin).
// No float atomics: the sums run in a fixed order, and two calls give
// bitwise-equal results.  Nothing is allocated but the output, which the
// wrapper allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Two butterflies interleaved; every lane ends with the same bits.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float x = __shfl_xor_sync(kFull, a, off), y = __shfl_xor_sync(kFull, b, off);
    a += x;
    b += y;
  }
}

// Three butterflies interleaved.
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float x = __shfl_xor_sync(kFull, a, off), y = __shfl_xor_sync(kFull, b, off);
    const float w = __shfl_xor_sync(kFull, c, off);
    a += x;
    b += y;
    c += w;
  }
}

// N consecutive fp32 values in vector loads (16-byte at most), and back.
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 u = reinterpret_cast<const float4*>(p)[j];
      x[4 * j] = u.x, x[4 * j + 1] = u.y, x[4 * j + 2] = u.z, x[4 * j + 3] = u.w;
    }
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x, x[1] = u.y;
  } else {
    x[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// N consecutive bf16 values as fp32, in one vector load (16-byte at most).
template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[j];
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) x[8 * j + 2 * h] = bf_lo(w[h]), x[8 * j + 2 * h + 1] = bf_hi(w[h]);
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(u.x), x[1] = bf_hi(u.x), x[2] = bf_lo(u.y), x[3] = bf_hi(u.y);
  } else if constexpr (N == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    x[0] = bf_lo(u), x[1] = bf_hi(u);
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

// How a CTA holds a D x D fp32 S: SW S warps; load i of S thread s is the 4
// floats at flat offset (i * ST + s) * 4, i.e. row i * RPL + s / SPR,
// columns (s % SPR) * 4 ..; a warp holds RPW rows of each load, its lanes'
// row bits are the top RB bits of the lane.
template <int D>
struct Shape {
  static constexpr int SW = D == 128 ? 16 : 8;  // S warps
  static constexpr int ST = 32 * SW;            // S threads
  static constexpr int THREADS = 32 + ST;       // warp 0 runs the chain
  static constexpr int F = D / 32;              // features a lane owns in the chain
  static constexpr int VB = 4;                  // floats a 16-byte load
  static constexpr int NV = D * D / (ST * VB);  // loads an S thread
  static constexpr int SPR = D / VB, RPW = 32 / SPR, RPL = ST / SPR;
  static constexpr int RB = RPW == 4 ? 2 : RPW == 2 ? 1 : 0;
  static constexpr int NOUT = VB >> RB;  // partial columns a lane ends with
  static_assert(D % 32 == 0 && F >= 1 && F <= 4 && NV >= 1 && NV * ST * VB == D * D &&
                    (1 << RB) == RPW && ST % D == 0,
                "S layout");
};

// Sum x over the warp's row bits (lane bits SPR, 2 SPR, ...), leaving each
// lane VB >> RB of the VB column sums: the lane keeps the upper half where
// its row bit is set, the lower half where it is clear, at each step.
// Returns the offset of the lane's first column within its VB.
template <int VB, int RB, int SPR>
__device__ __forceinline__ int reduce_scatter(float (&x)[VB], int lane) {
  int off = 0;
#pragma unroll
  for (int s = 0; s < RB; ++s) {
    const int h = VB >> (s + 1);
    const bool up = (lane & (SPR << s)) != 0;
#pragma unroll
    for (int i = 0; i < (VB >> 1); ++i) {
      if (i < h) {
        const float send = up ? x[i] : x[i + h];
        const float keep = up ? x[i + h] : x[i];
        x[i] = keep + __shfl_xor_sync(kFull, send, SPR << s);
      }
    }
    off += up ? h : 0;
  }
  return off;
}

__host__ __device__ constexpr size_t smem_floats(int sw, int g, int d, bool g1) {
  return (size_t)sw * g * d        // per-warp partials of phi(q) @ S
         + 3 * (size_t)g + 2       // sink_in, alloc, phi(q) . phi(k); e, t / z
         + (g1 ? 0 : (size_t)g * d);  // the chain's phi(q), one lane's own slots
}

template <typename T, int D, bool G1>
__global__ void __launch_bounds__(Shape<D>::THREADS, D <= 64 ? 4 : 1)
flow_decode_kernel(const int* __restrict__ t, const T* __restrict__ q,
                   const T* __restrict__ k, const T* __restrict__ v,
                   float* __restrict__ k_sum, float* __restrict__ q_sum,
                   float* __restrict__ ko_sum, float* __restrict__ qi_sum,
                   float* __restrict__ z, float* __restrict__ s, T* __restrict__ out,
                   int hkv, int G, int phi, int use_alloc, float eps) {
  using SH = Shape<D>;
  constexpr int F = SH::F, VB = SH::VB, NV = SH::NV, SW = SH::SW, ST = SH::ST;
  extern __shared__ float sm[];
  float* part = sm;                  // SW x G x D
  float* sink = part + SW * G * D;
  float* alloc = sink + G;
  float* dqk = alloc + G;
  float* scal = dqk + G;             // [0] e, [1] t / z
  float* qch = scal + 2;             // G x D, G > 1 only
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int si = threadIdx.x - 32, sw = warp - 1;  // S warps: thread si of ST
  const T* qb = q + (size_t)row * G * D;
  const T* kb = k + (size_t)row * D;
  const T* vb = v + (size_t)row * D;
  const int GG = G1 ? 1 : G;
  float* sb = s + (size_t)row * D * D;

  // the S warps' values: S, then S_new; phi(k) at their rows, v at their
  // columns
  float sn[NV][VB];
  float kr[NV], vc[VB], v_out = 0.f;
  const int c0 = (si % SH::SPR) * VB;

  if (warp == 0) {
    // ---- the flow chain, lane l owning features f0 .. f0 + F - 1 ----
    const int f0 = lane * F;
    const size_t o = (size_t)row * D + f0;
    float ks[F], qs[F], kos[F], qis[F];
    load_f<F>(k_sum + o, ks);
    load_f<F>(q_sum + o, qs);
    load_f<F>(ko_sum + o, kos);
    load_f<F>(qi_sum + o, qis);
    const float z_old = z[row];
    const float tf = (float)t[row / hkv], fG = (float)G;  // count after this token
    float pk[F], pq0[F];
    load_f<F>(kb + f0, pk);
    load_f<F>(qb + f0, pq0);
#pragma unroll
    for (int f = 0; f < F; ++f) pk[f] = phi_fn(pk[f], phi), pq0[f] = phi_fn(pq0[f], phi);
    if (!G1) {
      for (int g = 0; g < G; ++g) {
        float x[F];
        load_f<F>(qb + (size_t)g * D + f0, x);
#pragma unroll
        for (int f = 0; f < F; ++f) qch[g * D + f0 + f] = phi_fn(x[f], phi);
      }
    }
    auto pq = [&](int g, int f) { return G1 ? pq0[f] : qch[g * D + f0 + f]; };

    // level 1: the k and q sums; sink_in, src_out and phi(q) . phi(k)
    float a0 = 0.f, a_out = 0.f, d0 = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float x = 0.f;
      for (int g = 0; g < GG; ++g) x += pq(g, f);
      ks[f] = __fadd_rn(ks[f], pk[f]);
      qs[f] = __fadd_rn(qs[f], x);
      a0 += (pq(0, f) + eps) * (ks[f] + eps);
      a_out += (pk[f] + eps) * (qs[f] + eps);
      d0 += pq(0, f) * pk[f];
    }
    warp_sum3(a0, a_out, d0);
    // two divisions at once: lane 0 sink_in of group 0, lane 1 src_out
    const float r1 = (lane == 1 ? tf * fG : tf) / (lane == 1 ? a_out : a0);
    const float sink0 = __shfl_sync(kFull, r1, 0), src = __shfl_sync(kFull, r1, 1);
    if (lane == 0) sink[0] = sink0, dqk[0] = d0;
    for (int g = 1; g < GG; ++g) {
      float a = 0.f, dd = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a += (pq(g, f) + eps) * (ks[f] + eps);
        dd += pq(g, f) * pk[f];
      }
      warp_sum2(a, dd);
      if (lane == 0) sink[g] = tf / a, dqk[g] = dd;
    }
    __syncwarp();
    // level 2: the ko and qi sums, the conserved flows
    float c0s = 0.f, c_src = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float x = 0.f;
      for (int g = 0; g < GG; ++g) x += __fmul_rn(pq(g, f), G1 ? sink0 : sink[g]);
      kos[f] = __fadd_rn(kos[f], __fmul_rn(pk[f], src));
      qis[f] = __fadd_rn(qis[f], x);
      c0s += (pq(0, f) + eps) * (kos[f] + eps);
      c_src += (pk[f] + eps) * (qis[f] + eps);
    }
    warp_sum2(c0s, c_src);
    // the four sums, in place
    store_f<F>(k_sum + o, ks);
    store_f<F>(q_sum + o, qs);
    store_f<F>(ko_sum + o, kos);
    store_f<F>(qi_sum + o, qis);
    const float n_q = tf * fG;
    // lane 0: alloc = sigmoid(c0s / n_q); lane 1: e = exp(clip(c_src / t)),
    // z + e and t / (z + e) -- each step one division or exp for both
    const float r2 = (lane == 1 ? c_src : c0s) / (lane == 1 ? tf : n_q);
    const float ex = expf(lane == 1 ? fminf(fmaxf(r2, -1.f), 1.f) : -r2);
    const float den = (lane == 1 ? z_old : 1.f) + ex;
    const float r3 = (lane == 1 ? tf : 1.f) / den;
    if (lane == 0) alloc[0] = use_alloc ? r3 : 1.f;
    for (int g = 1; g < GG; ++g) {
      float a = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) a += (pq(g, f) + eps) * (kos[f] + eps);
      a = warp_sum(a);
      if (lane == 0) alloc[g] = use_alloc ? 1.f / (1.f + expf(-(a / n_q))) : 1.f;
    }
    if (lane == 1) {
      z[row] = den;  // z + e
      scal[0] = ex;  // e
      scal[1] = r3;  // t / z
    }
  } else {
    // ---- entry of the S warps: every global read, as vector loads ----
    float qr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) load_f<VB>(sb + (size_t)(i * ST + si) * VB, sn[i]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int r = i * SH::RPL + si / SH::SPR;
      kr[i] = to_f32(kb[r]);
      qr[i] = to_f32(qb[r]);  // group 0
    }
    load_f<VB>(vb + c0, vc);
    v_out = to_f32(vb[si % D]);  // the column of this thread's outputs
    // this warp's partials of phi(q) @ S, from the old S
#pragma unroll
    for (int i = 0; i < NV; ++i) kr[i] = phi_fn(kr[i], phi);
    for (int g = 0; g < G; ++g) {
      float acc[VB];
#pragma unroll
      for (int j = 0; j < VB; ++j) acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float p = phi_fn(
            g == 0 ? qr[i] : to_f32(qb[(size_t)g * D + i * SH::RPL + si / SH::SPR]), phi);
#pragma unroll
        for (int j = 0; j < VB; ++j) acc[j] += p * sn[i][j];
      }
      const int off = reduce_scatter<VB, SH::RB, SH::SPR>(acc, lane);
      float* dst = part + ((size_t)sw * G + g) * D + c0 + off;
#pragma unroll
      for (int j = 0; j < SH::NOUT; ++j) dst[j] = acc[j];
    }
  }
  __syncthreads();  // the chain's scalars and every partial

  if (warp > 0) {
    const float e = scal[0], ratio = scal[1];
    // S_new = S + phi(k) (v e)^T, in place with 16-byte stores
#pragma unroll
    for (int j = 0; j < VB; ++j) vc[j] = __fmul_rn(vc[j], e);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j < VB; ++j) sn[i][j] = __fadd_rn(sn[i][j], __fmul_rn(kr[i], vc[j]));
      store_f<VB>(sb + (size_t)(i * ST + si) * VB, sn[i]);
    }
    for (int i = si; i < G * D; i += ST) {
      const int g = i / D, c = i - g * D;
      float acc = part[(size_t)g * D + c];
#pragma unroll
      for (int w = 1; w < SW; ++w) acc += part[((size_t)w * G + g) * D + c];
      const float y = sink[g] * (acc + dqk[g] * __fmul_rn(v_out, e));
      out[(size_t)row * G * D + i] = from_f32<T>(y * ratio * alloc[g]);
    }
  }
}

template <typename T, int D, bool G1>
cudaError_t launch_g(const void* t, const void* q, const void* k, const void* v, void* k_sum,
                     void* q_sum, void* ko_sum, void* qi_sum, void* z, void* s, void* out,
                     int bh, int hkv, int g, int phi, int use_alloc, float eps,
                     cudaStream_t stream) {
  using SH = Shape<D>;
  auto kern = flow_decode_kernel<T, D, G1>;
  const size_t bytes = smem_floats(SH::SW, g, D, G1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, SH::THREADS, bytes, stream>>>(
      (const int*)t, (const T*)q, (const T*)k, (const T*)v, (float*)k_sum, (float*)q_sum,
      (float*)ko_sum, (float*)qi_sum, (float*)z, (float*)s, (T*)out, hkv, g, phi,
      use_alloc, eps);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* t, const void* q, const void* k, const void* v, void* k_sum,
                   void* q_sum, void* ko_sum, void* qi_sum, void* z, void* s, void* out,
                   int bh, int hkv, int g, int phi, int use_alloc, float eps,
                   cudaStream_t stream) {
  if (g == 1)
    return launch_g<T, D, true>(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh, hkv,
                                g, phi, use_alloc, eps, stream);
  return launch_g<T, D, false>(t, q, k, v, k_sum, q_sum, ko_sum, qi_sum, z, s, out, bh, hkv,
                               g, phi, use_alloc, eps, stream);
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

template <typename T, int D>
int occupancy_of(int g) {
  using SH = Shape<D>;
  int n = 0;
  cudaError_t err =
      g == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, flow_decode_kernel<T, D, true>, SH::THREADS,
                   smem_floats(SH::SW, g, D, true) * sizeof(float))
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, flow_decode_kernel<T, D, false>, SH::THREADS,
                   smem_floats(SH::SW, g, D, false) * sizeof(float));
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// t (B,) int32: each slot's count AFTER this token; q (BH, G, D), k (BH, D),
// v (BH, Dv) in `dtype` (0 fp32, 1 bf16) with BH = B * hkv; the fp32 state
// k/q/ko/qi sums (BH, D), z (BH,), s (BH, D, Dv) is updated in place; out
// (BH, G, Dv) in `dtype`.  D == Dv in {32, 64, 128}; q, k, v, the sums and
// s 16-byte aligned.  Returns a cudaError_t.
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

// CTAs of the kernel an SM holds at once for (D, dtype, G), by its
// registers and shared memory; minus a cudaError_t on failure.
extern "C" int flow_decode_occupancy(int d, int dtype, int g) {
  if (g < 1) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d == 32) return occupancy_of<float, 32>(g);
    if (d == 64) return occupancy_of<float, 64>(g);
    if (d == 128) return occupancy_of<float, 128>(g);
  } else if (dtype == 1) {
    if (d == 32) return occupancy_of<__nv_bfloat16, 32>(g);
    if (d == 64) return occupancy_of<__nv_bfloat16, 64>(g);
    if (d == 128) return occupancy_of<__nv_bfloat16, 128>(g);
  }
  return -(int)cudaErrorInvalidValue;
}

extern "C" const char* flow_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
