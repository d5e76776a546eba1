// flow_decode_q.cu — one batched Flow-Attention decode step on an int8
// FlowState pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_decode/quant.py::
// flow_decode_q_call (the pl.pallas_call at :158, body _kernel :56-128,
// _requant :44-53).  For every (slot, kv head) it dequantizes the pool's
// int8 payloads with their fp32 scales (payload * scale): the four flow
// sums (1, D) and S (D, Dv); runs the fp32 recurrence of flow_decode.cu
// (K3) from phi of the token to the (G, Dv) output row, with out taken from
// the fp32 state before requantization; then requantizes each of the five
// leaves with a fresh amax (scale = max(amax, 1e-12) / 127, payload =
// rint(clamp(x / scale)), IEEE division, round half to even) and writes
// payload and scale back IN PLACE (the TPU kernel aliased 11 inputs to
// outputs).  z stays raw fp32 and is updated in place; t advances in the
// wrapper.
//
// What bounds it on the H100: per (slot, head) it reads and writes
// D*Dv + 4*D payload bytes (4.4 KB at D = Dv = 64) plus ~50 B of scales and
// z, and does about 2*D*Dv*(G+1) flops: bytes, but at the serving shape (16
// slots x 8 heads, ~1.2 MB, ~0.36 us at 3.35 TB/s) one CTA's chain of
// dependent steps is what a launch pays.
//
// Design: one CTA of 288 threads per (slot, kv head), two block barriers.
//   * Warp 0 runs the flow chain with shuffles only (lane l owns features
//     l*D/32 ..): the four sums, the inflow/outflow dots with phi(q) .
//     phi(k) in one interleaved butterfly, ko/qi, the conserved dots,
//     alloc, e and z; the scalar divisions of a step run on separate lanes
//     at once.  Its reads (the four sum payloads, D/32 bytes a lane, their
//     scales, z, t, the token's features) are issued first.
//   * Meanwhile the 8 S warps issue their reads at entry as vector loads:
//     16 bytes of the S payload a thread (D = Dv = 64; four such loads at
//     128, 4 bytes at 32), the S scale, phi(k) and phi(q) at its rows and v
//     at its columns; then each forms its share of phi(q) @ deq(S): a
//     thread's rows summed in registers, the warp's rows by a shuffle
//     reduce-scatter, one partial per warp in shared memory.  The output
//     does not wait for the new S:
//       out_g = sink_g (phi(q)_g @ deq(S) + (phi(q)_g . phi(k)) (v e)) (t/z) alloc_g,
//     q_in_g @ S_new in another fp32 order (kernels/flow_decode/ref.py::
//     flow_decode_q_split is its plain twin).
//   * Barrier 1.  The S warps write the output and form S_new = deq(S) +
//     phi(k) (v e)^T elementwise, each product and sum rounded once as the
//     plain version rounds them (no contraction), and each warp's amax;
//     warp 0 meanwhile takes the four sums' amaxes (butterflies) and scales
//     (one lane per leaf).
//   * Barrier 2.  The S warps requantize S and write it back with 16-byte
//     stores, its scale by one thread; warp 0 the four sums' payloads.
// Each payload is rint(clamp(x / scale)) with the IEEE division, as the
// reference's _requant; int8 <-> fp32 steps use exact full-rate adds, not
// the conversion pipe.  Every old scale is read at entry and overwritten
// only after barrier 2; each payload byte is read and written by one
// thread.
// No float atomics: the sums run in a fixed order, and two calls give
// bitwise-equal results.  Nothing is allocated but the output, which the
// wrapper allocates.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSWarps = 8;                   // the warps that hold S
constexpr int kSThreads = 32 * kSWarps;
constexpr int kThreads = 32 + kSThreads;      // warp 0 runs the chain
constexpr unsigned kFull = 0xffffffffu;
constexpr float kQmax = 127.f;
constexpr float kScaleEps = 1e-12f;
// 1.5 * 2^23: for |x| < 2^22, x + kMagic is x rounded to an integer (ties to
// even) in the low mantissa bits, and bits kMagic + b the integer b: the
// int8 <-> fp32 steps in full-rate adds instead of conversions (whose pipe
// runs at a quarter of the rate)
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
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

// The reference's _requant of one value: rint(clamp(x / scale, -127, 127))
// with the IEEE division, rint (half to even) by the magic add.
__device__ __forceinline__ int quantize(float x, float scale) {
  const float y = fminf(fmaxf(x / scale, -kQmax), kQmax);
  return __float_as_int(__fadd_rn(y, kMagic)) - kMagicBits;
}

__device__ __forceinline__ float new_scale(float amax) {
  return fmaxf(amax, kScaleEps) / kQmax;
}

// payload * scale + x, each step rounded once, as the plain version does
__device__ __forceinline__ float deq_add(float payload, float scale, float x) {
  return __fadd_rn(__fmul_rn(payload, scale), x);
}

// N consecutive elements as fp32, in vector loads (16-byte at most).
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

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

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

// N int8 payload bytes (N in {1, 2, 4, 16}) in one load, as 32-bit words.
template <int N>
struct Bytes {
  static constexpr int W = N < 4 ? 1 : N / 4;
  unsigned w[W];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (N == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (N == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (N == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    } else {
      w[0] = (unsigned char)p[0];
    }
  }
  __device__ __forceinline__ void store(int8_t* p) const {
    if constexpr (N == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (N == 4) {
      *reinterpret_cast<unsigned*>(p) = w[0];
    } else if constexpr (N == 2) {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
    } else {
      p[0] = (int8_t)w[0];
    }
  }
  // byte j as a signed value
  __device__ __forceinline__ float at(int j) const {
    const int b = (int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24;
    return __fsub_rn(__int_as_float(kMagicBits + b), kMagic);
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ void set(int j, int q) {
    w[j >> 2] |= (unsigned)(q & 0xff) << (8 * (j & 3));
  }
};

// How the S warps hold a D x D int8 S: load i of S thread s is the VB bytes
// at flat offset (i * kSThreads + s) * VB, i.e. row i * RPL + s / SPR,
// columns (s % SPR) * VB ...; a warp holds RPW rows of each load, its
// lanes' row bits are the top RB bits of the lane.
template <int D>
struct Shape {
  static constexpr int F = D / 32;  // features a lane owns in the chain
  static constexpr int VB = D * D / kSThreads < 16 ? D * D / kSThreads : 16;
  static constexpr int NV = D * D / (kSThreads * VB);
  static constexpr int SPR = D / VB, RPW = 32 / SPR, RPL = kSThreads / SPR;
  static constexpr int RB = RPW == 8 ? 3 : RPW == 4 ? 2 : RPW == 2 ? 1 : 0;
  static constexpr int NOUT = VB >> RB;  // partial columns a lane ends with
  static_assert(D % 32 == 0 && F >= 1 && F <= 4 && NV * kSThreads * VB == D * D &&
                    (1 << RB) == RPW && NOUT >= 1,
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

__host__ __device__ constexpr size_t smem_floats(int g, int d, bool g1) {
  return (size_t)kSWarps * g * d  // per-warp partials of phi(q) @ deq(S)
         + 3 * (size_t)g + 2      // sink_in, alloc, phi(q) . phi(k); e, t / z
         + kSWarps                // S's per-warp amax
         + (g1 ? 0 : (size_t)g * d);  // the chain's phi(q), one lane's own slots
}

// Four CTAs an SM at D <= 64: ptxas then spills a few words at D = 64;
// three CTAs an SM, without the spill, ran slower at 1,024 slots.
template <typename T, int D, bool G1>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1)
flow_decode_q_kernel(const int* __restrict__ t, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     int8_t* __restrict__ k_pay, int8_t* __restrict__ q_pay,
                     int8_t* __restrict__ ko_pay, int8_t* __restrict__ qi_pay,
                     int8_t* __restrict__ s_pay, float* __restrict__ k_sc,
                     float* __restrict__ q_sc, float* __restrict__ ko_sc,
                     float* __restrict__ qi_sc, float* __restrict__ s_sc,
                     float* __restrict__ z, T* __restrict__ out, int hkv, int G,
                     int phi, int use_alloc, float eps) {
  using SH = Shape<D>;
  constexpr int F = SH::F, VB = SH::VB, NV = SH::NV;
  extern __shared__ float sm[];
  float* part = sm;                  // kSWarps x G x D
  float* sink = part + kSWarps * G * D;
  float* alloc = sink + G;
  float* dqk = alloc + G;
  float* scal = dqk + G;             // [0] e, [1] t / z
  float* red = scal + 2;             // kSWarps
  float* qch = red + kSWarps;        // G x D, G > 1 only
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = threadIdx.x - 32, sw = warp - 1;  // S warps: thread s of 256
  const T* qb = q + (size_t)row * G * D;
  const T* kb = k + (size_t)row * D;
  const T* vb = v + (size_t)row * D;
  const int GG = G1 ? 1 : G;
  int8_t* sb = s_pay + (size_t)row * D * D;

  // warp 0's chain values, kept across barrier 1
  float ks[F], qs[F], kos[F], qis[F];
  const size_t o = (size_t)row * D + lane * F;
  // the S warps' values: S's payload bytes, then deq(S), then S_new
  Bytes<VB> sp[NV];
  float sn[NV][VB];
  float s_old = 0.f, kr[NV], qr[NV], vc[VB], v_out = 0.f;
  const int c0 = (s % SH::SPR) * VB;

  if (warp == 0) {
    // ---- the flow chain, lane l owning features f0 .. f0 + F - 1 ----
    const int f0 = lane * F;
    Bytes<F> kp, qp, kop, qip;
    kp.load(k_pay + o);
    qp.load(q_pay + o);
    kop.load(ko_pay + o);
    qip.load(qi_pay + o);
    const float k_old = k_sc[row], q_old = q_sc[row], ko_old = ko_sc[row], qi_old = qi_sc[row];
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
      ks[f] = deq_add(kp.at(f), k_old, pk[f]);
      qs[f] = deq_add(qp.at(f), q_old, x);
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
      kos[f] = deq_add(kop.at(f), ko_old, __fmul_rn(pk[f], src));
      qis[f] = deq_add(qip.at(f), qi_old, x);
      c0s += (pq(0, f) + eps) * (kos[f] + eps);
      c_src += (pk[f] + eps) * (qis[f] + eps);
    }
    warp_sum2(c0s, c_src);
    const float n_q = tf * fG;
    // lane 0: alloc = sigmoid(c0s / n_q); lane 1: e = exp(clip(c_src / t)),
    // z + e and t / (z + e) -- each step one division or exp for both
    const float r2 = (lane == 1 ? c_src : c0s) / (lane == 1 ? tf : n_q);
    const float ex = expf(lane == 1 ? fminf(fmaxf(r2, -1.f), 1.f) : -r2);
    const float den = (lane == 1 ? z_old : 1.f) + ex;
    const float r3 = (lane == 1 ? tf : 1.f) / den;
    const float alloc0 = __shfl_sync(kFull, r3, 0);
    if (lane == 0) alloc[0] = use_alloc ? alloc0 : 1.f;
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
#pragma unroll
    for (int i = 0; i < NV; ++i) sp[i].load(sb + (size_t)(i * kSThreads + s) * VB);
    s_old = s_sc[row];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int r = i * SH::RPL + s / SH::SPR;
      kr[i] = to_f32(kb[r]);
      qr[i] = to_f32(qb[r]);  // group 0
    }
    load_f<VB>(vb + c0, vc);
    v_out = to_f32(vb[s % D]);  // the column of this thread's outputs
    // this warp's partials of phi(q) @ deq(S)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      kr[i] = phi_fn(kr[i], phi);
#pragma unroll
      for (int j = 0; j < VB; ++j) sn[i][j] = __fmul_rn(sp[i].at(j), s_old);
    }
    for (int g = 0; g < G; ++g) {
      float acc[VB];
#pragma unroll
      for (int j = 0; j < VB; ++j) acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float p = phi_fn(
            g == 0 ? qr[i] : to_f32(qb[(size_t)g * D + i * SH::RPL + s / SH::SPR]), phi);
#pragma unroll
        for (int j = 0; j < VB; ++j) acc[j] += p * sn[i][j];
      }
      const int off = reduce_scatter<VB, SH::RB, SH::SPR>(acc, lane);
      float* dst = part + ((size_t)sw * G + g) * D + c0 + off;
#pragma unroll
      for (int j = 0; j < SH::NOUT; ++j) dst[j] = acc[j];
    }
  }
  __syncthreads();  // 1: the chain's scalars and every partial

  float sc_l = 0.f, sum_sc[4];  // warp 0: lane j's leaf scale; all four
  if (warp > 0) {
    const float e = scal[0], ratio = scal[1];
    for (int i = s; i < G * D; i += kSThreads) {
      const int g = i / D, c = i - g * D;
      float acc = part[(size_t)g * D + c];
#pragma unroll
      for (int w = 1; w < kSWarps; ++w) acc += part[((size_t)w * G + g) * D + c];
      const float y = sink[g] * (acc + dqk[g] * __fmul_rn(v_out, e));
      out[(size_t)row * G * D + i] = from_f32<T>(y * ratio * alloc[g]);
    }
    // S_new = deq(S) + phi(k) (v e)^T and this warp's amax
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < VB; ++j) vc[j] = __fmul_rn(vc[j], e);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        sn[i][j] = __fadd_rn(sn[i][j], __fmul_rn(kr[i], vc[j]));
        m = fmaxf(m, fabsf(sn[i][j]));
      }
    m = warp_max(m);
    if (lane == 0) red[sw] = m;
  } else {
    // the sums' fresh amaxes and scales while the S warps work; lane j < 4
    // divides for leaf j
    float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int f = 0; f < F; ++f) {
      m[0] = fmaxf(m[0], fabsf(ks[f]));
      m[1] = fmaxf(m[1], fabsf(qs[f]));
      m[2] = fmaxf(m[2], fabsf(kos[f]));
      m[3] = fmaxf(m[3], fabsf(qis[f]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], __shfl_xor_sync(kFull, m[j], off));
    const float mine = lane == 0 ? m[0] : lane == 1 ? m[1] : lane == 2 ? m[2] : m[3];
    sc_l = new_scale(mine);
#pragma unroll
    for (int j = 0; j < 4; ++j) sum_sc[j] = __shfl_sync(kFull, sc_l, j);
  }
  __syncthreads();  // 2: S's amax

  if (warp > 0) {  // S requantized in place
    float amax = red[0];
#pragma unroll
    for (int w = 1; w < kSWarps; ++w) amax = fmaxf(amax, red[w]);
    const float sc = new_scale(amax);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      sp[i].clear();
#pragma unroll
      for (int j = 0; j < VB; ++j) sp[i].set(j, quantize(sn[i][j], sc));
      sp[i].store(sb + (size_t)(i * kSThreads + s) * VB);
    }
    if (s == 0) s_sc[row] = sc;
  } else {
    // the sums' payloads, in place (their scales are the chain warp's sc)
    auto requant = [&](const float(&x)[F], float scale, int8_t* pay) {
      Bytes<F> b;
      b.clear();
#pragma unroll
      for (int f = 0; f < F; ++f) b.set(f, quantize(x[f], scale));
      b.store(pay + o);
    };
    requant(ks, sum_sc[0], k_pay);
    requant(qs, sum_sc[1], q_pay);
    requant(kos, sum_sc[2], ko_pay);
    requant(qis, sum_sc[3], qi_pay);
    if (lane < 4) (lane == 0 ? k_sc : lane == 1 ? q_sc : lane == 2 ? ko_sc : qi_sc)[row] = sc_l;
  }
}

struct Args {
  const void *t, *q, *k, *v;
  void *k_pay, *q_pay, *ko_pay, *qi_pay, *s_pay;
  void *k_sc, *q_sc, *ko_sc, *qi_sc, *s_sc, *z, *out;
};

template <typename T, int D, bool G1>
cudaError_t launch_g(const Args& a, int bh, int hkv, int g, int phi, int use_alloc, float eps,
                     cudaStream_t stream) {
  auto kern = flow_decode_q_kernel<T, D, G1>;
  const size_t bytes = smem_floats(g, D, G1) * sizeof(float);
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

template <typename T, int D>
cudaError_t launch(const Args& a, int bh, int hkv, int g, int phi, int use_alloc, float eps,
                   cudaStream_t stream) {
  if (g == 1) return launch_g<T, D, true>(a, bh, hkv, g, phi, use_alloc, eps, stream);
  return launch_g<T, D, false>(a, bh, hkv, g, phi, use_alloc, eps, stream);
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

template <typename T, int D>
int occupancy_of(int g) {
  int n = 0;
  cudaError_t err =
      g == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, flow_decode_q_kernel<T, D, true>, kThreads,
                   smem_floats(g, D, true) * sizeof(float))
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, flow_decode_q_kernel<T, D, false>, kThreads,
                   smem_floats(g, D, false) * sizeof(float));
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// t (B,) int32: each slot's count AFTER this token; q (BH, G, D), k (BH, D),
// v (BH, Dv) in `dtype` (0 fp32, 1 bf16) with BH = B * hkv; the int8
// payloads of the k/q/ko/qi sums (BH, D) and of S (BH, D, Dv), their fp32
// scales (BH,) each and the raw fp32 z (BH,) are updated in place; out
// (BH, G, Dv) in `dtype`.  D == Dv in {32, 64, 128}; every pointer 16-byte
// aligned.  Returns a cudaError_t.
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

// CTAs of the kernel an SM holds at once for (D, dtype, G), by its
// registers and shared memory; minus a cudaError_t on failure.
extern "C" int flow_decode_q_occupancy(int d, int dtype, int g) {
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

extern "C" const char* flow_decode_q_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
