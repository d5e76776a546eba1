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
//
// The wide pairs follow K3's designs (flow_decode.cu): D = 192 (Dv = 128 or
// 192: DeepSeek-V2's MLA heads, Nemotron-4-340B's) holds S by columns,
// Dv / 8 S warps of eight columns each, lane l rows l, l + 32, .. (six),
// eight payload bytes a row in one load; D = Dv = 256 (RecurrentGemma's)
// splits Dv over a cluster of four CTAs a row, one panel of 64 columns each
// (flow_decode_q_cols_kernel).  The chain warp is the same code at six or
// eight features a lane.  The cluster's CTAs must share S's fresh scale:
// their amaxes meet through distributed shared memory after a cluster
// barrier, before any CTA writes a payload (see the kernel).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cooperative_groups.h>

namespace {

namespace cgrp = cooperative_groups;

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
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float2 u = reinterpret_cast<const float2*>(p)[j];
      x[2 * j] = u.x, x[2 * j + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = p[j];
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
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[j];
      x[4 * j] = bf_lo(u.x), x[4 * j + 1] = bf_hi(u.x), x[4 * j + 2] = bf_lo(u.y),
      x[4 * j + 3] = bf_hi(u.y);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const unsigned u = reinterpret_cast<const unsigned*>(p)[j];
      x[2 * j] = bf_lo(u), x[2 * j + 1] = bf_hi(u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = __bfloat162float(p[j]);
  }
}

// N int8 payload bytes (N in {1, 2, 4, 8, 16}: one load; 6: three 2-byte
// loads, the chain's lanes at D = 192) as 32-bit words.
template <int N>
struct Bytes {
  static constexpr int W = N < 4 ? 1 : (N + 3) / 4;
  unsigned w[W];
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (N == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (N == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else if constexpr (N == 6) {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
      w[0] = (unsigned)h[0] | (unsigned)h[1] << 16, w[1] = h[2];
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
    } else if constexpr (N == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (N == 6) {
      unsigned short* h = reinterpret_cast<unsigned short*>(p);
      h[0] = (unsigned short)w[0], h[1] = (unsigned short)(w[0] >> 16),
      h[2] = (unsigned short)w[1];
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

// How a CTA holds a DK x PV panel of a DK x DV int8 S by columns (DK = 192,
// 256; K3's ColShape in flow_decode.cu): S warp w owns columns [8 w, 8 w +
// 8) of the panel in every row, lane l rows l + 32 i (i < NR), eight payload
// bytes a row in one load; a warp's sums over its lanes are sums over every
// row.  NP = DV / PV CTAs (a cluster where NP > 1) hold the panels.
template <int DK, int DV, int PV_>
struct ColShape {
  static constexpr int PV = PV_, NP = DV / PV_;  // panel width, panels (CTAs)
  static constexpr int CW = 8;              // columns an S warp owns
  static constexpr int SW = PV / CW;        // S warps
  static constexpr int ST = 32 * SW;        // S threads
  static constexpr int THREADS = 32 + ST;   // warp 0 runs the chain
  static constexpr int F = DK / 32;         // features a lane owns in the chain
  static constexpr int NR = DK / 32;        // rows an S lane owns
  static_assert(DK % 32 == 0 && PV % CW == 0 && NP * PV == DV && ST % PV == 0 &&
                    THREADS <= 1024 && NP <= 8,
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

// The pool's pointers and the step's scalars, as the kernels take them.
template <typename T>
struct QArgs {
  const int* __restrict__ t;
  const T *__restrict__ q, *__restrict__ k, *__restrict__ v;
  int8_t *__restrict__ k_pay, *__restrict__ q_pay, *__restrict__ ko_pay, *__restrict__ qi_pay,
      *__restrict__ s_pay;
  float *__restrict__ k_sc, *__restrict__ q_sc, *__restrict__ ko_sc, *__restrict__ qi_sc,
      *__restrict__ s_sc, *__restrict__ z;
  T* __restrict__ out;
  int hkv, G, phi, use_alloc;
  float eps;
};

// Warp 0's new sums (lane l owning features l F .. l F + F - 1) and, on
// lane 1, z + e.
template <int F>
struct Chain {
  float ks[F], qs[F], kos[F], qis[F], den;
};

// Warp 0's flow chain for (slot, kv head) `row`, with shuffles only: the four
// sums dequantized and advanced, the inflow/outflow dots with phi(q) .
// phi(k) in one interleaved butterfly, ko/qi, the conserved dots, alloc, e
// and z; the scalar divisions of a step run on separate lanes at once.  Its
// reads (the four sum payloads, F bytes a lane, their scales, z, t, the
// token's features) are issued first.  Leaves sink_in, alloc, phi(q) .
// phi(k) (G each) and e, t / z in shared memory; writes nothing global.
template <typename T, int DK, bool G1>
__device__ __forceinline__ void flow_chain(const QArgs<T>& a, int row, int lane, float* sink,
                                           float* alloc, float* dqk, float* scal, float* qch,
                                           Chain<DK / 32>& c) {
  constexpr int F = DK / 32;
  const int G = a.G, GG = G1 ? 1 : G, phi = a.phi;
  const float eps = a.eps;
  const T* qb = a.q + (size_t)row * G * DK;
  const T* kb = a.k + (size_t)row * DK;
  const size_t o = (size_t)row * DK + lane * F;
  const int f0 = lane * F;
  Bytes<F> kp, qp, kop, qip;
  kp.load(a.k_pay + o);
  qp.load(a.q_pay + o);
  kop.load(a.ko_pay + o);
  qip.load(a.qi_pay + o);
  const float k_old = a.k_sc[row], q_old = a.q_sc[row], ko_old = a.ko_sc[row],
              qi_old = a.qi_sc[row];
  const float z_old = a.z[row];
  const float tf = (float)a.t[row / a.hkv], fG = (float)G;  // count after this token
  float pk[F], pq0[F];
  load_f<F>(kb + f0, pk);
  load_f<F>(qb + f0, pq0);
#pragma unroll
  for (int f = 0; f < F; ++f) pk[f] = phi_fn(pk[f], phi), pq0[f] = phi_fn(pq0[f], phi);
  if (!G1) {
    for (int g = 0; g < G; ++g) {
      float x[F];
      load_f<F>(qb + (size_t)g * DK + f0, x);
#pragma unroll
      for (int f = 0; f < F; ++f) qch[g * DK + f0 + f] = phi_fn(x[f], phi);
    }
  }
  auto pq = [&](int g, int f) { return G1 ? pq0[f] : qch[g * DK + f0 + f]; };

  // level 1: the k and q sums; sink_in, src_out and phi(q) . phi(k)
  float a0 = 0.f, a_out = 0.f, d0 = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float x = 0.f;
    for (int g = 0; g < GG; ++g) x += pq(g, f);
    c.ks[f] = deq_add(kp.at(f), k_old, pk[f]);
    c.qs[f] = deq_add(qp.at(f), q_old, x);
    a0 += (pq(0, f) + eps) * (c.ks[f] + eps);
    a_out += (pk[f] + eps) * (c.qs[f] + eps);
    d0 += pq(0, f) * pk[f];
  }
  warp_sum3(a0, a_out, d0);
  // two divisions at once: lane 0 sink_in of group 0, lane 1 src_out
  const float r1 = (lane == 1 ? tf * fG : tf) / (lane == 1 ? a_out : a0);
  const float sink0 = __shfl_sync(kFull, r1, 0), src = __shfl_sync(kFull, r1, 1);
  if (lane == 0) sink[0] = sink0, dqk[0] = d0;
  for (int g = 1; g < GG; ++g) {
    float s = 0.f, dd = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      s += (pq(g, f) + eps) * (c.ks[f] + eps);
      dd += pq(g, f) * pk[f];
    }
    warp_sum2(s, dd);
    if (lane == 0) sink[g] = tf / s, dqk[g] = dd;
  }
  __syncwarp();
  // level 2: the ko and qi sums, the conserved flows
  float c0s = 0.f, c_src = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float x = 0.f;
    for (int g = 0; g < GG; ++g) x += __fmul_rn(pq(g, f), G1 ? sink0 : sink[g]);
    c.kos[f] = deq_add(kop.at(f), ko_old, __fmul_rn(pk[f], src));
    c.qis[f] = deq_add(qip.at(f), qi_old, x);
    c0s += (pq(0, f) + eps) * (c.kos[f] + eps);
    c_src += (pk[f] + eps) * (c.qis[f] + eps);
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
  if (lane == 0) alloc[0] = a.use_alloc ? alloc0 : 1.f;
  for (int g = 1; g < GG; ++g) {
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) s += (pq(g, f) + eps) * (c.kos[f] + eps);
    s = warp_sum(s);
    if (lane == 0) alloc[g] = a.use_alloc ? 1.f / (1.f + expf(-(s / n_q))) : 1.f;
  }
  c.den = den;
  if (lane == 1) {
    scal[0] = ex;  // e
    scal[1] = r3;  // t / z
  }
}

// Warp 0 after barrier 1: the four sums' fresh amaxes, lane j < 4 dividing
// for leaf j's scale; returns lane j's scale and all four in `sc`.
template <int F>
__device__ __forceinline__ float sum_scales(const Chain<F>& c, int lane, float (&sc)[4]) {
  float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int f = 0; f < F; ++f) {
    m[0] = fmaxf(m[0], fabsf(c.ks[f]));
    m[1] = fmaxf(m[1], fabsf(c.qs[f]));
    m[2] = fmaxf(m[2], fabsf(c.kos[f]));
    m[3] = fmaxf(m[3], fabsf(c.qis[f]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], __shfl_xor_sync(kFull, m[j], off));
  const float mine = lane == 0 ? m[0] : lane == 1 ? m[1] : lane == 2 ? m[2] : m[3];
  const float sc_l = new_scale(mine);
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = __shfl_sync(kFull, sc_l, j);
  return sc_l;
}

// Warp 0 after barrier 2: the sums' payloads in place, lane j < 4 leaf j's
// scale.
template <typename T, int F>
__device__ __forceinline__ void write_sums(const QArgs<T>& a, const Chain<F>& c, int row,
                                           int lane, float sc_l, const float (&sc)[4]) {
  const size_t o = (size_t)row * (32 * F) + lane * F;
  auto requant = [&](const float(&x)[F], float scale, int8_t* pay) {
    Bytes<F> b;
    b.clear();
#pragma unroll
    for (int f = 0; f < F; ++f) b.set(f, quantize(x[f], scale));
    b.store(pay + o);
  };
  requant(c.ks, sc[0], a.k_pay);
  requant(c.qs, sc[1], a.q_pay);
  requant(c.kos, sc[2], a.ko_pay);
  requant(c.qis, sc[3], a.qi_pay);
  if (lane < 4) (lane == 0 ? a.k_sc : lane == 1 ? a.q_sc : lane == 2 ? a.ko_sc : a.qi_sc)[row] = sc_l;
}

// Four CTAs an SM at D <= 64: ptxas then spills a few words at D = 64;
// three CTAs an SM, without the spill, ran slower at 1,024 slots.
template <typename T, int D, bool G1>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1)
flow_decode_q_kernel(const QArgs<T> a) {
  using SH = Shape<D>;
  constexpr int F = SH::F, VB = SH::VB, NV = SH::NV;
  extern __shared__ float sm[];
  const int G = a.G, phi = a.phi;
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
  const T* qb = a.q + (size_t)row * G * D;
  const T* kb = a.k + (size_t)row * D;
  const T* vb = a.v + (size_t)row * D;
  int8_t* sb = a.s_pay + (size_t)row * D * D;

  // warp 0's chain values, kept across barrier 1
  Chain<F> c;
  // the S warps' values: S's payload bytes, then deq(S), then S_new
  Bytes<VB> sp[NV];
  float sn[NV][VB];
  float s_old = 0.f, kr[NV], qr[NV], vc[VB], v_out = 0.f;
  const int c0 = (s % SH::SPR) * VB;

  if (warp == 0) {
    flow_chain<T, D, G1>(a, row, lane, sink, alloc, dqk, scal, qch, c);
    if (lane == 1) a.z[row] = c.den;  // z + e
  } else {
    // ---- entry of the S warps: every global read, as vector loads ----
#pragma unroll
    for (int i = 0; i < NV; ++i) sp[i].load(sb + (size_t)(i * kSThreads + s) * VB);
    s_old = a.s_sc[row];
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
      const int g = i / D, cc = i - g * D;
      float acc = part[(size_t)g * D + cc];
#pragma unroll
      for (int w = 1; w < kSWarps; ++w) acc += part[((size_t)w * G + g) * D + cc];
      const float y = sink[g] * (acc + dqk[g] * __fmul_rn(v_out, e));
      a.out[(size_t)row * G * D + i] = from_f32<T>(y * ratio * alloc[g]);
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
    // the sums' fresh amaxes and scales while the S warps work
    sc_l = sum_scales<F>(c, lane, sum_sc);
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
    if (s == 0) a.s_sc[row] = sc;
  } else {
    // the sums' payloads, in place (their scales are the chain warp's sc)
    write_sums<T, F>(a, c, row, lane, sc_l, sum_sc);
  }
}

// The column layout (ColShape): D = 192 beside Dv = 128 or 192 in one CTA of
// Dv / 8 S warps (544 or 800 threads), D = Dv = 256 as a cluster of four
// CTAs a row, one panel of 64 columns each (288 threads).  The chain warp is
// the row layout's; the S warps hold S by columns, so one G x PV row of
// partials suffices.  The requantize takes one amax over the whole (D, Dv)
// state: in a cluster each CTA's S warps leave their amaxes in shared
// memory, and after a cluster barrier every CTA reads all NP x SW of them
// through distributed shared memory, in rank and warp order, before any
// payload is written; all four then hold the same scale.  The four sums, z
// and the S scale, which every CTA reads at entry, are written only by the
// first panel's CTA and only after that barrier; a last cluster barrier
// keeps every CTA's shared memory alive until the others have read it.
template <typename T, int DK, int DV, int PV, bool G1>
__global__ void __launch_bounds__(ColShape<DK, DV, PV>::THREADS, 1)
flow_decode_q_cols_kernel(const QArgs<T> a) {
  using SH = ColShape<DK, DV, PV>;
  constexpr int F = SH::F, CW = SH::CW, NR = SH::NR, SW = SH::SW, ST = SH::ST, NP = SH::NP;
  extern __shared__ float sm[];
  const int G = a.G, phi = a.phi;
  float* part = sm;                  // G x PV
  float* sink = part + G * PV;
  float* alloc = sink + G;
  float* dqk = alloc + G;
  float* scal = dqk + G;             // [0] e, [1] t / z
  float* red = scal + 2;             // SW: the S warps' amaxes
  float* qch = red + SW;             // G x DK, G > 1 only
  float* vsm = qch + (G1 ? 0 : G * DK);  // PV: v at the panel's columns
  // NP CTAs (one cluster) a row, each the PV columns from p0
  const int row = blockIdx.x / NP, p0 = (blockIdx.x % NP) * PV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int si = threadIdx.x - 32, sw = warp - 1;  // S warps: thread si of ST
  const int cw0 = sw * CW;  // the S warp's columns within the panel
  const T* qb = a.q + (size_t)row * G * DK;
  const T* kb = a.k + (size_t)row * DK;
  const T* vb = a.v + (size_t)row * DV;
  int8_t* sb = a.s_pay + (size_t)row * DK * DV;

  Chain<F> c;
  Bytes<CW> sp[NR];
  float sn[NR][CW];
  float kr[NR], vc[CW];

  if (warp == 0) {
    flow_chain<T, DK, G1>(a, row, lane, sink, alloc, dqk, scal, qch, c);
    if constexpr (NP == 1)
      if (lane == 1) a.z[row] = c.den;  // z + e
  } else {
    // ---- entry of the S warps: S (eight bytes a row), phi(k) at the
    // lane's rows, v into shared memory ----
#pragma unroll
    for (int i = 0; i < NR; ++i) sp[i].load(sb + (size_t)(i * 32 + lane) * DV + p0 + cw0);
    const float s_old = a.s_sc[row];
#pragma unroll
    for (int i = 0; i < NR; ++i) kr[i] = to_f32(kb[i * 32 + lane]);
    if (si < PV) vsm[si] = to_f32(vb[p0 + si]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      kr[i] = phi_fn(kr[i], phi);
#pragma unroll
      for (int j = 0; j < CW; ++j) sn[i][j] = __fmul_rn(sp[i].at(j), s_old);
    }
    // the warp's columns of phi(q) @ deq(S) over every row
    for (int g = 0; g < G; ++g) {
      float acc[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float p = phi_fn(to_f32(qb[(size_t)g * DK + i * 32 + lane]), phi);
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[j] += p * sn[i][j];
      }
      // lane bits 0-2 scatter the eight columns, bits 3-4 sum the rest
      const int off = reduce_scatter<CW, 3, 1>(acc, lane);
      acc[0] += __shfl_xor_sync(kFull, acc[0], 8);
      acc[0] += __shfl_xor_sync(kFull, acc[0], 16);
      if (lane < CW) part[(size_t)g * PV + cw0 + off] = acc[0];
    }
  }
  __syncthreads();  // 1: the chain's scalars and every partial

  float sc_l = 0.f, sum_sc[4];  // warp 0: lane j's leaf scale; all four
  if (warp > 0) {
    const float e = scal[0], ratio = scal[1];
    const float v_out = vsm[si % PV];  // the column of this thread's outputs
    for (int i = si; i < G * PV; i += ST) {
      const int g = i / PV, cc = i - g * PV;
      const float y = sink[g] * (part[(size_t)g * PV + cc] + dqk[g] * __fmul_rn(v_out, e));
      a.out[((size_t)row * G + g) * DV + p0 + cc] = from_f32<T>(y * ratio * alloc[g]);
    }
    // S_new = deq(S) + phi(k) (v e)^T and this warp's amax
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) vc[j] = __fmul_rn(vsm[cw0 + j], e);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        sn[i][j] = __fadd_rn(sn[i][j], __fmul_rn(kr[i], vc[j]));
        m = fmaxf(m, fabsf(sn[i][j]));
      }
    m = warp_max(m);
    if (lane == 0) red[sw] = m;
  } else {
    sc_l = sum_scales<F>(c, lane, sum_sc);
  }
  float amax = 0.f;
  if constexpr (NP == 1) {
    __syncthreads();  // 2: S's amax
    if (warp > 0) {
      amax = red[0];
#pragma unroll
      for (int w = 1; w < SW; ++w) amax = fmaxf(amax, red[w]);
    }
  } else {
    // 2: every CTA's S amaxes, and every CTA has read the sums, z and the
    // old scales
    cgrp::cluster_group cluster = cgrp::this_cluster();
    cluster.sync();
    if (warp > 0) {
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        const float* rr = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int w = 0; w < SW; ++w) amax = fmaxf(amax, rr[w]);  // every amax >= 0
      }
    }
  }

  if (warp > 0) {  // this panel of S requantized in place
    const float sc = new_scale(amax);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      sp[i].clear();
#pragma unroll
      for (int j = 0; j < CW; ++j) sp[i].set(j, quantize(sn[i][j], sc));
      sp[i].store(sb + (size_t)(i * 32 + lane) * DV + p0 + cw0);
    }
    if (si == 0 && p0 == 0) a.s_sc[row] = sc;
  } else if (p0 == 0) {
    // the sums' payloads and scales in place, and z + e where a cluster
    // deferred it
    write_sums<T, F>(a, c, row, lane, sc_l, sum_sc);
    if constexpr (NP > 1)
      if (lane == 1) a.z[row] = c.den;
  }
  if constexpr (NP > 1) cgrp::this_cluster().sync();  // the others read red
}

template <typename T, int D, bool G1>
cudaError_t launch_rows(const QArgs<T>& a, int bh, cudaStream_t stream) {
  auto kern = flow_decode_q_kernel<T, D, G1>;
  const size_t bytes = smem_floats(a.G, D, G1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

__host__ __device__ constexpr size_t cols_smem_floats(int g, int dk, int pv, int sw, bool g1) {
  return (size_t)g * pv        // partials of phi(q) @ deq(S): whole sums
         + 3 * (size_t)g + 2   // sink_in, alloc, phi(q) . phi(k); e, t / z
         + sw                  // S's per-warp amax
         + (g1 ? 0 : (size_t)g * dk)  // the chain's phi(q)
         + pv;                 // v at the panel's columns
}

template <typename T, int DK, int DV, int PV, bool G1>
cudaError_t launch_cols(const QArgs<T>& a, int bh, cudaStream_t stream) {
  using SH = ColShape<DK, DV, PV>;
  auto kern = flow_decode_q_cols_kernel<T, DK, DV, PV, G1>;
  const size_t bytes = cols_smem_floats(a.G, DK, PV, SH::SW, G1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if constexpr (SH::NP == 1) {
    kern<<<bh, SH::THREADS, bytes, stream>>>(a);
  } else {  // a cluster of NP CTAs a row, one a panel of Dv
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(bh * SH::NP, 1, 1);
    cfg.blockDim = dim3(SH::THREADS, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = SH::NP;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, a);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The (D, Dv) pairs with an instantiation: D == Dv in {32, 64, 128, 256},
// and D = 192 beside Dv = 128 or 192 (K3's, flow_decode.cu).
inline bool takes(int d, int dv) {
  if (d == 192) return dv == 128 || dv == 192;
  if (d == 256) return dv == 256;
  return d == dv && (d == 32 || d == 64 || d == 128);
}

template <typename T, bool G1>
cudaError_t dispatch_g(int d, int dv, const QArgs<T>& a, int bh, cudaStream_t st) {
  if (d == 192)
    return dv == 128 ? launch_cols<T, 192, 128, 128, G1>(a, bh, st)
                     : launch_cols<T, 192, 192, 192, G1>(a, bh, st);
  switch (d) {
    case 256: return launch_cols<T, 256, 256, 64, G1>(a, bh, st);
    case 32: return launch_rows<T, 32, G1>(a, bh, st);
    case 64: return launch_rows<T, 64, G1>(a, bh, st);
    case 128: return launch_rows<T, 128, G1>(a, bh, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int d, int dv, const QArgs<T>& a, int bh, cudaStream_t st) {
  return a.G == 1 ? dispatch_g<T, true>(d, dv, a, bh, st) : dispatch_g<T, false>(d, dv, a, bh, st);
}

template <typename T>
QArgs<T> args_of(const void* t, const void* q, const void* k, const void* v, void* k_pay,
                 void* q_pay, void* ko_pay, void* qi_pay, void* s_pay, void* k_sc, void* q_sc,
                 void* ko_sc, void* qi_sc, void* s_sc, void* z, void* out, int hkv, int g,
                 int phi, int use_alloc, float eps) {
  return QArgs<T>{(const int*)t, (const T*)q, (const T*)k, (const T*)v, (int8_t*)k_pay,
                  (int8_t*)q_pay, (int8_t*)ko_pay, (int8_t*)qi_pay, (int8_t*)s_pay,
                  (float*)k_sc, (float*)q_sc, (float*)ko_sc, (float*)qi_sc, (float*)s_sc,
                  (float*)z, (T*)out, hkv, g, phi, use_alloc, eps};
}

// The kernel's dynamic shared memory is allowed first, as a launch allows
// it: above 48 KB the calculator otherwise answers 0.
template <class K>
int occupancy(K kern, int threads, size_t bytes) {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, bytes);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, bool G1>
int occupancy_g(int d, int dv, int g) {
  auto cols = [&](auto kern, int dk, int pv, int sw, int threads) {
    return occupancy(kern, threads, cols_smem_floats(g, dk, pv, sw, G1) * sizeof(float));
  };
  if (d == 192 && dv == 128) {
    using SH = ColShape<192, 128, 128>;
    return cols(flow_decode_q_cols_kernel<T, 192, 128, 128, G1>, 192, 128, SH::SW, SH::THREADS);
  }
  if (d == 192 && dv == 192) {
    using SH = ColShape<192, 192, 192>;
    return cols(flow_decode_q_cols_kernel<T, 192, 192, 192, G1>, 192, 192, SH::SW, SH::THREADS);
  }
  if (d == 256 && dv == 256) {
    using SH = ColShape<256, 256, 64>;
    return cols(flow_decode_q_cols_kernel<T, 256, 256, 64, G1>, 256, 64, SH::SW, SH::THREADS);
  }
  if (d != dv) return -(int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(g, d, G1) * sizeof(float);
  if (d == 32) return occupancy(flow_decode_q_kernel<T, 32, G1>, kThreads, bytes);
  if (d == 64) return occupancy(flow_decode_q_kernel<T, 64, G1>, kThreads, bytes);
  if (d == 128) return occupancy(flow_decode_q_kernel<T, 128, G1>, kThreads, bytes);
  return -(int)cudaErrorInvalidValue;
}

template <typename T>
int occupancy_at(int d, int dv, int g) {
  return g == 1 ? occupancy_g<T, true>(d, dv, g) : occupancy_g<T, false>(d, dv, g);
}

}  // namespace

// t (B,) int32: each slot's count AFTER this token; q (BH, G, D), k (BH, D),
// v (BH, Dv) in `dtype` (0 fp32, 1 bf16) with BH = B * hkv; the int8
// payloads of the k/q/ko/qi sums (BH, D) and of S (BH, D, Dv), their fp32
// scales (BH,) each and the raw fp32 z (BH,) are updated in place; out
// (BH, G, Dv) in `dtype`.  D == Dv in {32, 64, 128, 256}, or D = 192 with
// Dv = 128 or 192 (D = 256 as a cluster of four CTAs a row); every pointer
// 16-byte aligned.  Returns a cudaError_t.
extern "C" int flow_decode_q_fwd(const void* t, const void* q, const void* k, const void* v,
                                 void* k_pay, void* q_pay, void* ko_pay, void* qi_pay,
                                 void* s_pay, void* k_sc, void* q_sc, void* ko_sc,
                                 void* qi_sc, void* s_sc, void* z, void* out, int bh,
                                 int hkv, int g, int d, int dv, int dtype, int phi,
                                 int use_alloc, float eps, void* stream) {
  if (!takes(d, dv) || g < 1 || hkv < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, dv, args_of<float>(t, q, k, v, k_pay, q_pay, ko_pay, qi_pay,
                                                      s_pay, k_sc, q_sc, ko_sc, qi_sc, s_sc, z,
                                                      out, hkv, g, phi, use_alloc, eps),
                                bh, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(
        d, dv, args_of<__nv_bfloat16>(t, q, k, v, k_pay, q_pay, ko_pay, qi_pay, s_pay, k_sc,
                                      q_sc, ko_sc, qi_sc, s_sc, z, out, hkv, g, phi, use_alloc,
                                      eps),
        bh, st);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the kernel an SM holds at once for (D, Dv, dtype, G), by its
// registers and shared memory; minus a cudaError_t on failure.
extern "C" int flow_decode_q_occupancy_dv(int d, int dv, int dtype, int g) {
  if (g < 1) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return occupancy_at<float>(d, dv, g);
  if (dtype == 1) return occupancy_at<__nv_bfloat16>(d, dv, g);
  return -(int)cudaErrorInvalidValue;
}

// flow_decode_q_occupancy_dv at D == Dv.
extern "C" int flow_decode_q_occupancy(int d, int dtype, int g) {
  return flow_decode_q_occupancy_dv(d, d, dtype, g);
}

extern "C" const char* flow_decode_q_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
