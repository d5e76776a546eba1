// flow_nc_common.cuh — pieces shared by the non-causal Flow-Attention
// kernels for Hopper (sm_90a): flow_nc_qside.cu (K7a; K7b for its sigmoid)
// and, for its shuffle sums and bf16 stores, flow_nc_fused.cu (K6).
//
// Two routes by head dim.  At D = 32, 64 and 128 the kernels below and in
// the two sources (K6 and K7b on the tensor cores); at the small head dims
// of the vision and time-series encoders, D = 6, 8, 12, 16, 24 and 48, the
// `Small` route at the end of this file: one row a thread, fp32 FMA.
//
// K7a streams rows of a (rows, D)
// matrix and multiplies staged tiles of them with a D x D fp32 kv held in
// shared memory.  Two thread layouts of a 256-thread block serve it:
//
//  * streaming: each thread loads 16 bytes (VEC elements) of one row, LG
//    consecutive lanes cover a row, RP rows per pass of the block.  Row
//    dot products reduce over the LG lanes with shuffles, so the flows of
//    a row need no shared memory; column sums stay in registers per
//    thread and are reduced over the row groups once, in a fixed order.
//  * products: thread (ty, tx) owns the 4-wide column block tx*4.. of a
//    D-wide output and RT rows of a kTile-row tile (tile x state).
//    Operands are read from shared memory as float4; every product is fp32 FMA on the CUDA cores
//    (no tensor cores, no TF32), each sum in a fixed order, so results are
//    deterministic and match the plain PyTorch versions to fp32
//    reassociation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flow_nc {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows staged in shared memory at a time

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T, int D>
struct Layout {
  static_assert(D == 32 || D == 64 || D == 128, "head dim must be 32, 64 or 128");
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
  static constexpr int LG = D / VEC;               // lanes per streamed row
  static constexpr int RP = kThreads / LG;         // rows per streaming pass
  static constexpr int TX = D / 4;                 // products: 4-wide column blocks
  static constexpr int TY = kThreads / TX;
  static constexpr int RT = kTile / TY;            // tile rows per thread
  static_assert(LG <= 32 && 32 % LG == 0 && kTile % RP == 0, "streaming layout");
  static_assert(TX <= 32 && kTile % TY == 0, "product layout");
};

// 16 bytes of a row in device memory, as VEC floats
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// four consecutive outputs of a row (bf16: round to nearest even, as torch's
// .to(bfloat16))
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// n (a multiple of 4) floats into shared memory
template <int N>
__device__ __forceinline__ void store_smem(float* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// sum over the W consecutive lanes that share a row (W a power of two <= 32)
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void fma_row(const float4 x, const float4 (&b)[4], float (&acc)[4]) {
  acc[0] = fmaf(x.x, b[0].x, acc[0]); acc[1] = fmaf(x.x, b[0].y, acc[1]);
  acc[2] = fmaf(x.x, b[0].z, acc[2]); acc[3] = fmaf(x.x, b[0].w, acc[3]);
  acc[0] = fmaf(x.y, b[1].x, acc[0]); acc[1] = fmaf(x.y, b[1].y, acc[1]);
  acc[2] = fmaf(x.y, b[1].z, acc[2]); acc[3] = fmaf(x.y, b[1].w, acc[3]);
  acc[0] = fmaf(x.z, b[2].x, acc[0]); acc[1] = fmaf(x.z, b[2].y, acc[1]);
  acc[2] = fmaf(x.z, b[2].z, acc[2]); acc[3] = fmaf(x.z, b[2].w, acc[3]);
  acc[0] = fmaf(x.w, b[3].x, acc[0]); acc[1] = fmaf(x.w, b[3].y, acc[1]);
  acc[2] = fmaf(x.w, b[3].z, acc[2]); acc[3] = fmaf(x.w, b[3].w, acc[3]);
}

// acc[i][j] += sum_a A[(ty*RT + i)*D + a] * B[a*D + tx*4 + j]: RT rows of a
// staged (kTile, D) tile times a D x D matrix, both in shared memory.
template <int D, int RT>
__device__ __forceinline__ void rows_times_mat(const float* A, const float* B, int ty, int tx,
                                               float (&acc)[RT][4]) {
#pragma unroll 2
  for (int a = 0; a < D; a += 4) {
    float4 b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) b[kk] = ld4(B + (a + kk) * D + tx * 4);
#pragma unroll
    for (int i = 0; i < RT; ++i) fma_row(ld4(A + (ty * RT + i) * D + a), b, acc[i]);
  }
}

// The sink side over rows [r_begin, r_end) of one (batch * kv head), given
// the key-side reductions in shared memory (kv_s D x D, ksum_s, kosum_s):
//   phi = sigmoid(q);  I = (phi+eps).(k_sum+eps);  C = (phi+eps).(ko_sum+eps)
//   out = sigmoid(C * sink_scale) * ((phi / I) @ kv) * out_scale
// K6's phase D (out_scale = m / z, the deferred softmax normalizer) and K7a
// (out_scale = 1).  tile_s (kTile x D) and rs_s (kTile) are scratch; the
// block is synchronized on entry and on return.
template <typename T, int D>
__device__ void sink_rows(const T* __restrict__ q, T* __restrict__ out, int r_begin, int r_end,
                          const float* kv_s, const float* ksum_s, const float* kosum_s,
                          float* tile_s, float* rs_s, float eps, float sink_scale,
                          float out_scale) {
  using L = Layout<T, D>;
  const int tid = threadIdx.x;
  const int cg = tid % L::LG, rg = tid / L::LG, col0 = cg * L::VEC;
  const int tx = tid % L::TX, ty = tid / L::TX;
  for (int t0 = r_begin; t0 < r_end; t0 += kTile) {
    for (int p = 0; p < kTile; p += L::RP) {
      const int tr = p + rg, r = t0 + tr;
      float x[L::VEC] = {};
      if (r < r_end) load16(q + (size_t)r * D + col0, x);
      float inc = 0.f, con = 0.f;
#pragma unroll
      for (int i = 0; i < L::VEC; ++i) {
        x[i] = sigmoid(x[i]);
        inc = fmaf(x[i] + eps, ksum_s[col0 + i] + eps, inc);
        con = fmaf(x[i] + eps, kosum_s[col0 + i] + eps, con);
      }
      inc = group_sum<L::LG>(inc);
      con = group_sum<L::LG>(con);
      store_smem<L::VEC>(tile_s + tr * D + col0, x);
      if (cg == 0) rs_s[tr] = sigmoid(con * sink_scale) / inc * out_scale;
    }
    __syncthreads();
    float acc[L::RT][4] = {};
    rows_times_mat<D, L::RT>(tile_s, kv_s, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < L::RT; ++i) {
      const int t = ty * L::RT + i, r = t0 + t;
      if (r < r_end) {
        const float s = rs_s[t];
        const float y[4] = {acc[i][0] * s, acc[i][1] * s, acc[i][2] * s, acc[i][3] * s};
        store4(out + (size_t)r * D + tx * 4, y);
      }
    }
    __syncthreads();
  }
}

// ---- the small-head route ----------------------------------------------------
//
// D in {6, 8, 12, 16, 24, 48}.  A row is D * sizeof(T) bytes (12 in bf16 at
// D = 6), not a whole number of 16-byte loads, and the tensor-core layouts
// want D a multiple of 16.  Here each thread owns whole rows: D is even, so
// a row's elements come in pairs of 4 bytes (bf16) or 8 (fp32), aligned
// wherever the tensor's base is, and its dot products and its products
// with a D x D matrix in shared memory (read by every lane at once) are
// fp32 FMA on the CUDA cores in index order.  Every sum over rows runs in a
// fixed order -- over a thread's rows, over a warp's lanes by a butterfly,
// over the warps in order -- and no float atomics, so two calls give the
// same bits.  The products at these widths are a few operations per byte
// read (2 D per element), so the CUDA cores' fp32 rate is no bound here.

template <int D>
__host__ __device__ constexpr bool small_dim() {
  return D == 6 || D == 8 || D == 12 || D == 16 || D == 24 || D == 48;
}

template <int D>
struct Small {
  static_assert(small_dim<D>(), "the small route takes D in {6, 8, 12, 16, 24, 48}");
  static constexpr int THREADS = D >= 48 ? 128 : 256;  // rows of a tile, one a thread
  static constexpr int WARPS = THREADS / 32;
  // at most 128 registers a thread: two rows' D floats stay live at most
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// elements c, c + 1 (c even) of a row, rounded to T (bf16: to nearest even,
// as torch's .to(bfloat16))
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the D elements of a row, in pairs
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 2) {
    const float2 f = load_pair(p + i);
    x[i] = f.x;
    x[i + 1] = f.y;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 2) store2(p + i, x[i], x[i + 1]);
}

// dst[c] (c < N) = x[c] summed over the block's threads: over a warp's lanes
// by a butterfly (every lane ends with the same bits), then over the warps
// in order.  red holds WARPS * N floats.  Every thread must call it; it
// synchronizes the block once, and threads c < N write dst after that.
template <int N, int WARPS>
__device__ __forceinline__ void block_sum(float (&x)[N], float* red, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[c] += __shfl_xor_sync(0xffffffffu, x[c], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < N; ++c) red[warp * N + c] = x[c];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * N + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// out[c] = sum_d x[d] m[d * D + c] for a D x D matrix m in shared memory
// (the same address in every lane: a broadcast)
template <int D>
__device__ __forceinline__ void row_times_mat(const float (&x)[D], const float* m,
                                              float (&out)[D]) {
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int c = 0; c < D; ++c) out[c] = fmaf(x[d], m[d * D + c], out[c]);
}

// Who sums which entries of an (R x C) sum over a tile's rows,
// sum_r A(r, i) B(r, j): NP = R C entries over THREADS threads.  Where NP
// fits G >= 2 times, G groups of NP threads each take every G-th row and the
// groups' sums are added in group order (group_total); otherwise each
// thread owns EPT entries, tid + i THREADS, over every row.
template <int NP, int THREADS>
struct Owners {
  static constexpr int G = NP <= THREADS ? THREADS / NP : 1;
  static constexpr int EPT = (NP + THREADS - 1) / THREADS;
  int grp, p0;
  __device__ __forceinline__ Owners()
      : grp(G > 1 ? (int)threadIdx.x / NP : 0), p0(G > 1 ? (int)threadIdx.x % NP : (int)threadIdx.x) {}
  __device__ __forceinline__ bool active() const { return grp < G; }
  __device__ __forceinline__ int entry(int i) const { return p0 + i * THREADS; }
};

// The entries' totals: dst(p) gets entry p's sum (the G groups in order).
// scratch holds THREADS floats; every thread must call it (one barrier
// where G > 1); dst is written by the owners after it.
template <int NP, int THREADS, typename Dst>
__device__ __forceinline__ void group_total(const Owners<NP, THREADS>& o,
                                            const float (&acc)[Owners<NP, THREADS>::EPT],
                                            float* scratch, Dst dst) {
  using O = Owners<NP, THREADS>;
  if constexpr (O::G > 1) {
    if (o.active()) scratch[threadIdx.x] = acc[0];
    __syncthreads();
    if ((int)threadIdx.x < NP) {
      float s = 0.f;
      for (int g = 0; g < O::G; ++g) s += scratch[g * NP + threadIdx.x];
      dst((int)threadIdx.x, s);
    }
  } else {
#pragma unroll
    for (int i = 0; i < O::EPT; ++i)
      if (o.entry(i) < NP) dst(o.entry(i), acc[i]);
  }
}

}  // namespace flow_nc
