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
// head) into contiguous runs of `rows` (flow_nc_qside_bwd_rows: whole
// tiles, as few blocks as fill the SMs once), one block each, writes each
// block's partial sums to a scratch (BH, splits, 2 D + D Dv) the wrapper
// allocates, and a second launch adds the partials in split order: a fixed
// order of summation, so the result is the same on every run.
//
// What bounds them on the H100: K7a does 2 D Dv operations per row against
// 2 (D + Dv) bytes (bf16), K7b 6 D Dv against 2 (2 D + Dv): both above the
// fp32 FMA rate's balance point with the card's memory (about 20
// operations per byte), so the products bound them.  K7a does them in fp32
// FMA on the CUDA cores; K7b on the tensor cores in 3xTF32
// (tensor_core.cuh), which leaves about 0.09 ms of work at the LRA shape
// against the 0.20 ms of its fp32 bound.  It takes ~0.36 ms there: the
// products near the card's mma.sync rate while they run, and the
// elementwise chain around them (the accurate sigmoid and IEEE divisions),
// which twelve warps an SM do not hide (PERF.md).
//
// Design: rows are independent.  K7a streams 64-row tiles of q through
// shared memory with kv resident beside them, each head over blocks of 256
// rows.  K7b (see its kernel below) gives each warp 16-row blocks: its q
// and g rows land by cp.async in the fp32 tiles that then hold phi and u;
// the row dots are quad shuffles in the accumulators' layout; agg = phi @
// kv and w = u @ kv^T run on the tensor cores, kv staged once in one
// swizzled fp32 layout, read down its columns by the first product and
// along its rows by the second, and split once into tf32 heads and rests
// (split as it is read at D = 128, where both copies would not fit); then
// phi^T [u | dI, dC] adds the tile to the block's dkv, dk_sum and dko_sum,
// in registers.  Three blocks of 128 threads an SM at D = 64.
//
// The small head dims (D = 6, 8, 12, 16, 24, 48) take K7a's and K7b's
// small-head kernels: the same chains, one row a thread in fp32 FMA on the
// CUDA cores (flow_nc_common.cuh), K7b's reductions summed by owner threads
// over each tile's rows in order and added across blocks by the same
// reduce launch.  The C entries pick the route by D.
#include "flow_nc_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace flow_nc;
using namespace tc;

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

// ---- K7b ----------------------------------------------------------------------

// The fp32 tiles of K7b (kv, phi, u) have a stride of LD = D + 8 floats (8
// mod 32) with columns swapped in 8s by bit 2 of the row: reads along a row
// (two floats a lane) and down a column (one) are both free of bank
// conflicts.  A row of q or g lands first in its phi or u row as raw bytes,
// 16-byte chunks swapped the same way (fp32: the same layout).
__device__ __forceinline__ int swz(int r, int c) { return c ^ ((r & 4) << 1); }

template <typename T>
__device__ __forceinline__ int raw_word(int r, int w) {
  return sizeof(T) == 4 ? w ^ ((r & 4) << 1) : w ^ (r & 4);
}

// elements c, c + 1 (c even) of a raw row staged at `row`
__device__ __forceinline__ float2 raw_pair(const float* row, int r, int c, float) {
  return *reinterpret_cast<const float2*>(row + raw_word<float>(r, c));
}
__device__ __forceinline__ float2 raw_pair(const float* row, int r, int c, __nv_bfloat16) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(row + raw_word<__nv_bfloat16>(r, c / 2)));
}

// sum over the four lanes of a quad (t = lane % 4), in a fixed order
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// kv's tf32 head and rest at float offset i: read from the split copies,
// or split as read
template <bool PRESPLIT>
__device__ __forceinline__ void kv_frag(const float* kv_s, const float* kv_lo, int i,
                                        uint32_t& hi, uint32_t& lo) {
  if constexpr (PRESPLIT) {
    hi = __float_as_uint(kv_s[i]);
    lo = __float_as_uint(kv_lo[i]);
  } else {
    split_tf32(kv_s[i], hi, lo);
  }
}

template <int D>
struct BwdCfg {
  static constexpr int W = D >= 128 ? 8 : 4;  // warps: one per 16-row strip of dkv at least
  static constexpr int THREADS = 32 * W;
  static constexpr int TR = 16 * W;           // rows per tile, 16 a warp
  static constexpr int LD = D + 8;
  static constexpr int NK = D / 8;            // 8-wide k-steps and n-tiles over D
  static constexpr int STRIPS = D / 16;       // 16-row strips of dkv
  static constexpr int WS = W / STRIPS;       // warps sharing a strip's columns
  static constexpr int NTS = NK / WS;         // a warp's 8-column tiles of dkv
  // kv split once into tf32 heads and rests where both fit beside the
  // tiles at three blocks an SM, else split as it is read (D = 128)
  static constexpr bool PRESPLIT = D <= 64;
  static constexpr int FLOATS = (PRESPLIT ? 2 : 1) * D * LD + 2 * TR * LD + 2 * D;
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
  static constexpr int PART = 2 * D + D * D;  // a block's partial, in floats
  static_assert(WS * STRIPS == W && NTS * WS == NK, "dkv layout");
};

// One CTA owns rows [split rows, (split + 1) rows) of one (batch * head),
// walked in tiles of TR rows.  Per tile each warp stages its 16 rows of q
// and g with cp.async and runs them on the tensor cores (3xTF32):
//   phi, I, C, alloc (the row dots with quad shuffles);
//   agg I = phi @ kv;  dalloc = g . agg;  u = g alloc / I;
//   w = u @ kv^T (u's accumulators are its A fragments);
//   dI = -(w . phi) / I;  dC = dalloc alloc (1 - alloc) n/m;
//   dq = (w + dI (k_sum + eps) + dC (ko_sum + eps)) phi (1 - phi),
// leaving phi, u and [dI, dC] in shared memory.  Then every warp adds the
// tile's rows to its block of [dkv | dk_sum, dko_sum] = phi^T [u | dI, dC]
// (its 16-row strip of D and its share of the columns; dk_sum and dko_sum
// as a ninth 8-column tile, A phi + eps and B [dI, dC] in u's padding
// columns, whose other six columns are never stored), kept in registers across
// the tiles.  At the end the CTA writes its partial to part[bh][split],
// which a second launch adds in split order.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS, BwdCfg<D>::MIN_BLOCKS)
flow_nc_qside_bwd_kernel(const T* __restrict__ q, const float* __restrict__ k_sum,
                         const float* __restrict__ ko_sum, const float* __restrict__ kv,
                         const T* __restrict__ g, T* __restrict__ dq, float* __restrict__ part,
                         int n, int rows, float eps, float sink_scale) {
  using B = BwdCfg<D>;
  constexpr int LD = B::LD, NK = B::NK, TR = B::TR;
  constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks of a raw row
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);   // D x D: kv, then its heads
  float* kv_lo = kv_s + D * LD;                     // D x D: the rests (PRESPLIT)
  float* P = kv_lo + (B::PRESPLIT ? D * LD : 0);    // TR x D: raw q, then phi
  float* Ut = P + TR * LD;                          // TR x D: raw g, then u; and
  float* X = Ut + D;                                // its padding: [dI, dC] (stride LD)
  float* kse = Ut + TR * LD;                        // k_sum + eps
  float* kose = kse + D;                            // ko_sum + eps

  const size_t bh = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
  const T* qb = q + bh * n * D;
  const T* gb = g + bh * n * D;
  T* dqb = dq + bh * n * D;

  const float* kvb = kv + bh * D * D;
  for (int i = tid; i < D * D / 4; i += B::THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    cp_async16(kv_s + r * LD + swz(r, c), kvb + r * D + c);
  }
  if (tid < D) {
    kse[tid] = k_sum[bh * D + tid] + eps;
    kose[tid] = ko_sum[bh * D + tid] + eps;
  }
  if constexpr (B::PRESPLIT) {  // kv's heads and rests, once; the loop's first barrier
                                // shows them
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < D * LD; i += B::THREADS) {
      uint32_t hi, lo;
      split_tf32(kv_s[i], hi, lo);
      kv_s[i] = __uint_as_float(hi);
      kv_lo[i] = __uint_as_float(lo);
    }
  }

  // the dkv phase's ownership: strip s (rows m0.. of D), column share c
  const int m0 = 16 * (warp % B::STRIPS), share = warp / B::STRIPS, n0 = share * 8 * B::NTS;
  const bool sums = share == 0;  // this warp also keeps dk_sum, dko_sum of its strip
  float acc[B::NTS][4], ext[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < B::NTS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int r_begin = split * rows, r_end = min(n, r_begin + rows);
  const int ra = 16 * warp + g8, rb = ra + 8;  // this thread's rows of a tile
  for (int t0 = r_begin; t0 < r_end; t0 += TR) {
    // this warp's 16 rows of q and g, raw, zeros at or past r_end
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = 16 * warp + i / CH, c = i % CH, row = t0 + r;
      const bool ok = row < r_end;
      const size_t src = ok ? (size_t)row * D * sizeof(T) + 16 * c : 0;
      const int dst = r * LD + raw_word<T>(r, 4 * c);
      cp_async16(P + dst, reinterpret_cast<const char*>(qb) + src, ok);
      cp_async16(Ut + dst, reinterpret_cast<const char*>(gb) + src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (t0 == r_begin) __syncthreads();  // kv and the sums
    else __syncwarp();

    // phi in its A-fragment layout: ph[j] = (ra, c), (ra, c + 1), (rb, c),
    // (rb, c + 1) at c = 8 j + 2 t4
    float ph[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float2 x = raw_pair(P + ra * LD, ra, 8 * j + 2 * t4, T());
      const float2 y = raw_pair(P + rb * LD, rb, 8 * j + 2 * t4, T());
      ph[j][0] = x.x; ph[j][1] = x.y; ph[j][2] = y.x; ph[j][3] = y.y;
    }
    __syncwarp();  // every lane has read its raw q: phi may overwrite it
    float ia = 0.f, ib = 0.f, ca = 0.f, cb = 0.f;  // I and C of rows ra, rb
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = 8 * j + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) ph[j][e] = sigmoid(ph[j][e]);
      ia = fmaf(ph[j][0] + eps, kse[c], ia);
      ia = fmaf(ph[j][1] + eps, kse[c + 1], ia);
      ib = fmaf(ph[j][2] + eps, kse[c], ib);
      ib = fmaf(ph[j][3] + eps, kse[c + 1], ib);
      ca = fmaf(ph[j][0] + eps, kose[c], ca);
      ca = fmaf(ph[j][1] + eps, kose[c + 1], ca);
      cb = fmaf(ph[j][2] + eps, kose[c], cb);
      cb = fmaf(ph[j][3] + eps, kose[c + 1], cb);
      *reinterpret_cast<float2*>(P + ra * LD + swz(ra, c)) = make_float2(ph[j][0], ph[j][1]);
      *reinterpret_cast<float2*>(P + rb * LD + swz(rb, c)) = make_float2(ph[j][2], ph[j][3]);
    }
    ia = quad_sum(ia);
    ib = quad_sum(ib);
    const float al_a = sigmoid(quad_sum(ca) * sink_scale);
    const float al_b = sigmoid(quad_sum(cb) * sink_scale);

    // agg I = phi @ kv (kv read down its columns)
    float u[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32(ph[ks][0], ah[0], al[0]);  // (g, t): element 2t
      split_tf32(ph[ks][2], ah[1], al[1]);  // (g + 8, t)
      split_tf32(ph[ks][1], ah[2], al[2]);  // (g, t + 4): element 2t + 1
      split_tf32(ph[ks][3], ah[3], al[3]);  // (g + 8, t + 4)
      const int k0 = 8 * ks + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        uint32_t bh_[2], bl_[2];
        kv_frag<B::PRESPLIT>(kv_s, kv_lo, k0 * LD + swz(k0, 8 * nt + g8), bh_[0], bl_[0]);
        kv_frag<B::PRESPLIT>(kv_s, kv_lo, (k0 + 1) * LD + swz(k0 + 1, 8 * nt + g8), bh_[1],
                             bl_[1]);
        mma_3xtf32(u[nt], ah, al, bh_, bl_);
      }
    }
    // dalloc = g . agg; u = g alloc / I, in place of agg and then of raw g
    float gv[NK][4];
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float2 x = raw_pair(Ut + ra * LD, ra, 8 * j + 2 * t4, T());
      const float2 y = raw_pair(Ut + rb * LD, rb, 8 * j + 2 * t4, T());
      gv[j][0] = x.x; gv[j][1] = x.y; gv[j][2] = y.x; gv[j][3] = y.y;
      da = fmaf(gv[j][0], u[j][0], da);
      da = fmaf(gv[j][1], u[j][1], da);
      db = fmaf(gv[j][2], u[j][2], db);
      db = fmaf(gv[j][3], u[j][3], db);
    }
    const float dalloc_a = quad_sum(da) / ia;
    const float dalloc_b = quad_sum(db) / ib;
    const float sa = al_a / ia, sb = al_b / ib;
    __syncwarp();  // every lane has read its raw g: u may overwrite it
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = 8 * j + 2 * t4;
      u[j][0] = gv[j][0] * sa; u[j][1] = gv[j][1] * sa;
      u[j][2] = gv[j][2] * sb; u[j][3] = gv[j][3] * sb;
      *reinterpret_cast<float2*>(Ut + ra * LD + swz(ra, c)) = make_float2(u[j][0], u[j][1]);
      *reinterpret_cast<float2*>(Ut + rb * LD + swz(rb, c)) = make_float2(u[j][2], u[j][3]);
    }
    const float dc_a = dalloc_a * al_a * (1.f - al_a) * sink_scale;
    const float dc_b = dalloc_b * al_b * (1.f - al_b) * sink_scale;

    // w = u @ kv^T (kv read along its rows); u's accumulators are the A
    // fragments, the reduction index permuted as the B rows below
    float w[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) w[j][0] = w[j][1] = w[j][2] = w[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      uint32_t ah[4], al[4];
      split_tf32(u[ks][0], ah[0], al[0]);
      split_tf32(u[ks][2], ah[1], al[1]);
      split_tf32(u[ks][1], ah[2], al[2]);
      split_tf32(u[ks][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const int r = 8 * nt + g8, i = r * LD + swz(r, 8 * ks + 2 * t4);
        const float2 x = *reinterpret_cast<const float2*>(kv_s + i);
        uint32_t bh_[2], bl_[2];
        if constexpr (B::PRESPLIT) {
          const float2 y = *reinterpret_cast<const float2*>(kv_lo + i);
          bh_[0] = __float_as_uint(x.x); bh_[1] = __float_as_uint(x.y);
          bl_[0] = __float_as_uint(y.x); bl_[1] = __float_as_uint(y.y);
        } else {
          split_tf32(x.x, bh_[0], bl_[0]);
          split_tf32(x.y, bh_[1], bl_[1]);
        }
        mma_3xtf32(w[nt], ah, al, bh_, bl_);
      }
    }
    // dI = -(w . phi) / I; dq
    float sa_ = 0.f, sb_ = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 x = *reinterpret_cast<const float2*>(P + ra * LD + swz(ra, c));
      const float2 y = *reinterpret_cast<const float2*>(P + rb * LD + swz(rb, c));
      ph[j][0] = x.x; ph[j][1] = x.y; ph[j][2] = y.x; ph[j][3] = y.y;
      sa_ = fmaf(w[j][0], ph[j][0], sa_);
      sa_ = fmaf(w[j][1], ph[j][1], sa_);
      sb_ = fmaf(w[j][2], ph[j][2], sb_);
      sb_ = fmaf(w[j][3], ph[j][3], sb_);
    }
    const float di_a = -quad_sum(sa_) / ia;
    const float di_b = -quad_sum(sb_) / ib;
    const bool va = t0 + ra < r_end, vb = t0 + rb < r_end;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = 8 * j + 2 * t4;
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float di = e < 2 ? di_a : di_b, dc = e < 2 ? dc_a : dc_b;
        const float dphi = w[j][e] + di * kse[c + (e & 1)] + dc * kose[c + (e & 1)];
        d[e] = dphi * ph[j][e] * (1.f - ph[j][e]);
      }
      if (va) store2(dqb + (size_t)(t0 + ra) * D + c, d[0], d[1]);
      if (vb) store2(dqb + (size_t)(t0 + rb) * D + c, d[2], d[3]);
    }
    if (t4 == 0) {
      X[ra * LD] = di_a;
      X[ra * LD + 1] = dc_a;
      X[rb * LD] = di_b;
      X[rb * LD + 1] = dc_b;
    }
    __syncthreads();

    // [dkv | dk_sum, dko_sum] += phi^T [u | dI, dC] over the tile's rows:
    // A = phi^T read down phi's columns, B = u read down its columns.  The
    // tile's sum takes fresh accumulators, then is added to the block's in
    // fp32: the tensor cores truncate as they accumulate, and a sum carried
    // through all of a block's tiles in them drifted by ~1e-5 of its size.
    float tacc[B::NTS][4], text[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < B::NTS; ++j) tacc[j][0] = tacc[j][1] = tacc[j][2] = tacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < TR / 8; ++ks) {
      const int r0 = 8 * ks + 2 * t4, r1 = r0 + 1;
      const float a[4] = {P[r0 * LD + swz(r0, m0 + g8)], P[r0 * LD + swz(r0, m0 + g8 + 8)],
                          P[r1 * LD + swz(r1, m0 + g8)], P[r1 * LD + swz(r1, m0 + g8 + 8)]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
      for (int nt = 0; nt < B::NTS; ++nt) {
        const int col = n0 + 8 * nt + g8;
        uint32_t bh_[2], bl_[2];
        split_tf32(Ut[r0 * LD + swz(r0, col)], bh_[0], bl_[0]);
        split_tf32(Ut[r1 * LD + swz(r1, col)], bh_[1], bl_[1]);
        mma_3xtf32(tacc[nt], ah, al, bh_, bl_);
      }
      if (sums) {  // A = phi + eps: sum_i dI_i (phi_i + eps), sum_i dC_i (phi_i + eps)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e] + eps, ah[e], al[e]);
        uint32_t bh_[2], bl_[2];
        split_tf32(X[r0 * LD + g8], bh_[0], bl_[0]);
        split_tf32(X[r1 * LD + g8], bh_[1], bl_[1]);
        mma_3xtf32(text, ah, al, bh_, bl_);
      }
    }
#pragma unroll
    for (int j = 0; j < B::NTS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += tacc[j][e];
#pragma unroll
    for (int e = 0; e < 4; ++e) ext[e] += text[e];
    __syncthreads();  // phi, u and X are read: the next tile may land
  }

  // this CTA's partial: dk_sum, dko_sum, then dkv (row-major), into
  // part[bh][split]
  float* pb = part + (bh * gridDim.x + split) * (size_t)B::PART;
#pragma unroll
  for (int nt = 0; nt < B::NTS; ++nt) {
    float* p = pb + 2 * D + (m0 + g8) * D + n0 + 8 * nt + 2 * t4;
    *reinterpret_cast<float2*>(p) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(p + 8 * D) = make_float2(acc[nt][2], acc[nt][3]);
  }
  if (sums && t4 == 0) {  // columns 0 and 1 of the ninth tile
    pb[m0 + g8] = ext[0];
    pb[D + m0 + g8] = ext[1];
    pb[m0 + g8 + 8] = ext[2];
    pb[D + m0 + g8 + 8] = ext[3];
  }
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

// ---- the small-head route (D = 6, 8, 12, 16, 24, 48) ------------------------
//
// One row a thread, fp32 FMA (flow_nc_common.cuh, "the small-head route").

// kv (D x D), k_sum + eps and ko_sum + eps of one (batch * head) into shared
// memory; the caller synchronizes
template <int D, int THREADS>
__device__ __forceinline__ void stage_key_side(const float* kv, const float* k_sum,
                                               const float* ko_sum, float add, float* kv_s,
                                               float* ks_s, float* kos_s) {
  const size_t bh = blockIdx.y;
  for (int i = threadIdx.x; i < D * D; i += THREADS) kv_s[i] = kv[bh * D * D + i];
  if (threadIdx.x < D) {
    ks_s[threadIdx.x] = k_sum[bh * D + threadIdx.x] + add;
    kos_s[threadIdx.x] = ko_sum[bh * D + threadIdx.x] + add;
  }
}

// K7a: block (x, bh) owns rows [x THREADS, (x + 1) THREADS), one a thread
template <typename T, int D>
__global__ void __launch_bounds__(Small<D>::THREADS, Small<D>::MIN_BLOCKS)
flow_nc_qside_kernel_small(const T* __restrict__ q, const float* __restrict__ k_sum,
                           const float* __restrict__ ko_sum, const float* __restrict__ kv,
                           T* __restrict__ out, int n, float eps, float sink_scale) {
  constexpr int THREADS = Small<D>::THREADS;
  extern __shared__ float4 smem4[];
  float* kv_s = reinterpret_cast<float*>(smem4);
  float* ksum_s = kv_s + D * D;
  float* kosum_s = ksum_s + D;
  stage_key_side<D, THREADS>(kv, k_sum, ko_sum, 0.f, kv_s, ksum_s, kosum_s);
  __syncthreads();
  const size_t bh = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  float x[D], y[D];
  load_row<T, D>(q + (bh * n + r) * D, x);
  float inc = 0.f, con = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = sigmoid(x[i]);
    inc = fmaf(x[i] + eps, ksum_s[i] + eps, inc);
    con = fmaf(x[i] + eps, kosum_s[i] + eps, con);
  }
  const float scale = sigmoid(con * sink_scale) / inc;
  row_times_mat<D>(x, kv_s, y);
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] *= scale;
  store_row<T, D>(out + (bh * n + r) * D, y);
}

// K7b's shared memory, in floats: kv, k_sum + eps, ko_sum + eps, a tile of
// phi (TR x D) and of X = [u | dI, dC] (TR x (D + 2)), the row groups'
// scratch
template <int D>
struct SmallBwd {
  static constexpr int THREADS = Small<D>::THREADS, TR = THREADS, W = D + 2;
  static constexpr int NP = D * W;  // [dkv | dk_sum, dko_sum] entries, (d, c)
  static constexpr int kKse = D * D, kKose = kKse + D, kPhi = kKose + D;
  static constexpr int kX = kPhi + TR * D, kGrp = kX + TR * W;
  static constexpr int FLOATS = kGrp + THREADS;
  static constexpr int PART = 2 * D + D * D;  // a block's partial, in floats
};

// K7b: block (split, bh) owns rows [split rows, (split + 1) rows), walked in
// tiles of TR rows, one a thread: phi, I, C, alloc; agg I = phi @ kv;
// dalloc = g . agg; u = g alloc / I; w = u @ kv^T; dI = -(w . phi) / I;
// dC = dalloc alloc (1 - alloc) n/m; dq = (w + dI (k_sum + eps) + dC
// (ko_sum + eps)) phi (1 - phi).  The tile's phi and [u | dI, dC] land in
// shared memory, and the owners of [dkv | dk_sum, dko_sum] = phi^T u |
// (phi + eps)^T [dI, dC] add its rows in order, in registers across the
// tiles; the block's partial goes to part[bh][split] for the reduce launch.
template <typename T, int D>
__global__ void __launch_bounds__(Small<D>::THREADS, Small<D>::MIN_BLOCKS)
flow_nc_qside_bwd_kernel_small(const T* __restrict__ q, const float* __restrict__ k_sum,
                               const float* __restrict__ ko_sum, const float* __restrict__ kv,
                               const T* __restrict__ g, T* __restrict__ dq,
                               float* __restrict__ part, int n, int rows, float eps,
                               float sink_scale) {
  using B = SmallBwd<D>;
  constexpr int THREADS = B::THREADS, W = B::W, NP = B::NP;
  using O = Owners<NP, THREADS>;
  extern __shared__ float4 smem4[];
  float* fs = reinterpret_cast<float*>(smem4);
  const float* kv_s = fs;
  const float* kse = fs + B::kKse;
  const float* kose = fs + B::kKose;
  float* ph_s = fs + B::kPhi;
  float* x_s = fs + B::kX;
  stage_key_side<D, THREADS>(kv, k_sum, ko_sum, eps, fs, fs + B::kKse, fs + B::kKose);
  __syncthreads();

  const size_t bh = blockIdx.y;
  const int split = blockIdx.x, tid = threadIdx.x;
  const T* qb = q + bh * n * D;
  const T* gb = g + bh * n * D;
  T* dqb = dq + bh * n * D;
  const O own;
  float acc[O::EPT] = {};
  const int r_begin = split * rows, r_end = min(n, r_begin + rows);
  for (int t0 = r_begin; t0 < r_end; t0 += B::TR) {
    const int cnt = min(B::TR, r_end - t0);
    if (tid < cnt) {
      // two rows of D floats live at most: phi, and agg I then w; u goes
      // to its row of X as it is formed and is read back from there
      const size_t r = t0 + tid;
      float ph[D], w[D];
      float* xr = x_s + tid * W;
      load_row<T, D>(qb + r * D, ph);
      float ia = 0.f, ca = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        ph[i] = sigmoid(ph[i]);
        ia = fmaf(ph[i] + eps, kse[i], ia);
        ca = fmaf(ph[i] + eps, kose[i], ca);
        ph_s[tid * D + i] = ph[i];
      }
      const float al = sigmoid(ca * sink_scale);
      row_times_mat<D>(ph, kv_s, w);  // agg I
      const T* gr = gb + r * D;
      const float s = al / ia;
      float da = 0.f;
#pragma unroll
      for (int i = 0; i < D; i += 2) {
        const float2 gv = load_pair(gr + i);
        da = fmaf(gv.x, w[i], da);
        da = fmaf(gv.y, w[i + 1], da);
        xr[i] = gv.x * s;  // u = g alloc / I
        xr[i + 1] = gv.y * s;
      }
      const float dalloc = da / ia;
      // w = u @ kv^T
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) t = fmaf(xr[c], kv_s[d * D + c], t);
        w[d] = t;
      }
      float sw = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) sw = fmaf(w[i], ph[i], sw);
      const float di = -sw / ia;
      const float dc = dalloc * al * (1.f - al) * sink_scale;
#pragma unroll
      for (int i = 0; i < D; ++i)
        w[i] = (w[i] + di * kse[i] + dc * kose[i]) * ph[i] * (1.f - ph[i]);
      xr[D] = di;
      xr[D + 1] = dc;
      store_row<T, D>(dqb + r * D, w);
    }
    __syncthreads();
    // the tile's rows summed afresh, then added to the block's sums: a sum
    // over the tile's rows and one over the tiles, as the tensor-core
    // kernel sums, rather than one flat sum over thousands of rows
    if (own.active())
#pragma unroll
      for (int i = 0; i < O::EPT; ++i) {
        const int p = own.entry(i);
        if (p >= NP) continue;
        const int d = p / W, c = p % W;
        const float add = c < D ? 0.f : eps;  // dk_sum, dko_sum take phi + eps
        float t_acc = 0.f;
        for (int t = own.grp; t < cnt; t += O::G)
          t_acc = fmaf(ph_s[t * D + d] + add, x_s[t * W + c], t_acc);
        acc[i] += t_acc;
      }
    __syncthreads();  // the tile is read: the next may land
  }
  // this block's partial: dk_sum, dko_sum, then dkv (row-major)
  float* pb = part + (bh * gridDim.x + split) * (size_t)B::PART;
  group_total(own, acc, fs + B::kGrp, [&](int p, float v) {
    const int d = p / W, c = p % W;
    pb[c < D ? 2 * D + d * D + c : c == D ? d : D + d] = v;
  });
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k_sum, const void* ko_sum, const void* kv,
                       void* out, int bh, int n, float sink_scale, float eps,
                       cudaStream_t stream) {
  if constexpr (small_dim<D>()) {
    constexpr int THREADS = Small<D>::THREADS;
    const size_t bytes = ((size_t)D * D + 2 * D) * sizeof(float);
    const dim3 grid((n + THREADS - 1) / THREADS, bh);
    flow_nc_qside_kernel_small<T, D><<<grid, THREADS, bytes, stream>>>(
        (const T*)q, (const float*)k_sum, (const float*)ko_sum, (const float*)kv, (T*)out, n,
        eps, sink_scale);
    return cudaGetLastError();
  } else {
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
}

// K7b's kernel, block size, tile rows and shared memory bytes for D
template <typename T, int D>
struct BwdKernel {
  static auto kern() {
    if constexpr (small_dim<D>()) return flow_nc_qside_bwd_kernel_small<T, D>;
    else return flow_nc_qside_bwd_kernel<T, D>;
  }
  static constexpr int threads() {
    if constexpr (small_dim<D>()) return SmallBwd<D>::THREADS;
    else return BwdCfg<D>::THREADS;
  }
  static constexpr int tile() {
    if constexpr (small_dim<D>()) return SmallBwd<D>::TR;
    else return BwdCfg<D>::TR;
  }
  static constexpr size_t bytes() {
    if constexpr (small_dim<D>()) return SmallBwd<D>::FLOATS * sizeof(float);
    else return BwdCfg<D>::FLOATS * sizeof(float);
  }
};

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k_sum, const void* ko_sum, const void* kv,
                       const void* g, void* dq, void* part, void* dk_sum, void* dko_sum,
                       void* dkv, int bh, int n, int rows, float sink_scale, float eps,
                       cudaStream_t stream) {
  using B = BwdKernel<T, D>;
  if (rows < B::tile() || rows % B::tile()) return cudaErrorInvalidValue;
  auto kern = B::kern();
  const size_t bytes = B::bytes();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int splits = (n + rows - 1) / rows;
  kern<<<dim3(splits, bh), B::threads(), bytes, stream>>>(
      (const T*)q, (const float*)k_sum, (const float*)ko_sum, (const float*)kv, (const T*)g,
      (T*)dq, (float*)part, n, rows, eps, sink_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flow_nc_reduce_kernel<<<bh, kThreads, 0, stream>>>((const float*)part, (float*)dk_sum,
                                                     (float*)dko_sum, (float*)dkv, splits, D);
  return cudaGetLastError();
}

// Rows of one (batch * head) per K7b block: whole tiles, as few blocks a
// row as fill the card's SMs once (the blocks an SM holds, from the
// occupancy calculator, times the SMs, over BH), at least one tile each.
template <typename T, int D>
int bwd_rows(int bh, int n) {
  using B = BwdKernel<T, D>;
  auto kern = B::kern();
  const size_t bytes = B::bytes();
  int occ = 0, dev = 0, sms = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, B::threads(), bytes) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || occ < 1)
    return -1;
  constexpr int TR = B::tile();
  const int tiles = (n + TR - 1) / TR;
  const int splits = max(1, min(tiles, occ * sms / bh));
  return (tiles + splits - 1) / splits * TR;
}

}  // namespace

#define FLOW_NC_DIMS(CALL, T)                   \
  switch (d) {                                  \
    case 6: return (int)CALL(T, 6);             \
    case 8: return (int)CALL(T, 8);             \
    case 12: return (int)CALL(T, 12);           \
    case 16: return (int)CALL(T, 16);           \
    case 24: return (int)CALL(T, 24);           \
    case 48: return (int)CALL(T, 48);           \
    case 32: return (int)CALL(T, 32);           \
    case 64: return (int)CALL(T, 64);           \
    case 128: return (int)CALL(T, 128);         \
    default: break;                             \
  }
#define FLOW_NC_DISPATCH(CALL)                  \
  if (dtype == 0) {                             \
    FLOW_NC_DIMS(CALL, float)                   \
  } else if (dtype == 1) {                      \
    FLOW_NC_DIMS(CALL, __nv_bfloat16)           \
  }

// q (BH, N, D) in `dtype` (0 fp32, 1 bf16); k_sum, ko_sum (BH, D) and kv
// (BH, D, Dv) fp32; out (BH, N, Dv) in `dtype`.  All contiguous and 16-byte
// aligned at their bases; D == Dv in {6, 8, 12, 16, 24, 48} (the small-head
// route) or {32, 64, 128}; N >= 1.  sink_scale = n_sinks / m_sources.
// Returns a cudaError_t.
extern "C" int flow_nc_qside_fwd(const void* q, const void* k_sum, const void* ko_sum,
                                 const void* kv, void* out, int bh, int n, int d, int dv,
                                 int dtype, float sink_scale, float eps, void* stream) {
  if (d != dv || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_NC_FWD(T, D) launch_fwd<T, D>(q, k_sum, ko_sum, kv, out, bh, n, sink_scale, eps, st)
  FLOW_NC_DISPATCH(FLOW_NC_FWD)
#undef FLOW_NC_FWD
  return (int)cudaErrorInvalidValue;
}

// Rows of one (batch * head) per block of flow_nc_qside_bwd on this device
// (a multiple of its tile), or -1 where it refuses the shape; the caller
// sizes its scratch with splits = ceil(N / rows).
extern "C" int flow_nc_qside_bwd_rows(int bh, int n, int d, int dtype) {
  if (bh < 1 || n < 1) return -1;
#define FLOW_NC_ROWS(T, D) bwd_rows<T, D>(bh, n)
  FLOW_NC_DISPATCH(FLOW_NC_ROWS)
#undef FLOW_NC_ROWS
  return -1;
}

// The cotangents of flow_nc_qside_fwd for g (BH, N, Dv) in `dtype`: dq
// (BH, N, D) in `dtype`, dk_sum, dko_sum (BH, D) and dkv (BH, D, Dv) fp32;
// rows from flow_nc_qside_bwd_rows; part is a fp32 scratch of BH * splits *
// (2 D + D Dv) floats, splits = ceil(N / rows).  Two launches on `stream`.
// Returns a cudaError_t.
extern "C" int flow_nc_qside_bwd(const void* q, const void* k_sum, const void* ko_sum,
                                 const void* kv, const void* g, void* dq, void* part,
                                 void* dk_sum, void* dko_sum, void* dkv, int bh, int n, int d,
                                 int dv, int rows, int dtype, float sink_scale, float eps,
                                 void* stream) {
  if (d != dv || n < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define FLOW_NC_BWD(T, D)                                                                  \
  launch_bwd<T, D>(q, k_sum, ko_sum, kv, g, dq, part, dk_sum, dko_sum, dkv, bh, n, rows, \
                   sink_scale, eps, st)
  FLOW_NC_DISPATCH(FLOW_NC_BWD)
#undef FLOW_NC_BWD
  return (int)cudaErrorInvalidValue;
}

#undef FLOW_NC_DISPATCH
#undef FLOW_NC_DIMS

extern "C" const char* flow_nc_qside_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
