// ssd_chunk_bwd.cu — the backward of the SSD chunk scan (K10b) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/ssd_chunk/bwd.py::ssd_chunk_bwd_call (the
// pl.pallas_call at :77, body _bwd_kernel :31-52): per (batch, head) row,
// walk the chunks back to front with the (P, S) cotangent gh of the carry
// (zero at the end: the forward discards its final state) and pull back
// each chunk from its saved carry-in h (a decay-contracted carry cannot be
// rebuilt by dividing the decay back out; bwd.py:1-14).  With D, M = (c
// b^T) o D, seg and cum as in ssd_chunk.cu and gy the chunk's output
// cotangent, the pull-back written out is
//
//   dx    = M^T gy + seg o (b gh^T)
//   db    = (dM o D)^T c + seg o (x gh),         dM = gy x^T
//   dc    = (dM o D) b + exp(cum) o (gy h)
//   gh   <- exp(cum_last) gh + (exp(cum) o gy)^T c
//   dcum  = rows(E) - cols(E) + exp(cum) o rowsum(c o gy h) - seg o dseg,
//           E = dM o (c b^T) o D, dseg = rowsum((x gh) o b), plus
//           exp(cum_last) sum(gh o h) + sum_j seg_j dseg_j at the last row
//   ddt   = reverse inclusive cumsum of dcum
//
// The plain version, kernels/ssd_chunk/bwd.py, is the same list in
// PyTorch.
//
// What bounds it on the H100: operations, as for K10a: at C = 128, P = 64,
// S = 128 about 1.68e7 per chunk over the causal triangle (C (C + 1)
// (3 S + 2 P) + 8 C P S: three triangular C x C x S products, two
// C x C x P ones and four C x P x S ones; 2.5e7 with the panels whole),
// against ~263 KB moved per chunk (x, g, dx, dta, ddta, the carry-in and
// the per-row db and dc): ~64 operations per byte, three times the
// card's ~20 of fp32 balance.
//
// Design.  One 256-thread block per row, chunks back to front, gh and the
// chunk's carry-in h in shared memory (2 x 32 KB at 64 x 128).  Per chunk,
// in 32-row tiles: a pass over key tiles j (dx_j, db_j and dseg_j in
// registers, summed over the query tiles i >= j, with the masked panels
// M, dM o D and E staged per tile; the rows and columns of E go to dcum),
// then a pass over query tiles i (dc_i over the key tiles j <= i, the
// inter-chunk terms, and the carry cotangent, in registers across the
// tiles), then thread 0 closes dcum and writes ddt.  db and dc are written
// per (batch, head) row -- the caller sums them over the heads that share
// b and c -- so no sum crosses blocks and nothing needs atomics.  Shared
// memory at P = 64, S = 128: 128 KB, one block per SM.  Simple first: no
// tensor cores, and dM is computed in both passes.
#include "ssd_chunk_common.cuh"

namespace {

using namespace ssd;

template <int P, int S>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * P * (S + 1) + 2 * kT * (P + 1) + 2 * kT * (S + 1) +
                          3 * kT * (kT + 1) + 5 * kMaxChunk + kThreads / 32 + 1);
}

// The sum of every thread's v, in a fixed order; all threads get it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = row_sum<32>(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    red[kThreads / 32] = s;
  }
  __syncthreads();
  return red[kThreads / 32];
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dta, Strided b,
                     Strided c, const float* __restrict__ hins, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ ddta, float* __restrict__ db,
                     float* __restrict__ dc, int n, int chunk) {
  constexpr int LP = P + 1, LS = S + 1, LT = kT + 1;
  using G = Own<kT, kT>;  // a panel tile
  using X = Own<kT, P>;   // a tile of dx
  using B = Own<kT, S>;   // a tile of db or dc
  using H = Own<P, S>;    // the carry's cotangent
  extern __shared__ float smem[];
  float* h_s = smem;              // the chunk's carry-in
  float* gh_s = h_s + P * LS;     // the carry-out's cotangent
  float* xj_s = gh_s + P * LS;    // key tile of x
  float* bj_s = xj_s + kT * LP;   // key tile of b
  float* ci_s = bj_s + kT * LS;   // query tile of c
  float* gyi_s = ci_s + kT * LS;  // query tile of gy
  float* m_s = gyi_s + kT * LP;   // M on a tile
  float* dmd_s = m_s + kT * LT;   // dM o D on a tile
  float* e_s = dmd_s + kT * LT;   // E on a tile
  float* cum = e_s + kT * LT;
  float* ecum = cum + kMaxChunk;
  float* seg = ecum + kMaxChunk;
  float* dcum = seg + kMaxChunk;
  float* dseg = dcum + kMaxChunk;
  float* red = dseg + kMaxChunk;

  const int r = blockIdx.x, tid = threadIdx.x;
  const int nc = n / chunk, nt = (chunk + kT - 1) / kT;
  const size_t row = (size_t)r * n;
  const float *xr = x + row * P, *gr = g + row * P;
  float *dxr = dx + row * P, *dbr = db + row * S, *dcr = dc + row * S;
  const int gm = (tid / G::TX) * G::RM, gx = tid % G::TX;
  const int xm = (tid / X::TX) * X::RM, xx = tid % X::TX;
  const int bm = (tid / B::TX) * B::RM, bx = tid % B::TX;
  const int hm = (tid / H::TX) * H::RM, hx = tid % H::TX;

  for (int i = tid; i < P * LS; i += kThreads) gh_s[i] = 0.f;
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * chunk;
    __syncthreads();  // gh_s holds the carry-out's cotangent
    const float* hin = hins + ((size_t)r * nc + ci) * P * S;
    for (int i = tid; i < P * S; i += kThreads) h_s[(i / S) * LS + i % S] = hin[i];
    for (int i = tid; i < chunk; i += kThreads) dcum[i] = dseg[i] = 0.f;
    chunk_cumsum(dta + row + t0, chunk, cum);
    __syncthreads();
    for (int i = tid; i < chunk; i += kThreads) {
      ecum[i] = expf(cum[i]);
      seg[i] = expf(cum[chunk - 1] - cum[i]);
    }
    float part = 0.f;
    for (int i = tid; i < P * S; i += kThreads) {
      const int k = (i / S) * LS + i % S;
      part += gh_s[k] * h_s[k];
    }
    const float ghh = block_sum(part, red);  // synchronizes: ecum, seg ready

    // Pass 1, key tiles j: dx_j, db_j, dseg_j; E's rows and columns.
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      load_rows<P>(xj_s, xr + (size_t)(t0 + j0) * P, P, kT, chunk - j0);
      load_rows<S>(bj_s, b.row(r, t0 + j0), b.sn, kT, chunk - j0);
      __syncthreads();
      float dxs[X::RM][4] = {}, dxi[X::RM][4] = {};
      float xgh[B::RM][4] = {}, dbi[B::RM][4] = {};
      mm<X::RM, 4, false, true>(dxs, bj_s, LS, gh_s, LS, xm, xx, X::TX, 0, S);   // b gh^T
      mm<B::RM, 4, false, false>(xgh, xj_s, LP, gh_s, LS, bm, bx, B::TX, 0, P);  // x gh
#pragma unroll
      for (int rr = 0; rr < B::RM; ++rr) {  // dseg_j = sum_s (x gh)_js b_js
        float v = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) v += xgh[rr][cc] * bj_s[(bm + rr) * LS + bx + cc * B::TX];
        v = row_sum<B::TX>(v);
        if (bx == 0 && j0 + bm + rr < chunk) dseg[j0 + bm + rr] = v;
      }
      for (int it = jt; it < nt; ++it) {
        const int i0 = it * kT;
        load_rows<S>(ci_s, c.row(r, t0 + i0), c.sn, kT, chunk - i0);
        load_rows<P>(gyi_s, gr + (size_t)(t0 + i0) * P, P, kT, chunk - i0);
        __syncthreads();
        {  // G = c_i . b_j and dM = gy_i . x_j on this tile
          float gg[G::RM][4] = {}, dm[G::RM][4] = {};
          mm<G::RM, 4, false, true>(gg, ci_s, LS, bj_s, LS, gm, gx, G::TX, 0, S);
          mm<G::RM, 4, false, true>(dm, gyi_s, LP, xj_s, LP, gm, gx, G::TX, 0, P);
#pragma unroll
          for (int rr = 0; rr < G::RM; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int col = gx + cc * G::TX, k = (gm + rr) * LT + col;
              const float d = decay(cum, i0 + gm + rr, j0 + col, chunk);
              m_s[k] = gg[rr][cc] * d;
              dmd_s[k] = dm[rr][cc] * d;
              e_s[k] = dm[rr][cc] * gg[rr][cc] * d;
            }
        }
        __syncthreads();
        mm<X::RM, 4, true, false>(dxi, m_s, LT, gyi_s, LP, xm, xx, X::TX, 0, kT);  // M^T gy
        mm<B::RM, 4, true, false>(dbi, dmd_s, LT, ci_s, LS, bm, bx, B::TX, 0, kT);  // (dM o D)^T c
        if (tid < kT) {  // E's row tid (position i0 + tid) and column tid (j0 + tid)
          float rs = 0.f, cs = 0.f;
          for (int q = 0; q < kT; ++q) {
            rs += e_s[tid * LT + q];
            cs += e_s[q * LT + tid];
          }
          if (it == jt) {
            if (i0 + tid < chunk) dcum[i0 + tid] += rs - cs;
          } else {
            if (i0 + tid < chunk) dcum[i0 + tid] += rs;
            if (j0 + tid < chunk) dcum[j0 + tid] -= cs;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < X::RM; ++rr) {
        const int j = j0 + xm + rr;
        if (j < chunk) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            dxr[(size_t)(t0 + j) * P + xx + cc * X::TX] = dxi[rr][cc] + seg[j] * dxs[rr][cc];
        }
      }
#pragma unroll
      for (int rr = 0; rr < B::RM; ++rr) {
        const int j = j0 + bm + rr;
        if (j < chunk) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            dbr[(size_t)(t0 + j) * S + bx + cc * B::TX] = dbi[rr][cc] + seg[j] * xgh[rr][cc];
        }
      }
    }

    // Pass 2, query tiles i: dc_i, the inter-chunk terms, the carry's
    // cotangent (exp(cum) o gy)^T c.
    float dh[H::RM][4] = {};
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // ci_s and gyi_s are free
      load_rows<S>(ci_s, c.row(r, t0 + i0), c.sn, kT, chunk - i0);
      load_rows<P>(gyi_s, gr + (size_t)(t0 + i0) * P, P, kT, chunk - i0);
      __syncthreads();
      float gyh[B::RM][4] = {}, dci[B::RM][4] = {};
      mm<B::RM, 4, false, false>(gyh, gyi_s, LP, h_s, LS, bm, bx, B::TX, 0, P);  // gy h
#pragma unroll
      for (int rr = 0; rr < B::RM; ++rr) {  // dcum_i += exp(cum_i) sum_s c_is (gy h)_is
        float v = 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) v += ci_s[(bm + rr) * LS + bx + cc * B::TX] * gyh[rr][cc];
        v = row_sum<B::TX>(v);
        const int i = i0 + bm + rr;
        if (bx == 0 && i < chunk) dcum[i] += ecum[i] * v;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        load_rows<P>(xj_s, xr + (size_t)(t0 + j0) * P, P, kT, chunk - j0);
        load_rows<S>(bj_s, b.row(r, t0 + j0), b.sn, kT, chunk - j0);
        __syncthreads();
        {
          float dm[G::RM][4] = {};
          mm<G::RM, 4, false, true>(dm, gyi_s, LP, xj_s, LP, gm, gx, G::TX, 0, P);
#pragma unroll
          for (int rr = 0; rr < G::RM; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int col = gx + cc * G::TX;
              dmd_s[(gm + rr) * LT + col] =
                  dm[rr][cc] * decay(cum, i0 + gm + rr, j0 + col, chunk);
            }
        }
        __syncthreads();
        mm<B::RM, 4, false, false>(dci, dmd_s, LT, bj_s, LS, bm, bx, B::TX, 0, kT);  // (dM o D) b
        __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < B::RM; ++rr) {
        const int i = i0 + bm + rr;
        if (i < chunk) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            dcr[(size_t)(t0 + i) * S + bx + cc * B::TX] = dci[rr][cc] + ecum[i] * gyh[rr][cc];
        }
      }
      for (int i = tid; i < kT * P; i += kThreads) {
        const int q = i / P;
        gyi_s[q * LP + i % P] *= i0 + q < chunk ? ecum[i0 + q] : 0.f;
      }
      __syncthreads();
      mm<H::RM, 4, true, false>(dh, gyi_s, LP, ci_s, LS, hm, hx, H::TX, 0, kT);
    }

    // Close the chunk: the carry's cotangent, dcum's carry terms, ddt.
    __syncthreads();
    const float ec = expf(cum[chunk - 1]);
#pragma unroll
    for (int rr = 0; rr < H::RM; ++rr)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float& gv = gh_s[(hm + rr) * LS + hx + cc * H::TX];
        gv = ec * gv + dh[rr][cc];
      }
    if (tid == 0) {
      float sd = 0.f;
      for (int j = 0; j < chunk; ++j) {
        const float t = seg[j] * dseg[j];
        sd += t;
        dcum[j] -= t;
      }
      dcum[chunk - 1] += ec * ghh + sd;
      float acc = 0.f;
      for (int j = chunk - 1; j >= 0; --j) {
        acc += dcum[j];
        ddta[row + t0 + j] = acc;
      }
    }
  }
}

template <int P, int S>
cudaError_t launch(const float* x, const float* dta, Strided b, Strided c, const float* hins,
                   const float* g, float* dx, float* ddta, float* db, float* dc, int bh, int n,
                   int chunk, cudaStream_t stream) {
  constexpr size_t bytes = bwd_smem_bytes<P, S>();
  auto kern = ssd_chunk_bwd_kernel<P, S>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(x, dta, b, c, hins, g, dx, ddta, db, dc, n, chunk);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx (BH, N, P), dta, ddta (BH, N, 1), hins (BH, N / chunk, P, S),
// db, dc (BH, N, S): fp32, contiguous and 16-byte aligned; b and c as for
// ssd_chunk_fwd.  (P, S) in {(64, 128), (32, 32)}, 1 <= chunk <= 128
// dividing N.  One launch on `stream`.  Returns a cudaError_t.
extern "C" int ssd_chunk_bwd(const void* x, const void* dta, const void* b, const void* c,
                             const void* hins, const void* g, void* dx, void* ddta, void* db,
                             void* dc, int bh, int heads, int n, int p, int s, int chunk,
                             int b_sb, int b_sh, int b_sn, int c_sb, int c_sh, int c_sn,
                             void* stream) {
  if (bh < 0 || heads < 1 || n < 0 || chunk < 1 || chunk > kMaxChunk || (n && n % chunk))
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return (int)cudaSuccess;
  const Strided bs{(const float*)b, b_sb, b_sh, b_sn, heads};
  const Strided cs{(const float*)c, c_sb, c_sh, c_sn, heads};
  const float *xf = (const float*)x, *af = (const float*)dta, *hf = (const float*)hins,
              *gf = (const float*)g;
  float *dxf = (float*)dx, *daf = (float*)ddta, *dbf = (float*)db, *dcf = (float*)dc;
  cudaStream_t st = (cudaStream_t)stream;
  // the (P, S) pairs of the configs: mamba2_1p3b and its smoke config
  if (p == 64 && s == 128)
    return (int)launch<64, 128>(xf, af, bs, cs, hf, gf, dxf, daf, dbf, dcf, bh, n, chunk, st);
  if (p == 32 && s == 32)
    return (int)launch<32, 32>(xf, af, bs, cs, hf, gf, dxf, daf, dbf, dcf, bh, n, chunk, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
