// ssd_chunk.cu — the Mamba-2 SSD chunk scan (K10a) for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_chunk/ssd_chunk.py::ssd_chunk_call, both of
// its pl.pallas_call sites: :138 (_kernel) and :145 (_kernel_hins, which
// also writes each chunk's carry-in for the backward).  Per (batch, head)
// row, for x (N, P) pre-scaled by dt, log decays a = dt A (N), b and c
// (N, S), and each chunk of C positions with carry-in h (P, S):
//
//   cum    = inclusive cumsum of a over the chunk
//   y_i    = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) (h c_i)
//   h_out  = exp(cum_last) h + sum_j exp(cum_last - cum_j) x_j (x) b_j
//
// (_ssd_step, ssd_chunk.py:32-64, which clamps cum_i - cum_j at 0 where
// this masks it: see decay() in ssd_chunk_common.cuh), all fp32.
//
// What bounds it on the H100: operations.  Over the causal triangle that
// the masked scan needs (pairs j <= i) a chunk is C (C + 1) (S + P) +
// 4 C P S, about 7.36e6 at C = 128, P = 64, S = 128 (1.05e7 with the C x C
// panels whole, as the TPU computes them), against 4 C (2 P + 1) bytes
// of x, y and dta per row (b and c are shared by the heads of a batch
// row): ~110 operations per byte, five times the ~20 at which the card's
// fp32 FMA rate (67 TFLOP/s) meets its memory.  The design computes
// only the tiles on or below the diagonal (10 of 16 at C = 128).
//
// Design.  The TPU carried h in VMEM along a sequential grid axis; a GPU
// grid has none.  So one 256-thread block owns one row and loops over its
// chunks in order, h (P x S, 32 KB at 64 x 128) in shared memory.  A whole
// chunk at C = 128 (x, b, c, the C x C panel and h) would take ~256 KB of
// shared memory, over the 227 KB a block may have, so per chunk the block
// stages x and b whole, then per 32-row query tile of c: the inter-chunk
// term c h^T, and per 32 x 32 key tile on or below the diagonal the
// masked panel (c b^T) o D (D rebuilt from the chunk's cumsum), then
// panel @ x.  Last, x is scaled by the segment decays in place and h is
// updated.  The carry-in is written at each chunk's start when hins is
// given (the _kernel_hins variant).  Shared memory at P = 64, S = 128:
// 151 KB, so one block per SM: 256 rows (B = 4, H = 64) fill 132 SMs in
// two waves.  The cumsum is warp 0's scan (four positions per lane in
// order, then the lanes' totals).  Any C from 1 to 128 that divides N
// works.  Simple first: no tensor cores, no asynchronous copies, and every
// head recomputes c b^T of its batch row.
#include "ssd_chunk_common.cuh"

namespace {

using namespace ssd;

template <int P, int S>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kMaxChunk * (P + 1) + kMaxChunk * (S + 1) + kT * (S + 1) +
                          P * (S + 1) + kT * (kT + 1) + 3 * kMaxChunk);
}

template <int P, int S, bool HINS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dta, Strided b, Strided c,
                 float* __restrict__ y, float* __restrict__ hins, int n, int chunk) {
  constexpr int LP = P + 1, LS = S + 1, LT = kT + 1;
  using G = Own<kT, kT>;  // a query x key panel tile
  using Y = Own<kT, P>;   // a query tile of y
  using H = Own<P, S>;    // the carry
  extern __shared__ float smem[];
  float* x_s = smem;                  // the chunk's x, then x * seg
  float* b_s = x_s + kMaxChunk * LP;  // the chunk's b
  float* c_s = b_s + kMaxChunk * LS;  // one query tile of c
  float* h_s = c_s + kT * LS;         // the carry
  float* m_s = h_s + P * LS;          // one masked panel tile
  float* cum = m_s + kT * LT;
  float* ecum = cum + kMaxChunk;  // exp(cum)
  float* seg = ecum + kMaxChunk;  // exp(cum_last - cum)

  const int r = blockIdx.x, tid = threadIdx.x;
  const int nc = n / chunk, nt = (chunk + kT - 1) / kT;
  const float* xr = x + (size_t)r * n * P;
  const float* ar = dta + (size_t)r * n;
  float* yr = y + (size_t)r * n * P;
  const int gm = (tid / G::TX) * G::RM, gx = tid % G::TX;
  const int ym = (tid / Y::TX) * Y::RM, yx = tid % Y::TX;
  const int hm = (tid / H::TX) * H::RM, hx = tid % H::TX;

  for (int i = tid; i < P * LS; i += kThreads) h_s[i] = 0.f;
  __syncthreads();
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * chunk;
    if (HINS) {  // the carry entering this chunk: K10b's residual
      float* hd = hins + ((size_t)r * nc + ci) * P * S;
      for (int i = tid; i < P * S; i += kThreads) hd[i] = h_s[(i / S) * LS + i % S];
    }
    load_rows<P>(x_s, xr + (size_t)t0 * P, P, nt * kT, chunk);
    load_rows<S>(b_s, b.row(r, t0), b.sn, nt * kT, chunk);
    chunk_cumsum(ar + t0, chunk, cum);
    __syncthreads();
    for (int i = tid; i < chunk; i += kThreads) {
      ecum[i] = expf(cum[i]);
      seg[i] = expf(cum[chunk - 1] - cum[i]);
    }
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // c_s is free; ecum and seg are written
      load_rows<S>(c_s, c.row(r, t0 + i0), c.sn, kT, chunk - i0);
      __syncthreads();
      float inter[Y::RM][4] = {}, intra[Y::RM][4] = {};
      mm<Y::RM, 4, false, true>(inter, c_s, LS, h_s, LS, ym, yx, Y::TX, 0, S);  // c_i . h_p
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        {  // m = (c b^T) o D on this tile
          float acc[G::RM][4] = {};
          mm<G::RM, 4, false, true>(acc, c_s, LS, b_s + j0 * LS, LS, gm, gx, G::TX, 0, S);
#pragma unroll
          for (int rr = 0; rr < G::RM; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int col = gx + cc * G::TX;
              m_s[(gm + rr) * LT + col] = acc[rr][cc] * decay(cum, i0 + gm + rr, j0 + col, chunk);
            }
        }
        __syncthreads();
        mm<Y::RM, 4, false, false>(intra, m_s, LT, x_s + j0 * LP, LP, ym, yx, Y::TX, 0, kT);
        __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < Y::RM; ++rr) {
        const int i = i0 + ym + rr;
        if (i < chunk) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            yr[(size_t)(t0 + i) * P + yx + cc * Y::TX] = intra[rr][cc] + inter[rr][cc] * ecum[i];
        }
      }
    }
    __syncthreads();  // every read of x_s and h_s for y is done
    for (int i = tid; i < chunk * P; i += kThreads) x_s[(i / P) * LP + i % P] *= seg[i / P];
    __syncthreads();
    {  // h = exp(cum_last) h + (x o seg)^T b, each thread on its own entries
      float acc[H::RM][4] = {};
      mm<H::RM, 4, true, false>(acc, x_s, LP, b_s, LS, hm, hx, H::TX, 0, chunk);
      const float ec = expf(cum[chunk - 1]);
#pragma unroll
      for (int rr = 0; rr < H::RM; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float& hv = h_s[(hm + rr) * LS + hx + cc * H::TX];
          hv = hv * ec + acc[rr][cc];
        }
    }
    __syncthreads();
  }
}

template <int P, int S, bool HINS>
cudaError_t launch(const float* x, const float* dta, Strided b, Strided c, float* y, float* hins,
                   int bh, int n, int chunk, cudaStream_t stream) {
  constexpr size_t bytes = fwd_smem_bytes<P, S>();
  auto kern = ssd_chunk_kernel<P, S, HINS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<bh, kThreads, bytes, stream>>>(x, dta, b, c, y, hins, n, chunk);
  return cudaGetLastError();
}

template <int P, int S>
cudaError_t launch_p_s(const float* x, const float* dta, Strided b, Strided c, float* y,
                       float* hins, int bh, int n, int chunk, cudaStream_t stream) {
  if (hins) return launch<P, S, true>(x, dta, b, c, y, hins, bh, n, chunk, stream);
  return launch<P, S, false>(x, dta, b, c, y, hins, bh, n, chunk, stream);
}

}  // namespace

// x (BH, N, P), dta (BH, N, 1) and y (BH, N, P) fp32, contiguous and
// 16-byte aligned; b and c fp32 with element (r, t, s) at
// base + (r / heads) * s_b + (r % heads) * s_h + t * s_n + s (strides in
// floats, multiples of 4); hins (BH, N / chunk, P, S) or null.  (P, S) in
// {(64, 128), (32, 32)}, 1 <= chunk <= 128 dividing N.  One launch on
// `stream`.  Returns a cudaError_t.
extern "C" int ssd_chunk_fwd(const void* x, const void* dta, const void* b, const void* c,
                             void* y, void* hins, int bh, int heads, int n, int p, int s,
                             int chunk, int b_sb, int b_sh, int b_sn, int c_sb, int c_sh, int c_sn,
                             void* stream) {
  if (bh < 0 || heads < 1 || n < 0 || chunk < 1 || chunk > kMaxChunk || (n && n % chunk))
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return (int)cudaSuccess;
  const Strided bs{(const float*)b, b_sb, b_sh, b_sn, heads};
  const Strided cs{(const float*)c, c_sb, c_sh, c_sn, heads};
  const float *xf = (const float*)x, *af = (const float*)dta;
  float *yf = (float*)y, *hf = (float*)hins;
  cudaStream_t st = (cudaStream_t)stream;
  // the (P, S) pairs of the configs: mamba2_1p3b and its smoke config
  if (p == 64 && s == 128)
    return (int)launch_p_s<64, 128>(xf, af, bs, cs, yf, hf, bh, n, chunk, st);
  if (p == 32 && s == 32)
    return (int)launch_p_s<32, 32>(xf, af, bs, cs, yf, hf, bh, n, chunk, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
