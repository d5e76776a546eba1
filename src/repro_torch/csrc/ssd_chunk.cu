// ssd_chunk.cu — the Mamba-2 SSD chunk scan (K10a) for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_chunk/ssd_chunk.py::ssd_chunk_call, both of
// its pl.pallas_call sites: :138 (_kernel) and :145 (_kernel_hins, which
// also writes each chunk's carry-in for the backward).  Per (batch, head)
// row, for x (N, P) pre-scaled by dt, log decays a = dt A (N), b and c
// (N, S) shared by the heads of a batch row, and each chunk of C
// positions with carry-in h (P, S):
//
//   cum    = inclusive cumsum of a over the chunk
//   y_i    = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) (h c_i)
//   h_out  = exp(cum_last) h + sum_j exp(cum_last - cum_j) x_j (x) b_j
//
// (_ssd_step, ssd_chunk.py:32-64, which clamps cum_i - cum_j at 0 where
// this masks it: see decay() in ssd_chunk_common.cuh), all fp32.
//
// What bounds it on the H100: operations.  The least work per (row,
// chunk) is C (C + 1) S / H for c b^T (shared by the H heads of a batch
// row), C (C + 1) P for the masked panel times x (the causal triangle)
// and 4 C P S for c h^T and the state: 5.28e6 at C = 128, P = 64,
// S = 128, H = 64, against ~2 KB of x, y and dta per position and head:
// ~100 operations per byte, five times the ~20 at which the card's fp32
// FMA rate (67 TFLOP/s) meets its memory.
//
// Design: the chunk axis in parallel, four launches per call.
//   ssd_fwd_gram: G^T = b c^T of each (batch, chunk), once for its H
//     heads, into a 128 x 128 scratch panel that they read from L2.
//   ssd_fwd_local: each (row, chunk)'s local state (x o seg)^T b, into the
//     carry-in buffer, and exp(cum_last).
//   ssd_fwd_pass: the state pass, h <- exp(cum_last) h + S_c over the
//     chunks in order, in place: each buffer slot ends as its chunk's
//     carry-in (the hins output, or scratch without it).
//   ssd_fwd_out: per (row, chunk), y = exp(cum) o (c h^T) over the k-tiles
//     of S (c m-major, h n-major: both as they lie in memory), then
//     + (G o D) x over the k-tiles of the chunk on or below the diagonal
//     (D built from the row's cumsum as each thread's G^T chunks land).
//     Each thread owns rows from both ends of the chunk, so the causal
//     product is balanced.
// The per-(row, chunk) grids run chunk-major, so the blocks in flight
// share their chunk's b, c and G^T in L2.  Shared memory per block at
// P = 64, S = 128: 70 KB (gram), 52 KB (local), 54 KB (out).  Any C from
// 1 to 128 that divides N works.  No tensor cores.
#include "ssd_chunk_common.cuh"

namespace {

using namespace ssd;

struct FwdArgs {
  const float* x;
  const float* dta;
  BC b, c;
  float* y;
  float* states;  // (BH, nc, P, S): local states, then carry-ins
  float* e;       // (BH, nc): exp(cum_last)
  float* gram;    // (B, nc, 128, 128): G^T
  int batch, heads, n, chunk, nc;
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_gram(FwdArgs a) {
  extern __shared__ float smem[];
  const int bt = blockIdx.x / a.nc, ci = blockIdx.x % a.nc;
  gram_block<S>(a.b, a.c, bt, ci * a.chunk, a.chunk,
                a.gram + (long long)blockIdx.x * kMaxChunk * kMaxChunk, smem);
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_local(FwdArgs a) {
  extern __shared__ float smem[];
  const int rows = a.batch * a.heads;  // chunk-major, as ssd_fwd_out
  const int r = blockIdx.x % rows, ci = blockIdx.x / rows, rc = r * a.nc + ci, t0 = ci * a.chunk;
  local_block<P, S, true>(a.x + ((long long)r * a.n + t0) * P, a.b.at(r / a.heads, t0), a.b.sn,
                          a.dta + (long long)r * a.n + t0, a.chunk,
                          a.states + (long long)rc * P * S, a.e + rc, smem);
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads) ssd_fwd_pass(FwdArgs a) {
  state_pass(a.states, a.e, a.batch * a.heads, a.nc, P * S / 4);
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_out(FwdArgs a) {
  using T = PanelTiles<P>;
  constexpr int nt1 = S / kK;
  using O = Own<kMaxChunk, P, 2, 1>;
  extern __shared__ float smem[];
  float* cum = smem + kStages * T::kStage;
  float* ecum = cum + kMaxChunk;
  const int rows = a.batch * a.heads;  // chunk-major: the blocks in flight share c and G^T
  const int r = blockIdx.x % rows, ci = blockIdx.x / rows, rc = r * a.nc + ci;
  const int t0 = ci * a.chunk, bt = r / a.heads, chunk = a.chunk;
  const float* xr = a.x + ((long long)r * a.n + t0) * P;
  const float* crow = a.c.at(bt, t0);
  const float* hin = a.states + (long long)rc * P * S;
  const float* gt = a.gram + ((long long)bt * a.nc + ci) * kMaxChunk * kMaxChunk;
  if (threadIdx.x < 32) warp_cumsum(a.dta + (long long)r * a.n + t0, chunk, cum);
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxChunk; i += kThreads) ecum[i] = i < chunk ? expf(cum[i]) : 0.f;
  __syncthreads();
  const O o;
  const int ar[2] = {o.row(0), o.row(1)}, bc[1] = {o.col(0)};
  const int nt = nt1 + (chunk + kK - 1) / kK;
  float acc[8][4] = {};
  run_tiles(
      nt, smem, T::kStage,
      [&](int kt, float* buf) {
        if (kt < nt1) {  // c rows i and h rows p, over s
          issue_rows<kK, kMaxChunk>(buf, crow + kt * kK, a.c.sn, chunk);
          issue_rows<kK, P, true>(buf + T::kInterB, hin + kt * kK, S, P);
        } else {  // G^T rows j and x rows j
          const int j0 = (kt - nt1) * kK;
          issue_rows<kMaxChunk>(buf, gt + j0 * kMaxChunk, kMaxChunk, kK);
          issue_rows<P>(buf + T::kIntraB, xr + (long long)j0 * P, P, chunk - j0);
        }
      },
      [&](int kt, float* buf) {
        if (kt < nt1) return;
        // (G o D)^T[j][i] = G^T[j][i] exp(cum_i - cum_j), masked
        const int j0 = (kt - nt1) * kK;
        land_rows<kMaxChunk>(buf, [&](int rr, int c, float4 v) {
          const int j = j0 + rr;
          return make_float4(v.x * decay(cum, c, j, chunk), v.y * decay(cum, c + 1, j, chunk),
                             v.z * decay(cum, c + 2, j, chunk), v.w * decay(cum, c + 3, j, chunk));
        });
      },
      [&](int kt, float* buf) {
        if (!o.on) return;
        if (kt < nt1) {  // rows past the chunk are zeros: no quad skips
          tile_fma<2, 1, T::LA, kK, true, true>(acc, buf, buf + T::kInterB, ar, bc);
          if (kt == nt1 - 1) {  // the inter-chunk term: exp(cum_i) (c_i . h)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) {
                const float s = ecum[ar[u] + rr];
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[4 * u + rr][q] *= s;
              }
          }
        } else {  // quads wholly above the diagonal (rows < j0) skip
          const int j0 = (kt - nt1) * kK;
          tile_fma_pair<1, kLM, T::LP>(acc, buf, buf + T::kIntraB, ar, bc,
                                       ar[0] < chunk && j0 <= ar[0] + 3,
                                       ar[1] < chunk && j0 <= ar[1] + 3);
        }
      });
  if (!o.on) return;
  float* yr = a.y + ((long long)r * a.n + t0) * P;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = ar[u] + rr;
      if (i < chunk)
        st4(yr + (long long)i * P + bc[0], make_float4(acc[4 * u + rr][0], acc[4 * u + rr][1],
                                                       acc[4 * u + rr][2], acc[4 * u + rr][3]));
    }
}

template <class K>
cudaError_t allow_smem(K kern, int floats) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

template <int P, int S>
cudaError_t launch(const FwdArgs& a, int bh, cudaStream_t st) {
  cudaError_t err;
  constexpr int f0 = gram_smem_floats<S>(), f1 = local_smem_floats<P, S>(),
                f3 = PanelTiles<P>::kFloats;
  if ((err = allow_smem(ssd_fwd_gram<S>, f0)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_fwd_local<P, S>, f1)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_fwd_out<P, S>, f3)) != cudaSuccess) return err;
  ssd_fwd_gram<S><<<a.batch * a.nc, kThreads, f0 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_fwd_local<P, S><<<bh * a.nc, kThreads, f1 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long q = (long long)bh * P * S / 4;
  ssd_fwd_pass<P, S><<<(unsigned)((q + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_fwd_out<P, S><<<bh * a.nc, kThreads, f3 * sizeof(float), st>>>(a);
  return cudaGetLastError();
}

bool dims_ok(int bh, int batch, int n, int p, int s, int chunk) {
  return bh >= 0 && batch >= 1 && bh % batch == 0 && n >= 0 && chunk >= 1 &&
         chunk <= kMaxChunk && (n == 0 || n % chunk == 0) &&
         ((p == 64 && s == 128) || (p == 32 && s == 32));
}

}  // namespace

// Floats of scratch ssd_chunk_fwd needs: the G^T panels, exp(cum_last)
// per (row, chunk) and, without hins, the states.  -1 for what it refuses.
extern "C" long long ssd_chunk_fwd_workspace(int bh, int batch, int n, int p, int s, int chunk,
                                             int hins) {
  if (!dims_ok(bh, batch, n, p, s, chunk)) return -1;
  const long long nc = n ? n / chunk : 0;
  return align4(batch * nc * kMaxChunk * kMaxChunk) + align4(bh * nc) +
         (hins ? 0 : (long long)bh * nc * p * s);
}

// x (BH, N, P), dta (BH, N, 1) and y (BH, N, P) fp32, contiguous and
// 16-byte aligned; b and c fp32 (B, N, S) rows shared by the BH / B heads
// of a batch row (row t of batch i at base + i * s_b + t * s_n, strides in
// floats, multiples of 4); hins (BH, N / chunk, P, S) or null; work
// ssd_chunk_fwd_workspace floats, 16-byte aligned.  (P, S) in {(64, 128),
// (32, 32)}, 1 <= chunk <= 128 dividing N.  Three launches on `stream`.
// Returns a cudaError_t.
extern "C" int ssd_chunk_fwd(const void* x, const void* dta, const void* b, const void* c,
                             void* y, void* hins, void* work, int bh, int batch, int n, int p,
                             int s, int chunk, long long b_sb, long long b_sn, long long c_sb,
                             long long c_sn, void* stream) {
  if (!dims_ok(bh, batch, n, p, s, chunk)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return (int)cudaSuccess;
  FwdArgs a;
  a.x = (const float*)x;
  a.dta = (const float*)dta;
  a.b = BC{(const float*)b, b_sb, b_sn};
  a.c = BC{(const float*)c, c_sb, c_sn};
  a.y = (float*)y;
  a.batch = batch;
  a.heads = bh / batch;
  a.n = n;
  a.chunk = chunk;
  a.nc = n / chunk;
  float* w = (float*)work;
  a.gram = w;
  w += align4((long long)batch * a.nc * kMaxChunk * kMaxChunk);
  a.e = w;
  w += align4((long long)bh * a.nc);
  a.states = hins ? (float*)hins : w;
  cudaStream_t st = (cudaStream_t)stream;
  // the (P, S) pairs of the configs: mamba2_1p3b and its smoke config
  if (p == 64) return (int)launch<64, 128>(a, bh, st);
  return (int)launch<32, 32>(a, bh, st);
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
