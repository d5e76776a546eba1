// ssd_chunk_bwd.cu — the backward of the SSD chunk scan (K10b) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/ssd_chunk/bwd.py::ssd_chunk_bwd_call (the
// pl.pallas_call at :77, body _bwd_kernel :31-52): pull back each chunk
// from its saved carry-in h, with the (P, S) cotangent gh of the chunk's
// carry-out (zero for the last chunk: the forward discards its final
// state; a decay-contracted carry cannot be rebuilt by dividing the decay
// back out, bwd.py:1-14).  With D, G = c b^T, M = G o D, seg and cum as
// in ssd_chunk.cu and gy the chunk's output cotangent, per head:
//
//   gh    = carry-out cotangent: g <- exp(cum_last) g + (exp(cum) o gy)^T c
//           over the chunks from the last
//   dx    = M^T gy + seg o (b gh^T)
//   dM    = gy x^T;  W = sum over the heads of dM o D
//   db    = W^T c + sum_h seg o (x gh)        (B, N, S), summed over heads
//   dc    = W b + sum_h exp(cum) o (gy h)     (B, N, S)
//   dcum  = rows(E) - cols(E) + exp(cum) o rowsum(c o gy h) - seg o dseg,
//           E = dM o G o D, dseg = rowsum(x o (b gh^T)), plus
//           exp(cum_last) sum(gh o h) + sum_j seg_j dseg_j at the last row
//   ddt   = reverse inclusive cumsum of dcum
//
// The plain versions, kernels/ssd_chunk/bwd.py (chunk by chunk, per
// head) and ref.py's decomposition (this one, in PyTorch).
//
// What bounds it on the H100: operations.  The least work per (row,
// chunk) is 3 C (C + 1) S / H (G, W^T c and W b, shared by the H heads),
// 2 C (C + 1) P (gy x^T and M^T gy on the causal triangle) and 8 C P S
// (b gh^T, x gh, gy h and the carry cotangent): 1.06e7 at C = 128, P = 64,
// S = 128, H = 64, against ~1.1 GB moved per call at the training shape.
//
// Design: seven launches per call, each parallel over chunks.
//   ssd_bwd_gram: G = c b^T of each (batch, chunk) into a scratch panel.
//   ssd_bwd_local: each (row, chunk)'s local carry cotangent
//     (exp(cum) o gy)^T c, exp(cum_last), and seg and exp(cum) per
//     position for ssd_bwd_bc.  A row's chunks are stored last first.
//   ssd_bwd_pass: the pass over those slots in memory order: each slot
//     becomes gh, the cotangent of its chunk's carry-out.
//   ssd_bwd_dx: per (row, chunk): b gh^T over S (then dseg, the row dot
//     with x, and the seg scaling), then M^T gy over the chunk's k-tiles on
//     or above the diagonal, M = G o D built as the G chunks land.
//   ssd_bwd_dm: per (batch, chunk, group of up to 8 heads): dM = gy x^T
//     (8 x 8 outputs a thread; the block of a thread's low rows and high
//     columns lies above the diagonal and is skipped), W summed over the
//     group's heads in registers, rows(E) - cols(E) per head, G held in
//     shared memory.  Each group's W goes to scratch.
//   ssd_bwd_bc: per (batch, chunk, 64 columns of S): for every head of the
//     batch row in order, seg-scaled x times gh (into db) and gy times h
//     (into dc, with its row dot against c for dcum) and sum(gh o h); the
//     next head's seg and exp(cum) are copied with the tile before its
//     first.  Then W^T c and W b, W the groups' sum in order.
//   ssd_bwd_ddt: one warp per (row, chunk): dcum and its reverse cumsum as
//     warp scans.
// The heads' partial sums meet in fixed orders; no float atomics.  Shared
// memory per block at P = 64, S = 128: 70 KB (gram), 52 KB (local), 54 KB
// (dx), 146 KB (dm), 93 KB (bc).  No tensor cores.
#include "ssd_chunk_common.cuh"

namespace {

using namespace ssd;

struct BwdArgs {
  const float* x;
  const float* dta;
  BC b, c;
  const float* hins;
  const float* g;
  float *dx, *ddta, *db, *dc;
  float* gram;   // (B, nc, 128, 128): G
  float* e;      // (BH, nc): exp(cum_last)
  float* gh;     // (BH, nc, P, S): local carry cotangents, then gh
  float* dseg;   // (BH, N)
  float* dcum1;  // (BH, N): rows(E) - cols(E)
  float* dcum2;  // (BH, N, nst): exp(cum) rowsum(c o gy h) per column tile
  float* ghh;    // (BH, nc, nst, 8): sum(gh o h) per column tile and warp
  float *seg, *ecum;  // (BH, N) + 4: exp(cum_last - cum), exp(cum) per position
  float* wsum;   // (B, nc, ngroups, 128, 128): W per group of heads
  int batch, heads, n, chunk, nc, ngroups, nst;
};

template <int S>
__host__ __device__ constexpr int col_tile() {
  return S < 64 ? S : 64;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_gram(BwdArgs a) {
  extern __shared__ float smem[];
  const int bt = blockIdx.x / a.nc, ci = blockIdx.x % a.nc;
  gram_block<S>(a.c, a.b, bt, ci * a.chunk, a.chunk,
                a.gram + (long long)blockIdx.x * kMaxChunk * kMaxChunk, smem);
}

// K10b keeps each row's chunks last first in gh and e, so that the pass
// walks them in memory order: chunk ci of row r is slot r nc + nc - 1 - ci.
__host__ __device__ inline long long rev_slot(int r, int nc, int ci) {
  return (long long)r * nc + nc - 1 - ci;
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_local(BwdArgs a) {
  extern __shared__ float smem[];
  const int rows = a.batch * a.heads;  // chunk-major, as ssd_bwd_dx
  const int r = blockIdx.x % rows, ci = blockIdx.x / rows, t0 = ci * a.chunk;
  const long long pos = (long long)r * a.n + t0, slot = rev_slot(r, a.nc, ci);
  local_block<P, S, false>(a.g + pos * P, a.c.at(r / a.heads, t0), a.c.sn, a.dta + pos, a.chunk,
                           a.gh + slot * P * S, a.e + slot, smem, a.seg + pos, a.ecum + pos);
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads) ssd_bwd_pass(BwdArgs a) {
  state_pass(a.gh, a.e, a.batch * a.heads, a.nc, P * S / 4);
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_dx(BwdArgs a) {
  using T = PanelTiles<P>;
  constexpr int nt1 = S / kK;
  using O = Own<kMaxChunk, P, 2, 1>;
  extern __shared__ float smem[];
  float* cum = smem + kStages * T::kStage;
  float* seg = cum + kMaxChunk;
  const int rows = a.batch * a.heads;  // chunk-major: the blocks in flight share b and G
  const int r = blockIdx.x % rows, ci = blockIdx.x / rows, rc = r * a.nc + ci;
  const int t0 = ci * a.chunk, bt = r / a.heads, chunk = a.chunk;
  const float* xr = a.x + ((long long)r * a.n + t0) * P;
  const float* gyr = a.g + ((long long)r * a.n + t0) * P;
  const float* brow = a.b.at(bt, t0);
  const float* ghr = a.gh + rev_slot(r, a.nc, ci) * P * S;
  const float* gm = a.gram + ((long long)bt * a.nc + ci) * kMaxChunk * kMaxChunk;
  if (threadIdx.x < 32) warp_cumsum(a.dta + (long long)r * a.n + t0, chunk, cum);
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxChunk; i += kThreads)
    seg[i] = i < chunk ? expf(cum[chunk - 1] - cum[i]) : 0.f;
  __syncthreads();
  const O o;
  const int ar[2] = {o.row(0), o.row(1)}, bc[1] = {o.col(0)};
  const int nt = nt1 + (chunk + kK - 1) / kK;
  float acc[8][4] = {};
  run_tiles(
      nt, smem, T::kStage,
      [&](int kt, float* buf) {
        if (kt < nt1) {  // b rows j and gh rows p, over s
          issue_rows<kK, kMaxChunk>(buf, brow + kt * kK, a.b.sn, chunk);
          issue_rows<kK, P, true>(buf + T::kInterB, ghr + kt * kK, S, P);
        } else {  // G rows i and gy rows i
          const int i0 = (kt - nt1) * kK;
          issue_rows<kMaxChunk>(buf, gm + i0 * kMaxChunk, kMaxChunk, kK);
          issue_rows<P>(buf + T::kIntraB, gyr + (long long)i0 * P, P, chunk - i0);
        }
      },
      [&](int kt, float* buf) {
        if (kt < nt1) return;
        // M[i][j] = G[i][j] exp(cum_i - cum_j), masked
        const int i0 = (kt - nt1) * kK;
        land_rows<kMaxChunk>(buf, [&](int rr, int c, float4 v) {
          const int i = i0 + rr;
          return make_float4(v.x * decay(cum, i, c, chunk), v.y * decay(cum, i, c + 1, chunk),
                             v.z * decay(cum, i, c + 2, chunk), v.w * decay(cum, i, c + 3, chunk));
        });
      },
      [&](int kt, float* buf) {
        if (!o.on) return;
        if (kt < nt1) {  // rows past the chunk are zeros: no quad skips
          tile_fma<2, 1, T::LA, kK, true, true>(acc, buf, buf + T::kInterB, ar, bc);
          if (kt == nt1 - 1) {  // acc = b gh^T: dseg = rowsum(x o acc), then seg o acc
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const int j = ar[m >> 2] + (m & 3);
              const float4 xv = j < chunk ? ldg4(xr + (long long)j * P + bc[0]) : zero4();
              const float d = row_sum<O::TN>(acc[m][0] * xv.x + acc[m][1] * xv.y +
                                             acc[m][2] * xv.z + acc[m][3] * xv.w);
              if (o.tn == 0 && j < chunk) a.dseg[(long long)r * a.n + t0 + j] = d;
            }
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const float s = seg[ar[m >> 2] + (m & 3)];
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[m][q] *= s;
            }
          }
        } else {  // quads wholly below the diagonal (rows > i0 + 31) skip
          const int i0 = (kt - nt1) * kK;
          tile_fma_pair<1, kLM, T::LP>(acc, buf, buf + T::kIntraB, ar, bc,
                                       ar[0] < chunk && i0 + kK - 1 >= ar[0],
                                       ar[1] < chunk && i0 + kK - 1 >= ar[1]);
        }
      });
  if (!o.on) return;
  float* dxr = a.dx + ((long long)r * a.n + t0) * P;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int j = ar[u] + rr;
      if (j < chunk)
        st4(dxr + (long long)j * P + bc[0], make_float4(acc[4 * u + rr][0], acc[4 * u + rr][1],
                                                        acc[4 * u + rr][2], acc[4 * u + rr][3]));
    }
}

constexpr int dm_smem_floats() {
  return kStages * kMaxChunk * (2 * kK + kPad) + kMaxChunk * kLM + 8 * kMaxChunk + 8 * kMaxChunk +
         kMaxChunk;
}

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dm(BwdArgs a) {
  constexpr int LA = kK + kPad, kB = kMaxChunk * LA, kStage = kB + kMaxChunk * kK, tph = P / kK;
  constexpr unsigned kSkip = 1u << 1;  // low rows x high columns: above the diagonal
  using O = Own<kMaxChunk, kMaxChunk, 2, 2>;
  extern __shared__ float smem[];
  float* gs = smem + kStages * kStage;         // [128][kLM]: the G panel the heads share
  float* cums = gs + kMaxChunk * kLM;    // [8][128]: each head's cumsum
  float* cole = cums + 8 * kMaxChunk;    // [8 warps][128]: column sums of E
  float* rowe = cole + 8 * kMaxChunk;    // [128]: row sums of E
  const int gh = a.heads / a.ngroups;
  const int bc_ = blockIdx.x / a.ngroups, grp = blockIdx.x % a.ngroups;
  const int bt = bc_ / a.nc, ci = bc_ % a.nc, t0 = ci * a.chunk, chunk = a.chunk;
  const int row0 = bt * a.heads + grp * gh;  // the group's first (batch, head) row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* gm = a.gram + (long long)bc_ * kMaxChunk * kMaxChunk;
  issue_rows<kMaxChunk, kMaxChunk>(gs, gm, kMaxChunk, kMaxChunk);
  cp_commit();
  if (warp < gh) warp_cumsum(a.dta + (long long)(row0 + warp) * a.n + t0, chunk,
                             cums + warp * kMaxChunk);
  cp_wait_all();
  __syncthreads();
  const O o;
  const int ar[2] = {o.row(0), o.row(1)}, bc[2] = {o.col(0), o.col(1)};
  float acc[8][8] = {}, w[8][8] = {};
  run_tiles(
      gh * tph, smem, kStage,
      [&](int kt, float* buf) {  // gy rows i and x rows j, over p
        const long long base = ((long long)(row0 + kt / tph) * a.n + t0) * P + (kt % tph) * kK;
        issue_rows<kK, kMaxChunk>(buf, a.g + base, P, chunk);
        issue_rows<kK, kMaxChunk, true>(buf + kB, a.x + base, P, chunk);
      },
      [&](int, float*) {},
      [&](int kt, float* buf) {
        tile_fma<2, 2, LA, kK, true, true, kSkip>(acc, buf, buf + kB, ar, bc);
        if (kt % tph != tph - 1) return;
        // the head's dM is whole: W += dM o D; E = dM o G o D
        const int h = kt / tph;
        const float* cum = cums + h * kMaxChunk;
        float rs[8] = {}, cs[8] = {};
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int i = ar[u] + rr;
#pragma unroll
            for (int g = 0; g < 2; ++g) {
              if ((kSkip >> (u * 2 + g)) & 1u) continue;
              const float4 gv = ld4(gs + i * kLM + bc[g]);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float dmd = acc[4 * u + rr][4 * g + q] * decay(cum, i, bc[g] + q, chunk);
                w[4 * u + rr][4 * g + q] += dmd;
                const float ev = dmd * get(gv, q);
                rs[4 * u + rr] += ev;
                cs[4 * g + q] += ev;
                acc[4 * u + rr][4 * g + q] = 0.f;
              }
            }
          }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          rs[k] = row_sum<O::TN>(rs[k]);
          cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 16);  // the warp's two row quads
        }
        if (o.tn == 0)
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) rowe[ar[u] + rr] = rs[4 * u + rr];
        if (lane < 16)
#pragma unroll
          for (int g = 0; g < 2; ++g)
#pragma unroll
            for (int q = 0; q < 4; ++q) cole[warp * kMaxChunk + bc[g] + q] = cs[4 * g + q];
        __syncthreads();
        if ((int)threadIdx.x < chunk) {
          const int i = threadIdx.x;
          float c = 0.f;
#pragma unroll
          for (int v = 0; v < 8; ++v) c += cole[v * kMaxChunk + i];
          a.dcum1[(long long)(row0 + h) * a.n + t0 + i] = rowe[i] - c;
        }
      });
  float* out = a.wsum + (long long)blockIdx.x * kMaxChunk * kMaxChunk;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        st4(out + (ar[u] + rr) * kMaxChunk + bc[g],
            make_float4(w[4 * u + rr][4 * g], w[4 * u + rr][4 * g + 1], w[4 * u + rr][4 * g + 2],
                        w[4 * u + rr][4 * g + 3]));
}

// ssd_bwd_bc's tiles: A is 128 rows of x, gy or W, m-major (or 32 rows of
// W, k-major, for W^T c); B is 32 rows of gh, h, c or b, ST columns.
template <int S>
struct BcTiles {
  static constexpr int ST = col_tile<S>(), LT = ST + kPad, LA = kK + kPad;
  static constexpr int kA = kMaxChunk * LA > kK * kLM ? kMaxChunk * LA : kK * kLM;
  static constexpr int kStage = kA + kK * LT;
  static constexpr int kFloats = kStages * kStage + 8 * kMaxChunk + kMaxChunk * LT;
};

template <int P, int S>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_bc(BwdArgs a) {
  using T = BcTiles<S>;
  constexpr int ST = T::ST, LT = T::LT, LA = T::LA, tph = P / kK;
  using O = Own<kMaxChunk, ST, 1, 2>;
  extern __shared__ float smem[];
  float* wts = smem + kStages * T::kStage;  // [4 slots][seg, exp(cum)][128]
  float* ct = wts + 8 * kMaxChunk;  // [128][ST]: this block's columns of c
  const int bc_ = blockIdx.x / a.nst, st = blockIdx.x % a.nst, s0 = st * ST;
  const int bt = bc_ / a.nc, ci = bc_ % a.nc, t0 = ci * a.chunk, chunk = a.chunk;
  const int warp = threadIdx.x >> 5;
  const int nth = a.heads * 2 * tph, nw = (chunk + kK - 1) / kK;
  // head h's seg and exp(cum) into slot h % 4, issued with the tile before
  // head h's first (a slot is rewritten only after its head is done); the
  // 16-byte copies may read past the chunk: those entries are never used
  auto weights = [&](int h) {
    if (threadIdx.x >= 2 * kMaxChunk / 4) return;
    const int half = threadIdx.x / (kMaxChunk / 4), i = 4 * (threadIdx.x % (kMaxChunk / 4));
    const long long pos = (long long)(bt * a.heads + h) * a.n + t0 + i;
    cp16(wts + (h & 3) * 2 * kMaxChunk + half * kMaxChunk + i, (half ? a.ecum : a.seg) + pos,
         i < chunk);
  };
  weights(0);
  issue_rows<ST, kMaxChunk>(ct, a.c.at(bt, t0) + s0, a.c.sn, chunk);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  const O o;
  const int ar[1] = {o.row(0)}, bc[2] = {o.col(0), o.col(1)};
  const float* ws = a.wsum + (long long)bc_ * a.ngroups * kMaxChunk * kMaxChunk;
  const long long wstride = (long long)kMaxChunk * kMaxChunk;
  float db[4][8] = {}, dc[4][8] = {}, gyh[4][8] = {};
  float ghh = 0.f;
  float4 keep[Rows<ST>::NV];
  run_tiles(
      nth + 2 * nw, smem, T::kStage,
      [&](int kt, float* buf) {
        if (kt < nth) {  // head h, tile t of P: X (x rows, gh rows) or Y (gy rows, h rows)
          const int h = kt / (2 * tph), q = kt % (2 * tph), p0 = (q >> 1) * kK;
          const long long row = (long long)bt * a.heads + h;
          const float* src = (q & 1) ? a.g : a.x;
          const long long slot = (q & 1) ? row * a.nc + ci : rev_slot(row, a.nc, ci);
          issue_rows<kK, kMaxChunk>(buf, src + (row * a.n + t0) * P + p0, P, chunk);
          issue_rows<ST>(buf + T::kA, ((q & 1) ? a.hins : a.gh) + slot * P * S +
                                          (long long)p0 * S + s0, S, kK);
          if (q == 2 * tph - 1 && h + 1 < a.heads) weights(h + 1);  // lands with this tile
        } else {  // c rows (W^T c) or b rows (W b); W itself lands below
          const int wt = kt - nth, i0 = (wt % nw) * kK;
          issue_rows<ST>(buf + T::kA, (wt < nw ? a.c : a.b).at(bt, t0 + i0) + s0,
                         (wt < nw ? a.c : a.b).sn, chunk - i0);
        }
      },
      [&](int kt, float* buf) {
        if (kt >= nth) {  // W summed over the groups: rows i (W^T c) or m-major (W b)
          const int wt = kt - nth, i0 = (wt % nw) * kK;
          if (wt < nw) load_rows_sum<kMaxChunk>(buf, ws + i0 * kMaxChunk, kMaxChunk, a.ngroups, wstride);
          else load_rows_sum<kK, kMaxChunk>(buf, ws + i0, kMaxChunk, a.ngroups, wstride);
          return;
        }
        const int h = kt / (2 * tph), q = kt % (2 * tph);
        float* tb = buf + T::kA;
        // this thread's chunks of the gh tile, then of the h tile at the
        // same places: sum(gh o h) needs no other thread's data
#pragma unroll
        for (int v = 0; v < Rows<ST>::NV; ++v) {
          const int it = threadIdx.x + v * kThreads;
          const float4 x = ld4(tb + tile_at<ST, false>(it / Rows<ST>::Q, (it % Rows<ST>::Q) * 4));
          if (q & 1) ghh += dot4(keep[v], x);
          else keep[v] = x;
        }
        if (!(q & 1)) {  // seg_j x_j: the heads' seg o (x gh) sum straight into db
          const float* sg = wts + (h & 3) * 2 * kMaxChunk;
          land_rows<kK, kMaxChunk>(buf, [&](int rr, int, float4 x) {
            return scale4(x, rr < chunk ? sg[rr] : 0.f);
          });
        }
      },
      [&](int kt, float* buf) {
        const float *ta = buf, *tb = buf + T::kA;
        if (kt >= nth) {
          if (!o.on) return;
          if (kt - nth < nw) tile_fma<1, 2, kLM, LT, false, false>(db, ta, tb, ar, bc);
          else tile_fma<1, 2, LA, LT, true, false>(dc, ta, tb, ar, bc);
          return;
        }
        const int h = kt / (2 * tph), q = kt % (2 * tph);
        if (o.on) {
          if (q & 1) tile_fma<1, 2, LA, LT, true, false>(gyh, ta, tb, ar, bc);
          else tile_fma<1, 2, LA, LT, true, false>(db, ta, tb, ar, bc);
        }
        if (q != 2 * tph - 1) return;
        // head h is done: dc += exp(cum) o gyh, its dcum term, sum(gh o h)
        const long long row = (long long)bt * a.heads + h;
        const float* ec = wts + (h & 3) * 2 * kMaxChunk + kMaxChunk;
        if (o.on) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int i = ar[0] + rr;
            float d = 0.f;
            if (i < chunk) {
#pragma unroll
              for (int g = 0; g < 2; ++g) {
                const float4 cv = ld4(ct + i * (ST + kPad) + bc[g]);
                d += gyh[rr][4 * g] * cv.x + gyh[rr][4 * g + 1] * cv.y +
                     gyh[rr][4 * g + 2] * cv.z + gyh[rr][4 * g + 3] * cv.w;
              }
            }
            d = row_sum<O::TN>(d);
            const float e = i < chunk ? ec[i] : 0.f;
            if (o.tn == 0 && i < chunk) a.dcum2[((row * a.n) + t0 + i) * a.nst + st] = e * d;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              dc[rr][k] += e * gyh[rr][k];
              gyh[rr][k] = 0.f;
            }
          }
        }
        const float t = row_sum<32>(ghh);
        ghh = 0.f;
        if ((threadIdx.x & 31) == 0) a.ghh[((row * a.nc + ci) * a.nst + st) * 8 + warp] = t;
      });
  if (!o.on) return;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = ar[0] + rr;
    if (i >= chunk) continue;
    const long long off = ((long long)bt * a.n + t0 + i) * S + s0;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      st4(a.db + off + bc[g], make_float4(db[rr][4 * g], db[rr][4 * g + 1], db[rr][4 * g + 2],
                                          db[rr][4 * g + 3]));
      st4(a.dc + off + bc[g], make_float4(dc[rr][4 * g], dc[rr][4 * g + 1], dc[rr][4 * g + 2],
                                          dc[rr][4 * g + 3]));
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_ddt(BwdArgs a) {
  __shared__ float cums[8][kMaxChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rc = (long long)blockIdx.x * 8 + warp;
  const int rows = a.batch * a.heads;
  if (rc >= (long long)rows * a.nc) return;  // whole warps
  const int r = (int)(rc / a.nc), ci = (int)(rc % a.nc), t0 = ci * a.chunk, chunk = a.chunk;
  float* cum = cums[warp];
  const long long pos = (long long)r * a.n + t0;
  warp_cumsum(a.dta + pos, chunk, cum);
  const int last = chunk - 1;
  float ghh = 0.f;
  for (int k = 0; k < a.nst * 8; ++k) ghh += a.ghh[rc * a.nst * 8 + k];
  float d[4], sd = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    d[q] = 0.f;
    if (i < chunk) {
      const float seg = expf(cum[last] - cum[i]), ds = a.dseg[pos + i];
      float v = a.dcum1[pos + i];
      for (int st = 0; st < a.nst; ++st) v += a.dcum2[(pos + i) * a.nst + st];
      d[q] = v - seg * ds;
      sd += seg * ds;
    }
  }
  sd = row_sum<32>(sd);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * lane + q == last) d[q] += expf(cum[last]) * ghh + sd;
  // ddt_i = sum_{k >= i} dcum_k: each lane's suffix sums, then the lanes'
  float loc[4], run = 0.f;
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    run += d[q];
    loc[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * lane + q;
    if (i < chunk) a.ddta[pos + i] = excl + loc[q];
  }
}

template <class K>
cudaError_t allow_smem(K kern, int floats) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(floats * sizeof(float)));
}

template <int P, int S>
cudaError_t launch(const BwdArgs& a, int bh, cudaStream_t st) {
  cudaError_t err;
  constexpr int f0 = gram_smem_floats<S>(), f1 = local_smem_floats<P, S>(),
                f3 = PanelTiles<P>::kFloats, f4 = dm_smem_floats(), f5 = BcTiles<S>::kFloats;
  if ((err = allow_smem(ssd_bwd_gram<S>, f0)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_local<P, S>, f1)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_dx<P, S>, f3)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_dm<P, S>, f4)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_bwd_bc<P, S>, f5)) != cudaSuccess) return err;
  const int bnc = a.batch * a.nc;
  ssd_bwd_gram<S><<<bnc, kThreads, f0 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_local<P, S><<<bh * a.nc, kThreads, f1 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long q = (long long)bh * P * S / 4;
  ssd_bwd_pass<P, S><<<(unsigned)((q + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx<P, S><<<bh * a.nc, kThreads, f3 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dm<P, S><<<bnc * a.ngroups, kThreads, f4 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_bc<P, S><<<bnc * a.nst, kThreads, f5 * sizeof(float), st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_ddt<<<(bh * a.nc + 7) / 8, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

bool dims_ok(int bh, int batch, int n, int p, int s, int chunk) {
  return bh >= 0 && batch >= 1 && bh % batch == 0 && n >= 0 && chunk >= 1 &&
         chunk <= kMaxChunk && (n == 0 || n % chunk == 0) &&
         ((p == 64 && s == 128) || (p == 32 && s == 32));
}

// Carve the scratch (ssd_chunk_bwd_workspace floats) into a's buffers;
// returns the floats used.
long long carve(BwdArgs* a, float* w, int bh, int p, int s) {
  const long long nc = a->nc, n = a->n;
  const long long sizes[10] = {(long long)a->batch * nc * kMaxChunk * kMaxChunk,
                              bh * nc,
                              bh * nc * p * s,
                              bh * n,
                              bh * n,
                              bh * n * a->nst,
                              bh * nc * a->nst * 8,
                              (long long)a->batch * nc * a->ngroups * kMaxChunk * kMaxChunk,
                              bh * n + 4,
                              bh * n + 4};
  float** dst[10] = {&a->gram, &a->e,    &a->gh,   &a->dseg, &a->dcum1,
                     &a->dcum2, &a->ghh, &a->wsum, &a->seg,  &a->ecum};
  long long off = 0;
  for (int k = 0; k < 10; ++k) {
    if (w) *dst[k] = w + off;
    off += align4(sizes[k]);
  }
  return off;
}

BwdArgs shape_args(int bh, int batch, int n, int s, int chunk) {
  BwdArgs a = {};
  a.batch = batch;
  a.heads = bh / batch;
  a.n = n;
  a.chunk = chunk;
  a.nc = n / chunk;
  a.ngroups = a.heads / group_heads(a.heads);
  a.nst = s / (s < 64 ? s : 64);
  return a;
}

}  // namespace

// Floats of scratch ssd_chunk_bwd needs (G panels, the carry cotangents,
// the dcum pieces, W per group of heads); -1 for what it refuses.
extern "C" long long ssd_chunk_bwd_workspace(int bh, int batch, int n, int p, int s, int chunk) {
  if (!dims_ok(bh, batch, n, p, s, chunk)) return -1;
  if (bh == 0 || n == 0) return 0;
  BwdArgs a = shape_args(bh, batch, n, s, chunk);
  return carve(&a, nullptr, bh, p, s);
}

// x, g, dx (BH, N, P), dta, ddta (BH, N, 1), hins (BH, N / chunk, P, S):
// fp32, contiguous and 16-byte aligned; b and c as for ssd_chunk_fwd;
// db, dc (B, N, S) contiguous, summed over the heads of a batch row; work
// ssd_chunk_bwd_workspace floats, 16-byte aligned.  (P, S) in {(64, 128),
// (32, 32)}, 1 <= chunk <= 128 dividing N.  Six launches on `stream`.
// Returns a cudaError_t.
extern "C" int ssd_chunk_bwd(const void* x, const void* dta, const void* b, const void* c,
                             const void* hins, const void* g, void* dx, void* ddta, void* db,
                             void* dc, void* work, int bh, int batch, int n, int p, int s,
                             int chunk, long long b_sb, long long b_sn, long long c_sb,
                             long long c_sn, void* stream) {
  if (!dims_ok(bh, batch, n, p, s, chunk)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || n == 0) return (int)cudaSuccess;
  BwdArgs a = shape_args(bh, batch, n, s, chunk);
  a.x = (const float*)x;
  a.dta = (const float*)dta;
  a.b = BC{(const float*)b, b_sb, b_sn};
  a.c = BC{(const float*)c, c_sb, c_sn};
  a.hins = (const float*)hins;
  a.g = (const float*)g;
  a.dx = (float*)dx;
  a.ddta = (float*)ddta;
  a.db = (float*)db;
  a.dc = (float*)dc;
  carve(&a, (float*)work, bh, p, s);
  cudaStream_t st = (cudaStream_t)stream;
  // the (P, S) pairs of the configs: mamba2_1p3b and its smoke config
  if (p == 64) return (int)launch<64, 128>(a, bh, st);
  return (int)launch<32, 32>(a, bh, st);
}

extern "C" const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
