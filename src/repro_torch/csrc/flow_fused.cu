// flow_fused.cu — strict-causal Flow-Attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flow_fused/flow_fused.py::
// flow_fused_call (the pl.pallas_call at :207, math in _chunk_step :56-141).
// It computes, per (row * kv head), the strict-causal Flow-Attention of
// paper Alg. 2 with per-row `lens` masking, and the boundary FlowState (four
// (D,) flow sums, z, and the (D, Dv) state S) frozen at each row's length.
//
// What bounds it on the H100: operations.  Per live position it needs
// 2 (G + 1) D Dv operations for the aggregation (q_in S and S += phi(k)^T
// (v e)) and ~7 (G + 1) D for the flows, all fp32 FMA on the CUDA cores
// (no tensor cores, no TF32) at 67 TFLOP/s, against ~2 (G + 2) D bytes of
// q, k, v and out: ~60 operations per byte at D = 64, three times what the
// card's memory rate would need.
//
// Design: the chunk axis in parallel, four launches per call (the pieces
// shared with K2 are in flow_fused_common.cuh).
//   flow_fwd_flows: one block of 1024 threads per row walks its live
//     super-chunks of T = 8192 / D positions (4096 / D or 2048 / D where a
//     larger group does not fit) through the three flow levels, each a
//     block-wide segmented scan and warp-reduced dot products with eight
//     rows in flight per warp, and writes sink_in, the output scale r alloc
//     (G, N) and e (N) per position, then the boundary sums and z.  With
//     one block per row it is a chain of latencies, not of operations:
//     1024 threads (four positions a thread per scan) and the largest
//     super-chunk that fits keep the chain short.
//   flow_fwd_state: per (row, chunk of C = 64 positions; 32 at D = 128) the
//     chunk state phi(k)^T (v e), D x Dv, register-blocked; dead chunks
//     skip.
//   flow_fwd_pass: the exclusive pass over each row's live chunks in chunk
//     order, in place, one thread per float4 of a row's state with eight
//     chunks' loads in flight; the sum of them all is the boundary S.
//   flow_fwd_out: per (row, chunk), for each group, the causal panel
//     tril(q_in phi(k)^T), then out = (panel (v e) + q_in S_<c) r alloc
//     over the whole of Dv; dead chunks write zeros.
// The per-(row, chunk) grids run chunk-major.  Chunking only reorders fp32
// sums: the kernel's C and T are its own, independent of the caller's
// chunk.  Shared memory per block at D = 64, G = 1: 204 KB (flows), 32 KB
// (state), 80 KB (out, two blocks an SM).
//
// D = 192 (DeepSeek-V2's MLA heads beside Dv = 128, Nemotron-4-340B's with
// Dv = 192) runs its own instantiations: the flows in super-chunks of a
// multiple of five positions (five scan segments of 192 columns), the
// products over Dv in panels of 64 (panel_of), chunks of C = 32.  Shared
// memory per block at D = 192: 143 KB (flows, G = 12, T = 10) and 196 KB
// (G = 1, T = 40); 40 KB (state, Dv = 128); 164 KB (out, Dv = 128) and
// 220 KB (out, Dv = 192), one block an SM.
//
// D = 256 (RecurrentGemma's heads, Dv = 256, G = 16) runs its own
// instantiation the same way: flows in super-chunks of a multiple of four
// positions (four scan segments of 256 columns; T = 8 at G = 16, 185 KB),
// the chunk state in panels of 64 columns (64 accumulators a thread, 64 KB
// of operands), chunks of C = 32.  The out stage cannot hold S_<c (256 KB
// fp32), so it streams S_<c one panel of 64 columns at a time (64 KB),
// restaged for each group and panel from L2: 164 KB of shared memory, one
// block an SM.  A G whose flows do not fit the block's shared memory even
// at the smallest super-chunk (G > 21 at D = 256) is refused by the
// workspace count.
//
// D = 24 (the Table 7 harness's heads) runs the D = 32 instantiation on
// rows the wrapper zero-pads to 32, with the real width dr = 24 passed
// down: phi is 0 on lanes 24-31 and the flow dots skip them
// (flow_fused_common.cuh), so the outputs there are exactly 0.
#include "flow_fused_common.cuh"

namespace {

using namespace ff;

template <typename TT, int D, int T>
__global__ void __launch_bounds__(kFlowThreads) flow_fwd_flows(FlowArgs<TT> a) {
  extern __shared__ float smem[];
  flows_body<TT, D, T>(a, smem);
}

template <typename TT, int D, int DV>
__global__ void __launch_bounds__(kThreads) flow_fwd_state(StateArgs<TT, D> a, int rows) {
  extern __shared__ float smem[];
  const int2 rc = row_chunk(blockIdx.x, rows);
  state_block<TT, D, DV>(a, 0, rc.x, rc.y, smem);
}

__global__ void __launch_bounds__(kThreads) flow_fwd_pass(PassArgs a) { pass_body(a, false); }

template <typename TT>
struct OutArgs {
  const TT *q, *k, *v;
  const int* lens;
  const float *sink, *scale, *e, *states;
  TT* out;
  int G, N, phi, rows, dr;
};

// Whether the out stage streams S_<c in panels of Dv (D = 256: the whole
// state, 256 KB fp32, does not fit a block's shared memory) or stages it
// once.
template <int D, int DV>
__host__ __device__ constexpr bool streams_state() { return D * DV > 192 * 192; }

template <int D, int DV>
constexpr int out_smem_floats() {
  constexpr int C = chunk_of<D>();
  constexpr int SW = streams_state<D, DV>() ? panel_of<D, DV>() : DV;
  return 2 * C * D + C * DV + D * SW + C * C;
}

template <typename TT, int D, int DV>
__global__ void __launch_bounds__(kThreads, 2) flow_fwd_out(OutArgs<TT> a) {
  constexpr int C = chunk_of<D>(), PW = panel_of<D, DV>(), NP = DV / PW;
  constexpr bool SS = streams_state<D, DV>();
  constexpr int SW = SS ? PW : DV;  // the staged width of S_<c
  extern __shared__ float smem[];
  float* Q = smem;         // C x D: q_in of one group
  float* K = Q + C * D;    // C x D: phi(k)
  float* V = K + C * D;    // C x DV: v e
  float* S = V + C * DV;   // D x SW: S_<c, or one panel of it
  float* P = S + D * SW;   // C x C: the causal panel
  const int2 rc = row_chunk(blockIdx.x, a.rows);
  const int row = rc.x, ci = rc.y, G = a.G, N = a.N, c0 = ci * C;
  const int len = min(a.lens[row], N);
  TT* orow = a.out + (size_t)row * G * N * DV;
  if (c0 >= len) {  // a dead chunk: exactly zero
    constexpr int Q4 = DV / 4;
    for (int i = threadIdx.x; i < G * C * Q4; i += kThreads) {
      const int g = i / (C * Q4), r = i - g * C * Q4, t = r / Q4, c = (r - t * Q4) * 4;
      if (c0 + t < N) store4(orow + ((size_t)g * N + c0 + t) * DV + c, zero4());
    }
    return;
  }
  const TT* kr = a.k + (size_t)row * N * D;
  const TT* vr = a.v + (size_t)row * N * DV;
  const float* er = a.e + (size_t)row * N;
  stage<C, D>(K, [&](int t, int c) {
    const int n = c0 + t;
    return n < len && c < a.dr ? phi4(load4(kr + (size_t)n * D + c), a.phi) : zero4();
  });
  stage<C, DV>(V, [&](int t, int c) {
    const int n = c0 + t;
    return n < len ? scale4(load4(vr + (size_t)n * DV + c), er[n]) : zero4();
  });
  const int nc = (N + C - 1) / C;
  const float* slot = a.states + ((size_t)row * nc + ci) * D * DV;
  if constexpr (!SS) stage<D, DV>(S, [&](int t, int c) { return ld4(slot + t * DV + c); });
  using OP = Own<C, C>;
  using OY = Own<C, PW>;  // one panel of Dv
  const OP op;
  const OY oy;
  const int kmax = min(C, (oy.r0 + OY::RM + 3) & ~3);  // the panel's causal extent
  for (int g = 0; g < G; ++g) {
    const size_t rg = (size_t)row * G + g;
    const TT* qr = a.q + rg * N * D;
    stage<C, D>(Q, [&](int t, int c) {
      const int n = c0 + t;
      return n < len && c < a.dr
                 ? scale4(phi4(load4(qr + (size_t)n * D + c), a.phi), a.sink[rg * N + n])
                 : zero4();
    });
    __syncthreads();
    {
      float acc[OP::RM][4];
      zero_acc(acc);
      mm_mn<OP::RM, D, D, D>(acc, Q, K, op.r0, op.c0);
      put_tile<OP::RM, C, true>(P, acc, op.r0, op.c0);
    }
    __syncthreads();
    for (int pn = 0; pn < NP; ++pn) {
      const int cy = pn * PW + oy.c0;
      if constexpr (SS) {  // this panel of S_<c
        stage<D, PW>(S, [&](int t, int c) { return ld4(slot + t * DV + pn * PW + c); });
        __syncthreads();
      }
      float acc[OY::RM][4];
      zero_acc(acc);
      mm_mk<OY::RM, C, DV>(acc, P, V, oy.r0, cy, kmax);
      mm_mk<OY::RM, D, SW>(acc, Q, S, oy.r0, SS ? oy.c0 : cy, D);
#pragma unroll
      for (int i = 0; i < OY::RM; ++i) {
        const int n = c0 + oy.r0 + i;
        if (n >= N) continue;
        const float s = n < len ? a.scale[rg * N + n] : 0.f;
        store4(orow + ((size_t)g * N + n) * DV + cy,
               make_float4(acc[i][0] * s, acc[i][1] * s, acc[i][2] * s, acc[i][3] * s));
      }
      if constexpr (SS) __syncthreads();  // S is restaged for the next panel
    }
    __syncthreads();  // Q and P are restaged for the next group
  }
}

template <typename TT, int D, int T>
cudaError_t flows_at(const FlowArgs<TT>& fa, int bh, cudaStream_t st) {
  const size_t f = flow_smem_floats<D, T>(fa.G);
  cudaError_t err = allow_smem(flow_fwd_flows<TT, D, T>, f);
  if (err != cudaSuccess) return err;
  flow_fwd_flows<TT, D, T><<<bh, kFlowThreads, f * sizeof(float), st>>>(fa);
  return cudaGetLastError();
}

// Stage 1 at the super-chunk t (a flows_tile).
template <typename TT, int D>
cudaError_t flows(const FlowArgs<TT>& fa, int t, int bh, cudaStream_t st) {
  constexpr int S = flow_segs<D>();
  if (t == 8 * S) return flows_at<TT, D, 8 * S>(fa, bh, st);
  if (t == 4 * S) return flows_at<TT, D, 4 * S>(fa, bh, st);
  return flows_at<TT, D, 2 * S>(fa, bh, st);
}

struct Work {
  float *sink, *scale, *e, *states;
};

// Floats of scratch for (bh, g, n, d, dv), d and dv the stored widths:
// sink_in, the output scale, e and the chunk states.
long long work_floats(int bh, int g, int n, int d, int dv, Work& w, float* base) {
  const int c = d >= 128 ? 32 : 64;
  const long long nc = (n + c - 1) / c;
  const long long sizes[4] = {align4((long long)bh * g * n), align4((long long)bh * g * n),
                              align4((long long)bh * n), (long long)bh * nc * d * dv};
  float** slots[4] = {&w.sink, &w.scale, &w.e, &w.states};
  long long off = 0;
  for (int i = 0; i < 4; ++i) {
    if (base) *slots[i] = base + off;
    off += sizes[i];
  }
  return off;
}

template <typename TT, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens, void* out,
                   void* q_sum, void* k_sum, void* ko_sum, void* qi_sum, void* z, void* s,
                   void* work, int bh, int g, int n, int phi, int use_alloc, float eps, int dr,
                   cudaStream_t st) {
  constexpr int C = chunk_of<D>();
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int T = flows_tile<D>(g, limit);
  if (T == 0) return cudaErrorInvalidValue;
  Work w;
  work_floats(bh, g, n, D, DV, w, (float*)work);

  FlowArgs<TT> fa{(const TT*)q, (const TT*)k, (const int*)lens, w.sink, w.scale, w.e, nullptr, T,
                  (float*)q_sum, (float*)k_sum, (float*)ko_sum, (float*)qi_sum, (float*)z,
                  g, n, phi, use_alloc, eps, dr};
  if ((err = flows<TT, D>(fa, T, bh, st)) != cudaSuccess) return err;

  const int nc = (n + C - 1) / C;
  StateArgs<TT, D> sa{(const TT*)q, (const TT*)k, (const TT*)v, nullptr, (const int*)lens,
                      w.sink, w.scale, w.e, w.states, nullptr, g, n, phi, dr};
  constexpr int fs = state_smem_floats<D, DV>();
  if ((err = allow_smem(flow_fwd_state<TT, D, DV>, fs)) != cudaSuccess) return err;
  flow_fwd_state<TT, D, DV><<<bh * nc, kThreads, fs * sizeof(float), st>>>(sa, bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  PassArgs pa{(const int*)lens, w.states, nullptr, (float*)s, nullptr, bh, n, C, D * DV / 4};
  const long long q4 = (long long)bh * D * DV / 4;
  flow_fwd_pass<<<(unsigned)((q4 + kThreads - 1) / kThreads), kThreads, 0, st>>>(pa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  OutArgs<TT> oa{(const TT*)q, (const TT*)k, (const TT*)v, (const int*)lens, w.sink, w.scale,
                 w.e, w.states, (TT*)out, g, n, phi, bh, dr};
  constexpr int fo = out_smem_floats<D, DV>();
  if ((err = allow_smem(flow_fwd_out<TT, D, DV>, fo)) != cudaSuccess) return err;
  flow_fwd_out<TT, D, DV><<<bh * nc, kThreads, fo * sizeof(float), st>>>(oa);
  return cudaGetLastError();
}

// The (D, Dv) pairs with an instantiation: D == Dv in {32, 64, 128, 256}
// (24 stored as 32), and D = 192 beside Dv = 128 or 192.
inline bool takes(int d, int dv) {
  if (d == 192) return dv == 128 || dv == 192;
  if (d == 256) return dv == 256;
  return d == dv && (d == 24 || d == 32 || d == 64 || d == 128);
}

template <typename TT>
cudaError_t dispatch(int d, int dv, const void* q, const void* k, const void* v, const void* lens,
                     void* out, void* q_sum, void* k_sum, void* ko_sum, void* qi_sum, void* z,
                     void* s, void* work, int bh, int g, int n, int phi, int use_alloc,
                     float eps, cudaStream_t st) {
  if (d == 192)
    return dv == 128 ? launch<TT, 192, 128>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                            s, work, bh, g, n, phi, use_alloc, eps, d, st)
                     : launch<TT, 192, 192>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                            s, work, bh, g, n, phi, use_alloc, eps, d, st);
  switch (d) {
    case 256: return launch<TT, 256, 256>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                          s, work, bh, g, n, phi, use_alloc, eps, d, st);
    case 24:  // rows stored 32 wide, zero past 24
    case 32: return launch<TT, 32, 32>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                       work, bh, g, n, phi, use_alloc, eps, d, st);
    case 64: return launch<TT, 64, 64>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                       work, bh, g, n, phi, use_alloc, eps, d, st);
    case 128: return launch<TT, 128, 128>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                          s, work, bh, g, n, phi, use_alloc, eps, d, st);
    default: return cudaErrorInvalidValue;
  }
}

// The flows' super-chunk at stored width d and group g on this device (0
// where none fits a block's shared memory), or minus a cudaError_t.
int flows_tile_at(int d, int g) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return -(int)err;
  switch (d) {
    case 32: return flows_tile<32>(g, limit);
    case 64: return flows_tile<64>(g, limit);
    case 128: return flows_tile<128>(g, limit);
    case 192: return flows_tile<192>(g, limit);
    case 256: return flows_tile<256>(g, limit);
    default: return 0;
  }
}

}  // namespace

// Floats of scratch flow_fused_fwd needs for these shapes (16-byte aligned
// slices); -1 for shapes it refuses, a group whose flows do not fit a
// block's shared memory included.
extern "C" long long flow_fused_fwd_workspace(int bh, int g, int n, int d, int dv) {
  if (bh < 0 || g < 1 || n < 1 || !takes(d, dv)) return -1;
  if (flows_tile_at(stored_width(d), g) <= 0) return -1;
  Work dummy;
  return work_floats(bh, g, n, stored_width(d), stored_width(dv), dummy, nullptr);
}

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) in `dtype` (0 fp32, 1 bf16);
// lens (BH,) int32 with 1 <= lens <= N; work flow_fused_fwd_workspace
// floats.  Writes out (BH, G, N, Dv) in `dtype`, q/k/ko/qi sums (BH, D),
// z (BH,) and s (BH, D, Dv) in fp32.  D == Dv in {24, 32, 64, 128, 256},
// or D = 192 with Dv = 128 or 192; at D = 24 every row (and s) is stored 32
// wide, q, k and v zero past 24, and the outputs there are written 0.
// Four launches on `stream`; returns a cudaError_t.
extern "C" int flow_fused_fwd(const void* q, const void* k, const void* v, const void* lens,
                              void* out, void* q_sum, void* k_sum, void* ko_sum,
                              void* qi_sum, void* z, void* s, void* work, int bh, int g, int n,
                              int d, int dv, int dtype, int phi, int use_alloc, float eps,
                              void* stream) {
  if (!takes(d, dv) || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, dv, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s, work,
                                bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, dv, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                        s, work, bh, g, n, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
