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
#include "flow_fused_common.cuh"

namespace {

using namespace ff;

template <typename TT, int D, int T>
__global__ void __launch_bounds__(kFlowThreads) flow_fwd_flows(FlowArgs<TT> a) {
  extern __shared__ float smem[];
  flows_body<TT, D, T>(a, smem);
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads) flow_fwd_state(StateArgs<TT, D> a, int rows) {
  extern __shared__ float smem[];
  const int2 rc = row_chunk(blockIdx.x, rows);
  state_block<TT, D>(a, 0, rc.x, rc.y, smem);
}

__global__ void __launch_bounds__(kThreads) flow_fwd_pass(PassArgs a) { pass_body(a, false); }

template <typename TT>
struct OutArgs {
  const TT *q, *k, *v;
  const int* lens;
  const float *sink, *scale, *e, *states;
  TT* out;
  int G, N, phi, rows;
};

template <int D>
constexpr int out_smem_floats() {
  constexpr int C = chunk_of<D>();
  return 2 * C * D + C * D + D * D + C * C;
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads, 2) flow_fwd_out(OutArgs<TT> a) {
  constexpr int C = chunk_of<D>(), DV = D;
  extern __shared__ float smem[];
  float* Q = smem;         // C x D: q_in of one group
  float* K = Q + C * D;    // C x D: phi(k)
  float* V = K + C * D;    // C x DV: v e
  float* S = V + C * DV;   // D x DV: S_<c
  float* P = S + D * DV;   // C x C: the causal panel
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
    return n < len ? phi4(load4(kr + (size_t)n * D + c), a.phi) : zero4();
  });
  stage<C, DV>(V, [&](int t, int c) {
    const int n = c0 + t;
    return n < len ? scale4(load4(vr + (size_t)n * DV + c), er[n]) : zero4();
  });
  const int nc = (N + C - 1) / C;
  const float* slot = a.states + ((size_t)row * nc + ci) * D * DV;
  stage<D, DV>(S, [&](int t, int c) { return ld4(slot + t * DV + c); });
  using OP = Own<C, C>;
  using OY = Own<C, DV>;
  const OP op;
  const OY oy;
  const int kmax = min(C, (oy.r0 + OY::RM + 3) & ~3);  // the panel's causal extent
  for (int g = 0; g < G; ++g) {
    const size_t rg = (size_t)row * G + g;
    const TT* qr = a.q + rg * N * D;
    stage<C, D>(Q, [&](int t, int c) {
      const int n = c0 + t;
      return n < len ? scale4(phi4(load4(qr + (size_t)n * D + c), a.phi), a.sink[rg * N + n])
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
    float acc[OY::RM][4];
    zero_acc(acc);
    mm_mk<OY::RM, C, DV>(acc, P, V, oy.r0, oy.c0, kmax);
    mm_mk<OY::RM, D, DV>(acc, Q, S, oy.r0, oy.c0, D);
#pragma unroll
    for (int i = 0; i < OY::RM; ++i) {
      const int n = c0 + oy.r0 + i;
      if (n >= N) continue;
      const float s = n < len ? a.scale[rg * N + n] : 0.f;
      store4(orow + ((size_t)g * N + n) * DV + oy.c0,
             make_float4(acc[i][0] * s, acc[i][1] * s, acc[i][2] * s, acc[i][3] * s));
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
  if (t == 8192 / D) return flows_at<TT, D, 8192 / D>(fa, bh, st);
  if (t == 4096 / D) return flows_at<TT, D, 4096 / D>(fa, bh, st);
  return flows_at<TT, D, 2048 / D>(fa, bh, st);
}

struct Work {
  float *sink, *scale, *e, *states;
};

// Floats of scratch for (bh, g, n, d): sink_in, the output scale, e and
// the chunk states.
long long work_floats(int bh, int g, int n, int d, Work& w, float* base) {
  const int c = d >= 128 ? 32 : 64;
  const long long nc = (n + c - 1) / c;
  const long long sizes[4] = {align4((long long)bh * g * n), align4((long long)bh * g * n),
                              align4((long long)bh * n), (long long)bh * nc * d * d};
  float** slots[4] = {&w.sink, &w.scale, &w.e, &w.states};
  long long off = 0;
  for (int i = 0; i < 4; ++i) {
    if (base) *slots[i] = base + off;
    off += sizes[i];
  }
  return off;
}

template <typename TT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lens, void* out,
                   void* q_sum, void* k_sum, void* ko_sum, void* qi_sum, void* z, void* s,
                   void* work, int bh, int g, int n, int phi, int use_alloc, float eps,
                   cudaStream_t st) {
  constexpr int C = chunk_of<D>();
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int T = flows_tile<D>(g, limit);
  if (T == 0) return cudaErrorInvalidValue;
  Work w;
  work_floats(bh, g, n, D, w, (float*)work);

  FlowArgs<TT> fa{(const TT*)q, (const TT*)k, (const int*)lens, w.sink, w.scale, w.e, nullptr, T,
                  (float*)q_sum, (float*)k_sum, (float*)ko_sum, (float*)qi_sum, (float*)z,
                  g, n, phi, use_alloc, eps};
  if ((err = flows<TT, D>(fa, T, bh, st)) != cudaSuccess) return err;

  const int nc = (n + C - 1) / C;
  StateArgs<TT, D> sa{(const TT*)q, (const TT*)k, (const TT*)v, nullptr, (const int*)lens,
                      w.sink, w.scale, w.e, w.states, nullptr, g, n, phi};
  constexpr int fs = state_smem_floats<D>();
  if ((err = allow_smem(flow_fwd_state<TT, D>, fs)) != cudaSuccess) return err;
  flow_fwd_state<TT, D><<<bh * nc, kThreads, fs * sizeof(float), st>>>(sa, bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  PassArgs pa{(const int*)lens, w.states, nullptr, (float*)s, nullptr, bh, n, C, D * D / 4};
  const long long q4 = (long long)bh * D * D / 4;
  flow_fwd_pass<<<(unsigned)((q4 + kThreads - 1) / kThreads), kThreads, 0, st>>>(pa);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  OutArgs<TT> oa{(const TT*)q, (const TT*)k, (const TT*)v, (const int*)lens, w.sink, w.scale,
                 w.e, w.states, (TT*)out, g, n, phi, bh};
  constexpr int fo = out_smem_floats<D>();
  if ((err = allow_smem(flow_fwd_out<TT, D>, fo)) != cudaSuccess) return err;
  flow_fwd_out<TT, D><<<bh * nc, kThreads, fo * sizeof(float), st>>>(oa);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* lens,
                     void* out, void* q_sum, void* k_sum, void* ko_sum, void* qi_sum, void* z,
                     void* s, void* work, int bh, int g, int n, int phi, int use_alloc,
                     float eps, cudaStream_t st) {
  switch (d) {
    case 32: return launch<TT, 32>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s, work,
                                   bh, g, n, phi, use_alloc, eps, st);
    case 64: return launch<TT, 64>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s, work,
                                   bh, g, n, phi, use_alloc, eps, st);
    case 128: return launch<TT, 128>(q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s,
                                     work, bh, g, n, phi, use_alloc, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch flow_fused_fwd needs for these shapes (16-byte aligned
// slices); -1 for shapes it refuses.
extern "C" long long flow_fused_fwd_workspace(int bh, int g, int n, int d) {
  if (bh < 0 || g < 1 || n < 1 || (d != 32 && d != 64 && d != 128)) return -1;
  Work dummy;
  return work_floats(bh, g, n, d, dummy, nullptr);
}

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) in `dtype` (0 fp32, 1 bf16);
// lens (BH,) int32 with 1 <= lens <= N; work flow_fused_fwd_workspace
// floats.  Writes out (BH, G, N, Dv) in `dtype`, q/k/ko/qi sums (BH, D),
// z (BH,) and s (BH, D, Dv) in fp32.  D == Dv in {32, 64, 128}.  Four
// launches on `stream`; returns a cudaError_t.
extern "C" int flow_fused_fwd(const void* q, const void* k, const void* v, const void* lens,
                              void* out, void* q_sum, void* k_sum, void* ko_sum,
                              void* qi_sum, void* z, void* s, void* work, int bh, int g, int n,
                              int d, int dv, int dtype, int phi, int use_alloc, float eps,
                              void* stream) {
  if (d != dv || g < 1 || n < 1 || phi < 0 || phi > 2) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z, s, work,
                                bh, g, n, phi, use_alloc, eps, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, lens, out, q_sum, k_sum, ko_sum, qi_sum, z,
                                        s, work, bh, g, n, phi, use_alloc, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
