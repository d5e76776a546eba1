// flow_fused_bwd.cu — K2, the backward of the strict-causal Flow-Attention
// kernel, for Hopper (sm_90a), at D == Dv in {24, 32, 64, 128}.
//
// Replaces the TPU kernel repro/kernels/flow_fused/bwd.py::
// flow_fused_bwd_call (the pl.pallas_call at :178) at these widths; the
// kernels and their design are in flow_fused_bwd.cuh, and the wide pairs
// (192, 128), (192, 192) and (256, 256) in flow_fused_bwd_wide.cu, a
// library of its own so that nvcc builds both at once.
#include "flow_fused_bwd.cuh"

namespace {

bool narrow(int d, int dv) { return d == dv && d != 192 && d != 256 && takes(d, dv); }

template <typename TT>
cudaError_t dispatch(int d, int dv, const void* const* in, void* dq, void* dk, void* dvp,
                     void* work, int bh, int g, int n, int phi, int use_alloc, float eps,
                     cudaStream_t st) {
  switch (narrow(d, dv) ? d : 0) {
    case 24:  // rows stored 32 wide, zero past 24
    case 32: return launch<TT, 32, 32>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st);
    case 64: return launch<TT, 64, 64>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st);
    case 128:
      return launch<TT, 128, 128>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch flow_fused_bwd needs for these shapes; -1 for shapes it
// refuses (workspace_floats).
extern "C" long long flow_fused_bwd_workspace(int bh, int g, int n, int d, int dv) {
  return workspace_floats(narrow(d, dv), bh, g, n, d, dv);
}

// The pull-back's super-chunk at (d, g) on this device, 0 where the group
// does not fit (the workspace count refuses it); any head width K2 takes.
extern "C" int flow_fused_bwd_tile(int g, int d) { return tile_of(g, stored_width(d)); }

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv) and g_out (BH, G, N, Dv) in
// `dtype` (0 fp32, 1 bf16); lens (BH,) int32 with 1 <= lens <= N; the
// cotangents of the six state outputs gq/gk/gko/gqi (BH, D), gz (BH,), gs
// (BH, D, Dv), fp32; work flow_fused_bwd_workspace floats.  Writes dq, dk,
// dv with the shapes and dtype of q, k, v.  D == Dv in {24, 32, 64, 128};
// at D = 24 every row (and gs) is stored 32 wide, zero past 24, and dq,
// dk and dv are written 0 there.  Five launches on `stream`; returns a
// cudaError_t.
extern "C" int flow_fused_bwd(const void* q, const void* k, const void* v, const void* lens,
                              const void* g_out, const void* gq, const void* gk,
                              const void* gko, const void* gqi, const void* gz, const void* gs,
                              void* dq, void* dk, void* dv, void* work, int bh, int g, int n,
                              int d, int dv_dim, int dtype, int phi, int use_alloc, float eps,
                              void* stream) {
  const void* in[11] = {q, k, v, lens, g_out, gq, gk, gko, gqi, gz, gs};
  return run_bwd(narrow(d, dv_dim), dispatch<float>, dispatch<__nv_bfloat16>, in, dq, dk, dv,
                 work, bh, g, n, d, dv_dim, dtype, phi, use_alloc, eps, stream);
}

extern "C" const char* flow_fused_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
