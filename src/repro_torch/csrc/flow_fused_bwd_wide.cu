// flow_fused_bwd_wide.cu — K2, the backward of the strict-causal
// Flow-Attention kernel, for Hopper (sm_90a), at the wide pairs (D, Dv) =
// (192, 128), (192, 192) (DeepSeek-V2's MLA heads, Nemotron-4-340B's) and
// (256, 256) (RecurrentGemma's).
//
// Replaces the TPU kernel repro/kernels/flow_fused/bwd.py::
// flow_fused_bwd_call (the pl.pallas_call at :178) at these widths; the
// kernels and their design are in flow_fused_bwd.cuh (flow_bwd_chunk_wide
// and the one-segment super-chunk of the pull-back), the narrow widths in
// flow_fused_bwd.cu.  A library of its own: its instantiations build
// beside the narrow ones, not after them.
#include "flow_fused_bwd.cuh"

namespace {

bool wide(int d, int dv) { return (d == 192 || d == 256) && takes(d, dv); }

template <typename TT>
cudaError_t dispatch(int d, int dv, const void* const* in, void* dq, void* dk, void* dvp,
                     void* work, int bh, int g, int n, int phi, int use_alloc, float eps,
                     cudaStream_t st) {
  if (!wide(d, dv)) return cudaErrorInvalidValue;
  if (d == 256)
    return launch<TT, 256, 256>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st);
  return dv == 128
             ? launch<TT, 192, 128>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st)
             : launch<TT, 192, 192>(in, dq, dk, dvp, work, bh, g, n, phi, use_alloc, eps, d, st);
}

}  // namespace

// Floats of scratch flow_fused_bwd_wide needs for these shapes; -1 for
// shapes it refuses (workspace_floats).
extern "C" long long flow_fused_bwd_wide_workspace(int bh, int g, int n, int d, int dv) {
  return workspace_floats(wide(d, dv), bh, g, n, d, dv);
}

// flow_fused_bwd's entry at the wide pairs: the same arguments and results.
extern "C" int flow_fused_bwd_wide(const void* q, const void* k, const void* v,
                                   const void* lens, const void* g_out, const void* gq,
                                   const void* gk, const void* gko, const void* gqi,
                                   const void* gz, const void* gs, void* dq, void* dk, void* dv,
                                   void* work, int bh, int g, int n, int d, int dv_dim,
                                   int dtype, int phi, int use_alloc, float eps, void* stream) {
  const void* in[11] = {q, k, v, lens, g_out, gq, gk, gko, gqi, gz, gs};
  return run_bwd(wide(d, dv_dim), dispatch<float>, dispatch<__nv_bfloat16>, in, dq, dk, dv,
                 work, bh, g, n, d, dv_dim, dtype, phi, use_alloc, eps, stream);
}

extern "C" const char* flow_fused_bwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
