// flow_chunk_bwd_wide.cu — dk and dv of the chunked causal dot (K5b) for
// Hopper (sm_90a) at the wide pairs (D, Dv) = (192, 128) (DeepSeek-V2's MLA
// heads), (128, 192), (192, 192) (Nemotron-4-340B's) and (256, 256)
// (RecurrentGemma's).
//
// Replaces repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_call (the
// pl.pallas_call at :114) at these widths; the kernels and their design
// (64-column output tiles across blocks, chunk_bwd_wide) are in
// flow_chunk_bwd.cuh, the narrow widths in flow_chunk_bwd.cu.  A library
// of its own: its instantiations build beside the narrow ones.
#include "flow_chunk_bwd.cuh"

// flow_chunk_dkv's entry at the wide pairs: the same arguments (work
// flow_chunk_dkv_workspace floats) and results; any other pair is refused.
extern "C" int flow_chunk_dkv_wide(const void* q, const void* k, const void* v, const void* g,
                                   void* dk, void* dv, void* work, int bh, int grp, int n, int d,
                                   int dv_dim, void* stream) {
  if (bh < 0 || grp < 1 || n < 1 || !wide_pair(d, dv_dim)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float* fg = (const float*)g;
  float *fdk = (float*)dk, *fdv = (float*)dv, *fw = (float*)work;
  if (d == 256) return (int)launch<256, 256>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);
  if (d == 128) return (int)launch<128, 192>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);
  return dv_dim == 128 ? (int)launch<192, 128>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st)
                       : (int)launch<192, 192>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);
}

extern "C" const char* flow_chunk_bwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
