// flow_chunk_wide.cu — the chunked causal dot (K5a) for Hopper (sm_90a) at
// the wide pairs (Dk, Dv) = (192, 128) (DeepSeek-V2's MLA heads), (128,
// 192) (their dq call: FlowChunkDot swaps k and v), (192, 192)
// (Nemotron-4-340B's) and (256, 256) (RecurrentGemma's).
//
// Replaces repro/kernels/flow_chunk/flow_chunk.py::flow_chunk_call (the
// pl.pallas_call at :72) at these widths; the kernels and their design
// (64-column output tiles across blocks) are in flow_chunk_fwd.cuh, the
// narrow widths in flow_chunk.cu.  A library of its own: its
// instantiations build beside the narrow ones, not after them.
#include "flow_chunk_fwd.cuh"

// flow_chunk_fwd's entry at the wide pairs: the same arguments (work
// flow_chunk_workspace floats) and results; any other pair is refused.
extern "C" int flow_chunk_wide_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* work, int bh, int grp, int n, int dk, int dv,
                                   void* stream) {
  if (bh < 0 || grp < 1 || n < 1 || !wide_pair(dk, dv)) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float *fo = (float*)out, *fw = (float*)work;
  if (dk == 256) return (int)launch<256, 256>(fq, fk, fv, fo, fw, bh, grp, n, st);
  if (dk == 128) return (int)launch<128, 192>(fq, fk, fv, fo, fw, bh, grp, n, st);
  return dv == 128 ? (int)launch<192, 128>(fq, fk, fv, fo, fw, bh, grp, n, st)
                   : (int)launch<192, 192>(fq, fk, fv, fo, fw, bh, grp, n, st);
}

extern "C" const char* flow_chunk_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
