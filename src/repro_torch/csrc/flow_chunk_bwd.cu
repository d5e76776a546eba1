// flow_chunk_bwd.cu — dk and dv of the chunked causal dot (K5b) for Hopper
// (sm_90a) at D and Dv in {32, 64, 128}.
//
// Replaces repro/kernels/flow_chunk/bwd.py::flow_chunk_dkv_call (the
// pl.pallas_call at :114) at these widths; the kernels and their design
// are in flow_chunk_bwd.cuh, and the wide pairs (192, 128), (128, 192),
// (192, 192) and (256, 256) in flow_chunk_bwd_wide.cu, a library of its
// own so that nvcc builds both at once.
#include "flow_chunk_bwd.cuh"

// Floats of scratch K5b needs for these shapes at any pair it takes
// (pair_ok: the wide library's pairs too): one D x Dv state per row and
// chunk but the first; -1 for shapes it refuses.
extern "C" long long flow_chunk_dkv_workspace(int bh, int grp, int n, int d, int dv) {
  return workspace_floats(bh, grp, n, d, dv);
}

// q (BH, G, N, D), k (BH, N, D), v (BH, N, Dv), g (BH, G, N, Dv); dk
// (BH, N, D) and dv (BH, N, Dv) out.  fp32, contiguous and 16-byte aligned;
// work flow_chunk_dkv_workspace floats; D and Dv in {32, 64, 128}; G,
// N >= 1.  Three launches on `stream` (one where N fits one chunk).
// Returns a cudaError_t.
extern "C" int flow_chunk_dkv(const void* q, const void* k, const void* v, const void* g,
                              void* dk, void* dv, void* work, int bh, int grp, int n, int d,
                              int dv_dim, void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  const float* fg = (const float*)g;
  float *fdk = (float*)dk, *fdv = (float*)dv, *fw = (float*)work;
#define FLOW_CHUNK_DV(D)                                                                   \
  if (dv_dim == 32) return (int)launch<D, 32>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);   \
  if (dv_dim == 64) return (int)launch<D, 64>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);   \
  if (dv_dim == 128) return (int)launch<D, 128>(fq, fk, fv, fg, fdk, fdv, fw, bh, grp, n, st);
  if (d == 32) { FLOW_CHUNK_DV(32) }
  if (d == 64) { FLOW_CHUNK_DV(64) }
  if (d == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
