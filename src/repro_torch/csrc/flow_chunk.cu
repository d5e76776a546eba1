// flow_chunk.cu — the chunked causal dot (K5a) for Hopper (sm_90a) at Dk
// and Dv in {32, 64, 128}.
//
// Replaces repro/kernels/flow_chunk/flow_chunk.py::flow_chunk_call (the
// pl.pallas_call at :72) at these widths; the kernels and their design are
// in flow_chunk_fwd.cuh, and the wide pairs (192, 128), (128, 192),
// (192, 192) and (256, 256) in flow_chunk_wide.cu, a library of its own so
// that nvcc builds both at once.
#include "flow_chunk_fwd.cuh"

// Floats of scratch K5a needs for these shapes at any pair it takes
// (pair_ok: the wide library's pairs too): one Dk x Dv state per row and
// chunk but the last; -1 for shapes it refuses.
extern "C" long long flow_chunk_workspace(int bh, int grp, int n, int dk, int dv) {
  return workspace_floats(bh, grp, n, dk, dv);
}

// q (BH, G, N, Dk), k (BH, N, Dk), v (BH, N, Dv) and out (BH, G, N, Dv),
// fp32, contiguous and 16-byte aligned; work flow_chunk_workspace floats;
// Dk and Dv in {32, 64, 128}; G, N >= 1.  Three launches on `stream` (one
// where N fits one chunk).  Returns a cudaError_t.
extern "C" int flow_chunk_fwd(const void* q, const void* k, const void* v, void* out, void* work,
                              int bh, int grp, int n, int dk, int dv, void* stream) {
  if (bh < 0 || grp < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (bh == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float *fo = (float*)out, *fw = (float*)work;
#define FLOW_CHUNK_DV(DK)                                                               \
  if (dv == 32) return (int)launch<DK, 32>(fq, fk, fv, fo, fw, bh, grp, n, st);         \
  if (dv == 64) return (int)launch<DK, 64>(fq, fk, fv, fo, fw, bh, grp, n, st);         \
  if (dv == 128) return (int)launch<DK, 128>(fq, fk, fv, fo, fw, bh, grp, n, st);
  if (dk == 32) { FLOW_CHUNK_DV(32) }
  if (dk == 64) { FLOW_CHUNK_DV(64) }
  if (dk == 128) { FLOW_CHUNK_DV(128) }
#undef FLOW_CHUNK_DV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flow_chunk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
