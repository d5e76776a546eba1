// boundary_gather.cu — the per-row conv-history gather of packed prefill
// (K9) for Hopper (sm_90a).
//
// Replaces repro/kernels/gather/boundary.py::boundary_gather (the
// pl.pallas_call at :67, body _kernel :31-41):
//
//   out[b, j, :] = x[b, lengths[b] - (k-1) + j, :]  if that index is >= 0,
//                  0                                 otherwise,  j < k - 1
//
// for x (B, N, W) in fp32 or bf16 (the kernel copies bytes, so any 2- or
// 4-byte element type works) and lengths (B,) int32 in [0, N].
//
// What bounds it on the H100: nothing of the card.  It moves
// 2 (k-1) B W element sizes (a read and a write of 3 x 4,096 bf16 values
// per row at the serving shape, 393 KB for 16 rows) -- a fraction of a
// microsecond at 3.35 TB/s -- so a launch's fixed cost bounds it, and the
// design is the plainest that keeps each load wide.
//
// Design.  The TPU prefetched the lengths as scalars ahead of its grid;
// here each block loads its own.  One block per (row, tap): grid
// (B, k - 1).  The block computes the tap's source index, clips it into
// [0, N - 1] (so no load leaves the row, as the TPU's clipped pl.ds), and
// writes zeros where the true index is below 0 -- the fresh conv's left
// pad.  Threads stride over the row in 16-byte vectors when the row's
// byte width and both pointers allow it, else in 4- or 2-byte units.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct alignas(16) V16 {
  uint4 v;
};

template <typename T>
__global__ void boundary_gather_kernel(const char* __restrict__ x, const int* __restrict__ lengths,
                                       char* __restrict__ out, int n, int row_units, int k) {
  const int b = blockIdx.x, tap = blockIdx.y;
  const int idx = lengths[b] - (k - 1) + tap;
  const int src = min(max(idx, 0), n - 1);
  const T* in = reinterpret_cast<const T*>(x) + ((size_t)b * n + src) * row_units;
  T* dst = reinterpret_cast<T*>(out) + ((size_t)b * (k - 1) + tap) * row_units;
  const T zero{};
  for (int i = threadIdx.x; i < row_units; i += blockDim.x) dst[i] = idx >= 0 ? in[i] : zero;
}

template <typename T>
cudaError_t launch(const void* x, const void* lengths, void* out, int bsz, int n, int row_bytes,
                   int k, cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(T);
  const int threads = units >= 256 ? 256 : ((units + 31) / 32) * 32;
  boundary_gather_kernel<T><<<dim3(bsz, k - 1), threads, 0, stream>>>(
      (const char*)x, (const int*)lengths, (char*)out, n, units, k);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

}  // namespace

// x (B, N, W) contiguous with elements of elem_size (2 or 4) bytes;
// lengths (B,) int32; out (B, k-1, W) contiguous.  N, k >= 1.  One launch
// on `stream`.  Returns a cudaError_t.
extern "C" int boundary_gather(const void* x, const void* lengths, void* out, int bsz, int n,
                               int w, int k, int elem_size, void* stream) {
  if (bsz < 0 || n < 1 || w < 0 || k < 1 || (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || w == 0 || k == 1) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_bytes = w * elem_size;
  if (row_bytes % 16 == 0 && aligned(x, 16) && aligned(out, 16))
    return (int)launch<V16>(x, lengths, out, bsz, n, row_bytes, k, st);
  if (row_bytes % 4 == 0 && aligned(x, 4) && aligned(out, 4))
    return (int)launch<uint32_t>(x, lengths, out, bsz, n, row_bytes, k, st);
  return (int)launch<uint16_t>(x, lengths, out, bsz, n, row_bytes, k, st);
}

extern "C" const char* boundary_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
