// boundary_gather.cu — the per-row conv-history gather of packed prefill
// (K9) for Hopper (sm_90a), for up to four streams in one launch.
//
// Replaces repro/kernels/gather/boundary.py::boundary_gather (the
// pl.pallas_call at :67, body _kernel :31-41), which the reference calls
// once per conv stream.  For each stream s, x_s (B, N, W_s):
//
//   out_s[b, j, :] = x_s[b, lengths[b] - (k-1) + j, :]  if that index is >= 0,
//                    0                                   otherwise,  j < k - 1
//
// in fp32 or bf16 (the kernel copies bytes, so any 2- or 4-byte element
// type works), lengths (B,) int32 in [0, N].  The streams share B, N,
// lengths and k: the mamba2 layer's raw x (W 4,096), B and C (W 128).
//
// What bounds it on the H100: nothing of the card.  One layer's three
// streams are read and written once, 2 (k-1) B (W_x + W_b + W_c) element
// sizes (836 KB for 16 rows of bf16 at the serving shape), a quarter of a
// microsecond at 3.35 TB/s, so the launch's fixed cost bounds it: one
// launch per layer gathers all of its streams, where one launch per stream
// paid that cost three times.
//
// Design.  The TPU prefetched the lengths as scalars ahead of its grid;
// here one thread of each block loads its row's length into shared memory.
// The streams' row widths are laid end to end and cut into units (16, 4 or
// 2 bytes, the widest that every stream's row width and pointers allow);
// the grid is (blocks of kUnitsPerBlock units, row x tap), so each block
// moves at most 4 KB (in 16-byte units) whatever the streams' widths, and
// the narrow B and C streams ride in the blocks of the wide x stream.  A
// block computes the tap's source index, clips it into [0, N - 1] (so no
// load leaves the row, as the TPU's clipped pl.ds) and writes zeros where
// the true index is below 0 -- the fresh conv's left pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kThreads = 128;
constexpr int kUnitsPerBlock = 2 * kThreads;

struct alignas(16) V16 {
  uint4 v;
};

// the streams, by value: pointers, and each stream's first unit in the
// end-to-end row (begin[n] = the row's total)
struct Streams {
  const char* x[kMaxStreams];
  char* out[kMaxStreams];
  int begin[kMaxStreams + 1];
  int n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
boundary_gather_kernel(const Streams s, const int* __restrict__ lengths, int n, int k) {
  __shared__ int len_s;
  const int taps = k - 1;
  const int b = blockIdx.y / taps, tap = blockIdx.y % taps;
  if (threadIdx.x == 0) len_s = lengths[b];
  __syncthreads();
  const int idx = len_s - taps + tap;
  const int src = min(max(idx, 0), n - 1);
  const int u0 = blockIdx.x * kUnitsPerBlock;
  const int u1 = min(u0 + kUnitsPerBlock, s.begin[s.n]);
  for (int u = u0 + threadIdx.x; u < u1; u += kThreads) {
    int j = 0;
    while (j + 1 < s.n && u >= s.begin[j + 1]) ++j;
    const int col = u - s.begin[j], w = s.begin[j + 1] - s.begin[j];
    const T* in = reinterpret_cast<const T*>(s.x[j]) + ((size_t)b * n + src) * w;
    T* dst = reinterpret_cast<T*>(s.out[j]) + ((size_t)b * taps + tap) * w;
    dst[col] = idx >= 0 ? in[col] : T{};
  }
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

template <typename T>
cudaError_t launch(Streams s, const int* row_bytes, const void* lengths, int bsz, int n, int k,
                   cudaStream_t stream) {
  s.begin[0] = 0;
  for (int j = 0; j < s.n; ++j) s.begin[j + 1] = s.begin[j] + row_bytes[j] / (int)sizeof(T);
  const int blocks = (s.begin[s.n] + kUnitsPerBlock - 1) / kUnitsPerBlock;
  boundary_gather_kernel<T><<<dim3(blocks, bsz * (k - 1)), kThreads, 0, stream>>>(
      s, (const int*)lengths, n, k);
  return cudaGetLastError();
}

}  // namespace

// xs[i] (B, N, widths[i]) contiguous with elements of elem_size (2 or 4)
// bytes, i < n_streams <= 4; lengths (B,) int32; outs[i] (B, k-1,
// widths[i]) contiguous.  N, k >= 1.  One launch on `stream`.  Returns a
// cudaError_t.
extern "C" int boundary_gather_many(const void* const* xs, void* const* outs, const int* widths,
                                    int n_streams, const void* lengths, int bsz, int n, int k,
                                    int elem_size, void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || bsz < 0 || n < 1 || k < 1 ||
      (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  Streams s{};
  s.n = n_streams;
  int row_bytes[kMaxStreams], total = 0;
  bool v16 = true, v4 = true;
  for (int j = 0; j < n_streams; ++j) {
    if (widths[j] < 0) return (int)cudaErrorInvalidValue;
    s.x[j] = (const char*)xs[j];
    s.out[j] = (char*)outs[j];
    row_bytes[j] = widths[j] * elem_size;
    total += row_bytes[j];
    v16 = v16 && row_bytes[j] % 16 == 0 && aligned(xs[j], 16) && aligned(outs[j], 16);
    v4 = v4 && row_bytes[j] % 4 == 0 && aligned(xs[j], 4) && aligned(outs[j], 4);
  }
  if (bsz == 0 || total == 0 || k == 1) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (v16) return (int)launch<V16>(s, row_bytes, lengths, bsz, n, k, st);
  if (v4) return (int)launch<uint32_t>(s, row_bytes, lengths, bsz, n, k, st);
  return (int)launch<uint16_t>(s, row_bytes, lengths, bsz, n, k, st);
}

__global__ void empty_kernel() {}

// An empty launch of this build on `stream`: the card's launch floor, which
// K9 is measured against.  Returns a cudaError_t.
extern "C" int boundary_gather_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* boundary_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
