// paged_gather.cu — the page-table gathers of paged KV decode (K8a, K8b)
// for Hopper (sm_90a).
//
// K8a replaces repro/kernels/gather/paged.py::paged_gather (the
// pl.pallas_call at :69, body _kernel :26-29):
//
//   kg[b, h, j*page + o, :] = kc[clip(table[b, j], 0, P-1), h, o, :]
//   vg[b, h, j*page + o, :] = vc[clip(table[b, j], 0, P-1), h, o, :]
//
// for pools kc (P, Hkv, page, D) and vc (P, Hkv, page, Dv) in bf16 or fp32
// (the kernel copies bytes, so any 2- or 4-byte element type works) and a
// (B, MP) int32 page table; the outputs are (B, Hkv, MP*page, D | Dv).
//
// K8b replaces repro/kernels/gather/paged.py::paged_gather_quant (the
// pl.pallas_call at :134, body _kernel_quant :76-84): the same gather from
// int8 payload pools with fp32 per-token scales ks, vs (P, Hkv, page, 1),
//
//   kg[b, h, j*page + o, e] = round(f32(kc[p, h, o, e]) * ks[p, h, o, 0])
//
// rounded once to the output dtype (bf16 with round-to-nearest-even, or
// fp32 as it is).
//
// What bounds them on the H100: the bytes.  Neither does arithmetic to
// speak of (K8b one fp32 multiply per element).  At the serving shape
// (16 slots x MP 8 pages of 64 x Hkv 8, D = Dv = 64) K8a reads and writes
// 16.8 MB each in bf16, 33.5 MB or ~10.0 us at 3.35 TB/s; K8b reads
// 8.4 MB of payload and 0.5 MB of scales and writes 16.8 MB of bf16,
// 25.7 MB or ~7.7 us.  So the design keeps every load and store wide and
// every block busy, and nothing else.
//
// Design.  The TPU drove the copy from a scalar-prefetched table in its
// index maps over grid (B, MP), one (Hkv, page, D) block per step.  Here
// both layouts are head-major: for each head h, page j of slot b is one
// contiguous (page x D) run in the pool and one contiguous run in the
// output.  So one block per (j, h, b) (1,024 blocks at the serving shape)
// loads its own table entry, clamps it into [0, P-1] so that no load
// leaves the pool (the TPU's jnp.clip: sentinel ids of unmapped pages read
// a real page whose positions the caller masks), and copies the K run and
// the V run.  K8a copies in 16-byte vectors when a run's byte width and
// both pointers allow it, else in 4- or 2-byte units (as K9 does), chosen
// apart for K and V since D may differ from Dv.  In K8b each thread takes
// 16 int8 payload values of one token row (one 16-byte load, when the
// row's width is a multiple of 16 and the pointers allow it), reads that
// row's scale once, multiplies in fp32, rounds once and stores 32 (bf16)
// or 64 (fp32) bytes; other widths go one value per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ void copy_units(const char* __restrict__ src, char* __restrict__ dst, int bytes) {
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(dst);
  const int n = bytes / (int)sizeof(T);
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = s[i];
}

// Copy one run of `bytes` bytes (a multiple of `unit`) with the block's threads.
__device__ void copy_run(const char* src, char* dst, int bytes, int unit) {
  if (unit == 16)
    copy_units<uint4>(src, dst, bytes);
  else if (unit == 4)
    copy_units<uint32_t>(src, dst, bytes);
  else
    copy_units<uint16_t>(src, dst, bytes);
}

__device__ __forceinline__ int page_of(const int* __restrict__ table, int b, int j, int mp,
                                       int p) {
  return min(max(table[(size_t)b * mp + j], 0), p - 1);
}

// Block (j, h, b): page table[b, j] of head h, K then V.  A run's index
// in the pool is src * Hkv + h, in the output (b * Hkv + h) * MP + j.
__global__ void paged_gather_kernel(const char* __restrict__ kc, const char* __restrict__ vc,
                                    const int* __restrict__ table, char* __restrict__ ko,
                                    char* __restrict__ vo, int p, int hkv, int mp, int krun,
                                    int vrun, int kunit, int vunit) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t s_run = (size_t)page_of(table, b, j, mp, p) * hkv + h;
  const size_t d_run = ((size_t)b * hkv + h) * mp + j;
  copy_run(kc + s_run * krun, ko + d_run * krun, krun, kunit);
  copy_run(vc + s_run * vrun, vo + d_run * vrun, vrun, vunit);
}

__device__ __forceinline__ float to_out(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// 16 dequantized values of one row: 4 x 16-byte stores of fp32.
__device__ __forceinline__ void store16(float* dst, const int8_t* q, float s) {
  float4* o = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = make_float4(__fmul_rn((float)q[4 * i], s), __fmul_rn((float)q[4 * i + 1], s),
                       __fmul_rn((float)q[4 * i + 2], s), __fmul_rn((float)q[4 * i + 3], s));
}

// 16 dequantized values of one row: 2 x 16-byte stores of bf16.
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const int8_t* q, float s) {
  uint4 w[2];
  uint32_t* u = reinterpret_cast<uint32_t*>(w);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 pair =
        __floats2bfloat162_rn(__fmul_rn((float)q[2 * i], s), __fmul_rn((float)q[2 * i + 1], s));
    u[i] = *reinterpret_cast<uint32_t*>(&pair);
  }
  uint4* o = reinterpret_cast<uint4*>(dst);
  o[0] = w[0];
  o[1] = w[1];
}

// One (page x width) run: payload src, its page per-row scales, output dst.
template <typename OutT>
__device__ void dequant_run(const int8_t* __restrict__ src, const float* __restrict__ scale,
                            OutT* __restrict__ dst, int page, int width, bool vec) {
  const int n = page * width;
  if (vec) {
    for (int c = threadIdx.x; c < n / 16; c += blockDim.x) {
      const int e = c * 16;
      const float s = scale[e / width];
      const uint4 raw = *reinterpret_cast<const uint4*>(src + e);
      store16(dst + e, reinterpret_cast<const int8_t*>(&raw), s);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = to_out(__fmul_rn((float)src[e], scale[e / width]), OutT{});
  }
}

template <typename OutT>
__global__ void paged_gather_quant_kernel(const int8_t* __restrict__ kc,
                                          const int8_t* __restrict__ vc,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          const int* __restrict__ table, OutT* __restrict__ ko,
                                          OutT* __restrict__ vo, int p, int hkv, int page, int d,
                                          int dv, int mp, int kvec, int vvec) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t s_run = (size_t)page_of(table, b, j, mp, p) * hkv + h;
  const size_t d_run = ((size_t)b * hkv + h) * mp + j;
  const size_t rows_s = s_run * page, rows_d = d_run * page;
  dequant_run(kc + rows_s * d, ks + rows_s, ko + rows_d * d, page, d, kvec != 0);
  dequant_run(vc + rows_s * dv, vs + rows_s, vo + rows_d * dv, page, dv, vvec != 0);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

int unit_of(const void* src, const void* dst, int run_bytes) {
  if (run_bytes % 16 == 0 && aligned(src, 16) && aligned(dst, 16)) return 16;
  if (run_bytes % 4 == 0 && aligned(src, 4) && aligned(dst, 4)) return 4;
  return 2;
}

bool bad_grid(int p, int hkv, int page, int d, int dv, int b, int mp) {
  return p < 1 || hkv < 0 || page < 0 || d < 0 || dv < 0 || b < 0 || mp < 0 || hkv > 65535 ||
         b > 65535;
}

}  // namespace

// K8a.  kc (P, Hkv, page, D) and vc (P, Hkv, page, Dv) contiguous, with
// elements of elem_size (2 or 4) bytes; table (B, MP) int32 contiguous;
// ko (B, Hkv, MP*page, D) and vo (B, Hkv, MP*page, Dv) contiguous.  One
// launch on `stream`.  Returns a cudaError_t.
extern "C" int paged_gather(const void* kc, const void* vc, const void* table, void* ko,
                            void* vo, int p, int hkv, int page, int d, int dv, int b, int mp,
                            int elem_size, void* stream) {
  if (bad_grid(p, hkv, page, d, dv, b, mp) || (elem_size != 2 && elem_size != 4))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || mp == 0 || hkv == 0 || page == 0) return (int)cudaSuccess;
  const int krun = page * d * elem_size, vrun = page * dv * elem_size;
  paged_gather_kernel<<<dim3(mp, hkv, b), kThreads, 0, (cudaStream_t)stream>>>(
      (const char*)kc, (const char*)vc, (const int*)table, (char*)ko, (char*)vo, p, hkv, mp, krun,
      vrun, unit_of(kc, ko, krun), unit_of(vc, vo, vrun));
  return (int)cudaGetLastError();
}

// K8b.  kc, vc int8 payloads shaped as K8a's pools; ks, vs (P, Hkv, page,
// 1) fp32 contiguous; ko, vo as K8a's outputs in bf16 (out_bf16 = 1) or
// fp32 (0).  One launch on `stream`.  Returns a cudaError_t.
extern "C" int paged_gather_quant(const void* kc, const void* vc, const void* ks, const void* vs,
                                  const void* table, void* ko, void* vo, int p, int hkv, int page,
                                  int d, int dv, int b, int mp, int out_bf16, void* stream) {
  if (bad_grid(p, hkv, page, d, dv, b, mp)) return (int)cudaErrorInvalidValue;
  if (b == 0 || mp == 0 || hkv == 0 || page == 0) return (int)cudaSuccess;
  const int kvec = d % 16 == 0 && aligned(kc, 16) && aligned(ko, 16);
  const int vvec = dv % 16 == 0 && aligned(vc, 16) && aligned(vo, 16);
  const dim3 grid(mp, hkv, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    paged_gather_quant_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const int8_t*)kc, (const int8_t*)vc, (const float*)ks, (const float*)vs,
        (const int*)table, (__nv_bfloat16*)ko, (__nv_bfloat16*)vo, p, hkv, page, d, dv, mp, kvec,
        vvec);
  else
    paged_gather_quant_kernel<float><<<grid, kThreads, 0, st>>>(
        (const int8_t*)kc, (const int8_t*)vc, (const float*)ks, (const float*)vs,
        (const int*)table, (float*)ko, (float*)vo, p, hkv, page, d, dv, mp, kvec, vvec);
  return (int)cudaGetLastError();
}

extern "C" const char* paged_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
