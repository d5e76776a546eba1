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
// pl.pallas_call at :134, body _kernel_quant :80-87): the same gather from
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
// output.  Each block loads its own table entry and clamps it into
// [0, P-1] so that no load leaves the pool (the TPU's jnp.clip: sentinel
// ids of unmapped pages read a real page whose positions the caller
// masks).
//
// K8a: one block per (j, h, b) (1,024 blocks at the serving shape) copies
// the K run and the V run in 16-byte vectors when a run's byte width and
// both pointers allow it, else in 4- or 2-byte units (as K9 does), chosen
// apart for K and V since D may differ from Dv.
//
// K8b: where every run of the launch is 16-byte aligned and a multiple of
// 16 bytes long (the serving pools), one block per 16 rows of a run pair
// (4,096 blocks of 128 threads at the serving shape) asks for all of its
// bytes in one round trip after the table read, as the TPU's DMA did.
// Its four runs (the K and V payloads and their scales) are each one
// contiguous range of the pool, so one thread asks the copy engine for
// each whole run (a 1-D cp.async.bulk into shared memory, completed with
// the transaction count on an mbarrier: K's two runs on one, V's on the
// other; no tensor map) as soon as the page id is known, and each half of
// the block dequantizes its run as soon as that run lands: 16 payload
// values of one row at a time, its row's scale read once, multiplied in
// fp32, rounded once and written as 32 (bf16) or 64 (fp32) bytes in
// 16-byte stores; a width that is not a multiple of 16 goes one value per
// thread.  Blocks of 16 rows ran faster than blocks of 8, 32 or a whole
// page.  A launch whose runs the copy engine refuses (a page not a
// multiple of 4 rows, odd widths, misaligned pools) takes one block per
// whole page that reads its runs straight from device memory, K then V:
// that measured faster than staging such runs through registers and
// shared memory (PERF.md, the K8b findings).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

constexpr int kQuantThreads = 128;     // half on the K run, half on the V run
constexpr int kBlockRows = 16;         // rows of a page a block takes
constexpr int kSmemBytes = 48 * 1024;  // a block's shared memory: no opt-in

__host__ __device__ constexpr int pad16(int bytes) { return (bytes + 15) & ~15; }

// A block's shared memory for `rows` rows: two mbarriers (K, V), then the
// K and V payloads and their scales, each from a 16-byte boundary.
__host__ __device__ constexpr int quant_smem(int rows, int d, int dv) {
  return 16 + pad16(rows * d) + pad16(rows * dv) + 2 * pad16(rows * 4);
}

// The copy engine takes a run that starts on a 16-byte boundary and is a
// multiple of 16 bytes long.
inline bool bulk_ok(const void* src, long long bytes) {
  return (uintptr_t)src % 16 == 0 && bytes % 16 == 0;
}

// n barriers, each completed by one arrival and its transactions.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
#if defined(__CUDA_ARCH__)
  for (int i = 0; i < n; ++i) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(bar + i);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

// Arrive on the barrier, expecting `bytes` of bulk copies to complete it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
#if defined(__CUDA_ARCH__)
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(a), "r"(bytes)
               : "memory");
#endif
}

// Copy `bytes` from device memory to shared memory with the copy engine,
// completing on `bar`.  Off the card (a CPU emulation of this source) it
// is a synchronous copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(d),
      "l"(src), "r"(bytes), "r"(a)
      : "memory");
#else
  memcpy(dst, src, bytes);
#endif
}

// Wait for the barrier's first phase: every bulk copy on it landed.
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, "
        "p; }"
        : "=r"(done)
        : "r"(a)
        : "memory");
#endif
}

// The n values of a run of rows of `width` values, dequantized from shared
// memory (payload `pay`, per-row scales `sc`) into `dst` in device memory
// by `nt` threads, this one the t-th; with `vec` (width a multiple of 16)
// each thread takes 16 values of one row at a time.
template <typename OutT>
__device__ void dequant_shared(const int8_t* __restrict__ pay, const float* __restrict__ sc,
                               OutT* __restrict__ dst, int n, int width, bool vec, int t,
                               int nt) {
  if (vec) {
    const int per_row = width / 16;
    for (int c = t; c < n / 16; c += nt) {
      const float s = sc[c / per_row];
      const uint4 raw = *reinterpret_cast<const uint4*>(pay + c * 16);
      store16(dst + c * 16, reinterpret_cast<const int8_t*>(&raw), s);
    }
  } else {
    for (int e = t; e < n; e += nt)
      dst[e] = to_out(__fmul_rn((float)pay[e], sc[e / width]), OutT{});
  }
}

// Ask the copy engine for one run, n payload bytes from src and ns scale
// bytes from ssrc, both completing on bar.
__device__ __forceinline__ void issue_run(unsigned char* dst, const void* src, int n,
                                          unsigned char* sdst, const void* ssrc, int ns,
                                          uint64_t* bar) {
  mbar_expect(bar, n + ns);
  bulk_copy(sdst, ssrc, ns, bar);
  if (n) bulk_copy(dst, src, n, bar);
}

// Block (j * pieces + piece, h, b): rows [piece * rows, ..) of page
// table[b, j] of head h, every run through the copy engine (the host
// checked each one).
template <typename OutT>
__global__ void __launch_bounds__(kQuantThreads)
paged_gather_quant_kernel(const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                          const float* __restrict__ ks, const float* __restrict__ vs,
                          const int* __restrict__ table, OutT* __restrict__ ko,
                          OutT* __restrict__ vo, int p, int hkv, int page, int d, int dv,
                          int mp, int rows, int pieces, int kvec, int vvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // K's, then V's
  unsigned char* sk = smem + 16;
  unsigned char* sv = sk + pad16(rows * d);
  unsigned char* sks = sv + pad16(rows * dv);
  unsigned char* svs = sks + pad16(rows * 4);
  const int piece = blockIdx.x % pieces, j = blockIdx.x / pieces, h = blockIdx.y,
            b = blockIdx.z;
  const int r0 = piece * rows, nr = min(rows, page - r0);
  const int nk = nr * d, nv = nr * dv;
  if (threadIdx.x == 0) {
    mbar_init(bar, 2);
    const size_t first = ((size_t)page_of(table, b, j, mp, p) * hkv + h) * page + r0;
    issue_run(sk, kc + first * d, nk, sks, ks + first, nr * 4, bar);
    issue_run(sv, vc + first * dv, nv, svs, vs + first, nr * 4, bar + 1);
  }
  __syncthreads();  // the barriers' initialization
  // each half of the block takes its run as soon as that run lands
  constexpr int kHalf = kQuantThreads / 2;
  const int t = threadIdx.x % kHalf;
  const size_t first_d = (((size_t)b * hkv + h) * mp + j) * page + r0;
  if (threadIdx.x < kHalf) {
    mbar_wait0(bar);
    dequant_shared(reinterpret_cast<const int8_t*>(sk), reinterpret_cast<const float*>(sks),
                   ko + first_d * d, nk, d, kvec != 0, t, kHalf);
  } else {
    mbar_wait0(bar + 1);
    dequant_shared(reinterpret_cast<const int8_t*>(sv), reinterpret_cast<const float*>(svs),
                   vo + first_d * dv, nv, dv, vvec != 0, t, kHalf);
  }
}

// One (page x width) run read straight from device memory: payload src,
// its page per-row scales, output dst.  This is the loop K8b had before
// the copy engine; dequant_shared's form of it (a fixed stride, the row
// by chunks) measured 15 % slower here (PERF.md, the K8b findings).
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

// Block (j, h, b): the whole page table[b, j] of head h, K then V, read
// straight from device memory (K8b's kernel before the copy engine), for
// pools whose runs the copy engine refuses.
template <typename OutT>
__global__ void __launch_bounds__(kQuantThreads)
paged_gather_quant_page_kernel(const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                               const float* __restrict__ ks, const float* __restrict__ vs,
                               const int* __restrict__ table, OutT* __restrict__ ko,
                               OutT* __restrict__ vo, int p, int hkv, int page, int d, int dv,
                               int mp, int kvec, int vvec) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t rows_s = ((size_t)page_of(table, b, j, mp, p) * hkv + h) * page;
  const size_t rows_d = (((size_t)b * hkv + h) * mp + j) * page;
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

// Whether the copy engine takes every piece of a run: `base` its start in
// the pool, `row_bytes` the bytes of a row, `rows` and `last` the rows of
// a piece and of the last.
bool bulk_run(const void* base, int row_bytes, int rows, int last, int page) {
  return bulk_ok(base, (long long)page * row_bytes) &&
         bulk_ok(nullptr, (long long)rows * row_bytes) &&
         bulk_ok(nullptr, (long long)last * row_bytes);
}

template <typename OutT>
cudaError_t launch_quant(const void* kc, const void* vc, const void* ks, const void* vs,
                         const void* table, void* ko, void* vo, int p, int hkv, int page, int d,
                         int dv, int b, int mp, cudaStream_t stream) {
  // rows a block: kBlockRows, or fewer where the page is shorter or the
  // rows do not fit the block's shared memory (then a multiple of 4 where
  // it can be, so that the scales' runs stay multiples of 16 bytes)
  int rows = min(page, kBlockRows);
  if (quant_smem(rows, d, dv) > kSmemBytes) {
    rows = max(1, (kSmemBytes - 16 - 64) / (d + dv + 8));
    if (rows >= 4) rows &= ~3;
  }
  const int pieces = (page + rows - 1) / rows, last = page - (pieces - 1) * rows;
  const bool bulk = (long long)mp * pieces <= 0x7fffffffLL &&
                    bulk_run(kc, d, rows, last, page) && bulk_run(vc, dv, rows, last, page) &&
                    bulk_run(ks, 4, rows, last, page) && bulk_run(vs, 4, rows, last, page);
  const int kvec = d % 16 == 0 && aligned(ko, 16) && (bulk || aligned(kc, 16));
  const int vvec = dv % 16 == 0 && aligned(vo, 16) && (bulk || aligned(vc, 16));
  if (bulk)
    paged_gather_quant_kernel<OutT><<<dim3(mp * pieces, hkv, b), kQuantThreads,
                                      quant_smem(rows, d, dv), stream>>>(
        (const int8_t*)kc, (const int8_t*)vc, (const float*)ks, (const float*)vs,
        (const int*)table, (OutT*)ko, (OutT*)vo, p, hkv, page, d, dv, mp, rows, pieces, kvec,
        vvec);
  else
    paged_gather_quant_page_kernel<OutT><<<dim3(mp, hkv, b), kQuantThreads, 0, stream>>>(
        (const int8_t*)kc, (const int8_t*)vc, (const float*)ks, (const float*)vs,
        (const int*)table, (OutT*)ko, (OutT*)vo, p, hkv, page, d, dv, mp, kvec, vvec);
  return cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return (int)launch_quant<__nv_bfloat16>(kc, vc, ks, vs, table, ko, vo, p, hkv, page, d, dv,
                                            b, mp, st);
  return (int)launch_quant<float>(kc, vc, ks, vs, table, ko, vo, p, hkv, page, d, dv, b, mp,
                                  st);
}

extern "C" const char* paged_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
