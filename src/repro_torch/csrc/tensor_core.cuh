// tensor_core.cuh — 3xTF32 products on the tensor cores and cp.async
// staging, shared by the Hopper (sm_90a) kernels that use them: K5a and K5b
// (flow_chunk.cu, flow_chunk_bwd.cu), K6 (flow_nc_fused.cu) and K7b
// (flow_nc_qside.cu).
//
// 3xTF32: an fp32 product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi
// on the tensor cores (mma.sync m16n8k8, fp32 accumulation), each operand
// split x = hi + lo with hi x cut to tf32.  The tensor cores drop the low
// bits of lo and do not round to nearest as they accumulate, so the error
// is a few times that of fp32 FMA in another order; no plain TF32 product
// is taken anywhere.
//
// Host-side builds of these sources (a CPU emulation of a block's threads)
// take the #else branches: cp.async becomes a plain copy, and mma.sync the
// same product gathered with warp shuffles, each operand cut to tf32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tc {

// x = hi + lo: hi is x cut to tf32 (its top 10 mantissa bits), lo the
// exact rest, whose low bits the tensor cores drop (a relative error of
// ~2^-21 of x in lo * b, and nothing in hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile (fragments as the PTX ISA lays them out:
// g = lane / 4, t = lane % 4; a: (g, t), (g+8, t), (g, t+4), (g+8, t+4);
// b: (t, g), (t+4, g); c: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1))
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  // the same product gathered with warp shuffles (host-side builds), each
  // operand cut to tf32 as the tensor cores read it
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  for (int kk = 0; kk < 8; ++kk) {
    const int hi = kk >= 4, src = kk & 3;
    const float a0 = tf32(__shfl_sync(0xffffffffu, a[hi ? 2 : 0], g * 4 + src));
    const float a1 = tf32(__shfl_sync(0xffffffffu, a[hi ? 3 : 1], g * 4 + src));
    const float b0 = tf32(__shfl_sync(0xffffffffu, b[hi], (2 * t) * 4 + src));
    const float b1 = tf32(__shfl_sync(0xffffffffu, b[hi], (2 * t + 1) * 4 + src));
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
#endif
}

// c += a b in 3xTF32: the small cross terms first, then hi * hi; where b
// is exact in tf32 (bf16 values: EXACT_B), its lo part is zero and two
// products do
template <bool EXACT_B = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  if constexpr (!EXACT_B) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
#else
  if (valid) memcpy(dst, src, 16);
  else memset(dst, 0, 16);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

}  // namespace tc
