// Helpers shared by the kernels that run float32 products on the tensor
// cores (csrc/decoder_scan.cu, csrc/decoder_scan_bwd.cu,
// csrc/lstm_bidir_bwd.cu): cp.async copies and the three-TF32 mma.
// cuda_build.py hashes every "*.cuh" a source includes into its library's
// name, so an edit here rebuilds those sources.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 4 or 16 bytes global -> shared in the background (cp.async);
// cp_async_wait_all waits for the thread's own copies
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 16 bytes of which the first `bytes` (0 to 16: whole floats or bf16s)
// come from src and the rest are zero; with bytes = 0 nothing is read
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or a zero where bytes = 0
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most n of the thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// x = hi + lo, hi its top 19 bits (a TF32 value), lo the exact rest; the
// tensor core reads lo's top 19 bits, so a product of such splits keeps
// ~21 bits of x
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), one TF32 mma m16n8k8 on fragments
// already in TF32 (the register layouts of the PTX ISA: a0 (g, t), a1
// (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (k t, n g), b1 (t+4, g); d0 (g,
// 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1); g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8, the m16n8k8 accumulator fragment) += a (16 x 8) b (8 x 8) in
// float32 accuracy (relative error ~1e-6 a product) from three TF32
// products: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma_3xtf32(float* d, const float* a, const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) tf32_split(b[i], bh[i], bl[i]);
#define MMA_TF32(A, B)                                                                       \
  asm(                                                                                       \
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "    \
      "{%8,%9}, {%0,%1,%2,%3};\n"                                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                       \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(B[0]), "r"(B[1]))
  MMA_TF32(al, bh);
  MMA_TF32(ah, bl);
  MMA_TF32(ah, bh);
#undef MMA_TF32
}

}  // namespace
