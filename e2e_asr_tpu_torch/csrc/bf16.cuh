// Storage-type helpers shared by the kernels that have a bfloat16 variant
// (csrc/lstm_bidir.cu, csrc/lstm_bidir_bwd.cu, csrc/decoder_scan.cu,
// csrc/decoder_scan_bwd.cu): a kernel is a template on its storage type S,
// float or bf16, and does its arithmetic in float32 either way. A bf16 value
// widens to float32 exactly at the load (its 16 bits are the top half of the
// float's); a store to bf16 rounds to nearest even, as PyTorch and JAX round;
// rnd<S> is a float32 value as it would be stored in S.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) {
  return bf_lo(*reinterpret_cast<const unsigned short*>(p));
}
// through the read-only cache
__device__ __forceinline__ float ldgf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldgf(const bf16* p) {
  return bf_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
// through L2 only (data written earlier in the same launch)
__device__ __forceinline__ float ldcgf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcgf(const bf16* p) {
  return bf_lo(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename S>
__device__ __forceinline__ float rnd(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive values (16 bytes of float, 8 of bf16, aligned so)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}
__device__ __forceinline__ float4 ld4cg(const float* p) { return __ldcg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 ld4cg(const bf16* p) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}
__device__ __forceinline__ float4 ld4g(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 ld4g(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

// two consecutive values (8 bytes of float, 4 of bf16, aligned so)
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf_lo(u), bf_hi(u));
}

// four consecutive values copied as they are stored (no conversion)
__device__ __forceinline__ void copy4(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ void copy4(bf16* d, const bf16* s) {
  *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
}
__device__ __forceinline__ void zero4(float* d) { *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero4(bf16* d) { *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u); }

}  // namespace
