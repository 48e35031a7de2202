// Device helpers shared by the fused SGNS kernels (fused_sgns.cu and
// fused_sgns_merged.cu): typed L2 loads and stores in f32, 16-byte words
// widened to f32, the sigmoid terms, a fixed-order warp sum and warp dot
// products. Every sum here runs in a fixed order, so a kernel built from
// them repeats bit for bit.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Loads of data that another CTA may write inside the launch: L2 only
// (ld.global.cg), never a stale L1 line or the non-coherent path.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
  return __uint_as_float(uint32_t(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// A 16-byte word of T (4 f32 or 8 bf16) widened into f32 at dst (16-byte
// aligned shared memory).
__device__ __forceinline__ void widen(float* dst, uint4 w, const float*) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                                                __uint_as_float(w.z), __uint_as_float(w.w));
}
__device__ __forceinline__ void widen(float* dst, uint4 w, const __nv_bfloat16*) {
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                  __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
                  __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
}

__device__ __forceinline__ bool in_range(int32_t r, int64_t capacity) {
  return r >= 0 && int64_t(r) < capacity;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Sum over the warp's lanes in a fixed butterfly order; every lane gets it.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// out[k] = a_k . b_k for k < n, one warp per product (lanes over the row).
// a_k, b_k are given by the functor; the result is the same on every run.
template <int kThreads, typename Rows>
__device__ void dots(float* out, int n, int d, Rows rows) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < n; k += kThreads / 32) {
    const float* a;
    const float* b;
    rows(k, a, b);
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s = fmaf(a[i], b[i], s);
    s = warp_sum(s);
    if (lane == 0) out[k] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace
