// Device helpers shared by the fused SGNS kernels (fused_sgns.cu and
// fused_sgns_merged.cu): typed loads and stores in f32, the sigmoid terms,
// fixed-order warp and block sums, row loads and warp dot products. Every
// sum here runs in a fixed order, so a kernel built from them repeats bit
// for bit.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// dst[j * d + i] = table[rows[j]][i] in f32 for j < n, zeros for a row id
// outside [0, capacity). The whole block (kThreads threads) cooperates.
template <int kThreads, typename T>
__device__ void load_rows(float* dst, const T* table, const int32_t* rows, int n,
                          int64_t capacity, int d) {
  for (int e = threadIdx.x; e < n * d; e += kThreads) {
    const int j = e / d;
    const int32_t r = rows[j];
    dst[e] = in_range(r, capacity) ? ld(table + int64_t(r) * d + (e - j * d)) : 0.f;
  }
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

// *loss_part = -inv_b * (sum of every thread's terms), summed per warp and
// then over the warps in order.
template <int kThreads>
__device__ void store_loss(float* loss_part, float mine, float inv_b) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_loss[kWarps];
  mine = warp_sum(mine);
  if ((threadIdx.x & 31) == 0) warp_loss[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_loss[w];
    *loss_part = -s * inv_b;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace
