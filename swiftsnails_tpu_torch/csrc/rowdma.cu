// The row kernels of the port's parameter tables, on Hopper: gather,
// scatter-add, scatter-write and the AdaGrad read-modify-writes.
//
// A table is C rows of row_elems elements, contiguous (the packed
// [C, S, 128] layout is one such row per key, S * 128 elements wide). These
// kernels are the parameter server's pull and its pushes.
//
//   ssn_gather_rows       out[j] = table[rows[j]]
//       Replaces the TPU kernel gather_rows / _gather_kernel in the JAX
//       package's ops/rowdma.py (one row DMA per id, double-buffered).
//   ssn_scatter_add_rows  table[rows[j]] += deltas[j], in place, UNIQUE rows;
//                         rows outside [0, C) are padding and skipped
//       Replaces scatter_add_rows / _scatter_kernel in the same file (a
//       read-modify-write of each row, two blocks deep).
//   ssn_scatter_write_rows  table[rows[j]] = values[j], UNIQUE rows, padding
//                           skipped
//       Replaces scatter_write_rows / _write_kernel there: the write half of
//       gather -> access rule -> write.
//   ssn_scatter_adagrad_rows  on UNIQUE rows of two tables of one layout,
//                             param and accum: accum += g * g,
//                             param -= lr * g * rsqrt(accum + eps)
//       Replaces scatter_adagrad_rows / _adagrad_kernel there.
//   ssn_scatter_adagrad_fused_rows  the same rule where a row of the table
//                                   holds the param half, then the accum half
//                                   ([C, 2, 128]: sublane 0, sublane 1), and
//                                   a gradient row is one half
//       Replaces scatter_adagrad_fused_rows / _adagrad_fused_kernel there.
//
// What bounds them: bytes. A gathered row is read once and written once, a
// scattered row is read, its delta read, and the sum written; an AdaGrad
// element takes 6 flops and an rsqrt against 20 bytes of traffic in f32
// (param and accum read and written, the gradient read), where the card
// could do ~20 flops a byte. So the floor is device-memory bandwidth
// (3.35 TB/s on an H100 SXM). The rows are scattered over a table far larger
// than L2, so each row is an independent random access: the design keeps
// many of them in flight and moves each row in full 16-byte words.
//
// Design: one warp per row. Lane 0 loads the row id and broadcasts it; the
// 32 lanes then move the row as 16-byte words, neighbouring lanes on
// neighbouring addresses, so a 1024-byte f32 row is two words a lane and
// one warp-wide load instruction moves 512 bytes. The row width is an
// argument (128 is not assumed); it and every base address must be
// multiples of 16 bytes, which the Python wrapper checks. 8 warps a block,
// a grid of ceil(N / 8) blocks, any N (no block multiple, no padding of N).
// The gather differs: each warp moves 4 rows, all their loads issued before
// their stores, the table's rows kept in L2 and the output streamed past it
// (gather_rows_kernel says why). The TPU's double buffering and shared DMA
// semaphores existed to hide DMA issue latency on one sequential core; here
// the many resident warps of 132 SMs, and the rows in flight in each, hide
// the latency instead.
//
// The gather and the write copy bytes, so f32 and bf16 share them. An id
// outside [0, C) reads nothing: the gather writes a row of zeros for it, the
// scatters skip it and never read its delta, value or gradient. The
// scatter-add adds in f32 and rounds once (__float2bfloat16_rn for bf16), as
// the TPU kernel's add does. The AdaGrad kernels widen each element to f32,
// apply the rule with every operation rounded on its own (__fadd_rn,
// __fmul_rn, __fsub_rn: no contraction into FMAs) in the order of the plain
// version, lr * g first, then times rsqrtf (what torch.rsqrt runs on the
// card), and round param and accum once each to the table's type. The
// gradient arrives already in the table's type, as the TPU wrapper casts
// it. No kernel uses atomics: uniqueness of the rows is the caller's
// contract, as on the TPU (the stores merge duplicates first).
//
// Bound by a plain C interface, loaded with ctypes. Each entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success), or
// cudaErrorMisalignedAddress, launching nothing, for a row or base address
// that is not a multiple of 16 bytes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps, one row each
constexpr int kRowsPerBlock = kThreads / kWarp;

__device__ __forceinline__ int64_t warp_index() {
  return (int64_t(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
}

__device__ __forceinline__ int32_t row_id(const int32_t* __restrict__ rows,
                                          int64_t j) {
  int32_t r = 0;
  if ((threadIdx.x % kWarp) == 0) r = __ldg(rows + j);
  return __shfl_sync(0xffffffffu, r, 0);
}

// ---------------------------------------------------------------- gather ---

// Each warp moves kGatherRows rows: the lanes first load the rows' ids, one
// a lane; then every load of the rows is issued (up to kGatherWords 16-byte
// words a lane a row a pass) before any store, so a warp keeps kGatherRows
// * kGatherWords loads in flight where one row a warp kept 2 (a 1 KB row).
// The table is read-only for the launch, so its loads take the
// non-coherent path, with an L2 evict-last policy; the output is written
// with streaming stores (st.global.cs, evict-first): it is not read again
// here, and evicting it first keeps the table's repeated rows in L2 (at the
// Wide & Deep pull 76,303 of 212,992 ids repeat a tile). The grid covers N
// in one turn a warp: a grid of the CTAs resident at once walking the rows
// in a grid-stride loop read slower at that pull.
constexpr int kGatherRows = 4;
constexpr int kGatherWords = 2;

__device__ __forceinline__ uint4 ld_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ rows,
                   uint4* __restrict__ out, int64_t n, int64_t capacity,
                   int64_t row_words) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j0 = warp_index() * kGatherRows;
  if (j0 >= n) return;  // whole warps leave together
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  const int32_t mine = lane < kGatherRows && j0 + lane < n ? __ldg(rows + j0 + lane) : -1;
  int32_t r[kGatherRows];
#pragma unroll
  for (int u = 0; u < kGatherRows; ++u) {
    r[u] = __shfl_sync(0xffffffffu, mine, u);
    if (r[u] >= 0 && int64_t(r[u]) >= capacity) r[u] = -1;  // reads nothing: zeros
  }
  const int64_t rows_here = n - j0;  // kGatherRows, or fewer in the last warp
  for (int64_t w0 = lane; w0 < row_words; w0 += kWarp * kGatherWords) {
    uint4 v[kGatherRows][kGatherWords];
#pragma unroll
    for (int u = 0; u < kGatherRows; ++u)
#pragma unroll
      for (int m = 0; m < kGatherWords; ++m) {
        const int64_t i = w0 + m * kWarp;
        v[u][m] = r[u] >= 0 && i < row_words
                      ? ld_keep(table + int64_t(r[u]) * row_words + i, policy)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int u = 0; u < kGatherRows; ++u)
#pragma unroll
      for (int m = 0; m < kGatherWords; ++m) {
        const int64_t i = w0 + m * kWarp;
        if (u < rows_here && i < row_words) __stcs(out + (j0 + u) * row_words + i, v[u][m]);
      }
  }
}

// ------------------------------------------------------------ scatter-add ---

// Element-wise a + d on 32-bit words holding whole elements of type T: each
// element widened to f32, added, and rounded back once.
template <typename T>
struct Add;

template <>
struct Add<float> {
  __device__ static __forceinline__ uint32_t word(uint32_t a, uint32_t d) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(d));
  }
};

template <>
struct Add<__nv_bfloat16> {
  __device__ static __forceinline__ uint32_t half(uint32_t a, uint32_t d) {
    // a, d: one bf16 in the low 16 bits; bf16 -> f32 is a 16-bit shift
    const float s = __uint_as_float(a << 16) + __uint_as_float(d << 16);
    return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(s)));
  }
  __device__ static __forceinline__ uint32_t word(uint32_t a, uint32_t d) {
    return half(a & 0xffffu, d & 0xffffu) | (half(a >> 16, d >> 16) << 16);
  }
};

template <typename T>
__device__ __forceinline__ uint4 add_words(uint4 a, uint4 d) {
  return make_uint4(Add<T>::word(a.x, d.x), Add<T>::word(a.y, d.y),
                    Add<T>::word(a.z, d.z), Add<T>::word(a.w, d.w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(uint4* __restrict__ table, const int32_t* __restrict__ rows,
                        const uint4* __restrict__ deltas, int64_t n,
                        int64_t capacity, int64_t row_words) {
  const int64_t j = warp_index();
  if (j >= n) return;
  const int32_t r = row_id(rows, j);
  if (r < 0 || int64_t(r) >= capacity) return;  // padding: delta never read
  const int lane = threadIdx.x % kWarp;
  uint4* dst = table + int64_t(r) * row_words;
  const uint4* src = deltas + j * row_words;
#pragma unroll 4
  for (int64_t i = lane; i < row_words; i += kWarp) {
    dst[i] = add_words<T>(dst[i], __ldg(src + i));
  }
}

// ---------------------------------------------------------- scatter-write ---

__global__ void __launch_bounds__(kThreads)
scatter_write_rows_kernel(uint4* __restrict__ table, const int32_t* __restrict__ rows,
                          const uint4* __restrict__ values, int64_t n,
                          int64_t capacity, int64_t row_words) {
  const int64_t j = warp_index();
  if (j >= n) return;
  const int32_t r = row_id(rows, j);
  if (r < 0 || int64_t(r) >= capacity) return;  // padding: value never read
  const int lane = threadIdx.x % kWarp;
  uint4* dst = table + int64_t(r) * row_words;
  const uint4* src = values + j * row_words;
#pragma unroll 4
  for (int64_t i = lane; i < row_words; i += kWarp) dst[i] = __ldg(src + i);
}

// --------------------------------------------------------------- AdaGrad ---

// One element, in f32: a += g * g; p -= (lr * g) * rsqrt(a + eps), each
// operation rounded on its own, as the plain version's torch ops are.
__device__ __forceinline__ void adagrad(float& p, float& a, float g, float lr,
                                        float eps) {
  a = __fadd_rn(a, __fmul_rn(g, g));
  p = __fsub_rn(p, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, eps))));
}

// The rule on 32-bit words holding whole elements of type T.
template <typename T>
struct AdaGrad;

template <>
struct AdaGrad<float> {
  __device__ static __forceinline__ void word(uint32_t& p, uint32_t& a, uint32_t g,
                                              float lr, float eps) {
    float pf = __uint_as_float(p), af = __uint_as_float(a);
    adagrad(pf, af, __uint_as_float(g), lr, eps);
    p = __float_as_uint(pf);
    a = __float_as_uint(af);
  }
};

template <>
struct AdaGrad<__nv_bfloat16> {
  __device__ static __forceinline__ uint32_t bits(float x) {
    return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  // p, a, g: one bf16 each in the low 16 bits; bf16 -> f32 is a 16-bit shift
  __device__ static __forceinline__ void half(uint32_t& p, uint32_t& a, uint32_t g,
                                              float lr, float eps) {
    float pf = __uint_as_float(p << 16), af = __uint_as_float(a << 16);
    adagrad(pf, af, __uint_as_float(g << 16), lr, eps);
    p = bits(pf);
    a = bits(af);
  }
  __device__ static __forceinline__ void word(uint32_t& p, uint32_t& a, uint32_t g,
                                              float lr, float eps) {
    uint32_t p0 = p & 0xffffu, a0 = a & 0xffffu, p1 = p >> 16, a1 = a >> 16;
    half(p0, a0, g & 0xffffu, lr, eps);
    half(p1, a1, g >> 16, lr, eps);
    p = p0 | (p1 << 16);
    a = a0 | (a1 << 16);
  }
};

// Param words p[0, words) and accum words a[0, words) of one row, by the
// warp, from gradient words g[0, words).
template <typename T>
__device__ __forceinline__ void adagrad_row(uint4* __restrict__ p, uint4* __restrict__ a,
                                            const uint4* __restrict__ g, int64_t words,
                                            float lr, float eps) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll 2
  for (int64_t i = lane; i < words; i += kWarp) {
    uint4 pv = p[i], av = a[i];
    const uint4 gv = __ldg(g + i);
    AdaGrad<T>::word(pv.x, av.x, gv.x, lr, eps);
    AdaGrad<T>::word(pv.y, av.y, gv.y, lr, eps);
    AdaGrad<T>::word(pv.z, av.z, gv.z, lr, eps);
    AdaGrad<T>::word(pv.w, av.w, gv.w, lr, eps);
    p[i] = pv;
    a[i] = av;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_adagrad_rows_kernel(uint4* __restrict__ table, uint4* __restrict__ accum,
                            const int32_t* __restrict__ rows,
                            const uint4* __restrict__ grads, int64_t n,
                            int64_t capacity, int64_t row_words, float lr, float eps) {
  const int64_t j = warp_index();
  if (j >= n) return;
  const int32_t r = row_id(rows, j);
  if (r < 0 || int64_t(r) >= capacity) return;  // padding: gradient never read
  const int64_t at = int64_t(r) * row_words;
  adagrad_row<T>(table + at, accum + at, grads + j * row_words, row_words, lr, eps);
}

// A table row is [param half | accum half], half_words each; a gradient row
// is one half.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_adagrad_fused_rows_kernel(uint4* __restrict__ table,
                                  const int32_t* __restrict__ rows,
                                  const uint4* __restrict__ grads, int64_t n,
                                  int64_t capacity, int64_t half_words, float lr,
                                  float eps) {
  const int64_t j = warp_index();
  if (j >= n) return;
  const int32_t r = row_id(rows, j);
  if (r < 0 || int64_t(r) >= capacity) return;
  uint4* p = table + int64_t(r) * 2 * half_words;
  adagrad_row<T>(p, p + half_words, grads + j * half_words, half_words, lr, eps);
}

// Rows and base addresses in 16-byte words; anything else is refused.
bool aligned(int64_t row_bytes, const void* a, const void* b) {
  const uint64_t bits = uint64_t(row_bytes) | uint64_t(reinterpret_cast<uintptr_t>(a)) |
                        uint64_t(reinterpret_cast<uintptr_t>(b));
  return row_bytes > 0 && bits % sizeof(uint4) == 0;
}

unsigned grid(int64_t n) { return unsigned((n + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace

extern "C" {

int ssn_gather_rows(const void* table, const void* rows, void* out, long long n,
                    long long capacity, long long row_bytes, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, table, out)) return int(cudaErrorMisalignedAddress);
  if (n <= 0) return int(cudaSuccess);
  const int64_t warps = (n + kGatherRows - 1) / kGatherRows;
  gather_rows_kernel<<<unsigned((warps + kRowsPerBlock - 1) / kRowsPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(rows),
      static_cast<uint4*>(out), n, capacity, row_bytes / int64_t(sizeof(uint4)));
  return int(cudaGetLastError());
}

// elem_bytes: 4 for f32, 2 for bf16 (the type the add widens and rounds).
int ssn_scatter_add_rows(void* table, const void* rows, const void* deltas,
                         long long n, long long capacity, long long row_bytes,
                         int elem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, table, deltas)) return int(cudaErrorMisalignedAddress);
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  const int64_t words = row_bytes / int64_t(sizeof(uint4));
  if (elem_bytes == 4) {
    scatter_add_rows_kernel<float><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), ids, static_cast<const uint4*>(deltas), n,
        capacity, words);
  } else {
    scatter_add_rows_kernel<__nv_bfloat16><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), ids, static_cast<const uint4*>(deltas), n,
        capacity, words);
  }
  return int(cudaGetLastError());
}

int ssn_scatter_write_rows(void* table, const void* rows, const void* values,
                           long long n, long long capacity, long long row_bytes,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, table, values)) return int(cudaErrorMisalignedAddress);
  if (n <= 0) return int(cudaSuccess);
  scatter_write_rows_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(table), static_cast<const int32_t*>(rows),
      static_cast<const uint4*>(values), n, capacity, row_bytes / int64_t(sizeof(uint4)));
  return int(cudaGetLastError());
}

// table, accum and grads share one row layout of row_bytes; elem_bytes: 4
// for f32, 2 for bf16.
int ssn_scatter_adagrad_rows(void* table, void* accum, const void* rows,
                             const void* grads, long long n, long long capacity,
                             long long row_bytes, int elem_bytes, float lr, float eps,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, table, accum) || !aligned(row_bytes, grads, table)) {
    return int(cudaErrorMisalignedAddress);
  }
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  const int64_t words = row_bytes / int64_t(sizeof(uint4));
  if (elem_bytes == 4) {
    scatter_adagrad_rows_kernel<float><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), static_cast<uint4*>(accum), ids,
        static_cast<const uint4*>(grads), n, capacity, words, lr, eps);
  } else {
    scatter_adagrad_rows_kernel<__nv_bfloat16><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), static_cast<uint4*>(accum), ids,
        static_cast<const uint4*>(grads), n, capacity, words, lr, eps);
  }
  return int(cudaGetLastError());
}

// half_bytes: the bytes of one half of a table row (param or accum), which
// is a gradient row.
int ssn_scatter_adagrad_fused_rows(void* table, const void* rows, const void* grads,
                                   long long n, long long capacity, long long half_bytes,
                                   int elem_bytes, float lr, float eps, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(half_bytes, table, grads)) return int(cudaErrorMisalignedAddress);
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  if (n <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  const int64_t words = half_bytes / int64_t(sizeof(uint4));
  if (elem_bytes == 4) {
    scatter_adagrad_fused_rows_kernel<float><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), ids, static_cast<const uint4*>(grads), n, capacity,
        words, lr, eps);
  } else {
    scatter_adagrad_fused_rows_kernel<__nv_bfloat16><<<grid(n), kThreads, 0, s>>>(
        static_cast<uint4*>(table), ids, static_cast<const uint4*>(grads), n, capacity,
        words, lr, eps);
  }
  return int(cudaGetLastError());
}

const char* ssn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
