// Row gather and row scatter-add for the port's parameter tables, on Hopper.
//
// A table is C rows of row_elems elements, contiguous (the packed
// [C, S, 128] layout is one such row per key, S * 128 elements wide). These
// two kernels are the parameter server's pull and SGD push.
//
//   ssn_gather_rows       out[j] = table[rows[j]]
//       Replaces the TPU kernel gather_rows / _gather_kernel in the JAX
//       package's ops/rowdma.py (one row DMA per id, double-buffered).
//   ssn_scatter_add_rows  table[rows[j]] += deltas[j], in place, UNIQUE rows;
//                         rows outside [0, C) are padding and skipped
//       Replaces scatter_add_rows / _scatter_kernel in the same file (a
//       read-modify-write of each row, two blocks deep).
//
// What bounds them: bytes. A gathered row is read once and written once, a
// scattered row is read, its delta read, and the sum written: no arithmetic
// to speak of, so the floor is device-memory bandwidth (3.35 TB/s on an
// H100 SXM). The rows are scattered over a table far larger than L2, so
// each row is an independent random access: the design keeps many of them
// in flight and moves each row in full 16-byte words.
//
// Design: one warp per row. Lane 0 loads the row id and broadcasts it; the
// 32 lanes then move the row as 16-byte words, neighbouring lanes on
// neighbouring addresses, so a 1024-byte f32 row is two words a lane and
// one warp-wide load instruction moves 512 bytes. The row width is an
// argument (128 is not assumed); it and both base addresses must be
// multiples of 16 bytes, which the Python wrapper checks. 8 warps a block,
// a grid of ceil(N / 8) blocks, any N (no block multiple, no padding of N).
// The TPU's double buffering and shared DMA semaphores existed to hide DMA
// issue latency on one sequential core; here the many resident warps of
// 132 SMs hide the latency instead.
//
// The gather copies bytes, so f32 and bf16 share it. An id outside [0, C)
// reads nothing and writes a row of zeros. The scatter-add adds in f32 and
// rounds once (__float2bfloat16_rn for bf16), as the TPU kernel's add does.
// It uses no atomics: uniqueness of the rows is the caller's contract, as
// on the TPU (push_packed merges duplicates first), and a padding slot's
// delta is never read.
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

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ rows,
                   uint4* __restrict__ out, int64_t n, int64_t capacity,
                   int64_t row_words) {
  const int64_t j = warp_index();
  if (j >= n) return;  // whole warps leave together: j is warp-uniform
  const int32_t r = row_id(rows, j);
  const int lane = threadIdx.x % kWarp;
  uint4* dst = out + j * row_words;
  if (r < 0 || int64_t(r) >= capacity) {
    for (int64_t i = lane; i < row_words; i += kWarp) dst[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* src = table + int64_t(r) * row_words;
#pragma unroll 4
  for (int64_t i = lane; i < row_words; i += kWarp) dst[i] = __ldg(src + i);
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
  gather_rows_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

const char* ssn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
