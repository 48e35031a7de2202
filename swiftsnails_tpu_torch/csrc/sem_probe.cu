// Probes of bulk-copy completion accounting on Hopper: cp.async.bulk row
// copies (the TMA engine) completing onto mbarriers in shared memory.
//
// They answer, on this card, the question tools/sem_probe.py asks of the
// TPU's DMA semaphores: is completion accounted by bytes, so that one armed
// barrier phase retires a chunk of scattered row copies, and what does
// waiting once a chunk save over waiting once a copy?
//
//   ssn_unit_probe   one copy of `rows` contiguous rows (x[0], or x[0:8])
//       Replaces unit_kernel (tools/sem_probe.py:63, pallas_call :80): one
//       async row copy, then polling the DMA semaphore's count. Here the
//       barrier word is not read (its layout is not documented); the probe
//       shows the accounting by arming: a phase armed with exactly the
//       copy's bytes completes, one armed with 16 bytes more does not
//       within the poll bound (it is then drained by one more 16-byte
//       copy). For an 8-row copy also: eight single-row copies onto one
//       barrier armed with the 8 rows' bytes complete, seven do not, and
//       the eighth drains it.
//   ssn_chunk_probe  64 scattered row copies onto one barrier armed with
//                    their bytes, one wait, the rows copied out
//       Replaces chunk_kernel (tools/sem_probe.py:129, pallas_call :164):
//       64 row copies retired by one [64, S, 128] descriptor wait.
//   ssn_pipe_probe   per block of K ids: K row copies through a ring of
//                    stages of 64 rows, each stage XOR-reduced
//       Replaces pipe_kernel (tools/sem_probe.py:200, pallas_call :233):
//       K row copies per grid step, retired by K per-copy waits or K/64
//       chunked waits.
//
// What bounds them: latency, not bytes. A probe moves a few KB (unit,
// chunk): its time is the copy's issue-to-complete latency and the polls.
// The pipe probe moves 64 x 1,856 rows of 1 KB (121.6 MB) and would be bound
// by device-memory bytes (3.35 TB/s) if enough rows were in flight; each CTA
// keeps at most three stages of 64 rows in flight, so latency per stage and
// the waits are what it measures.
//
// Design. A row (S * 128 elements, 1,024 B at dim 200 in f32) moves as one
// bulk copy that one thread asks of the TMA engine:
// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes, whose
// completion decrements the barrier's transaction count by the bytes it
// wrote. A barrier is initialised with one arrival; mbarrier.arrive.expect_tx
// arms a phase with the bytes it waits for, and the phase completes when the
// arrival is in and the count is back at 0. The TPU ran a grid in order on
// one core; here the pipe probe's B blocks are B CTAs on B SMs at once. K
// rows (1.9 MB) do not fit in shared memory (227 KB a CTA), so each CTA runs
// a ring of `stages` x 64 rows: thread 0 issues, all threads wait on the
// stage, XOR-reduce its words (which proves every copy landed), meet at
// __syncthreads, and thread 0 re-arms the stage after fence.proxy.async.
// The two variants differ only in the accounting: per-copy, 64 barriers a
// stage each armed with one row and 64 waits; chunked, one barrier armed
// with 64 rows and one wait.
//
// No wait without a deadline: every wait that must complete is a
// try_wait.parity loop against a clock64 deadline (~100 ms). Past it the
// kernel writes a code to a status word in mapped host memory (readable by
// the host after the context is lost) and calls __trap(), so the launch
// fails with an error instead of hanging, and no CTA exits with a bulk copy
// still in flight into its shared memory. An id outside [0, C) traps too.
//
// Bound by a plain C interface, loaded with ctypes. Each entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success), or an error
// code, launching nothing, for a row or base address that is not a multiple
// of 16 bytes, a phase above the transaction count's range or a ring that
// does not fit in shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr long long kDeadlineCycles = 200000000LL;  // ~100 ms at ~2 GHz
constexpr int kChunkThreads = 256;
constexpr int kPipeThreads = 256;
constexpr int kMaxTxBytes = (1 << 20) - 1;  // an mbarrier phase's tx-count range
constexpr int kBarrierBytes = 128;          // room ahead of a row buffer
constexpr long long kUnitPolls = 100000;     // the JAX tool's poll bound for one copy
constexpr long long kChunkPolls = 200000;    // and for a chunk
constexpr int kChunkRows = 64;               // the pipe's rows a stage

// Status codes: which wait passed its deadline.
enum : int {
  kOk = 0,
  kUnitExact = 1,
  kUnitOverDrain = 2,
  kUnitSingles = 3,
  kUnitLastDrain = 4,
  kChunkWait = 5,
  kPipeWait = 6,
  kBadId = 7,
};

// unit probe output fields (int64), in this order
enum : int {
  kUnit = 0,          // bytes one copy accounts for, or -1
  kExactDone,         // exact arming completed within the poll bound
  kExactPolls,        // test_wait polls until it completed
  kExactCycles,       // clock64 cycles from issue to completion
  kExactNs,           // %globaltimer ns from issue to completion
  kOverDone,          // arming 16 B above the copy completed (must not)
  kOverDrained,       // one more 16-byte copy completed it
  kSinglesDone,       // 8 single-row copies onto one 8-row phase completed
  kPartialDone,       // 7 of them completed it (must not)
  kLastDrained,       // the 8th completed it
  kUnitFields,
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void barrier_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (the TMA
// engine) and the other threads; a __syncthreads follows.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's and (after a __syncthreads) the CTA's generic-proxy
// reads of shared memory before async-proxy writes that reuse it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The one arrival of the phase, with the bytes it waits for.
__device__ __forceinline__ void arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory by the TMA engine, completing onto `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Has the phase of this parity completed? test_wait never blocks.
__device__ __forceinline__ bool test_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// try_wait may suspend the thread for a while before it answers.
__device__ __forceinline__ bool try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __noinline__ void fail(int* status, int code) {
  *reinterpret_cast<volatile int*>(status) = code;
  __threadfence_system();
  __trap();
}

// Waits for the phase of this parity, or fails with `code` at the deadline.
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity, int* status,
                                             int code) {
  const long long t0 = clock64();
  while (!try_wait(bar, parity)) {
    if (clock64() - t0 > kDeadlineCycles) fail(status, code);
  }
}

struct Poll {
  bool done;
  long long polls, cycles, ns;
};

// Polls the phase (parity 0) at most `max_polls` times; cycles and ns are
// counted from t0 / g0, the copy's issue.
__device__ __forceinline__ Poll poll(uint32_t bar, long long max_polls, long long t0,
                                     uint64_t g0) {
  Poll p{false, 0, 0, 0};
  while (p.polls < max_polls) {
    ++p.polls;
    if (test_wait(bar, 0)) {
      p.done = true;
      break;
    }
  }
  p.cycles = clock64() - t0;
  p.ns = static_cast<long long>(globaltimer() - g0);
  return p;
}

// ------------------------------------------------------------ unit probe ---

// One thread launched. Shared memory: 5 barriers, a 16-byte drain slot at 64, and
// the rows' buffer at kBarrierBytes. Each barrier serves one phase.
__global__ void unit_probe_kernel(const unsigned char* __restrict__ x, uint32_t row_bytes,
                                  int rows, long long* __restrict__ out, int* status) {
  extern __shared__ __align__(128) unsigned char shm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(shm);
  const uint32_t drain = smem_addr(shm + 64);
  const uint32_t buf = smem_addr(shm + kBarrierBytes);
  for (int i = 0; i < 5; ++i) barrier_init(smem_addr(&bars[i]), 1);
  fence_barrier_init();
  const uint32_t bytes = uint32_t(rows) * row_bytes;

  // exact arming
  const uint32_t exact = smem_addr(&bars[0]);
  long long t0 = clock64();
  uint64_t g0 = globaltimer();
  arm(exact, bytes);
  bulk_copy(buf, x, bytes, exact);
  Poll p = poll(exact, kUnitPolls, t0, g0);
  out[kExactDone] = p.done;
  out[kExactPolls] = p.polls;
  out[kExactCycles] = p.cycles;
  out[kExactNs] = p.ns;
  if (!p.done) wait_or_trap(exact, 0, status, kUnitExact);

  // over-arming by 16 bytes, then drained by one more 16-byte copy
  const uint32_t over = smem_addr(&bars[1]);
  arm(over, bytes + 16);
  bulk_copy(buf, x, bytes, over);
  p = poll(over, kUnitPolls, clock64(), globaltimer());
  out[kOverDone] = p.done;
  if (!p.done) {
    bulk_copy(drain, x, 16, over);
    wait_or_trap(over, 0, status, kUnitOverDrain);
  }
  out[kOverDrained] = 1;
  out[kUnit] = (out[kExactDone] && !out[kOverDone]) ? (long long)bytes : -1;

  if (rows == 1) {
    out[kSinglesDone] = out[kPartialDone] = out[kLastDrained] = -1;
    return;
  }
  // additivity: `rows` single-row copies onto one phase armed with all
  const uint32_t singles = smem_addr(&bars[2]);
  arm(singles, bytes);
  for (int k = 0; k < rows; ++k) {
    bulk_copy(buf + k * row_bytes, x + size_t(k) * row_bytes, row_bytes, singles);
  }
  p = poll(singles, kUnitPolls, clock64(), globaltimer());
  out[kSinglesDone] = p.done;
  if (!p.done) wait_or_trap(singles, 0, status, kUnitSingles);

  // all but the last must leave the phase pending; the last completes it
  const uint32_t partial = smem_addr(&bars[3]);
  arm(partial, bytes);
  for (int k = 0; k + 1 < rows; ++k) {
    bulk_copy(buf + k * row_bytes, x + size_t(k) * row_bytes, row_bytes, partial);
  }
  p = poll(partial, kUnitPolls, clock64(), globaltimer());
  out[kPartialDone] = p.done;
  // a phase that completed early takes no more bytes: the last copy then
  // goes to a fresh barrier, so that nothing is left in flight
  const uint32_t last = p.done ? smem_addr(&bars[4]) : partial;
  if (p.done) arm(last, row_bytes);
  const uint32_t k = uint32_t(rows - 1);
  bulk_copy(buf + k * row_bytes, x + size_t(k) * row_bytes, row_bytes, last);
  wait_or_trap(last, 0, status, kUnitLastDrain);
  out[kLastDrained] = 1;
}

// ----------------------------------------------------------- chunk probe ---

// One CTA. Thread 0 arms one barrier with n rows' bytes (+ arm_extra) and
// issues n scattered row copies; it polls the phase, the others wait on it;
// then all copy the rows out. stats: [flag, polls, cycles, ns], the flag
// +armed bytes if the phase completed within the poll bound, else -armed.
__global__ void __launch_bounds__(kChunkThreads)
chunk_probe_kernel(const unsigned char* __restrict__ x, const int32_t* __restrict__ rows,
                   int n, long long capacity, uint32_t row_bytes, uint32_t arm_extra,
                   uint4* __restrict__ out, long long* __restrict__ stats, int* status) {
  extern __shared__ __align__(128) unsigned char shm[];
  uint64_t* bar_ptr = reinterpret_cast<uint64_t*>(shm);
  unsigned char* buf = shm + kBarrierBytes;
  const uint32_t bar = smem_addr(bar_ptr);
  if (threadIdx.x == 0) {
    barrier_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t armed = uint32_t(n) * row_bytes + arm_extra;
    const long long t0 = clock64();
    const uint64_t g0 = globaltimer();
    arm(bar, armed);
    for (int k = 0; k < n; ++k) {
      const int32_t r = __ldg(rows + k);
      if (r < 0 || r >= capacity) fail(status, kBadId);
      bulk_copy(smem_addr(buf + size_t(k) * row_bytes), x + size_t(r) * row_bytes,
                row_bytes, bar);
    }
    const Poll p = poll(bar, kChunkPolls, t0, g0);
    stats[0] = p.done ? (long long)armed : -(long long)armed;
    stats[1] = p.polls;
    stats[2] = p.cycles;
    stats[3] = p.ns;
  }
  wait_or_trap(bar, 0, status, kChunkWait);
  const uint4* src = reinterpret_cast<const uint4*>(buf);
  const int words = int(size_t(n) * row_bytes / sizeof(uint4));
  for (int i = threadIdx.x; i < words; i += blockDim.x) out[i] = src[i];
}

// ------------------------------------------------------------ pipe probe ---

// Block i handles ids rows[i*k_rows, (i+1)*k_rows) in chunks of kChunkRows
// rows through a ring of `stages` stages. out[i] = (word 0 of its first row,
// XOR of every 32-bit word of its k_rows rows).
template <bool kChunked>
__global__ void __launch_bounds__(kPipeThreads)
pipe_probe_kernel(const unsigned char* __restrict__ x, const int32_t* __restrict__ rows,
                  int k_rows, int stages, long long capacity, uint32_t row_bytes,
                  uint32_t buf_offset, uint32_t* __restrict__ out, int* status) {
  extern __shared__ __align__(128) unsigned char shm[];
  __shared__ uint32_t warp_xor[kPipeThreads / 32];
  uint64_t* bars = reinterpret_cast<uint64_t*>(shm);  // stages (x kChunkRows per-copy)
  unsigned char* buf = shm + buf_offset;
  const int32_t* ids = rows + size_t(blockIdx.x) * k_rows;
  constexpr int ch = kChunkRows;
  const int nch = k_rows / ch;
  const uint32_t stage_bytes = uint32_t(ch) * row_bytes;
  const int n_bars = kChunked ? stages : stages * ch;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_bars; ++i) barrier_init(smem_addr(&bars[i]), 1);
    fence_barrier_init();
  }
  __syncthreads();

  // thread 0: arm stage c % stages and issue chunk c into it
  auto issue = [&](int c) {
    const int s = c % stages;
    unsigned char* dst = buf + size_t(s) * stage_bytes;
    if (kChunked) arm(smem_addr(&bars[s]), stage_bytes);
    for (int j = 0; j < ch; ++j) {
      const int32_t r = __ldg(ids + size_t(c) * ch + j);
      if (r < 0 || r >= capacity) fail(status, kBadId);
      const uint32_t bar = smem_addr(&bars[kChunked ? s : s * ch + j]);
      if (!kChunked) arm(bar, row_bytes);
      bulk_copy(smem_addr(dst + size_t(j) * row_bytes), x + size_t(r) * row_bytes,
                row_bytes, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int c = 0; c < stages && c < nch; ++c) issue(c);
  }

  uint32_t acc = 0, first = 0;
  const int words = int(stage_bytes / sizeof(uint4));
  for (int c = 0; c < nch; ++c) {
    const int s = c % stages;
    const uint32_t parity = uint32_t(c / stages) & 1u;
    if (kChunked) {
      wait_or_trap(smem_addr(&bars[s]), parity, status, kPipeWait);
    } else {
      for (int j = 0; j < ch; ++j) {
        wait_or_trap(smem_addr(&bars[s * ch + j]), parity, status, kPipeWait);
      }
    }
    const uint4* st = reinterpret_cast<const uint4*>(buf + size_t(s) * stage_bytes);
    if (c == 0 && threadIdx.x == 0) first = st[0].x;
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      const uint4 v = st[w];
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && c + stages < nch) {
      fence_proxy_async();
      issue(c + stages);
    }
  }

  for (int off = 16; off > 0; off /= 2) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) warp_xor[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPipeThreads / 32; ++w) acc ^= warp_xor[w];
    out[2 * blockIdx.x] = first;
    out[2 * blockIdx.x + 1] = acc;
  }
}

// ------------------------------------------------------------------ host ---

// The status word: mapped, pinned host memory, allocated at first use.
int* g_status_host = nullptr;
int* g_status_dev = nullptr;

cudaError_t status_word(int** dev) {
  if (g_status_host == nullptr) {
    cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&g_status_host), sizeof(int),
                                    cudaHostAllocMapped);
    if (err != cudaSuccess) return err;
    err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&g_status_dev), g_status_host, 0);
    if (err != cudaSuccess) return err;
  }
  *g_status_host = kOk;
  *dev = g_status_dev;
  return cudaSuccess;
}

bool aligned(long long row_bytes, const void* a, const void* b) {
  const uint64_t bits = uint64_t(row_bytes) | uint64_t(reinterpret_cast<uintptr_t>(a)) |
                        uint64_t(reinterpret_cast<uintptr_t>(b));
  return row_bytes > 0 && bits % 16 == 0;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace

extern "C" {

// x: >= rows contiguous rows of row_bytes; out: kUnitFields int64.
int ssn_unit_probe(const void* x, long long row_bytes, int rows, void* out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, x, out)) return int(cudaErrorMisalignedAddress);
  if (rows < 1 || rows * row_bytes + 16 > kMaxTxBytes) return int(cudaErrorInvalidValue);
  int* status;
  if ((err = status_word(&status)) != cudaSuccess) return int(err);
  const size_t smem = kBarrierBytes + size_t(rows) * row_bytes;
  if ((err = set_smem(unit_probe_kernel, smem)) != cudaSuccess) return int(err);
  unit_probe_kernel<<<1, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), uint32_t(row_bytes), rows,
      static_cast<long long*>(out), status);
  return int(cudaGetLastError());
}

// n scattered rows of x ([capacity] rows of row_bytes) into out ([n] rows);
// stats: 4 int64.
int ssn_chunk_probe(const void* x, const void* rows, long long n, long long capacity,
                    long long row_bytes, long long arm_extra, void* out, void* stats,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, x, out) || arm_extra % 16) return int(cudaErrorMisalignedAddress);
  if (n < 1 || arm_extra < 0 || n * row_bytes + arm_extra > kMaxTxBytes) {
    return int(cudaErrorInvalidValue);
  }
  int* status;
  if ((err = status_word(&status)) != cudaSuccess) return int(err);
  const size_t smem = kBarrierBytes + size_t(n) * row_bytes;
  if ((err = set_smem(chunk_probe_kernel, smem)) != cudaSuccess) return int(err);
  chunk_probe_kernel<<<1, kChunkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int32_t*>(rows), int(n),
      capacity, uint32_t(row_bytes), uint32_t(arm_extra), static_cast<uint4*>(out),
      static_cast<long long*>(stats), status);
  return int(cudaGetLastError());
}

// blocks x k_rows ids; out: [blocks, 2] uint32. chunked: 1 for one barrier
// a stage, 0 for one a copy.
int ssn_pipe_probe(const void* x, const void* rows, long long blocks, long long k_rows,
                   long long stages, long long capacity, long long row_bytes, int chunked,
                   void* out, int device, void* stream) {
  constexpr long long ch = kChunkRows;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, x, nullptr)) return int(cudaErrorMisalignedAddress);
  if (blocks < 1 || stages < 1 || k_rows < ch || k_rows % ch ||
      ch * row_bytes > kMaxTxBytes) {
    return int(cudaErrorInvalidValue);
  }
  int* status;
  if ((err = status_word(&status)) != cudaSuccess) return int(err);
  const size_t bar_bytes = size_t(stages) * ch * sizeof(uint64_t);
  const size_t offset = (bar_bytes + 127) / 128 * 128;
  const size_t smem = offset + size_t(stages) * ch * row_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* xs = static_cast<const unsigned char*>(x);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (chunked) {
    if ((err = set_smem(pipe_probe_kernel<true>, smem)) != cudaSuccess) return int(err);
    pipe_probe_kernel<true><<<unsigned(blocks), kPipeThreads, smem, s>>>(
        xs, ids, int(k_rows), int(stages), capacity, uint32_t(row_bytes), uint32_t(offset), o,
        status);
  } else {
    if ((err = set_smem(pipe_probe_kernel<false>, smem)) != cudaSuccess) return int(err);
    pipe_probe_kernel<false><<<unsigned(blocks), kPipeThreads, smem, s>>>(
        xs, ids, int(k_rows), int(stages), capacity, uint32_t(row_bytes), uint32_t(offset), o,
        status);
  }
  return int(cudaGetLastError());
}

// The code of the wait that passed its deadline in the last probe (0: none).
// Host memory: readable after the trap has ended the context.
int ssn_probe_status() {
  return g_status_host ? *reinterpret_cast<volatile int*>(g_status_host) : 0;
}

const char* ssn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
