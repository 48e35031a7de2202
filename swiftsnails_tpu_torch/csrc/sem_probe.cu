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
// What bounds them. The unit probe moves a few KB: its time is one copy's
// issue-to-complete latency and, above all, the 100,000 polls of the
// over-armed phase, which the JAX tool's semantics fix. The chunk probe (64
// rows, 64 KB) is bound by latency too: the launch, one load of the ids, the
// TMA engine's issue of 64 copies and their landing, the copy out. The pipe
// probe reads 64 x 1,856 rows of 1 KB (121.6 MB, 71 MB of them distinct) and
// is bound by device-memory bytes (3.35 TB/s) once enough rows are in flight
// on enough SMs: a CTA with three stages of 64 rows holds 192 KB in flight,
// so 128 CTAs hold ~25 MB, far above the ~5 MB that HBM's latency asks.
//
// Design. A row (S * 128 elements, 1,024 B at dim 200 in f32) moves as one
// bulk copy:
// cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes, whose
// completion decrements the barrier's transaction count by the bytes it
// wrote. A barrier is initialised with its arrivals; mbarrier.arrive.expect_tx
// arms a phase with the bytes it waits for, and the phase completes when the
// arrivals are in and the count is back at 0. Copies are issued by a warp:
// each lane loads its ids in one coalesced load (the stage's 64 ids: two a
// lane), the warp checks their bounds with one vote, one lane arms the phase
// (or, per copy, each lane the barriers of its rows) and every lane issues its
// copies. No id load waits behind another copy's issue.
//   * chunk probe: one CTA, one barrier armed with the n rows' bytes (plus
//     arm_extra), armed by lane 0 of warp 0 before the warp loads the ids,
//     so the time from the arming covers the ids' loads, the copies' issue
//     and their landing; warp 0 issues, thread 0 alone polls the phase while
//     the other warps wait at the CTA barrier, then the CTA's threads copy
//     the rows out.
//   * pipe probe: the TPU ran a grid in order on one core; here a block of K
//     ids is one thread-block cluster of G CTAs on neighbouring SMs, and CTA
//     rank r takes the block's chunks of 64 rows r, r + G, ... G is the
//     hogwild kernels' rule (cluster_launch.cuh), picked once a shape by
//     ssn_pipe_probe itself: the least rounds x waves,
//     ceil(chunks / G) x ceil(blocks / clusters of G the card holds at once);
//     at the JAX tool's shape (29 chunks, 64 blocks, 66 clusters of 2
//     resident) G = 2, 128 CTAs in one wave. K rows (1.9 MB) do not fit in
//     shared memory (227 KB), so each CTA runs a ring of `stages` x 64 rows: a
//     producer warp and four consumer warps. Each stage has "full" barriers
//     (chunked: one armed with the stage's bytes; per copy: 64, each armed
//     with one row's bytes by the lane that issues that row) and an "empty"
//     barrier that every consumer thread arrives on once it has XOR-reduced
//     its share of the stage (per copy: a row only after its own barrier's
//     phase). The producer refills a stage as soon as it is released (after
//     fence.proxy.async, which orders the consumers' generic reads before the
//     async-proxy writes), with no CTA-wide barrier in the loop, and loads
//     the next stage's ids before it waits. At the end the ranks' XORs meet
//     in rank 0 through distributed shared memory between two cluster
//     barriers; `first` is chunk 0's first word, which rank 0 holds. XOR is
//     order-free, so the result is bit-identical run to run.
//
// No wait without a deadline, apart from the hardware cluster barrier: every
// wait that must complete is a try_wait.parity loop against a clock64
// deadline (~100 ms). Past it the kernel writes a code to a status word in
// mapped host memory (readable by the host after the context is lost) and
// calls __trap(), so the launch fails with an error instead of hanging, and
// no CTA exits with a bulk copy still in flight into its shared memory. An id
// outside [0, C) traps too.
//
// Bound by a plain C interface, loaded with ctypes. Each entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success), or an error
// code, launching nothing, for a row or base address that is not a multiple
// of 16 bytes, a phase above the transaction count's range or a ring that
// does not fit in shared memory. ssn_pipe_plan and ssn_chunk_plan report the
// geometry the probes launch with (cluster, CTAs, threads, issuing lanes).

#include <cooperative_groups.h>
#include <cstdint>

#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr long long kDeadlineCycles = 200000000LL;  // ~100 ms at ~2 GHz
constexpr int kChunkCtas = 1;
constexpr int kChunkThreads = 256;
constexpr int kChunkIssueLanes = 32;  // warp 0: two ids and two copies a lane
constexpr int kPipeConsumerWarps = 4;
constexpr int kPipeConsumers = 32 * kPipeConsumerWarps;
constexpr int kPipeThreads = kPipeConsumers + 32;  // and the producer warp
constexpr unsigned kWarp = 0xffffffffu;
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
  kPipeRelease = 8,  // the producer's wait for a stage its consumers released
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

// A consumer's arrival: it is done with the stage (release order).
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

// One CTA. Lane 0 of warp 0 initialises one barrier and arms it with n rows'
// bytes (+ arm_extra); then each of the warp's kChunkIssueLanes lanes loads
// two ids of each 64 (one coalesced load), the warp checks them with one vote
// and each lane issues its two rows' copies. Thread 0 polls the phase and,
// past the poll bound, waits for it to its deadline. The other warps
// meanwhile wait at the CTA barrier, not on the mbarrier: 224 more threads
// polling it while the copies land slow their completion by about half. Then
// every thread passes the completed phase and the CTA copies the rows out.
// stats: [flag, polls, cycles, ns], the flag +armed bytes if the phase
// completed within the poll bound, else -armed; cycles and ns from the
// arming, so they cover the ids' loads, the copies' issue and their landing.
__global__ void __launch_bounds__(kChunkThreads)
chunk_probe_kernel(const unsigned char* __restrict__ x, const int32_t* __restrict__ rows,
                   int n, long long capacity, uint32_t row_bytes, uint32_t arm_extra,
                   uint4* __restrict__ out, long long* __restrict__ stats, int* status) {
  extern __shared__ __align__(128) unsigned char shm[];
  unsigned char* buf = shm + kBarrierBytes;
  const uint32_t bar = smem_addr(shm);
  if (threadIdx.x < kChunkIssueLanes) {
    const int lane = threadIdx.x;
    const uint32_t armed = uint32_t(n) * row_bytes + arm_extra;
    long long t0 = 0;
    uint64_t g0 = 0;
    if (lane == 0) {
      barrier_init(bar, 1);
      fence_barrier_init();
      t0 = clock64();
      g0 = globaltimer();
      arm(bar, armed);
    }
    __syncwarp();
    // each id loaded once; both of a lane's rows checked before either copy
    for (int base = 0; base < n; base += 2 * kChunkIssueLanes) {
      const int k0 = base + lane, k1 = k0 + kChunkIssueLanes;
      const int32_t r0 = k0 < n ? __ldg(rows + k0) : 0;
      const int32_t r1 = k1 < n ? __ldg(rows + k1) : 0;
      if (__any_sync(kWarp, r0 < 0 || r0 >= capacity || r1 < 0 || r1 >= capacity)) {
        fail(status, kBadId);
      }
      if (k0 < n) {
        bulk_copy(smem_addr(buf + size_t(k0) * row_bytes), x + size_t(r0) * row_bytes,
                  row_bytes, bar);
      }
      if (k1 < n) {
        bulk_copy(smem_addr(buf + size_t(k1) * row_bytes), x + size_t(r1) * row_bytes,
                  row_bytes, bar);
      }
    }
    if (lane == 0) {
      const Poll p = poll(bar, kChunkPolls, t0, g0);
      stats[0] = p.done ? (long long)armed : -(long long)armed;
      stats[1] = p.polls;
      stats[2] = p.cycles;
      stats[3] = p.ns;
      if (!p.done) wait_or_trap(bar, 0, status, kChunkWait);
    }
  }
  __syncthreads();  // thread 0 has seen the phase complete, or trapped
  wait_or_trap(bar, 0, status, kChunkWait);  // complete: each thread's view of the rows
  const uint4* src = reinterpret_cast<const uint4*>(buf);
  const int words = int(size_t(n) * row_bytes / sizeof(uint4));
  for (int i = threadIdx.x; i < words; i += blockDim.x) out[i] = src[i];
}

// ------------------------------------------------------------ pipe probe ---

// A spin of twice the deadline, trapping nowhere: a test's stand-in for
// consumers that never release their stage.
__device__ __noinline__ void hold_stage() {
  const long long t0 = clock64();
  while (clock64() - t0 < 2 * kDeadlineCycles) {
  }
}

// Block b (a cluster of G CTAs) handles ids rows[b*k_rows, (b+1)*k_rows) in
// chunks of kChunkRows rows; CTA rank r takes chunks r, r+G, ... through a
// ring of `stages` stages. out[b] = (word 0 of its first row, XOR of every
// 32-bit word of its k_rows rows). Shared memory: the full barriers (stages,
// or stages x kChunkRows per copy), the empty barriers (stages), the ring at
// buf_offset. hold (a test's fault): the consumers keep their first stage.
template <bool kChunked>
__global__ void __launch_bounds__(kPipeThreads)
pipe_probe_kernel(const unsigned char* __restrict__ x, const int32_t* __restrict__ rows,
                  int k_rows, int stages, long long capacity, uint32_t row_bytes,
                  uint32_t buf_offset, int hold, uint32_t* __restrict__ out, int* status) {
  extern __shared__ __align__(128) unsigned char shm[];
  __shared__ uint32_t warp_xor[kPipeConsumerWarps];
  constexpr int ch = kChunkRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), g = int(cluster.num_blocks());
  const int block = int(blockIdx.x) / g;
  const int nch = k_rows / ch;
  const int mine = rank < nch ? (nch - rank + g - 1) / g : 0;  // chunks rank + i g
  const uint32_t stage_bytes = uint32_t(ch) * row_bytes;
  const int n_full = kChunked ? stages : stages * ch;
  uint64_t* full = reinterpret_cast<uint64_t*>(shm);
  uint64_t* empty = full + n_full;
  unsigned char* buf = shm + buf_offset;
  const int32_t* ids = rows + size_t(block) * k_rows;
  const int warp = int(threadIdx.x) / 32, lane = int(threadIdx.x) % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_full; ++i) barrier_init(smem_addr(&full[i]), 1);
    for (int s = 0; s < stages; ++s) barrier_init(smem_addr(&empty[s]), kPipeConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  uint32_t acc = 0, first = 0;
  if (warp == kPipeConsumerWarps) {
    // the producer warp: lane l issues rows l and l + 32 of each chunk
    for (int i = 0; i < mine; ++i) {
      const int s = i % stages;
      const int32_t* cid = ids + size_t(rank + i * g) * ch;
      const int32_t r0 = __ldg(cid + lane), r1 = __ldg(cid + 32 + lane);
      if (i >= stages) {
        wait_or_trap(smem_addr(&empty[s]), uint32_t(i / stages - 1) & 1u, status,
                     kPipeRelease);
        fence_proxy_async();
      }
      if (__any_sync(kWarp, r0 < 0 || r0 >= capacity || r1 < 0 || r1 >= capacity)) {
        fail(status, kBadId);
      }
      uint32_t b0, b1;
      if (kChunked) {
        b0 = b1 = smem_addr(&full[s]);
        if (lane == 0) arm(b0, stage_bytes);
        __syncwarp();
      } else {
        b0 = smem_addr(&full[s * ch + lane]);
        b1 = smem_addr(&full[s * ch + 32 + lane]);
        arm(b0, row_bytes);
        arm(b1, row_bytes);
      }
      unsigned char* dst = buf + size_t(s) * stage_bytes;
      bulk_copy(smem_addr(dst + size_t(lane) * row_bytes), x + size_t(r0) * row_bytes,
                row_bytes, b0);
      bulk_copy(smem_addr(dst + size_t(lane + 32) * row_bytes), x + size_t(r1) * row_bytes,
                row_bytes, b1);
    }
  } else {
    // the consumer warps: chunked, thread t XORs words t, t + 128, ... of the
    // stage; per copy, warp w rows w, w + 4, ..., each after its own barrier
    const int t = int(threadIdx.x);
    const int row_words = int(row_bytes / sizeof(uint4));
    for (int i = 0; i < mine; ++i) {
      const int s = i % stages;
      const uint32_t parity = uint32_t(i / stages) & 1u;
      const uint4* st = reinterpret_cast<const uint4*>(buf + size_t(s) * stage_bytes);
      if (kChunked) {
        wait_or_trap(smem_addr(&full[s]), parity, status, kPipeWait);
#pragma unroll 4
        for (int w = t; w < ch * row_words; w += kPipeConsumers) {
          const uint4 v = st[w];
          acc ^= v.x ^ v.y ^ v.z ^ v.w;
        }
      } else {
        for (int j = warp; j < ch; j += kPipeConsumerWarps) {
          wait_or_trap(smem_addr(&full[s * ch + j]), parity, status, kPipeWait);
          for (int w = lane; w < row_words; w += 32) {
            const uint4 v = st[j * row_words + w];
            acc ^= v.x ^ v.y ^ v.z ^ v.w;
          }
        }
      }
      if (i == 0 && t == 0) first = st[0].x;  // rank 0's chunk 0 is the block's first
      if (hold && i == 0) {
        hold_stage();
        continue;
      }
      arrive(smem_addr(&empty[s]));
    }
    for (int off = 16; off > 0; off /= 2) acc ^= __shfl_xor_sync(kWarp, acc, off);
    if (lane == 0) warp_xor[warp] = acc;
  }

  cluster.sync();  // every rank's XOR is in its shared memory
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t total = 0;
    for (int k = 0; k < g; ++k) {
      const uint32_t* part = cluster.map_shared_rank(warp_xor, k);
      for (int w = 0; w < kPipeConsumerWarps; ++w) total ^= part[w];
    }
    out[2 * block] = first;
    out[2 * block + 1] = total;
  }
  cluster.sync();  // no CTA exits while rank 0 reads its shared memory
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

// The pipe's launch of a shape on a card: the cluster (cluster_launch.cuh)
// and a CTA's shared memory, the full and empty barriers, then the ring at
// `offset`.
struct PipePlan : ClusterPick {
  size_t offset = 0, bytes = 0;
};

bool pipe_shape_ok(long long blocks, long long k_rows, long long stages, long long row_bytes) {
  constexpr long long ch = kChunkRows;
  return blocks >= 1 && stages >= 1 && k_rows >= ch && k_rows % ch == 0 && row_bytes > 0 &&
         ch * row_bytes <= kMaxTxBytes;
}

// The plan of a shape on a card, computed once: the occupancy queries cost
// more host time than the launch. G is picked for blocks of k_rows / 64
// chunks.
cudaError_t pipe_plan(long long blocks, long long k_rows, long long stages, long long row_bytes,
                      bool chunked, int device, PipePlan* out) {
  static std::mutex mu;
  static std::map<std::tuple<long long, long long, long long, long long, int, int>, PipePlan>
      cache;
  const auto key = std::make_tuple(blocks, k_rows, stages, row_bytes, int(chunked), device);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  PipePlan p;
  const size_t bars = size_t(stages) * ((chunked ? 1 : kChunkRows) + 1);
  p.offset = (bars * sizeof(uint64_t) + 127) / 128 * 128;
  p.bytes = p.offset + size_t(stages) * kChunkRows * row_bytes;
  const int nch = int(k_rows / kChunkRows);
  const cudaError_t err =
      chunked ? pick_cluster(pipe_probe_kernel<true>, blocks, nch, kPipeThreads, p.bytes, &p)
              : pick_cluster(pipe_probe_kernel<false>, blocks, nch, kPipeThreads, p.bytes, &p);
  if (err != cudaSuccess) return err;
  cache[key] = p;
  *out = p;
  return cudaSuccess;
}

template <bool kChunked>
cudaError_t launch_pipe(const PipePlan& p, long long blocks, cudaStream_t s,
                        const unsigned char* x, const int32_t* ids, int k_rows, int stages,
                        long long capacity, uint32_t row_bytes, int hold, uint32_t* out,
                        int* status) {
  // the limit is the kernel's, not the shape's: another shape may have set it
  cudaError_t err = set_smem(pipe_probe_kernel<kChunked>, p.bytes);
  if (err != cudaSuccess) return err;
  ClusterConfig c(p.cluster, blocks, kPipeThreads, p.bytes, s);
  return cudaLaunchKernelEx(&c.cfg, pipe_probe_kernel<kChunked>, x, ids, k_rows, stages,
                            capacity, row_bytes, uint32_t(p.offset), hold, out, status);
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
  chunk_probe_kernel<<<kChunkCtas, kChunkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int32_t*>(rows), int(n),
      capacity, uint32_t(row_bytes), uint32_t(arm_extra), static_cast<uint4*>(out),
      static_cast<long long*>(stats), status);
  return int(cudaGetLastError());
}

// blocks x k_rows ids; out: [blocks, 2] uint32. chunked: 1 for one barrier
// a stage, 0 for one a copy; hold: a test's fault, the consumers keep their
// first stage (0 otherwise). A block is a cluster of G CTAs, G as
// ssn_pipe_plan gives it.
int ssn_pipe_probe(const void* x, const void* rows, long long blocks, long long k_rows,
                   long long stages, long long capacity, long long row_bytes, int chunked,
                   int hold, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!aligned(row_bytes, x, nullptr)) return int(cudaErrorMisalignedAddress);
  if (!pipe_shape_ok(blocks, k_rows, stages, row_bytes)) return int(cudaErrorInvalidValue);
  PipePlan p;
  if ((err = pipe_plan(blocks, k_rows, stages, row_bytes, chunked != 0, device, &p)) !=
      cudaSuccess) {
    return int(err);
  }
  int* status;
  if ((err = status_word(&status)) != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* xs = static_cast<const unsigned char*>(x);
  const int32_t* ids = static_cast<const int32_t*>(rows);
  uint32_t* o = static_cast<uint32_t*>(out);
  err = chunked ? launch_pipe<true>(p, blocks, s, xs, ids, int(k_rows), int(stages), capacity,
                                    uint32_t(row_bytes), hold, o, status)
                : launch_pipe<false>(p, blocks, s, xs, ids, int(k_rows), int(stages), capacity,
                                     uint32_t(row_bytes), hold, o, status);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// How ssn_pipe_probe launches this shape on this card, from the launch
// configuration it builds: out[0..5] = G (the CTAs of a block's cluster),
// the CTAs of the grid, the threads a CTA, the lanes that issue the copies
// (the producer warp), the consumer warps, the clusters of G the card holds
// at once; out[6..13] = the clusters of 1..8 CTAs it holds at once, from
// which the rule picked G.
int ssn_pipe_plan(long long blocks, long long k_rows, long long stages, long long row_bytes,
                  int chunked, int device, void* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (!pipe_shape_ok(blocks, k_rows, stages, row_bytes)) return int(cudaErrorInvalidValue);
  PipePlan p;
  if ((err = pipe_plan(blocks, k_rows, stages, row_bytes, chunked != 0, device, &p)) !=
      cudaSuccess) {
    return int(err);
  }
  const ClusterConfig c(p.cluster, blocks, kPipeThreads, p.bytes, nullptr);
  const long long v[6] = {p.cluster,
                          c.cfg.gridDim.x,
                          c.cfg.blockDim.x,
                          kPipeThreads - kPipeConsumers,
                          kPipeConsumerWarps,
                          p.max_active};
  long long* o = static_cast<long long*>(out);
  for (int i = 0; i < 6; ++i) o[i] = v[i];
  for (int k = 1; k <= kMaxCluster; ++k) o[5 + k] = p.active[k];
  return 0;
}

// How ssn_chunk_probe launches: out[0..2] = the CTAs, the threads a CTA and
// the lanes that issue the copies (warp 0).
int ssn_chunk_plan(void* out) {
  const long long v[3] = {kChunkCtas, kChunkThreads, kChunkIssueLanes};
  long long* o = static_cast<long long*>(out);
  for (int i = 0; i < 3; ++i) o[i] = v[i];
  return 0;
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
