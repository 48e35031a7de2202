// The merged fused SGNS substeps on Hopper: the grouped substep (blocks of PC
// centers, CW = 2 * window context slots each, -1 = pad, sharing PN pooled
// negatives) with some rows' updates merged, the kernel blocks of a substep
// in order. One entry point serves three TPU kernels of the JAX package's
// ops/fused_sgns.py:
//
//   fused_sgns_resident_step        / _resident_kernel       (hot_n > 0)
//   fused_sgns_dedup_step           / _dedup_kernel          (unique lists)
//   fused_sgns_dedup_resident_step  / _dedup_resident_kernel (both)
//
// Semantics (the Python wrappers' docstring has them in full). Kernel block
// b of a substep reads cold rows as the writes of blocks <= b - 2 left them
// and hot rows (id < hot_n, both tables) as blocks <= b - 1 left them. It
// then writes each row it touched once: a merged row (hot, or a context row
// in its block's unique list) gets base - lr * (sum of its slots'
// gradients); any other row gets the value of its last slot, in the order
// centers, contexts (c-major), pool. A unique row's merged write follows
// the pool's. The TPU kernels get this from their sequential grid.
//
// Design: one persistent launch a substep. The grid is every CTA the card
// holds at once (the occupancy of this kernel at its shared memory, times
// the SMs), launched cooperatively so that all of them are resident, and
// it walks the substep's kernel blocks in order, with a grid-wide barrier
// between the phases of a block:
//   stage(0) | C(0) | dQ(0) | W(0) | C(1) | dQ(1) | W(1) | ...
//   C(b): each CTA takes one center of the block at a time (centers j,
//     j + grid, ...), so the block's PC centers spread over every SM. It
//     loads the pool (hot rows live from the tables, cold rows from a
//     staging buffer), its center and that center's context slots into
//     shared memory, scores them as the grouped kernel does, and writes the
//     center's read value V and gradient dV, each context slot's gradient
//     scalar g_pos and each pool slot's g_neg to scratch, and adds its loss
//     terms to a per-CTA sum. In the same phase every warp of the grid
//     stages a share of block b + 1's cold rows into the other half of a
//     two-slot staging buffer: read after W(b - 1) and before W(b), which
//     is the b - 2 rule. Hot rows are never staged: C reads them live,
//     after W(b - 1).
//   dQ(b): output-stationary. Each CTA owns a tile of dQ [PN, D] (4 pool
//     rows x 32 lanes) and sums it over the block's centers: warp w sums
//     centers [w * J, (w + 1) * J), J = ceil(PC / 16), reading g_neg and V
//     from L2, and the 16 partials are added in warp order. No partial
//     buffer, no second pass.
//   W(b): the runs of the prep (ops/fused_sgns.py merge_runs), one per
//     written row, sorted by row so that a merged row's slots are
//     contiguous. A run of at most `chunk` slots is one warp's (warps taken
//     from the last CTA backwards): it sums its slots' gradients in order
//     and writes base - lr * sum once. A longer run, from the prep's list
//     of long runs, is one CTA's (CTAs from the first forwards): warp w sums
//     the w-th of 16 contiguous pieces, and the partials are added in warp
//     order in shared memory before the write. No two runs write one row,
//     so no atomics, and every sum has a fixed order: two runs are bit for
//     bit alike.
// The barrier is a counter of the kernel's own in a buffer the wrapper
// zeroes: each CTA's thread 0 adds one (after __threadfence, which orders
// the CTA's writes before it) and waits, with ld.acquire, until it holds k
// times the grid at the k-th barrier. A cooperative launch is what makes
// this safe: cudaLaunchCooperativeKernel refuses a grid that cannot be
// resident at once (the error is returned, and the wrapper raises), so no
// CTA waits on one that has not started. cooperative_groups' grid.sync()
// would serve too but cannot carry a deadline: here every wait has a
// clock64 deadline of ~100 ms, past which the kernel stores a code in
// mapped host memory and traps, so that a barrier that never fills fails
// the launch instead of hanging the card (the probes' pattern,
// csrc/sem_probe.cu). 3 barriers a kernel block replace the 3 launches a
// block (and the reduce launch's 4 MB of partials) of this kernel's first
// form.
//
// Coherence. Tables, staging and scratch are written and read inside the
// launch by different SMs, so every load of them is ld.global.cg (__ldcg:
// L2, never a stale L1 line or the non-coherent path), after the barrier's
// acquire. Row ids and the prep's lists are not written in the launch.
//
// What bounds it. At the main shape (f32 rows of 256 lanes, PC 256, PN 64,
// 32 kernel blocks) the f32 arithmetic (~1 GFLOP a substep) and the
// distinct rows moved (~40 MB) bound it near 0.015 ms; in practice the
// kernel blocks' order does: 96 grid barriers a substep, each phase a few
// rounds of L2 latency. Staging copies every cold slot's row, duplicates
// included; reading each distinct row once is later work.
//
// Compute is f32 with one rounding on write (__float2bfloat16_rn for bf16).
// Row ids outside [0, C) (the -1 pads) are never dereferenced: such a slot
// reads zeros, is masked out of the arithmetic and is never written.
//
// Bound by a plain C interface, loaded with ctypes. The entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns the launch's error (0 on success), or
// cudaErrorInvalidValue, launching nothing, for shapes whose center does
// not fit in shared memory (ssn_fused_sgns_merged_grid says so
// beforehand).

#include "sgns_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDqRows = 4;  // pool rows of a dQ tile (x 32 lanes)
constexpr int kMaxLaneElems = 16;  // row elements a lane holds in W and staging: rows up to 512
constexpr long long kDeadlineCycles = 200000000LL;  // ~100 ms at ~2 GHz
constexpr size_t kMaxDynamicSmem = 232448 - kWarps * sizeof(float);
constexpr size_t kAlign = 256;

// Which barrier passed its deadline (ssn_fused_sgns_merged_status).
enum : int { kOk = 0, kStaged = 1, kComputed = 2, kReduced = 3, kWritten = 4 };

// Shared memory of C: the pool, a center, its context slots, its scores,
// its count of real contexts and its context ids.
size_t compute_smem(int cw, int pool, int d) {
  return sizeof(float) * (size_t(pool) * d + d + size_t(cw) * d + size_t(cw + pool) + 1) +
         sizeof(int32_t) * size_t(cw);
}

// The dynamic shared memory of the kernel (C's, or W's and dQ's partials
// where larger), or 0 where C's does not fit or rows are wider than 512
// elements (W's registers).
size_t plan_smem(int cw, int pool, int d) {
  if (d > 32 * kMaxLaneElems) return 0;
  const size_t c = compute_smem(cw, pool, d);
  if (c > kMaxDynamicSmem) return 0;
  const size_t w = sizeof(float) * size_t(kWarps) * d;
  const size_t q = sizeof(float) * size_t(kWarps) * kDqRows * 32;
  return c > w ? (c > q ? c : q) : (w > q ? w : q);
}

size_t aligned(size_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

size_t workspace_bytes(int pc, int cw, int pool, int d, size_t elem) {
  return aligned(2 * size_t(pc) * d * elem) + aligned(2 * size_t(pc) * cw * d * elem) +
         aligned(2 * size_t(pool) * d * elem) + 2 * aligned(sizeof(float) * pc * d) +
         aligned(sizeof(float) * pc * cw) + aligned(sizeof(float) * pc * pool) +
         aligned(sizeof(float) * pool * d);
}

template <typename T>
struct Params {
  T* in_table;
  T* out_table;
  const int32_t* centers;    // [nblocks * pc]
  const int32_t* ctxs;       // [nblocks * pc, cw]
  const int32_t* pool_rows;  // [nblocks * pool]
  const int32_t* ent;        // [nblocks, K] slot codes of the runs
  const int32_t* run_start;  // [nblocks, K + 1]
  const int32_t* n_runs;     // [nblocks]
  const int32_t* long_runs;  // [nblocks, K] the runs longer than chunk
  const int32_t* n_long;     // [nblocks]
  T* stage_v;     // [2, pc, d]       cold center rows of blocks b, b + 1
  T* stage_u;     // [2, pc * cw, d]  cold context rows (p-major slots)
  T* stage_q;     // [2, pool, d]     cold pool rows
  float* vs;      // [pc, d]          the block's center values as read
  float* dvs;     // [pc, d]          their gradients
  float* gpos;    // [pc * cw]        each context slot's gradient scalar
  float* gneg;    // [pc, pool]       each pool slot's, per center
  float* dq;      // [pool, d]        dQ
  float* loss_parts;  // [grid]       each CTA's loss terms over the blocks
  unsigned* bar;      // the barrier counter, 0 at launch
  int* status;        // mapped host memory: the code of a missed deadline
  int64_t nblocks, capacity;
  int pc, cw, pool, d, hot_n, chunk;
  float lr, lam, inv_b;
  int miss;  // the barrier CTA 0 does not arrive at (-1: none), to test the deadline
};

__device__ __forceinline__ void copy_cg(float* dst, const float* src) { *dst = __ldcg(src); }
__device__ __forceinline__ void copy_cg(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<unsigned short*>(dst) =
      __ldcg(reinterpret_cast<const unsigned short*>(src));
}

// Four consecutive elements (16-byte aligned f32, 8-byte aligned bf16) as
// f32, and back with one rounding each.
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldcg4(const __nv_bfloat16* p) {
  const uint2 w = __ldcg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __noinline__ void fail(int* status, int code) {
  *reinterpret_cast<volatile int*>(status) = code;
  __threadfence_system();
  __trap();
}

// The k-th grid-wide barrier of the launch (k from 1), or a trap with
// `code` at the deadline.
template <typename T>
__device__ void grid_barrier(const Params<T>& p, unsigned k, int code) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!(blockIdx.x == 0 && int(k) == p.miss)) {
      __threadfence();
      atomicAdd(p.bar, 1u);
    }
    const unsigned target = k * gridDim.x;
    const long long t0 = clock64();
    while (ld_acquire(p.bar) < target) {
      if (clock64() - t0 > kDeadlineCycles) fail(p.status, code);
    }
    __threadfence();
  }
  __syncthreads();
}

// The sum of every thread's `mine`, per warp and then over the warps in
// order; thread 0 gets it.
__device__ float block_sum(float mine) {
  __shared__ float warp_part[kWarps];
  mine = warp_sum(mine);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = mine;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
  return s;
}

// Elements a warp's lane moves at a time: rows move in 16-byte words (kVec:
// rows of a multiple of 16 bytes, tables 16-byte aligned), else element by
// element.
template <bool kVec, typename T>
constexpr int kWordElems = kVec ? 16 / int(sizeof(T)) : 1;

// Block b's cold rows into staging slot b % 2, one row a warp over the
// whole grid: its centers, context slots (p-major) and pool rows, copied
// as they are. Hot rows are read live, pads never.
template <bool kVec, typename T>
__device__ void stage_block(const Params<T>& p, int64_t b) {
  const int lane = threadIdx.x & 31;
  const int slot = int(b & 1), d = p.d;
  const int cap = p.pc * p.cw, total = p.pc + cap + p.pool;
  const int nw = gridDim.x * kWarps;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < total; k += nw) {
    int32_t r;
    const T* table;
    T* dst;
    if (k < p.pc) {
      r = p.centers[b * p.pc + k];
      table = p.in_table;
      dst = p.stage_v + (int64_t(slot) * p.pc + k) * d;
    } else if (k < p.pc + cap) {
      const int s = k - p.pc;
      r = p.ctxs[b * cap + s];
      table = p.out_table;
      dst = p.stage_u + (int64_t(slot) * cap + s) * d;
    } else {
      const int c = k - p.pc - cap;
      r = p.pool_rows[b * p.pool + c];
      table = p.out_table;
      dst = p.stage_q + (int64_t(slot) * p.pool + c) * d;
    }
    if (!in_range(r, p.capacity) || r < p.hot_n) continue;  // warp-uniform
    const T* src = table + int64_t(r) * d;
    if (kVec) {
      const int words = d / kWordElems<kVec, T>;  // at most 4 a lane (2 KB rows)
      uint4 w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < words) w[m] = __ldcg(reinterpret_cast<const uint4*>(src) + lane + 32 * m);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < words) reinterpret_cast<uint4*>(dst)[lane + 32 * m] = w[m];
    } else {
      for (int i = lane; i < d; i += 32) copy_cg(dst + i, src + i);
    }
  }
}

// Where row r of C's shared memory comes from for center j of block b
// (rows 0 .. pool - 1 the pool, then the center, then its context slots):
// the table if hot, the staging slot if cold, nothing (zeros) for a pad.
template <typename T>
__device__ const T* row_source(const Params<T>& p, int64_t b, int j, int r) {
  const int pc = p.pc, cw = p.cw, pool = p.pool, d = p.d, slot = int(b & 1);
  int32_t id;
  const T* live;
  const T* staged;
  if (r < pool) {
    id = p.pool_rows[b * pool + r];
    live = p.out_table;
    staged = p.stage_q + (int64_t(slot) * pool + r) * d;
  } else if (r == pool) {
    id = p.centers[b * pc + j];
    live = p.in_table;
    staged = p.stage_v + (int64_t(slot) * pc + j) * d;
  } else {
    const int s = r - pool - 1;
    id = p.ctxs[(b * pc + j) * cw + s];
    live = p.out_table;
    staged = p.stage_u + ((int64_t(slot) * pc + j) * cw + s) * d;
  }
  if (!in_range(id, p.capacity)) return nullptr;
  return id < p.hot_n ? live + int64_t(id) * d : staged;
}

// rows [pool + 1 + cw, d] of C's shared memory in f32, a warp kFillRows rows
// at a time: lane u < kFillRows finds row u's source, the lanes share them
// by shuffles, and every word of the rows is loaded before any is stored.
template <bool kVec, typename T>
__device__ void fill_rows(const Params<T>& p, int64_t b, int j, float* q) {
  constexpr int kFillRows = 5, kFillWords = kVec ? 2 : 4, E = kWordElems<kVec, T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = p.d;
  const int rows = p.pool + 1 + p.cw, words = d / E;
  for (int r0 = warp; r0 < rows; r0 += kWarps * kFillRows) {
    const T* mine = nullptr;
    if (lane < kFillRows && r0 + lane * kWarps < rows)
      mine = row_source(p, b, j, r0 + lane * kWarps);
    const T* src[kFillRows];
#pragma unroll
    for (int u = 0; u < kFillRows; ++u)
      src[u] = reinterpret_cast<const T*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(mine), u));
    for (int c0 = lane; c0 < words; c0 += 32 * kFillWords) {
      if (kVec) {
        uint4 w[kFillRows][kFillWords];
#pragma unroll
        for (int u = 0; u < kFillRows; ++u)
#pragma unroll
          for (int m = 0; m < kFillWords; ++m) {
            const int c = c0 + 32 * m;
            w[u][m] = src[u] && c < words
                          ? __ldcg(reinterpret_cast<const uint4*>(src[u]) + c)
                          : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int u = 0; u < kFillRows; ++u)
#pragma unroll
          for (int m = 0; m < kFillWords; ++m) {
            const int r = r0 + u * kWarps, c = c0 + 32 * m;
            if (r < rows && c < words) widen(q + r * d + c * E, w[u][m], src[u]);
          }
      } else {
        float x[kFillRows][kFillWords];
#pragma unroll
        for (int u = 0; u < kFillRows; ++u)
#pragma unroll
          for (int m = 0; m < kFillWords; ++m) {
            const int c = c0 + 32 * m;
            x[u][m] = src[u] && c < words ? ldcg(src[u] + c) : 0.f;
          }
#pragma unroll
        for (int u = 0; u < kFillRows; ++u)
#pragma unroll
          for (int m = 0; m < kFillWords; ++m) {
            const int r = r0 + u * kWarps, c = c0 + 32 * m;
            if (r < rows && c < words) q[r * d + c] = x[u][m];
          }
      }
    }
  }
}

// C(b), and the staging of block b + 1. Thread 0 adds the CTA's loss terms
// to `loss`.
template <bool kVec, typename T>
__device__ void compute_block(const Params<T>& p, int64_t b, float* smem, float& loss) {
  if (b + 1 < p.nblocks) stage_block<kVec>(p, b + 1);
  const int pc = p.pc, cw = p.cw, pool = p.pool, d = p.d;
  float* q = smem;               // [pool, d]
  float* v = q + pool * d;       // [d]       the center row
  float* u = v + d;              // [cw, d]   its context rows, zeros on pads
  float* g = u + cw * d;         // [cw + pool]: pos (masked), then neg
  float* n_real = g + cw + pool;                        // [1]
  int32_t* xrow = reinterpret_cast<int32_t*>(n_real + 1);  // [cw]
  const int stride = cw + pool;
  for (int j = blockIdx.x; j < pc; j += gridDim.x) {  // the same for the whole CTA
    const int64_t cj = b * pc + j;
    for (int s = threadIdx.x; s < cw; s += kThreads) xrow[s] = p.ctxs[cj * cw + s];
    fill_rows<kVec>(p, b, j, q);
    __syncthreads();
    if (threadIdx.x == 0) {
      float c = 0.f;
      for (int s = 0; s < cw; ++s) c += in_range(xrow[s], p.capacity);
      *n_real = c;
    }
    dots<kThreads>(g, stride, d, [&](int k, const float*& a, const float*& bb) {
      a = v;
      bb = k < cw ? u + k * d : q + (k - cw) * d;
    });
    __syncthreads();
    float mine = 0.f;
    for (int k = threadIdx.x; k < stride; k += kThreads) {
      const float x = g[k];
      if (k < cw) {
        const bool real = in_range(xrow[k], p.capacity);
        if (real) mine += log_sigmoid(x);
        g[k] = real ? (sigmoid(x) - 1.f) * p.inv_b : 0.f;
      } else {
        mine += p.lam * log_sigmoid(-x) * *n_real;
        g[k] = p.lam * p.inv_b * sigmoid(x) * *n_real;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float dv = 0.f;
      for (int c = 0; c < cw; ++c) dv = fmaf(g[c], u[c * d + i], dv);
      for (int c = 0; c < pool; ++c) dv = fmaf(g[cw + c], q[c * d + i], dv);
      p.vs[int64_t(j) * d + i] = v[i];
      p.dvs[int64_t(j) * d + i] = dv;
    }
    for (int c = threadIdx.x; c < cw; c += kThreads) p.gpos[j * cw + c] = g[c];
    for (int c = threadIdx.x; c < pool; c += kThreads) p.gneg[j * pool + c] = g[cw + c];
    const float s = block_sum(mine);
    if (threadIdx.x == 0) loss += -s * p.inv_b;
    __syncthreads();  // smem is refilled by the next center
  }
}

// dQ(b) = g_neg^T V, output-stationary: a CTA a tile of kDqRows pool rows x
// 32 lanes, warp w summing centers [w * J, (w + 1) * J) in order, the warps'
// partials added in warp order.
template <typename T>
__device__ void dq_block(const Params<T>& p, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pool = p.pool, d = p.d;
  const int itiles = (d + 31) / 32, tiles = (pool + kDqRows - 1) / kDqRows * itiles;
  const int span = (p.pc + kWarps - 1) / kWarps;
  const int j0 = min(warp * span, p.pc), j1 = min(j0 + span, p.pc);
  const bool quad = pool % kDqRows == 0;  // a tile's g_neg as one float4
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int c0 = t / itiles * kDqRows, i = t % itiles * 32 + lane;
    float acc[kDqRows];
#pragma unroll
    for (int u = 0; u < kDqRows; ++u) acc[u] = 0.f;
    if (i < d) {
#pragma unroll 8
      for (int j = j0; j < j1; ++j) {
        const float x = __ldcg(p.vs + int64_t(j) * d + i);
        const float* gj = p.gneg + j * pool + c0;
        if (quad) {
          const float4 g4 = __ldcg(reinterpret_cast<const float4*>(gj));
          acc[0] = fmaf(g4.x, x, acc[0]);
          acc[1] = fmaf(g4.y, x, acc[1]);
          acc[2] = fmaf(g4.z, x, acc[2]);
          acc[3] = fmaf(g4.w, x, acc[3]);
        } else {
#pragma unroll
          for (int u = 0; u < kDqRows; ++u)
            if (c0 + u < pool) acc[u] = fmaf(__ldcg(gj + u), x, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDqRows; ++u) smem[(warp * kDqRows + u) * 32 + lane] = acc[u];
    __syncthreads();
    if (threadIdx.x < kDqRows * 32) {
      const int u = threadIdx.x >> 5;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += smem[(w * kDqRows + u) * 32 + lane];
      if (c0 + u < pool && i < d) p.dq[int64_t(c0 + u) * d + i] = s;
    }
    __syncthreads();
  }
}

// The row element that a lane's m-th sum of W holds: lanes over four
// consecutive elements at a time (kVec), else over single elements.
template <bool kVec>
__device__ __forceinline__ int lane_elem(int lane, int m) {
  return kVec ? 128 * (m / 4) + 4 * lane + m % 4 : lane + 32 * m;
}

// acc[m] += the gradients of slots ent[s0 .. s1) at row element
// lane_elem(lane, m), in slot order. A slot code below pc * cw is a context
// slot (p-major): g_pos times its center's V; then come the pool slots
// (their dQ row) and the centers (their dV). The warp reads 32 codes at a
// time, one a lane, and walks them by shuffles, so a piece streams its
// rows' loads.
template <int kLane, bool kVec, typename T>
__device__ void accumulate(const Params<T>& p, const int32_t* ent, int s0, int s1,
                           float (&acc)[kLane]) {
  const int lane = threadIdx.x & 31, d = p.d;
  const int cap = p.pc * p.cw, first_center = cap + p.pool;
  for (int k0 = s0; k0 < s1; k0 += 32) {
    const int n = min(32, s1 - k0);
    const int my_e = lane < n ? ent[k0 + lane] : 0;
    const float my_g = lane < n && my_e < cap ? __ldcg(p.gpos + my_e) : 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int e = __shfl_sync(0xffffffffu, my_e, j);
      const float g = __shfl_sync(0xffffffffu, my_g, j);
      const float* src = e < cap            ? p.vs + int64_t(e / p.cw) * d
                         : e < first_center ? p.dq + int64_t(e - cap) * d
                                            : p.dvs + int64_t(e - first_center) * d;
      const float scale = e < cap ? g : 1.f;
      if (kVec) {
#pragma unroll
        for (int m = 0; m < kLane; m += 4) {
          const int i = lane_elem<kVec>(lane, m);
          if (i < d) {
            const float4 x = ldcg4(src + i);
            acc[m] = fmaf(scale, x.x, acc[m]);
            acc[m + 1] = fmaf(scale, x.y, acc[m + 1]);
            acc[m + 2] = fmaf(scale, x.z, acc[m + 2]);
            acc[m + 3] = fmaf(scale, x.w, acc[m + 3]);
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < kLane; ++m)
          if (lane + 32 * m < d) acc[m] = fmaf(scale, __ldcg(src + lane + 32 * m), acc[m]);
      }
    }
  }
}

// Where the run whose first slot is e0 writes, and its base: a center's
// value as read (in-table, f32 scratch), or an out-table row, live if hot
// and as staged if cold.
template <typename T>
struct Target {
  T* dst;
  const T* base;        // out-table runs
  const float* base_f;  // in-table runs
};

template <typename T>
__device__ Target<T> target(const Params<T>& p, int64_t b, int e0) {
  const int cap = p.pc * p.cw, first_center = cap + p.pool, d = p.d;
  Target<T> t{nullptr, nullptr, nullptr};
  if (e0 >= first_center) {
    const int j = e0 - first_center;
    t.dst = p.in_table + int64_t(p.centers[b * p.pc + j]) * d;
    t.base_f = p.vs + int64_t(j) * d;
    return t;
  }
  const int32_t r = e0 < cap ? p.ctxs[b * cap + e0] : p.pool_rows[b * p.pool + (e0 - cap)];
  const int slot = int(b & 1);
  t.dst = p.out_table + int64_t(r) * d;
  t.base = r < p.hot_n ? t.dst
           : e0 < cap  ? p.stage_u + (int64_t(slot) * cap + e0) * d
                       : p.stage_q + (int64_t(slot) * p.pool + (e0 - cap)) * d;
  return t;
}

template <typename T>
__device__ __forceinline__ void write_elem(const Params<T>& p, const Target<T>& t, int i,
                                           float sum) {
  const float base = t.base_f ? __ldcg(t.base_f + i) : ldcg(t.base + i);
  st(t.dst + i, base - p.lr * sum);
}

// Elements i .. i + 3 at once (kVec).
template <typename T>
__device__ __forceinline__ void write_elem4(const Params<T>& p, const Target<T>& t, int i,
                                            float4 sum) {
  const float4 base = t.base_f ? ldcg4(t.base_f + i) : ldcg4(t.base + i);
  st4(t.dst + i, make_float4(base.x - p.lr * sum.x, base.y - p.lr * sum.y,
                             base.z - p.lr * sum.z, base.w - p.lr * sum.w));
}

// W(b): long runs one a CTA, short runs one a warp.
template <int kLane, bool kVec, typename T>
__device__ void write_block(const Params<T>& p, int64_t b, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = p.d;
  const int kent = p.pc * p.cw + p.pool + p.pc;
  const int32_t* ent = p.ent + b * kent;
  const int32_t* rs = p.run_start + b * (kent + 1);
  const int32_t* longs = p.long_runs + b * kent;
  const int nl = p.n_long[b], nr = p.n_runs[b];
  for (int l = blockIdx.x; l < nl; l += gridDim.x) {  // the same for the whole CTA
    const int run = longs[l];
    const int start = rs[run], end = rs[run + 1];
    const int piece = (end - start + kWarps - 1) / kWarps;
    const int s0 = min(start + warp * piece, end), s1 = min(s0 + piece, end);
    float acc[kLane];
#pragma unroll
    for (int m = 0; m < kLane; ++m) acc[m] = 0.f;
    accumulate<kLane, kVec>(p, ent, s0, s1, acc);
#pragma unroll
    for (int m = 0; m < kLane; ++m) {
      const int i = lane_elem<kVec>(lane, m);
      if (i < d) smem[warp * d + i] = acc[m];
    }
    __syncthreads();
    const Target<T> t = target(p, b, ent[start]);
    for (int i = threadIdx.x; i < d; i += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += smem[w * d + i];
      write_elem(p, t, i, s);
    }
    __syncthreads();
  }
  const int nw = gridDim.x * kWarps;
  for (int run = (gridDim.x - 1 - blockIdx.x) * kWarps + warp; run < nr; run += nw) {
    const int start = rs[run], end = rs[run + 1];
    if (end - start > p.chunk) continue;  // a long run: its CTA writes it
    float acc[kLane];
#pragma unroll
    for (int m = 0; m < kLane; ++m) acc[m] = 0.f;
    accumulate<kLane, kVec>(p, ent, start, end, acc);
    const Target<T> t = target(p, b, ent[start]);
    if (kVec) {
#pragma unroll
      for (int m = 0; m < kLane; m += 4) {
        const int i = lane_elem<kVec>(lane, m);
        if (i < d) write_elem4(p, t, i, make_float4(acc[m], acc[m + 1], acc[m + 2], acc[m + 3]));
      }
    } else {
#pragma unroll
      for (int m = 0; m < kLane; ++m)
        if (lane + 32 * m < d) write_elem(p, t, lane + 32 * m, acc[m]);
    }
  }
}

// kLane: row elements a lane sums in W, 8 for rows up to 256 elements (two
// CTAs an SM fit the registers), 16 up to 512. kVec: rows of a multiple of
// 16 bytes at 16-byte aligned tables, moved in 16-byte words.
template <typename T, int kLane, bool kVec>
__global__ void __launch_bounds__(kThreads, kLane <= 8 ? 2 : 1)
merged_sgns_kernel(const Params<T> p) {
  extern __shared__ float smem[];
  unsigned k = 0;
  float loss = 0.f;
  stage_block<kVec>(p, 0);
  grid_barrier(p, ++k, kStaged);
  for (int64_t b = 0; b < p.nblocks; ++b) {
    compute_block<kVec>(p, b, smem, loss);
    grid_barrier(p, ++k, kComputed);
    dq_block(p, smem);
    grid_barrier(p, ++k, kReduced);
    write_block<kLane, kVec>(p, b, smem);
    if (b + 1 < p.nblocks) grid_barrier(p, ++k, kWritten);
  }
  if (threadIdx.x == 0) p.loss_parts[blockIdx.x] = loss;
}

template <typename T, int kLane, bool kVec>
cudaError_t resident(size_t smem, int* per_sm) {
  auto kernel = merged_sgns_kernel<T, kLane, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// CTAs an SM holds of both forms (words and elements), so that either can
// take the grid.
template <typename T, int kLane>
cudaError_t plan_grid(size_t smem, int device, int* grid) {
  int vec = 0, elems = 0, sms = 0;
  cudaError_t err = resident<T, kLane, true>(smem, &vec);
  if (err == cudaSuccess) err = resident<T, kLane, false>(smem, &elems);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = (vec < elems ? vec : elems) * sms;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T, int kLane, bool kVec>
cudaError_t launch(const Params<T>& p, int grid, size_t smem, cudaStream_t s) {
  // the limit is the kernel's, not the shape's: another shape may have set it
  cudaError_t err = allow_smem(merged_sgns_kernel<T, kLane, kVec>, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<Params<T>*>(&p)};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(merged_sgns_kernel<T, kLane, kVec>), dim3(grid),
      dim3(kThreads), args, smem, s);
}

// The grid and shared memory of these shapes: 0 CTAs (cudaSuccess) where a
// center's rows and the pool do not fit in shared memory or rows are wider
// than 512 elements.
cudaError_t grid_for(int cw, int pool, int d, int elem_bytes, int device, int* grid,
                     size_t* smem) {
  *grid = 0;
  *smem = cw > 0 && pool > 0 ? plan_smem(cw, pool, d) : 0;
  if (*smem == 0) return cudaSuccess;
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  const bool narrow = d <= 256;
  if (elem_bytes == 4)
    return narrow ? plan_grid<float, 8>(*smem, device, grid)
                  : plan_grid<float, 16>(*smem, device, grid);
  return narrow ? plan_grid<__nv_bfloat16, 8>(*smem, device, grid)
                : plan_grid<__nv_bfloat16, 16>(*smem, device, grid);
}

struct Args {
  void *in_table, *out_table;
  const void *centers, *ctxs, *pool_rows, *ent, *run_start, *n_runs, *long_runs, *n_long;
  void *workspace, *state;
  int grid;
  long long nblocks;
  int pc, cw, pool;
  long long capacity;
  int d, hot_n, chunk;
  float lr, lam, inv_b;
  int miss;
};

template <typename T>
cudaError_t run(const Args& a, int* status, size_t smem, cudaStream_t s) {
  Params<T> p{};
  char* at = static_cast<char*>(a.workspace);
  auto take = [&](size_t n) {
    char* out = at;
    at += aligned(n);
    return out;
  };
  const size_t pc = a.pc, cw = a.cw, pool = a.pool, d = a.d;
  p.stage_v = reinterpret_cast<T*>(take(2 * pc * d * sizeof(T)));
  p.stage_u = reinterpret_cast<T*>(take(2 * pc * cw * d * sizeof(T)));
  p.stage_q = reinterpret_cast<T*>(take(2 * pool * d * sizeof(T)));
  p.vs = reinterpret_cast<float*>(take(sizeof(float) * pc * d));
  p.dvs = reinterpret_cast<float*>(take(sizeof(float) * pc * d));
  p.gpos = reinterpret_cast<float*>(take(sizeof(float) * pc * cw));
  p.gneg = reinterpret_cast<float*>(take(sizeof(float) * pc * pool));
  p.dq = reinterpret_cast<float*>(take(sizeof(float) * pool * d));
  p.in_table = static_cast<T*>(a.in_table);
  p.out_table = static_cast<T*>(a.out_table);
  p.centers = static_cast<const int32_t*>(a.centers);
  p.ctxs = static_cast<const int32_t*>(a.ctxs);
  p.pool_rows = static_cast<const int32_t*>(a.pool_rows);
  p.ent = static_cast<const int32_t*>(a.ent);
  p.run_start = static_cast<const int32_t*>(a.run_start);
  p.n_runs = static_cast<const int32_t*>(a.n_runs);
  p.long_runs = static_cast<const int32_t*>(a.long_runs);
  p.n_long = static_cast<const int32_t*>(a.n_long);
  p.loss_parts = static_cast<float*>(a.state);
  p.bar = reinterpret_cast<unsigned*>(static_cast<float*>(a.state) + a.grid);
  p.status = status;
  p.nblocks = a.nblocks;
  p.capacity = a.capacity;
  p.pc = a.pc;
  p.cw = a.cw;
  p.pool = a.pool;
  p.d = a.d;
  p.hot_n = a.hot_n;
  p.chunk = a.chunk;
  p.lr = a.lr;
  p.lam = a.lam;
  p.inv_b = a.inv_b;
  p.miss = a.miss;
  const bool vec = (size_t(a.d) * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.in_table) |
                    reinterpret_cast<uintptr_t>(a.out_table)) % 16 == 0;
  if (a.d <= 256)
    return vec ? launch<T, 8, true>(p, a.grid, smem, s) : launch<T, 8, false>(p, a.grid, smem, s);
  return vec ? launch<T, 16, true>(p, a.grid, smem, s) : launch<T, 16, false>(p, a.grid, smem, s);
}

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

}  // namespace

extern "C" {

// CTAs of the persistent grid for these shapes on this card (all resident
// at once); 0 where a center's rows and the pool do not fit in shared
// memory or rows are wider than 512 elements; minus a CUDA error code where
// the card could not be asked.
int ssn_fused_sgns_merged_grid(int cw, int pool, int row_elems, int elem_bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  int grid = 0;
  size_t smem = 0;
  if (err == cudaSuccess) err = grid_for(cw, pool, row_elems, elem_bytes, device, &grid, &smem);
  return err == cudaSuccess ? grid : -int(err);
}

// Bytes of the workspace ssn_fused_sgns_merged_step needs.
long long ssn_fused_sgns_merged_workspace(int pc, int cw, int pool, int row_elems,
                                          int elem_bytes) {
  return (long long)workspace_bytes(pc, cw, pool, row_elems, size_t(elem_bytes));
}

// centers [nblocks * pc], ctxs [nblocks * pc, cw] (-1 = pad), pool_rows
// [nblocks * pool]; ent [nblocks, K], run_start [nblocks, K + 1], n_runs
// [nblocks], long_runs [nblocks, K], n_long [nblocks] with K = pc * cw +
// pool + pc (ops/fused_sgns.py merge_runs; long_runs lists the runs longer
// than `chunk` slots); workspace of ssn_fused_sgns_merged_workspace bytes;
// state: zeros, `grid` f32 loss partials then the barrier counter, with
// grid from ssn_fused_sgns_merged_grid (called first for these shapes on
// this device). elem_bytes: 4 for f32 tables, 2
// for bf16. miss: a barrier that CTA 0 skips (-1: none), which then traps
// at its deadline.
int ssn_fused_sgns_merged_step(void* in_table, void* out_table, const void* centers,
                               const void* ctxs, const void* pool_rows, const void* ent,
                               const void* run_start, const void* n_runs,
                               const void* long_runs, const void* n_long, void* workspace,
                               void* state, int grid, long long nblocks, int pc, int cw,
                               int pool, long long capacity, int row_elems, int elem_bytes,
                               int hot_n, int chunk, float lr, float lam, float inv_b,
                               int miss, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  // ssn_fused_sgns_merged_grid planned the grid; a grid larger than the
  // card holds is refused by the launch
  const size_t smem = cw > 0 && pool > 0 ? plan_smem(cw, pool, row_elems) : 0;
  if (pc <= 0 || chunk <= 0 || grid <= 0 || smem == 0 || (elem_bytes != 4 && elem_bytes != 2))
    return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  int* status;
  if ((err = status_word(&status)) != cudaSuccess) return int(err);
  const Args a{in_table, out_table, centers, ctxs, pool_rows, ent, run_start, n_runs,
               long_runs, n_long, workspace, state, grid, nblocks, pc, cw, pool, capacity,
               row_elems, hot_n, chunk, lr, lam, inv_b, miss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(elem_bytes == 4 ? run<float>(a, status, smem, s)
                             : run<__nv_bfloat16>(a, status, smem, s));
}

// The code of the barrier that passed its deadline in the last launch (0:
// none). Host memory: readable after the trap has ended the context.
int ssn_fused_sgns_merged_status() {
  return g_status_host ? *reinterpret_cast<volatile int*>(g_status_host) : 0;
}

const char* ssn_fused_sgns_merged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
