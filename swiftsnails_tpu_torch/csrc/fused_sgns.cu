// Fused SGNS substeps on Hopper: gather -> pooled-SGNS gradient -> SGD write,
// one kernel per substep, with no merge and no sort of the gradients.
//
//   ssn_fused_sgns_step          the flat form: blocks of P pairs share PN
//                                pooled negatives.
//       Replaces the TPU kernel fused_sgns_step / _kernel in the JAX
//       package's ops/fused_sgns.py.
//   ssn_fused_sgns_grouped_step  the center-major form: blocks of PC centers,
//                                each with CW = 2 * window context slots
//                                (-1 = pad), sharing PN pooled negatives.
//       Replaces fused_sgns_grouped_step / _grouped_kernel in the same file.
//
// Semantics (the Python wrapper's docstring has them in full). Within one
// kernel block the reads are a snapshot and the last slot wins: centers (V)
// are written to the in-table, contexts (U) and the pool to the out-table,
// each row once, by the slot that the last-occurrence flags computed before
// the launch mark (the grouped form ranks context slots in c-major order,
// k = c * PC + p), and a pool write wins over a context write of the same
// row in its block. Across kernel blocks the card is hogwild: blocks run
// concurrently, as the reference's asynchronous SGD workers do. A center or
// context write applies its block's step to the row as it stands when
// written (read again, ld.global.cg, just before the store), so the steps of
// blocks that share the row add up, as pushes to the reference's parameter
// server do, unless two writes of it race. A pool write stores the block's
// snapshot of the row less its pool step, which sums the gradients of all
// the block's pairs: added to the steps of every other block that shares
// the row, those stale sums overshoot (PERF.md, Findings). On inputs whose rows
// are disjoint between blocks the result is deterministic: no atomics, and
// every sum runs in a fixed order.
//
// What bounds them. At the main path's shapes (f32, rows of 256 lanes, PN
// 64, 32 kernel blocks) the arithmetic is the pair x pool products, ~6 *
// pairs * PN * 256 flops, against ~1 KB moved per distinct row: ~1.6 GFLOP
// against ~35 MB for the flat step, ~0.9 GFLOP for the grouped one, so the
// floor is the f32 rate without tensor cores (67 TFLOP/s on an H100 SXM),
// not the 3.35 TB/s of HBM. In practice (the phase clocks below, PERF.md)
// the flat kernel spends most of a CTA's time in the products, bound by
// shared-memory wavefronts (an LDS.128 costs a warp 4 of them, broadcast or
// not), and the grouped kernel most in moving context rows: its ring of
// them from the tables, their steps to scratch, and scratch and the rows
// again to the tables.
//
// Design: one thread-block cluster of K CTAs per kernel block, the clusters
// hogwild between each other. A CTA's time goes as its rounds of tiles,
// ceil(tiles / K), and the launch's as its waves of clusters, ceil(nblocks /
// the clusters of K the card holds at once, cudaOccupancyMaxActiveClusters):
// K in 1..8 minimises rounds x waves, the smaller K on a tie. A cluster
// lives in one GPC, and at one CTA an SM (the shared memory of a CTA) an
// H100 SXM holds 66 clusters of 2, 39 of 3 and 30 of 4 (120 of its 132 SMs):
// 32 kernel blocks of 16 or 8 tiles take K = 3, 96 CTAs in one wave, where
// K = 4 would take two. The tile is then the smallest that keeps those
// rounds, so that every CTA has a tile in every round (512 pairs or 256
// centers: tiles of 29).
//   * The block's tiles (pairs, or centers) are dealt round-robin: tile T
//     to CTA T mod K, in rounds of K tiles. In each round every CTA reads
//     its tile's rows into shared memory and computes, then the cluster
//     syncs (barrier.cluster arrive.release / wait.acquire), then every CTA
//     writes its tile's flagged rows. A row written in round r has its last
//     slot there, so no later round reads it, and every read of it in round
//     r came before the barrier: one barrier a round keeps the snapshot.
//     Each CTA loads the pool rows before its first barrier, so no write
//     of the block can come before a pool read.
//   * A center or context write is the row as it stands less the step: a
//     tile keeps in shared memory the step's direction (dV for a center,
//     the center row for a flat context) and writes row - lr * dV (or
//     - lr g_pos v), reading the row again at the write (see Semantics).
//   * Flat: V and U rows of a tile are written after the round's barrier.
//     Grouped: center rows the same way; context rows are deferred (the
//     last-write order is c-major, across tiles): each flagged slot writes
//     its step (f32) to a scratch buffer, and after the pool's writes the
//     cluster's warps apply the flagged steps to the table (flagged rows are
//     distinct: no two CTAs write one row). A slot whose row is one of the
//     block's pool rows is not written, so the pool's write wins, and the
//     steps other blocks make to such a row land after it, mostly, where
//     the pool's snapshot write would otherwise discard them.
//   * dQ: each CTA sums g_neg^T V over its own tiles in tile order, in
//     registers (an 8 pool rows x 4 lanes micro-tile a thread) where they
//     hold it, else in shared memory. After a cluster barrier CTA k sums the
//     pool rows [k * PN / K, (k + 1) * PN / K) over the K partials in rank
//     order through distributed shared memory and writes the flagged ones
//     (the snapshot less lr dQ): in the flat form behind every context
//     write of the block. The loss: one partial a CTA, added in rank order
//     by CTA 0 into the block's partial.
//   * Rows reach shared memory a warp 4 rows at a time in 16-byte words
//     (elements for rows that are not whole words), every word loaded
//     before any is stored, widened to f32.
//   * The products are register-tiled from shared memory: scores V Q^T a
//     thread 4 pairs x 4 pool rows over float4 steps of the row (rows padded
//     to an odd count of float4, so the 8 pool rows a quarter-warp reads at
//     once sit in distinct banks); dV = G Q a thread 4 pairs x 4 lanes; dQ a
//     thread 8 pool rows x 4 lanes. The positive terms (one dot a pair or
//     context slot) are one warp a dot with a fixed butterfly sum; the
//     grouped form streams a tile's context rows through a ring that the
//     CTA's warps fill in one pass. The rows a tile writes (flag and id)
//     are read into shared memory with its rows, and the deferred copy
//     moves 4 rows a warp at a time, so no write waits on a flag's load.
// Tensor cores (a 3xTF32 split keeps the f32 gate) are later work.
//
// Coherence. Table rows and scratch rows may be written by other CTAs of
// the launch, so they are read with ld.global.cg (L2, never a stale L1 line
// or the non-coherent path); row ids and flags are not written in the
// launch. The cluster barriers' release/acquire order a row's scratch step
// before its copy, every read of the block before its writes, and, flat,
// two writes of one row by different CTAs of a cluster (a context slot's,
// then the pool's).
//
// Compute is f32 with one rounding on write (__float2bfloat16_rn for bf16),
// as in the TPU kernels. Row ids outside [0, C) are never dereferenced: such
// a center, context or pool row reads as zeros and is never written, and a
// grouped context slot outside [0, C) (the -1 pads) is masked out of the
// arithmetic altogether.
//
// Bound by a plain C interface, loaded with ctypes. Each entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns the launch's error (0 on success; a cluster
// launch the card refuses returns its error, with no fallback), or
// cudaErrorInvalidValue, launching nothing, for shapes whose tile does not
// fit in shared memory (ssn_fused_sgns_tile says so beforehand).

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster_launch.cuh"
#include "sgns_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;    // pairs (flat) or centers (grouped) a tile
constexpr int kDqRows = 8;      // pool rows of a thread's dQ micro-tile (x 4 lanes)
constexpr int kRowsInFlight = 4;  // rows a warp loads before it stores any
constexpr int kRingRows = 32;   // grouped: the context rows a tile wants in its ring,
constexpr int kRingMax = kWarps * kRowsInFlight;  // and the most: one pass of the CTA's warps
// Dynamic shared memory a block may use on Hopper (227 KB), less the static
// loss partials.
constexpr size_t kMaxDynamicSmem = 232448 - 128;

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The shared-memory plan of one shape; offsets and sizes in floats.
struct Shape {
  int tile;     // pairs (flat) or centers (grouped) a tile
  int ring;     // grouped: context rows a ring fill
  int ds;       // row stride of Q and V (a multiple of 4)
  int d4;       // float4 a row (rows padded with zeros to 4 * d4)
  int pnp;      // the pool rounded up to kDqRows: the row stride of S / G
  int tpp;      // the row stride of G^T: the tile rounded up to an odd count of 4
               // (G^T is written a pool row a lane: 4-way bank conflicts, not 32)
  int dq_smem;  // 1: the dQ partial lives in shared memory, else in registers
  int v, u, dv, s, gt, g1, nr, x, wr, pid, dqp;  // offsets: see layout()
  size_t bytes;
};

// Q [pool, ds] | V [tile, ds] | flat: U [tile, 4 d4]; grouped: D [tile, 4 d4]
// (dV), ring [ring, 4 d4] | S / G [tile, pnp] | G^T [pool, tpp] | g1: flat
// pos scores / g_pos [tpp], grouped g_pos [tile * cw] | grouped n_real [tpp],
// context ids [tile * cw] | the rows the tile writes (the row id where its
// slot is flagged and in range, else -1): flat V [tpp] and U [tpp], grouped
// centers [tpp] and context slots [tile * cw] | grouped: the pool's row ids
// [pool] | dQ partial [pool, 4 d4], after the round loop over V.. where it
// is in registers, else a region of its own.
bool layout(bool grouped, int cw, int pool, int d, int tile, int ring, int ds,
            Shape* s) {
  const int d4 = (d + 3) / 4, w = 4 * d4;
  s->tile = tile;
  s->ring = ring;
  s->ds = ds;
  s->d4 = d4;
  s->pnp = round_up(pool, kDqRows);
  s->tpp = round_up(tile, 4);
  if (s->tpp / 4 % 2 == 0) s->tpp += 4;
  s->dq_smem = (pool + kDqRows - 1) / kDqRows * d4 > kThreads;
  size_t o = size_t(pool) * ds;
  s->v = int(o);
  o += size_t(tile) * ds;
  if (grouped) {
    s->dv = int(o);
    o += size_t(tile) * w;
    s->u = int(o);
    o += size_t(ring) * w;
  } else {
    s->u = int(o);
    o += size_t(tile) * w;
    s->dv = 0;
  }
  const size_t dq = size_t(pool) * w;
  if (!s->dq_smem && o < s->v + dq) o = s->v + dq;
  s->s = int(o);
  o += size_t(tile) * s->pnp;
  s->gt = int(o);
  o += size_t(pool) * s->tpp;
  s->g1 = int(o);
  o += round_up(grouped ? tile * cw : s->tpp, 4);
  s->nr = int(o);
  o += grouped ? s->tpp : 0;
  s->x = int(o);
  o += grouped ? round_up(tile * cw, 4) : 0;
  s->wr = int(o);
  o += grouped ? s->tpp + round_up(tile * cw, 4) : 2 * s->tpp;
  s->pid = int(o);
  o += grouped ? round_up(pool, 4) : 0;
  s->dqp = s->v;
  if (s->dq_smem) {
    s->dqp = int(o);
    o += dq;
  }
  s->bytes = o * sizeof(float);
  return s->bytes <= kMaxDynamicSmem && o < (size_t(1) << 31);
}

// The largest tile up to max_tile that fits (grouped: with a ring of
// kRingRows context rows, or of the tile's rows if fewer; else any ring;
// then the largest ring up to kRingMax, which the CTA's warps fill in one
// pass), rows padded to an odd count of float4 where that fits too. False
// where a tile of one does not.
bool plan(bool grouped, int cw, int pool, int d, Shape* s, int max_tile = kMaxTile) {
  if (pool <= 0 || d <= 0 || (grouped && cw <= 0)) return false;
  const int d4 = (d + 3) / 4;
  const int strides[2] = {4 * (d4 | 1), 4 * d4};
  for (int pass = 0; pass < 2; ++pass)
    for (int tile = max_tile; tile >= 1; --tile)
      for (int ds : strides) {
        if (!grouped) {
          if (layout(false, 0, pool, d, tile, 0, ds, s)) return true;
          continue;
        }
        const int want = pass == 0 ? (tile * cw < kRingRows ? tile * cw : kRingRows) : 1;
        if (!layout(true, cw, pool, d, tile, want, ds, s)) continue;
        int ring = want;  // then the largest ring that fits, up to the tile's rows
        while (ring < tile * cw && ring < kRingMax &&
               layout(true, cw, pool, d, tile, ring + 1, ds, s))
          ++ring;
        return layout(true, cw, pool, d, tile, ring, ds, s);
      }
  return false;
}

// ------------------------------------------------------------ helpers ---

// Elements 4 * i4 .. 4 * i4 + 3 of a row (those below d), one rounding each:
// one 16-byte (f32) or 8-byte (bf16) store where rows are whole words.
__device__ __forceinline__ void put4(float* row, int i4, float4 v, int d, bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(row)[i4] = v;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
  for (int e = 0; e < 4 && 4 * i4 + e < d; ++e) row[4 * i4 + e] = x[e];
}
__device__ __forceinline__ void put4(__nv_bfloat16* row, int i4, float4 v, int d, bool vec) {
  if (vec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&a);
    w.y = *reinterpret_cast<const uint32_t*>(&b);
    reinterpret_cast<uint2*>(row)[i4] = w;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
  for (int e = 0; e < 4 && 4 * i4 + e < d; ++e) st(row + 4 * i4 + e, x[e]);
}

__device__ __forceinline__ void axpy(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float4 sub_scaled(float4 a, float s, float4 b) {  // a - s * b
  return make_float4(fmaf(-s, b.x, a.x), fmaf(-s, b.y, a.y), fmaf(-s, b.z, a.z),
                     fmaf(-s, b.w, a.w));
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ const float4* row4(const float* base, int r, int stride) {
  return reinterpret_cast<const float4*>(base + size_t(r) * stride);
}
__device__ __forceinline__ float4* row4(float* base, int r, int stride) {
  return reinterpret_cast<float4*>(base + size_t(r) * stride);
}

// Elements 4 * i4 .. 4 * i4 + 3 of a table row (zeros past d) in f32, read
// through L2 (another CTA may have written the row in the launch): one
// 16-byte (f32) or 8-byte (bf16) load where rows are whole words.
__device__ __forceinline__ float4 get4(const float* row, int i4, int d, bool vec) {
  if (vec) return __ldcg(reinterpret_cast<const float4*>(row) + i4);
  float x[4];
  for (int e = 0; e < 4; ++e) x[e] = 4 * i4 + e < d ? ldcg(row + 4 * i4 + e) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float4 get4(const __nv_bfloat16* row, int i4, int d, bool vec) {
  if (vec) {
    const uint2 w = __ldcg(reinterpret_cast<const uint2*>(row) + i4);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
  float x[4];
  for (int e = 0; e < 4; ++e) x[e] = 4 * i4 + e < d ? ldcg(row + 4 * i4 + e) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Whether row r is one of the block's pool rows (pid [pool], in shared
// memory): a vote of the warp, whose lanes all call it with the same r.
__device__ __forceinline__ bool in_pool(int32_t r, const int32_t* pid, int pool) {
  bool hit = false;
  for (int c = threadIdx.x & 31; c < pool; c += 32) hit |= pid[c] == r;
  return __any_sync(0xffffffffu, hit);
}

// The rows r < n that row(r, dst, src, s) names (dst nullptr: none) become
// dst - s * src, each element of dst read at the write (ld.global.cg) and
// rounded once; src holds 4 * ceil(d / 4) f32 in shared memory, or in
// global memory (kGlobalSrc, read ld.global.cg with the rows). Warp gw of
// nw takes rows kR at a time, its lanes over the row, and reads every
// word of them from global memory before it stores any. row() is called
// by every lane of the warp.
template <int kR, bool kGlobalSrc, typename T, typename Row>
__device__ void step_rows(int n, int gw, int nw, int d, bool vec, Row row) {
  constexpr int kW = 2;
  const int lane = threadIdx.x & 31, d4 = (d + 3) / 4;
  for (int r0 = gw * kR; r0 < n; r0 += nw * kR) {
    T* dst[kR];
    const float4* src[kR];
    float s[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      dst[u] = nullptr;
      src[u] = nullptr;
      s[u] = 0.f;
      if (r0 + u < n) {
        const float* f = nullptr;
        row(r0 + u, dst[u], f, s[u]);
        src[u] = reinterpret_cast<const float4*>(f);
      }
    }
    for (int i0 = lane; i0 < d4; i0 += 32 * kW) {
      float4 cur[kR][kW], x[kGlobalSrc ? kR : 1][kW];
#pragma unroll
      for (int u = 0; u < kR; ++u)
#pragma unroll
        for (int m = 0; m < kW; ++m) {
          const int i4 = i0 + 32 * m;
          if (dst[u] && i4 < d4) {
            cur[u][m] = get4(dst[u], i4, d, vec);
            if constexpr (kGlobalSrc) x[u][m] = __ldcg(src[u] + i4);
          }
        }
#pragma unroll
      for (int u = 0; u < kR; ++u)
#pragma unroll
        for (int m = 0; m < kW; ++m) {
          const int i4 = i0 + 32 * m;
          if (!dst[u] || i4 >= d4) continue;
          float4 step;
          if constexpr (kGlobalSrc)
            step = x[u][m];
          else
            step = src[u][i4];
          put4(dst[u], i4, sub_scaled(cur[u][m], s[u], step), d, vec);
        }
    }
  }
}

// Every thread of the cluster; orders the CTAs' global and shared writes
// before the barrier ahead of their reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Where a CTA's time goes, for a build with SSN_PHASE_CLOCKS defined
// (phase_clocks.py at the root of the repository builds one and reads it):
// thread 0 of each CTA adds the clock64 cycles since its last mark to the
// phase's total. Most marks follow a block barrier, so the phase counts the
// CTA's wall time in it; kDv's does not (the round's cluster barrier ends
// it), so it counts thread 0's own dV work, and the rest of the CTA's shows
// in kRoundBarrier. The marks add no barrier: the clocked build runs the
// schedule that is timed. Without the macro they compile to nothing.
enum Phase {
  kFill,          // the tile's rows into shared memory (and the pool, first)
  kScores,        // V Q^T, and the flat form's positive dots
  kGrad,          // the sigmoid terms: G, G^T, g_pos, the loss
  kPos,           // grouped: the context rows' ring fills, dots, D and scratch
  kDq,            // dQ += G^T V
  kDv,            // dV = G Q (+ g_pos U, or D), the steps in shared memory
  kRoundBarrier,  // the wait at the round's cluster barrier
  kWrite,         // the tile's flagged rows to the tables
  kFinish,        // the pool's reduction and writes, the deferred context steps
  kPhases
};

#ifdef SSN_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhases];

__device__ __forceinline__ long long phase_start() { return clock64(); }

__device__ __forceinline__ void phase_mark(long long& last, int phase) {
  if (threadIdx.x != 0) return;
  const long long now = clock64();
  atomicAdd(&g_phase_clocks[phase], static_cast<unsigned long long>(now - last));
  last = now;
}
#else
__device__ __forceinline__ long long phase_start() { return 0; }
__device__ __forceinline__ void phase_mark(long long&, int) {}
#endif

// Rows r < n into dst [n, stride] in f32, ids(r) giving each row's id (one
// outside [0, cap) reads zeros), padded with zeros to 4 * ceil(d / 4). A
// warp takes kR rows at a time and loads every word of them before it
// stores any: 16-byte words where rows are whole words (vec), else elements.
template <typename T, typename Ids>
__device__ void fill_rows(float* dst, int stride, const T* table, int n, Ids ids,
                          int64_t cap, int d, bool vec) {
  constexpr int kR = kRowsInFlight, kW = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp * kR; r0 < n; r0 += kWarps * kR) {
    const T* src[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int32_t id = r0 + u < n ? ids(r0 + u) : -1;
      src[u] = in_range(id, cap) ? table + int64_t(id) * d : nullptr;
    }
    if (vec) {
      constexpr int E = 16 / int(sizeof(T));
      const int words = d / E;
      for (int c0 = lane; c0 < words; c0 += 32 * kW) {
        uint4 w[kR][kW];
#pragma unroll
        for (int u = 0; u < kR; ++u)
#pragma unroll
          for (int m = 0; m < kW; ++m) {
            const int c = c0 + 32 * m;
            w[u][m] = src[u] && c < words ? __ldcg(reinterpret_cast<const uint4*>(src[u]) + c)
                                          : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int u = 0; u < kR; ++u)
#pragma unroll
          for (int m = 0; m < kW; ++m) {
            const int c = c0 + 32 * m;
            if (r0 + u < n && c < words)
              widen(dst + size_t(r0 + u) * stride + c * E, w[u][m], src[u]);
          }
      }
    } else {
      const int w4 = (d + 3) & ~3;
      for (int i0 = lane; i0 < w4; i0 += 32 * kW) {
        float x[kR][kW];
#pragma unroll
        for (int u = 0; u < kR; ++u)
#pragma unroll
          for (int m = 0; m < kW; ++m) {
            const int i = i0 + 32 * m;
            x[u][m] = src[u] && i < d ? ldcg(src[u] + i) : 0.f;
          }
#pragma unroll
        for (int u = 0; u < kR; ++u)
#pragma unroll
          for (int m = 0; m < kW; ++m) {
            const int i = i0 + 32 * m;
            if (r0 + u < n && i < w4) dst[size_t(r0 + u) * stride + i] = x[u][m];
          }
      }
    }
  }
}

// S[j][c] = V[j] . Q[c] for j < t, c < pool. A warp takes 16 pairs x 32
// pool rows, a lane 4 pairs x 4 pool rows (pairs 16 jb + 4 (lane / 8) + u,
// pool rows 32 cb + lane % 8 + 8 m), over the row in float4 steps: 8 loads
// for 64 FMAs. A quarter-warp reads one pair row (a broadcast) and 8
// consecutive pool rows, which a row stride of an odd count of float4 puts
// in distinct banks.
__device__ void scores(const float* V, const float* Q, float* S, int t, int pool,
                       const Shape& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncb = (pool + 31) / 32, items = (t + 15) / 16 * ncb;
  for (int it = warp; it < items; it += kWarps) {
    const int jb = it / ncb, cb = it - jb * ncb;
    const int j0 = 16 * jb + 4 * (lane >> 3), c0 = 32 * cb + (lane & 7);
    const float4* v[4];
    const float4* q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = row4(V, min(j0 + u, t - 1), sh.ds);
      q[u] = row4(Q, min(c0 + 8 * u, pool - 1), sh.ds);
    }
    float acc[4][4] = {};
    for (int k = 0; k < sh.d4; ++k) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = v[u][k];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 b = q[m][k];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u][m] = dot4(acc[u][m], a[u], b);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (j0 + u < t && c0 + 8 * m < pool) S[(j0 + u) * sh.pnp + c0 + 8 * m] = acc[u][m];
  }
}

// v[j] . x[j] for j < n, a warp a dot, lanes over float4 steps then a fixed
// butterfly sum; f(j, dot) on lane 0.
template <typename Rows, typename F>
__device__ void warp_dots(int n, int d4, Rows rows, F f) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    const float4* a;
    const float4* b;
    rows(j, a, b);
    float s = 0.f;
    for (int k = lane; k < d4; k += 32) s = dot4(s, a[k], b[k]);
    s = warp_sum(s);
    if (lane == 0) f(j, s);
  }
}

// acc (pool rows 8 cg .. 8 cg + 7, lanes 4 i4 .. 4 i4 + 3) += sum over j < t
// of G[j][c] V[j][i], in pair order.
__device__ __forceinline__ void dq_tile(float4 (&acc)[kDqRows], const float* V,
                                        const float* G, int t, int cg, int i4,
                                        const Shape& sh) {
#pragma unroll 2
  for (int j = 0; j < t; ++j) {
    const float4 v = row4(V, j, sh.ds)[i4];
    const float4* g = row4(G, j, sh.pnp) + 2 * cg;
    const float4 g0 = g[0], g1 = g[1];
    axpy(acc[0], g0.x, v);
    axpy(acc[1], g0.y, v);
    axpy(acc[2], g0.z, v);
    axpy(acc[3], g0.w, v);
    axpy(acc[4], g1.x, v);
    axpy(acc[5], g1.y, v);
    axpy(acc[6], g1.z, v);
    axpy(acc[7], g1.w, v);
  }
}

// The CTA's dQ partial += G^T V over this tile: in registers where one
// micro-tile a thread covers the pool (acc carries it across tiles), else
// in shared memory at dqp.
__device__ void dq_update(float4 (&acc)[kDqRows], float* smem, int t, int pool,
                          const Shape& sh) {
  const float* V = smem + sh.v;
  const float* G = smem + sh.s;
  const int items = (pool + kDqRows - 1) / kDqRows * sh.d4;
  if (!sh.dq_smem) {
    if (int(threadIdx.x) < items)
      dq_tile(acc, V, G, t, threadIdx.x / sh.d4, threadIdx.x % sh.d4, sh);
    return;
  }
  float* dq = smem + sh.dqp;
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int cg = w / sh.d4, i4 = w - cg * sh.d4;
#pragma unroll
    for (int m = 0; m < kDqRows; ++m) {
      const int c = kDqRows * cg + m;
      acc[m] = c < pool ? row4(dq, c, 4 * sh.d4)[i4] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    dq_tile(acc, V, G, t, cg, i4, sh);
#pragma unroll
    for (int m = 0; m < kDqRows; ++m) {
      const int c = kDqRows * cg + m;
      if (c < pool) row4(dq, c, 4 * sh.d4)[i4] = acc[m];
    }
  }
}

// a[u] += sum over c < pool of G^T[c][4 jb + u] Q[c][i4], in pool order: a
// thread of dV takes 4 pairs x 4 lanes.
__device__ __forceinline__ void neg_grad(float4 (&a)[4], const float* Q, const float* GT,
                                         int pool, int jb, int i4, const Shape& sh) {
#pragma unroll 4
  for (int c = 0; c < pool; ++c) {
    const float4 q = row4(Q, c, sh.ds)[i4];
    const float4 g = row4(GT, c, sh.tpp)[jb];
    axpy(a[0], g.x, q);
    axpy(a[1], g.y, q);
    axpy(a[2], g.z, q);
    axpy(a[3], g.w, q);
  }
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

// The pool's writes after the round loop. The CTA's dQ partial goes to
// shared memory (if it was in registers) and its loss to cta_loss; after a
// cluster barrier CTA k sums pool rows [k PN / K, (k + 1) PN / K)
// over the K partials in rank order and writes the flagged ones, each the
// snapshot less lr dQ; CTA 0 adds the K losses in rank order. A last
// barrier keeps every CTA's shared memory alive until the others have read
// it.
template <typename T>
__device__ void finish_pool(float4 (&acc)[kDqRows], float* smem, float loss,
                            T* out_table, const int32_t* pool_rows, const bool* q_last,
                            float* loss_part, int pool, int64_t cap, int d, float lr,
                            float inv_b, bool vec, const Shape& sh, long long& clk) {
  __shared__ float cta_loss;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), k_n = int(cluster.num_blocks());
  float* dqp = smem + sh.dqp;
  const int w4 = 4 * sh.d4;
  __syncthreads();  // the last tile's readers of V and U are done
  if (!sh.dq_smem) {
    const int items = (pool + kDqRows - 1) / kDqRows * sh.d4;
    if (int(threadIdx.x) < items) {
      const int cg = threadIdx.x / sh.d4, i4 = threadIdx.x % sh.d4;
#pragma unroll
      for (int m = 0; m < kDqRows; ++m)
        if (kDqRows * cg + m < pool) row4(dqp, kDqRows * cg + m, w4)[i4] = acc[m];
    }
  }
  const float s = block_sum(loss);
  if (threadIdx.x == 0) cta_loss = s;
  cluster_sync();
  const float* Q = smem;
  const int c0 = rank * pool / k_n, c1 = (rank + 1) * pool / k_n;
  for (int w = threadIdx.x; w < (c1 - c0) * sh.d4; w += kThreads) {
    const int c = c0 + w / sh.d4, i4 = w % sh.d4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < k_n; ++k) {
      const float4 x = row4(cluster.map_shared_rank(dqp, k), c, w4)[i4];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int32_t r = pool_rows[c];
    if (q_last[c] && in_range(r, cap))
      put4(out_table + int64_t(r) * d, i4, sub_scaled(row4(Q, c, sh.ds)[i4], lr, sum), d, vec);
  }
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int k = 0; k < k_n; ++k) total += *cluster.map_shared_rank(&cta_loss, k);
    *loss_part = -total * inv_b;
  }
  cluster_sync();
  phase_mark(clk, kFinish);
}

template <typename T>
struct Args {
  T* in_table;
  T* out_table;
  const int32_t* a_rows;     // flat: in_rows [nb * P]; grouped: centers [nb * PC]
  const int32_t* b_rows;     // flat: pos_rows [nb * P]; grouped: ctxs [nb * PC * CW]
  const int32_t* pool_rows;  // [nb * PN]
  const bool* a_last;        // v_last / c_last
  const bool* b_last;        // u_last / x_last
  const bool* q_last;        // [nb * PN]
  float* scratch;            // grouped: [nb * PC * CW] f32 steps of 4 * ceil(d / 4)
  float* loss_parts;         // [nb]
  int per_block;             // P or PC
  int cw, pool;
  int64_t capacity;
  int d;
  float lr, lam, inv_b;
  bool vec;  // rows of whole 16-byte words at 16-byte aligned tables
  Shape sh;
};

// --------------------------------------------------------------- flat ---

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_sgns_kernel(const Args<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Shape& sh = p.sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), k_n = int(cluster.num_blocks());
  const int64_t blk = blockIdx.x / k_n;
  const int pool = p.pool, d = p.d, tile = sh.tile, w4 = 4 * sh.d4;
  const int warp = threadIdx.x >> 5;
  const int64_t base = blk * p.per_block;
  const int32_t* my_pool = p.pool_rows + blk * pool;
  float* Q = smem;
  float* V = smem + sh.v;
  float* U = smem + sh.u;
  float* S = smem + sh.s;
  float* GT = smem + sh.gt;
  float* g1 = smem + sh.g1;
  int32_t* wv = reinterpret_cast<int32_t*>(smem + sh.wr);  // [tpp] V rows to write
  int32_t* wu = wv + sh.tpp;                                // [tpp] U rows to write
  long long clk = phase_start();

  fill_rows(Q, sh.ds, p.out_table, pool, [&](int r) { return my_pool[r]; }, p.capacity, d,
            p.vec);
  float4 acc[kDqRows];
#pragma unroll
  for (int m = 0; m < kDqRows; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sh.dq_smem)
    for (int e = threadIdx.x; e < pool * w4; e += kThreads) smem[sh.dqp + e] = 0.f;
  float loss = 0.f;

  const int ntiles = (p.per_block + tile - 1) / tile;
  const int rounds = (ntiles + k_n - 1) / k_n;
  for (int round = 0; round < rounds; ++round) {
    const int tix = round * k_n + rank;
    const int j0 = tix * tile;
    const int t = tix < ntiles ? min(tile, p.per_block - j0) : 0;
    const int32_t* vr = p.a_rows + base + j0;
    const int32_t* ur = p.b_rows + base + j0;
    if (t > 0) {
      for (int j = threadIdx.x; j < t; j += kThreads) {
        const int32_t a = vr[j], b = ur[j];
        wv[j] = p.a_last[base + j0 + j] && in_range(a, p.capacity) ? a : -1;
        wu[j] = p.b_last[base + j0 + j] && in_range(b, p.capacity) ? b : -1;
      }
      fill_rows(V, sh.ds, p.in_table, t, [&](int r) { return vr[r]; }, p.capacity, d, p.vec);
      fill_rows(U, w4, p.out_table, t, [&](int r) { return ur[r]; }, p.capacity, d, p.vec);
      __syncthreads();  // Q too, on the first round
      phase_mark(clk, kFill);
      scores(V, Q, S, t, pool, sh);
      warp_dots(t, sh.d4,
                [&](int j, const float4*& a, const float4*& b) {
                  a = row4(V, j, sh.ds);
                  b = row4(U, j, w4);
                },
                [&](int j, float x) { g1[j] = x; });
      __syncthreads();
      phase_mark(clk, kScores);
      for (int k = threadIdx.x; k < t * sh.pnp; k += kThreads) {
        const int j = k / sh.pnp, c = k - j * sh.pnp;
        float g = 0.f;
        if (c < pool) {
          const float x = S[k];
          loss += p.lam * log_sigmoid(-x);
          g = p.lam * p.inv_b * sigmoid(x);
          GT[c * sh.tpp + j] = g;
        }
        S[k] = g;
      }
      for (int j = threadIdx.x; j < t; j += kThreads) {
        const float x = g1[j];
        loss += log_sigmoid(x);
        g1[j] = (sigmoid(x) - 1.f) * p.inv_b;
      }
      __syncthreads();
      phase_mark(clk, kGrad);
      dq_update(acc, smem, t, pool, sh);
      __syncthreads();  // dQ has read V
      phase_mark(clk, kDq);
      // dV = g_pos U + G Q; V becomes dV and U the center row (the context
      // row's step is lr g_pos V), in place: each thread reads and writes
      // only its own elements of them
      for (int w = threadIdx.x; w < (t + 3) / 4 * sh.d4; w += kThreads) {
        const int jb = w / sh.d4, i4 = w - jb * sh.d4;
        float4 a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = min(4 * jb + u, t - 1);
          const float4 x = row4(U, j, w4)[i4];
          const float g = g1[j];
          a[u] = make_float4(g * x.x, g * x.y, g * x.z, g * x.w);
        }
        neg_grad(a, Q, GT, pool, jb, i4, sh);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * jb + u;
          if (j >= t) break;
          row4(U, j, w4)[i4] = row4(V, j, sh.ds)[i4];
          row4(V, j, sh.ds)[i4] = a[u];
        }
      }
      phase_mark(clk, kDv);
    }
    cluster_sync();  // every CTA's reads of this round come before any write of it
    phase_mark(clk, kRoundBarrier);
    if (t > 0) {
      step_rows<2, false, T>(  // 2 rows a warp: the dQ partial holds registers
          2 * t, warp, kWarps, d, p.vec,
          [&](int r, T*& dst, const float*& src, float& s) {
            const bool is_v = r < t;
            const int j = is_v ? r : r - t;
            const int32_t id = is_v ? wv[j] : wu[j];
            if (id < 0) return;
            dst = (is_v ? p.in_table : p.out_table) + int64_t(id) * d;
            src = is_v ? V + size_t(j) * sh.ds : U + size_t(j) * w4;
            s = is_v ? p.lr : p.lr * g1[j];
          });
      __syncthreads();  // the next tile refills V and U
      phase_mark(clk, kWrite);
    }
  }
  finish_pool(acc, smem, loss, p.out_table, my_pool, p.q_last + blk * pool,
              p.loss_parts + blk, pool, p.capacity, d, p.lr, p.inv_b, p.vec, sh, clk);
}

// ------------------------------------------------------------ grouped ---

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_sgns_grouped_kernel(const Args<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Shape& sh = p.sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), k_n = int(cluster.num_blocks());
  const int64_t blk = blockIdx.x / k_n;
  const int pool = p.pool, d = p.d, tile = sh.tile, cw = p.cw, w4 = 4 * sh.d4;
  const int pc = p.per_block;
  const int64_t cbase = blk * pc;  // first center of the block
  const int32_t* my_pool = p.pool_rows + blk * pool;
  float* Q = smem;
  float* V = smem + sh.v;
  float* D = smem + sh.dv;
  float* ring = smem + sh.u;
  float* S = smem + sh.s;
  float* GT = smem + sh.gt;
  float* gp = smem + sh.g1;   // [tile * cw] g_pos of each context slot
  float* n_real = smem + sh.nr;
  int32_t* xrow = reinterpret_cast<int32_t*>(smem + sh.x);  // [tile * cw]
  int32_t* wc = reinterpret_cast<int32_t*>(smem + sh.wr);   // [tpp] center rows to write
  int32_t* wx = wc + sh.tpp;                                // [tile * cw] context rows
  long long clk = phase_start();

  fill_rows(Q, sh.ds, p.out_table, pool, [&](int r) { return my_pool[r]; }, p.capacity, d,
            p.vec);
  int32_t* pid = reinterpret_cast<int32_t*>(smem + sh.pid);  // the pool's row ids
  for (int c = threadIdx.x; c < pool; c += kThreads) pid[c] = my_pool[c];
  float4 acc[kDqRows];
#pragma unroll
  for (int m = 0; m < kDqRows; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sh.dq_smem)
    for (int e = threadIdx.x; e < pool * w4; e += kThreads) smem[sh.dqp + e] = 0.f;
  float loss = 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int ntiles = (pc + tile - 1) / tile;
  const int rounds = (ntiles + k_n - 1) / k_n;
  for (int round = 0; round < rounds; ++round) {
    const int tix = round * k_n + rank;
    const int j0 = tix * tile;
    const int t = tix < ntiles ? min(tile, pc - j0) : 0;
    const int32_t* cr = p.a_rows + cbase + j0;
    const int64_t slot0 = (cbase + j0) * cw;  // first context slot of the tile
    if (t > 0) {
      for (int s = threadIdx.x; s < t * cw; s += kThreads) {
        const int32_t r = p.b_rows[slot0 + s];
        xrow[s] = r;
        wx[s] = p.b_last[slot0 + s] && in_range(r, p.capacity) ? r : -1;
      }
      for (int j = threadIdx.x; j < t; j += kThreads) {
        const int32_t r = cr[j];
        wc[j] = p.a_last[cbase + j0 + j] && in_range(r, p.capacity) ? r : -1;
      }
      fill_rows(V, sh.ds, p.in_table, t, [&](int r) { return cr[r]; }, p.capacity, d, p.vec);
      __syncthreads();
      // a context slot whose row is one of the block's pool rows is not
      // written: the pool's write wins (read at the scratch writes, after
      // later barriers)
      for (int s = warp; s < t * cw; s += kWarps) {
        const int32_t r = wx[s];
        const bool drop = r >= 0 && in_pool(r, pid, pool);
        if (drop && lane == 0) wx[s] = -1;
      }
      phase_mark(clk, kFill);
      for (int j = threadIdx.x; j < t; j += kThreads) {
        float n = 0.f;
        for (int c = 0; c < cw; ++c) n += in_range(xrow[j * cw + c], p.capacity);
        n_real[j] = n;
      }
      scores(V, Q, S, t, pool, sh);
      __syncthreads();
      phase_mark(clk, kScores);
      for (int k = threadIdx.x; k < t * sh.pnp; k += kThreads) {
        const int j = k / sh.pnp, c = k - j * sh.pnp;
        float g = 0.f;
        if (c < pool) {
          const float x = S[k];
          loss += p.lam * log_sigmoid(-x) * n_real[j];
          g = p.lam * p.inv_b * sigmoid(x) * n_real[j];
          GT[c * sh.tpp + j] = g;
        }
        S[k] = g;
      }
      __syncthreads();
      phase_mark(clk, kGrad);
      // The positive terms, the tile's context slots s = j * cw + c a ring
      // fill at a time: g_pos, D[j] = sum over c of g_pos U (slot order,
      // carried across fills), and each flagged slot's step lr g_pos V[j]
      // to scratch.
      for (int s0 = 0; s0 < t * cw; s0 += sh.ring) {
        const int n = min(sh.ring, t * cw - s0);
        fill_rows(ring, w4, p.out_table, n, [&](int r) { return xrow[s0 + r]; }, p.capacity,
                  d, p.vec);  // pads are never read: they fill zeros
        __syncthreads();
        warp_dots(n, sh.d4,
                  [&](int r, const float4*& a, const float4*& b) {
                    a = row4(V, (s0 + r) / cw, sh.ds);
                    b = row4(ring, r, w4);
                  },
                  [&](int r, float x) {
                    const bool real = in_range(xrow[s0 + r], p.capacity);
                    if (real) loss += log_sigmoid(x);
                    gp[s0 + r] = real ? (sigmoid(x) - 1.f) * p.inv_b : 0.f;
                  });
        __syncthreads();
        const int jf = s0 / cw, jl = (s0 + n - 1) / cw;  // centers this fill touches
        for (int w = threadIdx.x; w < (jl - jf + 1) * sh.d4; w += kThreads) {
          const int j = jf + w / sh.d4, i4 = w % sh.d4;
          const int sa = max(j * cw, s0), sb = min((j + 1) * cw, s0 + n);
          float4 a = sa == j * cw ? make_float4(0.f, 0.f, 0.f, 0.f) : row4(D, j, w4)[i4];
          for (int s = sa; s < sb; ++s) axpy(a, gp[s], row4(ring, s - s0, w4)[i4]);
          row4(D, j, w4)[i4] = a;
        }
        for (int r = warp; r < n; r += kWarps) {
          const int s = s0 + r, j = s / cw;
          if (wx[s] < 0) continue;
          float4* dst = reinterpret_cast<float4*>(p.scratch) + (slot0 + s) * sh.d4;
          const float g = p.lr * gp[s];
          for (int i4 = lane; i4 < sh.d4; i4 += 32) {
            const float4 v = row4(V, j, sh.ds)[i4];
            dst[i4] = make_float4(g * v.x, g * v.y, g * v.z, g * v.w);
          }
        }
        __syncthreads();  // the next fill reuses the ring; D is complete after the last
      }
      phase_mark(clk, kPos);
      dq_update(acc, smem, t, pool, sh);
      __syncthreads();  // dQ has read V
      phase_mark(clk, kDq);
      // dV = D + G Q, into V in place
      for (int w = threadIdx.x; w < (t + 3) / 4 * sh.d4; w += kThreads) {
        const int jb = w / sh.d4, i4 = w - jb * sh.d4;
        float4 a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = row4(D, min(4 * jb + u, t - 1), w4)[i4];
        neg_grad(a, Q, GT, pool, jb, i4, sh);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * jb + u;
          if (j >= t) break;
          row4(V, j, sh.ds)[i4] = a[u];
        }
      }
      phase_mark(clk, kDv);
    }
    cluster_sync();  // every CTA's reads of this round come before any write of it
    phase_mark(clk, kRoundBarrier);
    if (t > 0) {
      step_rows<2, false, T>(  // 2 rows a warp: the dQ partial holds registers
          t, warp, kWarps, d, p.vec, [&](int j, T*& dst, const float*& src, float& s) {
            if (wc[j] < 0) return;
            dst = p.in_table + int64_t(wc[j]) * d;
            src = V + size_t(j) * sh.ds;
            s = p.lr;
          });
      __syncthreads();  // the next tile refills V
      phase_mark(clk, kWrite);
    }
  }
  finish_pool(acc, smem, loss, p.out_table, my_pool, p.q_last + blk * pool,
              p.loss_parts + blk, pool, p.capacity, d, p.lr, p.inv_b, p.vec, sh, clk);
  // The deferred context writes, after the pool's (the barriers in
  // finish_pool order them after every scratch write), over the cluster's
  // warps, each the row as it stands less its step; flagged rows are
  // distinct, and none is one of the block's pool rows. Another block's
  // step of a row that is this block's pool row lands after this block's
  // pool write, mostly, where it would otherwise be overwritten.
  const int64_t first = cbase * cw;
  step_rows<kRowsInFlight, true, T>(
      pc * cw, rank * kWarps + warp, k_n * kWarps, d, p.vec,
      [&](int r, T*& dst, const float*& src, float& s) {
        const int64_t slot = first + r;
        const int32_t id = p.b_rows[slot];
        if (!p.b_last[slot] || !in_range(id, p.capacity) || in_pool(id, pid, pool)) return;
        dst = p.out_table + int64_t(id) * d;
        src = p.scratch + slot * w4;
        s = 1.f;
      });
  phase_mark(clk, kFinish);
}

// ------------------------------------------------------------ launch ---

// A shape's launch: its cluster (cluster_launch.cuh) and its shared memory.
struct Launch : ClusterPick {
  Shape sh;
};

// The plan of a shape on a card, computed once: the occupancy queries cost
// more host time than the launch.
template <typename T>
cudaError_t launch_plan(bool grouped, long long nblocks, int per_block, int cw, int pool,
                        int d, int device, Launch* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, long long, int, int, int, int, int, int>, Launch> cache;
  const auto key =
      std::make_tuple(int(grouped), nblocks, per_block, cw, pool, d, int(sizeof(T)), device);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  Launch l;
  if (!plan(grouped, cw, pool, d, &l.sh) || per_block <= 0) return cudaErrorInvalidValue;
  const int ntiles = (per_block + l.sh.tile - 1) / l.sh.tile;
  cudaError_t err =
      grouped ? pick_cluster(fused_sgns_grouped_kernel<T>, nblocks, ntiles, kThreads,
                             l.sh.bytes, &l)
              : pick_cluster(fused_sgns_kernel<T>, nblocks, ntiles, kThreads, l.sh.bytes, &l);
  if (err != cudaSuccess) return err;
  // The same rounds with every CTA busy in each: the smallest tile that
  // still takes ceil(ntiles / K) rounds (it takes no more shared memory, so
  // the card holds at least as many clusters at once).
  const int rounds = (ntiles + l.cluster - 1) / l.cluster;
  const int balanced = (per_block + rounds * l.cluster - 1) / (rounds * l.cluster);
  if (balanced < l.sh.tile && !plan(grouped, cw, pool, d, &l.sh, balanced))
    return cudaErrorInvalidValue;
  cache[key] = l;
  *out = l;
  return cudaSuccess;
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const Args<T>& a, const Launch& l, long long nblocks,
                   cudaStream_t s) {
  // the limit is the kernel's, not the shape's: another shape may have set it
  cudaError_t err = allow_smem(kernel, l.sh.bytes);
  if (err != cudaSuccess) return err;
  ClusterConfig c(l.cluster, nblocks, kThreads, l.sh.bytes, s);
  err = cudaLaunchKernelEx(&c.cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t step(bool grouped, void* in_table, void* out_table, const void* a_rows,
                 const void* b_rows, const void* pool_rows, const void* a_last,
                 const void* b_last, const void* q_last, void* scratch, void* loss_parts,
                 long long nblocks, int per_block, int cw, int pool, long long capacity,
                 int d, float lr, float lam, float inv_b, int device, cudaStream_t s) {
  Launch l;
  cudaError_t err = launch_plan<T>(grouped, nblocks, per_block, cw, pool, d, device, &l);
  if (err != cudaSuccess) return err;
  Args<T> a;
  a.in_table = static_cast<T*>(in_table);
  a.out_table = static_cast<T*>(out_table);
  a.a_rows = static_cast<const int32_t*>(a_rows);
  a.b_rows = static_cast<const int32_t*>(b_rows);
  a.pool_rows = static_cast<const int32_t*>(pool_rows);
  a.a_last = static_cast<const bool*>(a_last);
  a.b_last = static_cast<const bool*>(b_last);
  a.q_last = static_cast<const bool*>(q_last);
  a.scratch = static_cast<float*>(scratch);
  a.loss_parts = static_cast<float*>(loss_parts);
  a.per_block = per_block;
  a.cw = cw;
  a.pool = pool;
  a.capacity = capacity;
  a.d = d;
  a.lr = lr;
  a.lam = lam;
  a.inv_b = inv_b;
  a.vec = (size_t(d) * sizeof(T)) % 16 == 0 && aligned16(in_table) && aligned16(out_table);
  if (grouped && !aligned16(scratch)) return cudaErrorInvalidValue;  // read as float4
  a.sh = l.sh;
  return grouped ? launch(fused_sgns_grouped_kernel<T>, a, l, nblocks, s)
                 : launch(fused_sgns_kernel<T>, a, l, nblocks, s);
}

}  // namespace

extern "C" {

// Tile size the kernels use for these shapes (pairs or centers a tile), or 0
// where even a tile of one does not fit in shared memory.
int ssn_fused_sgns_tile(int grouped, int cw, int pool, int row_elems) {
  Shape sh;
  return plan(grouped != 0, cw, pool, row_elems, &sh) ? sh.tile : 0;
}

// The launch of a shape on a card: out[0..6] = tile, ring rows (grouped),
// cluster size K, CTAs (nblocks * K), clusters the card holds at once at K,
// dynamic shared memory bytes, 1 where the dQ partial is in shared memory;
// out[7..14] = the clusters of 1..8 CTAs the card holds at once, from which
// the rule picked K. per_block: pairs (flat) or centers (grouped) a kernel
// block.
int ssn_fused_sgns_plan(int grouped, long long nblocks, int per_block, int cw, int pool,
                        int row_elems, int elem_bytes, int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if ((elem_bytes != 4 && elem_bytes != 2) || nblocks <= 0) return int(cudaErrorInvalidValue);
  Launch l;
  err = elem_bytes == 4 ? launch_plan<float>(grouped != 0, nblocks, per_block, cw, pool,
                                             row_elems, device, &l)
                        : launch_plan<__nv_bfloat16>(grouped != 0, nblocks, per_block, cw,
                                                     pool, row_elems, device, &l);
  if (err != cudaSuccess) return int(err);
  const long long v[7] = {l.sh.tile, l.sh.ring, l.cluster, nblocks * l.cluster, l.max_active,
                          (long long)l.sh.bytes, l.sh.dq_smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  for (int k = 1; k <= kMaxCluster; ++k) out[6 + k] = l.active[k];
  return 0;
}

// elem_bytes: 4 for f32 tables, 2 for bf16. Flags are bool arrays: v_last /
// u_last [nblocks * pairs], q_last [nblocks * pool].
int ssn_fused_sgns_step(void* in_table, void* out_table, const void* in_rows,
                        const void* pos_rows, const void* pool_rows, const void* v_last,
                        const void* u_last, const void* q_last, void* loss_parts,
                        long long nblocks, int pairs, int pool, long long capacity,
                        int row_elems, int elem_bytes, float lr, float lam, float inv_b,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  Shape sh;
  if (!plan(false, 0, pool, row_elems, &sh) || pairs <= 0) return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = elem_bytes == 4
            ? step<float>(false, in_table, out_table, in_rows, pos_rows, pool_rows, v_last,
                          u_last, q_last, nullptr, loss_parts, nblocks, pairs, 0, pool,
                          capacity, row_elems, lr, lam, inv_b, device, s)
            : step<__nv_bfloat16>(false, in_table, out_table, in_rows, pos_rows, pool_rows,
                                  v_last, u_last, q_last, nullptr, loss_parts, nblocks, pairs,
                                  0, pool, capacity, row_elems, lr, lam, inv_b, device, s);
  return int(err);
}

// ctxs / x_last are [nblocks * pc, cw] (center-major memory); c_last is
// [nblocks * pc], q_last [nblocks * pool]; scratch (16-byte aligned) holds
// nblocks * pc * cw f32 rows of 4 * ceil(row_elems / 4).
int ssn_fused_sgns_grouped_step(void* in_table, void* out_table, const void* centers,
                                const void* ctxs, const void* pool_rows,
                                const void* c_last, const void* x_last,
                                const void* q_last, void* scratch, void* loss_parts,
                                long long nblocks, int pc, int cw, int pool,
                                long long capacity, int row_elems, int elem_bytes,
                                float lr, float lam, float inv_b, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  Shape sh;
  if (!plan(true, cw, pool, row_elems, &sh) || pc <= 0) return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = elem_bytes == 4
            ? step<float>(true, in_table, out_table, centers, ctxs, pool_rows, c_last, x_last,
                          q_last, scratch, loss_parts, nblocks, pc, cw, pool, capacity,
                          row_elems, lr, lam, inv_b, device, s)
            : step<__nv_bfloat16>(true, in_table, out_table, centers, ctxs, pool_rows, c_last,
                                  x_last, q_last, scratch, loss_parts, nblocks, pc, cw, pool,
                                  capacity, row_elems, lr, lam, inv_b, device, s);
  return int(err);
}

#ifdef SSN_PHASE_CLOCKS
// The phase totals (cycles summed over the CTAs, in the order of enum
// Phase) into out[kPhases], then zero them. Only in the clocked build.
int ssn_fused_sgns_phase_clocks(unsigned long long* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  static const unsigned long long zeros[kPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros));
  return int(err);
}
#endif

const char* ssn_fused_sgns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
