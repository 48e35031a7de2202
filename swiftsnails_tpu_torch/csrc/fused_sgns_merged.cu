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
// Design. The blocks of a substep run one after the other, and each block's
// work is spread over the card in three launches:
//   C(b): ceil(PC / tile) thread blocks, each with `tile` centers. A thread
//     block loads the pool (hot rows live from the tables, cold rows from a
//     staging buffer), its centers and their context slots, scores them as
//     the grouped kernel does, and writes its centers' read values V and
//     gradients dV, each context slot's gradient scalar g_pos and its share
//     of the pool gradient dQ to a scratch buffer, plus one loss partial.
//     In the same launch it stages block b + 1's cold rows into the other
//     half of a two-slot staging buffer: read after W(b - 1) and before
//     W(b), which is the b - 2 rule. Hot rows are never staged: C reads them
//     live, after W(b - 1).
//   R(b): dQ, the C thread blocks' shares summed in order.
//   W(b): one warp per written row ("run"). The runs and their slots come
//     from the prep in Python (ops/fused_sgns.py merge_runs), sorted by row,
//     so that a merged row's slots are contiguous: the warp sums their
//     gradients in that fixed order and writes base - lr * sum once. A
//     last-write-wins row is a run of one slot. No two runs write one row,
//     so no atomics.
// That makes 3 launches a kernel block plus one to stage block 0, enqueued
// from one C call; a cooperative launch with grid.sync() between the phases
// would save the launches but needs every thread block resident at once and
// ties the grid to the card's occupancy, which the launches leave free.
// On Hopper the resident head is the tables' first hot_n rows: at 2,048
// rows of 1 KB in two tables it is 4 MB and stays in the 50 MB L2, so C
// reads it directly instead of holding it in shared memory (the TPU
// kernel's one-hot expansion was Mosaic's way to index VMEM), and the
// unique list needs no broadcast: its content is the merged write.
//
// What bounds it. At the main shape (f32 rows of 256 lanes, PC 256, PN 64)
// the f32 arithmetic (~1 GFLOP a substep) and the distinct rows moved
// (~40 MB) bound it near 0.015 ms; in practice the 97 launches of a
// substep and the block-by-block order bound it: each launch does a few
// microseconds of work and waits on a few rounds of memory latency (the
// loads are unrolled so that each round has many in flight). Staging copies every cold
// slot's row, duplicates included; reading each distinct row once is later
// work.
//
// Compute is f32 with one rounding on write (__float2bfloat16_rn for bf16).
// Row ids outside [0, C) (the -1 pads) are never dereferenced: such a slot
// reads zeros, is masked out of the arithmetic and is never written.
//
// Bound by a plain C interface, loaded with ctypes. The entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns the first launch error (0 on success), or
// cudaErrorInvalidValue, launching nothing, for shapes whose tile does not
// fit in shared memory (ssn_fused_sgns_merged_tiles says so beforehand).

#include "sgns_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCenterTile = 4;  // most centers a C thread block
constexpr int kMaxLaneElems = 16;  // row elements a lane of W sums: rows up to 512
constexpr int kStageRows = 2;      // rows a warp stages at a time
constexpr size_t kMaxDynamicSmem = 232448 - kWarps * sizeof(float);
constexpr size_t kAlign = 256;

size_t compute_smem(int tile, int cw, int pool, int d) {
  return sizeof(float) * (size_t(pool) * d + size_t(tile) * d + size_t(tile) * cw * d +
                          size_t(tile) * (cw + pool) + size_t(tile)) +
         sizeof(int32_t) * size_t(tile) * cw;
}

// The largest tile whose shared memory fits, or 0 (also for rows wider than
// W's registers hold).
int plan_tile(int cw, int pool, int d, size_t* bytes) {
  if (d > 32 * kMaxLaneElems) return 0;
  for (int t = kCenterTile; t >= 1; --t) {
    const size_t n = compute_smem(t, cw, pool, d);
    if (n <= kMaxDynamicSmem) {
      *bytes = n;
      return t;
    }
  }
  return 0;
}

size_t aligned(size_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

// Scratch of one substep, in the wrapper's workspace.
template <typename T>
struct Work {
  T* stage_v;      // [2, pc, d]       cold center rows of blocks b, b + 1
  T* stage_u;      // [2, pc * cw, d]  cold context rows (p-major slots)
  T* stage_q;      // [2, pool, d]     cold pool rows
  float* vs;       // [pc, d]          the block's center values as read
  float* dvs;      // [pc, d]          their gradients
  float* gpos;     // [pc * cw]        each context slot's gradient scalar
  float* dq;       // [pool, d]        dQ, summed over the C thread blocks
  float* dq_part;  // [ntiles, pool, d] each C thread block's share of dQ
};

size_t workspace_bytes(int pc, int cw, int pool, int ntiles, int d, size_t elem) {
  return aligned(2 * size_t(pc) * d * elem) + aligned(2 * size_t(pc) * cw * d * elem) +
         aligned(2 * size_t(pool) * d * elem) + 2 * aligned(sizeof(float) * pc * d) +
         aligned(sizeof(float) * pc * cw) + aligned(sizeof(float) * pool * d) +
         aligned(sizeof(float) * ntiles * pool * d);
}

template <typename T>
Work<T> carve(void* base, int pc, int cw, int pool, int d) {
  char* p = static_cast<char*>(base);
  Work<T> w;
  auto take = [&](size_t n) {
    char* out = p;
    p += aligned(n);
    return out;
  };
  w.stage_v = reinterpret_cast<T*>(take(2 * size_t(pc) * d * sizeof(T)));
  w.stage_u = reinterpret_cast<T*>(take(2 * size_t(pc) * cw * d * sizeof(T)));
  w.stage_q = reinterpret_cast<T*>(take(2 * size_t(pool) * d * sizeof(T)));
  w.vs = reinterpret_cast<float*>(take(sizeof(float) * pc * d));
  w.dvs = reinterpret_cast<float*>(take(sizeof(float) * pc * d));
  w.gpos = reinterpret_cast<float*>(take(sizeof(float) * pc * cw));
  w.dq = reinterpret_cast<float*>(take(sizeof(float) * pool * d));
  w.dq_part = reinterpret_cast<float*>(p);
  return w;
}

// Copy the cold rows among rows[k], k = first, first + step, ... < n, to
// dst[k]: a warp copies kStageRows rows at a time, all their loads in flight
// before the stores. Hot rows are read live, pads never.
template <typename T>
__device__ void stage_rows(T* __restrict__ dst, const T* __restrict__ table,
                           const int32_t* __restrict__ rows, int first, int step, int n,
                           int64_t capacity, int d, int hot_n) {
  const int lane = threadIdx.x & 31;
  for (int m0 = threadIdx.x >> 5; first + m0 * step < n; m0 += kStageRows * kWarps) {
    int k[kStageRows];
    int32_t r[kStageRows];
#pragma unroll
    for (int u = 0; u < kStageRows; ++u) {
      k[u] = first + (m0 + u * kWarps) * step;
      r[u] = k[u] < n ? rows[k[u]] : -1;
      if (!in_range(r[u], capacity) || r[u] < hot_n) r[u] = -1;
    }
    T v[kStageRows][kMaxLaneElems];
#pragma unroll
    for (int u = 0; u < kStageRows; ++u)
#pragma unroll
      for (int m = 0; m < kMaxLaneElems; ++m)
        if (r[u] >= 0 && lane + 32 * m < d) v[u][m] = table[int64_t(r[u]) * d + lane + 32 * m];
#pragma unroll
    for (int u = 0; u < kStageRows; ++u)
#pragma unroll
      for (int m = 0; m < kMaxLaneElems; ++m)
        if (r[u] >= 0 && lane + 32 * m < d) dst[int64_t(k[u]) * d + lane + 32 * m] = v[u][m];
  }
}

// This thread block's share of block b's cold rows, into staging slot b % 2:
// the centers of its tile, their context slots, and every gridDim.x-th pool
// row from blockIdx.x.
template <typename T>
__device__ void stage_block(const Work<T>& w, const T* in_table, const T* out_table,
                            const int32_t* centers, const int32_t* ctxs,
                            const int32_t* pool_rows, int64_t b, int pc, int cw, int pool,
                            int tile, int64_t capacity, int d, int hot_n) {
  const int slot = int(b & 1);
  const int p0 = blockIdx.x * tile;
  const int t = min(tile, pc - p0);
  stage_rows(w.stage_v + (int64_t(slot) * pc + p0) * d, in_table, centers + b * pc + p0, 0, 1,
             t, capacity, d, hot_n);
  stage_rows(w.stage_u + (int64_t(slot) * pc + p0) * cw * d, out_table,
             ctxs + (b * pc + p0) * cw, 0, 1, t * cw, capacity, d, hot_n);
  stage_rows(w.stage_q + int64_t(slot) * pool * d, out_table, pool_rows + b * pool, blockIdx.x,
             gridDim.x, pool, capacity, d, hot_n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merged_stage_kernel(Work<T> w, const T* in_table, const T* out_table,
                    const int32_t* __restrict__ centers, const int32_t* __restrict__ ctxs,
                    const int32_t* __restrict__ pool_rows, int64_t b, int pc, int cw,
                    int pool, int tile, int64_t capacity, int d, int hot_n) {
  stage_block(w, in_table, out_table, centers, ctxs, pool_rows, b, pc, cw, pool, tile,
              capacity, d, hot_n);
}

// C(b), and the staging of block b + 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merged_compute_kernel(Work<T> w, const T* in_table, const T* out_table,
                      const int32_t* __restrict__ centers, const int32_t* __restrict__ ctxs,
                      const int32_t* __restrict__ pool_rows, float* __restrict__ loss_parts,
                      int64_t b, int64_t nblocks, int pc, int cw, int pool, int tile,
                      int64_t capacity, int d, int hot_n, float lam, float inv_b) {
  extern __shared__ float smem[];
  float* q = smem;                     // [pool, d]
  float* v = q + pool * d;             // [tile, d]       center rows
  float* u = v + tile * d;             // [tile * cw, d]  context rows, zeros on pads
  float* g = u + tile * cw * d;        // [tile, cw + pool]: pos (masked), then neg
  float* n_real = g + tile * (cw + pool);                     // [tile]
  int32_t* xrow = reinterpret_cast<int32_t*>(n_real + tile);  // [tile * cw]
  const int stride = cw + pool;
  const int slot = int(b & 1);
  const int p0 = blockIdx.x * tile;
  const int t = min(tile, pc - p0);
  const int cap = pc * cw;
  const int64_t cbase = b * pc;
  const int32_t* my_pool = pool_rows + b * pool;
  const T* sv = w.stage_v + int64_t(slot) * pc * d;
  const T* su = w.stage_u + int64_t(slot) * cap * d;
  const T* sq = w.stage_q + int64_t(slot) * pool * d;

  for (int s = threadIdx.x; s < t * cw; s += kThreads) xrow[s] = ctxs[(cbase + p0) * cw + s];
#pragma unroll 8
  for (int e = threadIdx.x; e < pool * d; e += kThreads) {
    const int c = e / d, i = e - c * d;
    const int32_t r = my_pool[c];
    q[e] = !in_range(r, capacity) ? 0.f
           : r < hot_n            ? ld(out_table + int64_t(r) * d + i)
                                  : ld(sq + int64_t(c) * d + i);
  }
  for (int e = threadIdx.x; e < t * d; e += kThreads) {
    const int j = e / d, i = e - j * d;
    const int32_t r = centers[cbase + p0 + j];
    v[e] = !in_range(r, capacity) ? 0.f
           : r < hot_n            ? ld(in_table + int64_t(r) * d + i)
                                  : ld(sv + int64_t(p0 + j) * d + i);
  }
  __syncthreads();
#pragma unroll 8
  for (int e = threadIdx.x; e < t * cw * d; e += kThreads) {
    const int s = e / d, i = e - s * d;
    const int32_t r = xrow[s];
    u[e] = !in_range(r, capacity) ? 0.f
           : r < hot_n            ? ld(out_table + int64_t(r) * d + i)
                                  : ld(su + (int64_t(p0) * cw + s) * d + i);
  }
  if (threadIdx.x < t) {
    float n = 0.f;
    for (int c = 0; c < cw; ++c) n += in_range(xrow[threadIdx.x * cw + c], capacity);
    n_real[threadIdx.x] = n;
  }
  __syncthreads();
  dots<kThreads>(g, t * stride, d, [&](int k, const float*& a, const float*& bb) {
    const int j = k / stride, c = k - j * stride;
    a = v + j * d;
    bb = c < cw ? u + (j * cw + c) * d : q + (c - cw) * d;
  });
  __syncthreads();
  float loss = 0.f;
  for (int k = threadIdx.x; k < t * stride; k += kThreads) {
    const int j = k / stride, c = k - j * stride;
    const float x = g[k];
    if (c < cw) {
      const bool real = in_range(xrow[j * cw + c], capacity);
      if (real) loss += log_sigmoid(x);
      g[k] = real ? (sigmoid(x) - 1.f) * inv_b : 0.f;
    } else {
      loss += lam * log_sigmoid(-x) * n_real[j];
      g[k] = lam * inv_b * sigmoid(x) * n_real[j];
    }
  }
  __syncthreads();
  // the tile's center values and gradients, for W
  for (int e = threadIdx.x; e < t * d; e += kThreads) {
    const int j = e / d, i = e - j * d;
    const float* gj = g + j * stride;
    float dv = 0.f;
    for (int c = 0; c < cw; ++c) dv = fmaf(gj[c], u[(j * cw + c) * d + i], dv);
    for (int c = 0; c < pool; ++c) dv = fmaf(gj[cw + c], q[c * d + i], dv);
    w.vs[int64_t(p0 + j) * d + i] = v[e];
    w.dvs[int64_t(p0 + j) * d + i] = dv;
  }
  for (int s = threadIdx.x; s < t * cw; s += kThreads)
    w.gpos[p0 * cw + s] = g[(s / cw) * stride + s % cw];
  // this tile's share of dQ = g_neg^T V, in center order
  for (int e = threadIdx.x; e < pool * d; e += kThreads) {
    const int c = e / d, i = e - c * d;
    float acc = 0.f;
    for (int j = 0; j < t; ++j) acc = fmaf(g[j * stride + cw + c], v[j * d + i], acc);
    w.dq_part[(int64_t(blockIdx.x) * pool + c) * d + i] = acc;
  }
  store_loss<kThreads>(loss_parts + b * gridDim.x + blockIdx.x, loss, inv_b);
  if (b + 1 < nblocks)
    stage_block(w, in_table, out_table, centers, ctxs, pool_rows, b + 1, pc, cw, pool, tile,
                capacity, d, hot_n);
}

// R(b): dQ = the C thread blocks' shares summed in order, one thread an
// element, so that a pool slot in W reads one row.
__global__ void __launch_bounds__(256)
merged_reduce_kernel(float* __restrict__ dq, const float* __restrict__ dq_part, int ntiles,
                     int n) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int tb = 0; tb < ntiles; ++tb) s += dq_part[int64_t(tb) * n + e];
  dq[e] = s;
}

// W(b): warp k writes run k of block b, the slots ent[run_start[k] ..
// run_start[k + 1]) of one row. A slot code below pc * cw is a context slot
// (p-major), then come the pool slots and the centers (in-table). A lane
// holds the sums of row elements lane, lane + 32, ... in registers; the warp
// reads the run's slots 32 at a time, one a lane, and walks them by
// shuffles, so that a long run (a head row has ~100 slots a block) streams
// its rows' loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merged_write_kernel(Work<T> w, T* in_table, T* out_table, const int32_t* __restrict__ centers,
                    const int32_t* __restrict__ ctxs, const int32_t* __restrict__ pool_rows,
                    const int32_t* __restrict__ ent_all, const int32_t* __restrict__ run_all,
                    const int32_t* __restrict__ nrun, int64_t b, int pc, int cw, int pool,
                    int d, int hot_n, float lr) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (run >= nrun[b]) return;  // the whole warp
  const int cap = pc * cw, first_center = cap + pool, kent = cap + pool + pc;
  const int32_t* ent = ent_all + b * kent;
  const int start = run_all[b * (kent + 1) + run], end = run_all[b * (kent + 1) + run + 1];
  float acc[kMaxLaneElems];
#pragma unroll
  for (int m = 0; m < kMaxLaneElems; ++m) acc[m] = 0.f;
  for (int k0 = start; k0 < end; k0 += 32) {
    const int n = min(32, end - k0);
    const int my_e = lane < n ? ent[k0 + lane] : 0;
    const float my_g = lane < n && my_e < cap ? w.gpos[my_e] : 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int e = __shfl_sync(0xffffffffu, my_e, j);
      const float g = __shfl_sync(0xffffffffu, my_g, j);
      // a context slot's dU = g_pos * V of its center; a pool slot's dQ; a
      // center's dV
      const float* src = e < cap            ? w.vs + int64_t(e / cw) * d
                         : e < first_center ? w.dq + int64_t(e - cap) * d
                                            : w.dvs + int64_t(e - first_center) * d;
      const float scale = e < cap ? g : 1.f;
#pragma unroll
      for (int m = 0; m < kMaxLaneElems; ++m)
        if (lane + 32 * m < d) acc[m] = fmaf(scale, src[lane + 32 * m], acc[m]);
    }
  }
  const int e0 = ent[start];
  const int slot = int(b & 1);
  T* dst;
  if (e0 >= first_center) {  // in-table: the center's value as read
    const int p = e0 - first_center;
    dst = in_table + int64_t(centers[b * pc + p]) * d;
    const float* base = w.vs + int64_t(p) * d;
#pragma unroll
    for (int m = 0; m < kMaxLaneElems; ++m)
      if (lane + 32 * m < d) st(dst + lane + 32 * m, base[lane + 32 * m] - lr * acc[m]);
    return;
  }
  // out-table: a hot row live, a cold one as staged
  const int32_t r = e0 < cap ? ctxs[b * cap + e0] : pool_rows[b * pool + (e0 - cap)];
  dst = out_table + int64_t(r) * d;
  const T* base = r < hot_n ? dst
                  : e0 < cap ? w.stage_u + (int64_t(slot) * cap + e0) * d
                             : w.stage_q + (int64_t(slot) * pool + (e0 - cap)) * d;
#pragma unroll
  for (int m = 0; m < kMaxLaneElems; ++m)
    if (lane + 32 * m < d) st(dst + lane + 32 * m, ld(base + lane + 32 * m) - lr * acc[m]);
}

template <typename T>
cudaError_t launch_all(void* in_table, void* out_table, const int32_t* centers,
                       const int32_t* ctxs, const int32_t* pool_rows, const int32_t* ent,
                       const int32_t* run_start, const int32_t* n_runs, void* workspace,
                       float* loss_parts, int64_t nblocks, int pc, int cw, int pool, int tile,
                       size_t smem, int64_t capacity, int d, int hot_n, float lr, float lam,
                       float inv_b, cudaStream_t s) {
  cudaError_t err = allow_smem(merged_compute_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  auto* it = static_cast<T*>(in_table);
  auto* ot = static_cast<T*>(out_table);
  const Work<T> w = carve<T>(workspace, pc, cw, pool, d);
  const int ntiles = (pc + tile - 1) / tile;
  const int wblocks = (pc + pc * cw + pool + kWarps - 1) / kWarps;
  merged_stage_kernel<T><<<ntiles, kThreads, 0, s>>>(w, it, ot, centers, ctxs, pool_rows, 0,
                                                      pc, cw, pool, tile, capacity, d, hot_n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int64_t b = 0; b < nblocks; ++b) {
    merged_compute_kernel<T><<<ntiles, kThreads, smem, s>>>(
        w, it, ot, centers, ctxs, pool_rows, loss_parts, b, nblocks, pc, cw, pool, tile,
        capacity, d, hot_n, lam, inv_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    merged_reduce_kernel<<<(pool * d + 255) / 256, 256, 0, s>>>(w.dq, w.dq_part, ntiles,
                                                                  pool * d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    merged_write_kernel<T><<<wblocks, kThreads, 0, s>>>(
        w, it, ot, centers, ctxs, pool_rows, ent, run_start, n_runs, b, pc, cw, pool, d,
        hot_n, lr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// C thread blocks a kernel block uses for these shapes, or 0 where even a
// tile of one center does not fit in shared memory, or rows are wider than
// 512 elements.
int ssn_fused_sgns_merged_tiles(int pc, int cw, int pool, int row_elems) {
  size_t bytes = 0;
  const int tile = plan_tile(cw, pool, row_elems, &bytes);
  return tile == 0 || pc <= 0 ? 0 : (pc + tile - 1) / tile;
}

// Bytes of the workspace ssn_fused_sgns_merged_step needs (0 where the
// shapes do not fit).
long long ssn_fused_sgns_merged_workspace(int pc, int cw, int pool, int row_elems,
                                          int elem_bytes) {
  const int ntiles = ssn_fused_sgns_merged_tiles(pc, cw, pool, row_elems);
  if (ntiles == 0) return 0;
  return (long long)workspace_bytes(pc, cw, pool, ntiles, row_elems, size_t(elem_bytes));
}

// centers [nblocks * pc], ctxs [nblocks * pc, cw] (-1 = pad), pool_rows
// [nblocks * pool]; ent [nblocks, K], run_start [nblocks, K + 1], n_runs
// [nblocks] with K = pc * cw + pool + pc (ops/fused_sgns.py merge_runs); workspace of
// ssn_fused_sgns_merged_workspace bytes; loss_parts [nblocks * ntiles] f32.
// elem_bytes: 4 for f32 tables, 2 for bf16.
int ssn_fused_sgns_merged_step(void* in_table, void* out_table, const void* centers,
                               const void* ctxs, const void* pool_rows, const void* ent,
                               const void* run_start, const void* n_runs, void* workspace,
                               void* loss_parts, long long nblocks, int pc, int cw, int pool,
                               long long capacity, int row_elems, int elem_bytes, int hot_n,
                               float lr, float lam, float inv_b, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (elem_bytes != 4 && elem_bytes != 2) return int(cudaErrorInvalidValue);
  size_t smem = 0;
  const int tile = plan_tile(cw, pool, row_elems, &smem);
  if (tile == 0 || pc <= 0 || cw <= 0 || pool <= 0) return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cr = static_cast<const int32_t*>(centers);
  const auto* xr = static_cast<const int32_t*>(ctxs);
  const auto* qr = static_cast<const int32_t*>(pool_rows);
  const auto* en = static_cast<const int32_t*>(ent);
  const auto* rs = static_cast<const int32_t*>(run_start);
  const auto* nr = static_cast<const int32_t*>(n_runs);
  auto* loss = static_cast<float*>(loss_parts);
  if (elem_bytes == 4)
    err = launch_all<float>(in_table, out_table, cr, xr, qr, en, rs, nr, workspace, loss,
                            nblocks, pc, cw, pool, tile, smem, capacity, row_elems,
                            hot_n, lr, lam, inv_b, s);
  else
    err = launch_all<__nv_bfloat16>(in_table, out_table, cr, xr, qr, en, rs, nr, workspace,
                                    loss, nblocks, pc, cw, pool, tile, smem,
                                    capacity, row_elems, hot_n, lr, lam, inv_b, s);
  return int(err);
}

const char* ssn_fused_sgns_merged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
