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
// are written to the in-table, then contexts (U) and then the pool to the
// out-table, each row once, by the slot that the last-occurrence flags
// computed before the launch mark (the grouped form ranks context slots in
// c-major order, k = c * PC + p). Pool writes come after every context write
// of the block, behind a block-wide barrier. Across kernel blocks the card
// is hogwild: blocks run concurrently, as the reference's asynchronous SGD
// workers do. On inputs whose rows are disjoint between blocks the result is
// deterministic: no atomics, and every sum runs in a fixed order.
//
// What bounds them. At the main path's shapes (f32, rows of 256 lanes, PN
// 64) the arithmetic is the pair x pool products, ~6 * pairs * PN * 256
// flops, against ~1 KB moved per distinct row: about 1.6 GFLOP against
// 17 MB for the flat step, so the floor is the f32 rate without tensor
// cores (67 TFLOP/s on an H100 SXM), not the 3.35 TB/s of HBM.
//
// Design: one thread block per kernel block, looping over tiles of pairs
// (flat) or of centers (grouped). A block of the TPU kernel holds ~1 MB
// (flat) or ~2.8 MB (grouped) of rows in VMEM; a Hopper block has 227 KB of
// shared memory. So the block keeps only the pool rows and the pool gradient
// dQ in shared memory (2 * PN * row floats, 128 KB at the main shape) and
// streams the V / U rows through a tile. A tile's rows are all read before
// any of them is written (barrier), and dQ accumulates over the tiles in
// order, one thread per element.
//   * Flat: a row's last slot lies in the last tile that holds the row, so a
//     row written in tile t is read by no later tile and the tiles keep the
//     snapshot.
//   * Grouped: tiles run over centers, but the last-write order is c-major,
//     so a context row's last slot may lie in an earlier tile than another of
//     its slots. Context writes are therefore deferred: each flagged slot
//     writes its new row to a scratch buffer, and after the last tile (and a
//     barrier) the block copies those rows to the table. Center rows need no
//     deferral (their order is the tile order).
//   * The score dot products use one warp each, lanes over the row and a
//     fixed butterfly sum; the loss sums per thread in a fixed order, then
//     per warp and per block, into one partial per block that the wrapper
//     adds up.
// With 32 kernel blocks at the main shape, 32 of the 132 SMs work and the
// others idle; splitting a block across SMs (with a two-pass dQ) and tensor
// cores are later work.
//
// Compute is f32 with one rounding on write (__float2bfloat16_rn for bf16),
// as in the TPU kernels. Row ids outside [0, C) are never dereferenced: such
// a center, context or pool row reads as zeros and is never written, and a
// grouped context slot outside [0, C) (the -1 pads) is masked out of the
// arithmetic altogether.
//
// Bound by a plain C interface, loaded with ctypes. Each entry point takes
// the device index and the stream, launches on that stream, does not
// synchronise, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue, launching nothing, for shapes whose tile does not
// fit in shared memory (ssn_fused_sgns_tile says so beforehand).

#include "sgns_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPairTile = 16;   // flat: most pairs per tile
constexpr int kCenterTile = 4;  // grouped: most centers per tile
// Dynamic shared memory a block may use on Hopper (227 KB), less the static
// per-warp loss partials.
constexpr size_t kMaxDynamicSmem = 232448 - kWarps * sizeof(float);

// --------------------------------------------------------------- flat ---

size_t flat_smem(int tile, int pool, int d) {
  return sizeof(float) * (size_t(2) * pool * d + size_t(2) * tile * d +
                          size_t(tile) * (pool + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_sgns_kernel(T* in_table, T* out_table, const int32_t* __restrict__ in_rows,
                  const int32_t* __restrict__ pos_rows,
                  const int32_t* __restrict__ pool_rows,
                  const bool* __restrict__ v_last, const bool* __restrict__ u_last,
                  const bool* __restrict__ q_last, float* __restrict__ loss_parts,
                  int pairs, int pool, int tile, int64_t capacity, int d, float lr,
                  float lam, float inv_b) {
  extern __shared__ float smem[];
  float* q = smem;                 // [pool, d]  pool rows, read once
  float* dq = q + pool * d;        // [pool, d]  pool gradient
  float* v = dq + pool * d;        // [tile, d]  center rows of the tile
  float* u = v + tile * d;         // [tile, d]  context rows of the tile
  float* g = u + tile * d;         // [tile, pool + 1]  scores, then gradients
  const int stride = pool + 1;     // g[j * stride + c]: c < pool neg, c == pool pos
  const int64_t base = int64_t(blockIdx.x) * pairs;
  const int32_t* my_pool = pool_rows + int64_t(blockIdx.x) * pool;

  load_rows<kThreads>(q, out_table, my_pool, pool, capacity, d);
  for (int e = threadIdx.x; e < pool * d; e += kThreads) dq[e] = 0.f;
  float loss = 0.f;

  for (int j0 = 0; j0 < pairs; j0 += tile) {
    const int t = min(tile, pairs - j0);
    __syncthreads();  // the last tile's readers are done; q is loaded
    load_rows<kThreads>(v, in_table, in_rows + base + j0, t, capacity, d);
    load_rows<kThreads>(u, out_table, pos_rows + base + j0, t, capacity, d);
    __syncthreads();
    dots<kThreads>(g, t * stride, d, [&](int k, const float*& a, const float*& b) {
      const int j = k / stride, c = k - j * stride;
      a = v + j * d;
      b = c == pool ? u + j * d : q + c * d;
    });
    __syncthreads();
    for (int k = threadIdx.x; k < t * stride; k += kThreads) {
      const float x = g[k];
      if (k % stride == pool) {
        loss += log_sigmoid(x);
        g[k] = (sigmoid(x) - 1.f) * inv_b;
      } else {
        loss += lam * log_sigmoid(-x);
        g[k] = lam * inv_b * sigmoid(x);
      }
    }
    __syncthreads();
    // new V and U rows of the tile, written by their last slot only
    for (int e = threadIdx.x; e < t * d; e += kThreads) {
      const int j = e / d, i = e - j * d;
      const float* gj = g + j * stride;
      float dv = gj[pool] * u[e];
      for (int c = 0; c < pool; ++c) dv = fmaf(gj[c], q[c * d + i], dv);
      const int64_t slot = base + j0 + j;
      const int32_t rv = in_rows[slot], ru = pos_rows[slot];
      if (v_last[slot] && in_range(rv, capacity))
        st(in_table + int64_t(rv) * d + i, v[e] - lr * dv);
      if (u_last[slot] && in_range(ru, capacity))
        st(out_table + int64_t(ru) * d + i, u[e] - lr * (gj[pool] * v[e]));
    }
    // dQ += g_neg^T V over the tile's pairs, in pair order
    for (int e = threadIdx.x; e < pool * d; e += kThreads) {
      const int c = e / d, i = e - c * d;
      float acc = dq[e];
      for (int j = 0; j < t; ++j) acc = fmaf(g[j * stride + c], v[j * d + i], acc);
      dq[e] = acc;
    }
  }
  __syncthreads();  // every U write of the block lands before the pool writes
  for (int e = threadIdx.x; e < pool * d; e += kThreads) {
    const int c = e / d;
    const int32_t r = my_pool[c];
    if (q_last[int64_t(blockIdx.x) * pool + c] && in_range(r, capacity))
      st(out_table + int64_t(r) * d + (e - c * d), q[e] - lr * dq[e]);
  }
  store_loss<kThreads>(loss_parts + blockIdx.x, loss, inv_b);
}

// ------------------------------------------------------------ grouped ---

size_t grouped_smem(int tile, int cw, int pool, int d) {
  return sizeof(float) * (size_t(2) * pool * d + size_t(tile) * d +
                          size_t(tile) * cw * d + size_t(tile) * (cw + pool) +
                          size_t(tile)) +
         sizeof(int32_t) * size_t(tile) * cw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_sgns_grouped_kernel(T* in_table, T* out_table,
                          const int32_t* __restrict__ centers,
                          const int32_t* __restrict__ ctxs,
                          const int32_t* __restrict__ pool_rows,
                          const bool* __restrict__ c_last,
                          const bool* __restrict__ x_last,
                          const bool* __restrict__ q_last, T* scratch,
                          float* __restrict__ loss_parts, int pc, int cw, int pool,
                          int tile, int64_t capacity, int d, float lr, float lam,
                          float inv_b) {
  extern __shared__ float smem[];
  float* q = smem;                     // [pool, d]
  float* dq = q + pool * d;            // [pool, d]
  float* v = dq + pool * d;            // [tile, d]       center rows
  float* u = v + tile * d;             // [tile * cw, d]  context rows, zeros on pads
  float* g = u + tile * cw * d;        // [tile, cw + pool]: pos (masked), then neg
  float* n_real = g + tile * (cw + pool);          // [tile] real contexts a center
  int32_t* xrow = reinterpret_cast<int32_t*>(n_real + tile);  // [tile * cw]
  const int stride = cw + pool;
  const int64_t cbase = int64_t(blockIdx.x) * pc;  // first center of the block
  const int32_t* my_pool = pool_rows + int64_t(blockIdx.x) * pool;

  load_rows<kThreads>(q, out_table, my_pool, pool, capacity, d);
  for (int e = threadIdx.x; e < pool * d; e += kThreads) dq[e] = 0.f;
  float loss = 0.f;

  for (int p0 = 0; p0 < pc; p0 += tile) {
    const int t = min(tile, pc - p0);
    const int64_t slot0 = (cbase + p0) * cw;  // first context slot of the tile
    __syncthreads();
    for (int s = threadIdx.x; s < t * cw; s += kThreads) xrow[s] = ctxs[slot0 + s];
    load_rows<kThreads>(v, in_table, centers + cbase + p0, t, capacity, d);
    // pads are never read: load_rows gives them zeros
    load_rows<kThreads>(u, out_table, ctxs + slot0, t * cw, capacity, d);
    __syncthreads();
    if (threadIdx.x < t) {
      float n = 0.f;
      for (int c = 0; c < cw; ++c) n += in_range(xrow[threadIdx.x * cw + c], capacity);
      n_real[threadIdx.x] = n;
    }
    dots<kThreads>(g, t * stride, d, [&](int k, const float*& a, const float*& b) {
      const int j = k / stride, c = k - j * stride;
      a = v + j * d;
      b = c < cw ? u + (j * cw + c) * d : q + (c - cw) * d;
    });
    __syncthreads();
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
    // new center rows, written by their last slot
    for (int e = threadIdx.x; e < t * d; e += kThreads) {
      const int j = e / d, i = e - j * d;
      const float* gj = g + j * stride;
      float dv = 0.f;
      for (int c = 0; c < cw; ++c) dv = fmaf(gj[c], u[(j * cw + c) * d + i], dv);
      for (int c = 0; c < pool; ++c) dv = fmaf(gj[cw + c], q[c * d + i], dv);
      const int64_t center = cbase + p0 + j;
      const int32_t r = centers[center];
      if (c_last[center] && in_range(r, capacity))
        st(in_table + int64_t(r) * d + i, v[e] - lr * dv);
    }
    // new context rows of the flagged slots, to the scratch buffer
    for (int e = threadIdx.x; e < t * cw * d; e += kThreads) {
      const int s = e / d, i = e - s * d;
      const int j = s / cw;
      if (x_last[slot0 + s] && in_range(xrow[s], capacity))
        st(scratch + (slot0 + s) * d + i,
           u[e] - lr * (g[j * stride + (s - j * cw)] * v[j * d + i]));
    }
    // dQ += g_neg^T V over the tile's centers, in center order
    for (int e = threadIdx.x; e < pool * d; e += kThreads) {
      const int c = e / d, i = e - c * d;
      float acc = dq[e];
      for (int j = 0; j < t; ++j) acc = fmaf(g[j * stride + cw + c], v[j * d + i], acc);
      dq[e] = acc;
    }
  }
  __syncthreads();  // the scratch rows are written and every tile has read
  // the deferred context writes: flagged rows are distinct, one warp a row
  {
    const int lane = threadIdx.x & 31;
    const int64_t first = cbase * cw;
    for (int s = threadIdx.x >> 5; s < pc * cw; s += kWarps) {
      const int32_t r = ctxs[first + s];
      if (!x_last[first + s] || !in_range(r, capacity)) continue;
      const T* src = scratch + (first + s) * d;
      T* dst = out_table + int64_t(r) * d;
      for (int i = lane; i < d; i += 32) dst[i] = src[i];
    }
  }
  __syncthreads();  // every context write lands before the pool writes
  for (int e = threadIdx.x; e < pool * d; e += kThreads) {
    const int c = e / d;
    const int32_t r = my_pool[c];
    if (q_last[int64_t(blockIdx.x) * pool + c] && in_range(r, capacity))
      st(out_table + int64_t(r) * d + (e - c * d), q[e] - lr * dq[e]);
  }
  store_loss<kThreads>(loss_parts + blockIdx.x, loss, inv_b);
}

// The largest tile whose shared memory fits, or 0.
int plan_tile(bool grouped, int cw, int pool, int d, size_t* bytes) {
  for (int t = grouped ? kCenterTile : kPairTile; t >= 1; --t) {
    const size_t n = grouped ? grouped_smem(t, cw, pool, d) : flat_smem(t, pool, d);
    if (n <= kMaxDynamicSmem) {
      *bytes = n;
      return t;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Tile size the kernels use for these shapes (pairs or centers a tile), or 0
// where even a tile of one does not fit in shared memory.
int ssn_fused_sgns_tile(int grouped, int cw, int pool, int row_elems) {
  size_t bytes = 0;
  return plan_tile(grouped != 0, cw, pool, row_elems, &bytes);
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
  size_t bytes = 0;
  const int tile = plan_tile(false, 0, pool, row_elems, &bytes);
  if (tile == 0 || pairs <= 0) return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ir = static_cast<const int32_t*>(in_rows);
  const auto* pr = static_cast<const int32_t*>(pos_rows);
  const auto* qr = static_cast<const int32_t*>(pool_rows);
  const auto* vl = static_cast<const bool*>(v_last);
  const auto* ul = static_cast<const bool*>(u_last);
  const auto* ql = static_cast<const bool*>(q_last);
  auto* loss = static_cast<float*>(loss_parts);
  if (elem_bytes == 4) {
    err = allow_smem(fused_sgns_kernel<float>, bytes);
    if (err != cudaSuccess) return int(err);
    fused_sgns_kernel<float><<<unsigned(nblocks), kThreads, bytes, s>>>(
        static_cast<float*>(in_table), static_cast<float*>(out_table), ir, pr, qr, vl,
        ul, ql, loss, pairs, pool, tile, capacity, row_elems, lr, lam, inv_b);
  } else {
    err = allow_smem(fused_sgns_kernel<__nv_bfloat16>, bytes);
    if (err != cudaSuccess) return int(err);
    fused_sgns_kernel<__nv_bfloat16><<<unsigned(nblocks), kThreads, bytes, s>>>(
        static_cast<__nv_bfloat16*>(in_table), static_cast<__nv_bfloat16*>(out_table),
        ir, pr, qr, vl, ul, ql, loss, pairs, pool, tile, capacity, row_elems, lr, lam,
        inv_b);
  }
  return int(cudaGetLastError());
}

// ctxs / x_last are [nblocks * pc, cw] (center-major memory); c_last is
// [nblocks * pc], q_last [nblocks * pool]; scratch holds nblocks * pc * cw
// rows of the table's type.
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
  size_t bytes = 0;
  const int tile = plan_tile(true, cw, pool, row_elems, &bytes);
  if (tile == 0 || pc <= 0 || cw <= 0) return int(cudaErrorInvalidValue);
  if (nblocks <= 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cr = static_cast<const int32_t*>(centers);
  const auto* xr = static_cast<const int32_t*>(ctxs);
  const auto* qr = static_cast<const int32_t*>(pool_rows);
  const auto* cl = static_cast<const bool*>(c_last);
  const auto* xl = static_cast<const bool*>(x_last);
  const auto* ql = static_cast<const bool*>(q_last);
  auto* loss = static_cast<float*>(loss_parts);
  if (elem_bytes == 4) {
    err = allow_smem(fused_sgns_grouped_kernel<float>, bytes);
    if (err != cudaSuccess) return int(err);
    fused_sgns_grouped_kernel<float><<<unsigned(nblocks), kThreads, bytes, s>>>(
        static_cast<float*>(in_table), static_cast<float*>(out_table), cr, xr, qr, cl,
        xl, ql, static_cast<float*>(scratch), loss, pc, cw, pool, tile, capacity,
        row_elems, lr, lam, inv_b);
  } else {
    err = allow_smem(fused_sgns_grouped_kernel<__nv_bfloat16>, bytes);
    if (err != cudaSuccess) return int(err);
    fused_sgns_grouped_kernel<__nv_bfloat16><<<unsigned(nblocks), kThreads, bytes, s>>>(
        static_cast<__nv_bfloat16*>(in_table), static_cast<__nv_bfloat16*>(out_table),
        cr, xr, qr, cl, xl, ql, static_cast<__nv_bfloat16*>(scratch), loss, pc, cw,
        pool, tile, capacity, row_elems, lr, lam, inv_b);
  }
  return int(cudaGetLastError());
}

const char* ssn_fused_sgns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
