// Launching a kernel as thread-block clusters of K CTAs, and the rule that
// picks K, shared by the hogwild SGNS kernels (fused_sgns.cu) and the pipe
// probe (sem_probe.cu). A kernel block is one cluster; a CTA's time goes as
// its rounds of work, ceil(ntiles / K), and the launch's as the waves it
// takes, ceil(nblocks / the clusters of K the card holds at once): K in 1..8
// minimises rounds x waves, the smaller K on a tie.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size

// A launch of nblocks clusters of k CTAs of `threads` threads.
struct ClusterConfig {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterConfig(int k, long long nblocks, unsigned threads, size_t bytes, cudaStream_t s)
      : cfg() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = unsigned(k);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(unsigned(nblocks * k));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterConfig(const ClusterConfig&) = delete;
};

// The rule's pick: K, the clusters of K held at once, and those of each size.
struct ClusterPick {
  int cluster = 0, max_active = 0;
  int active[kMaxCluster + 1] = {};  // clusters of k CTAs the card holds at once
};

// K for nblocks kernel blocks of ntiles tiles each, from the clusters of each
// size the card holds at once with `bytes` of dynamic shared memory a CTA.
template <typename Kernel>
cudaError_t pick_cluster(Kernel kernel, long long nblocks, int ntiles, unsigned threads,
                         size_t bytes, ClusterPick* p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  long long best = -1;
  for (int k = 1; k <= kMaxCluster; ++k) {
    ClusterConfig c(k, nblocks, threads, bytes, nullptr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &c.cfg);
    if (err != cudaSuccess) return err;
    p->active[k] = active;
    if (active <= 0) continue;
    const long long cost = (ntiles + k - 1) / k * ((nblocks + active - 1) / active);
    if (best < 0 || cost < best) {
      best = cost;
      p->cluster = k;
      p->max_active = active;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace
