// Privatized histograms summed over a thread-block cluster, shared by K4
// seg_sum (segment.cu) and K7 attr_fold (attr_fold.cu).
//
// Every block of a cluster folds its lanes into its own full copy of a
// histogram in shared memory (cluster size times chunk words, chunk a
// multiple of 4).  After a cluster.sync(), block r sums words
// [r * chunk, (r + 1) * chunk) of every block's copy through distributed
// shared memory (map_shared_rank, 16-byte reads) and hands each group of 4
// sums to the caller's flush, which adds the nonzero ones into global
// memory.  Global atomics fall from one per lane to one per touched word
// per cluster; the flushes of a word come from as many clusters as the
// grid holds, never from every lane.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

template <typename T>
struct OtVec4;
template <>
struct OtVec4<int32_t> {
  using type = int4;
};
template <>
struct OtVec4<float> {
  using type = float4;
};

// sums chunk words of the cluster's copies (hist4: this block's copy as
// 16-byte groups) and calls flush(first word, 4-word sum) for each group
// of this block's chunk; no block leaves while its copy may be read
template <typename T, typename Flush>
__device__ __forceinline__ void ot_cluster_sum(
    typename OtVec4<T>::type* hist4, int64_t chunk, Flush&& flush) {
  using V4 = typename OtVec4<T>::type;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's copy is complete
  const int64_t lo = static_cast<int64_t>(cluster.block_rank()) * chunk;
  const unsigned blocks = cluster.num_blocks();
  for (int64_t q = threadIdx.x; q < chunk / 4; q += blockDim.x) {
    V4 s{};
    for (unsigned b = 0; b < blocks; ++b) {
      const V4 v = cluster.map_shared_rank(hist4, b)[lo / 4 + q];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    flush(lo + 4 * q, s);
  }
  cluster.sync();  // no block leaves while its copy is read
}

// zero this block's copy of n4 16-byte groups, then __syncthreads()
template <typename V4>
__device__ __forceinline__ void ot_hist_zero(V4* hist4, int64_t n4) {
  for (int64_t w = threadIdx.x; w < n4; w += blockDim.x) hist4[w] = V4{};
  __syncthreads();
}

// clusters of a launch's shape (cfg's block and shared memory sizes, its
// first attribute the cluster size) the card holds at once, 0 when the
// query fails; asked once per
// kernel and shape (a host query, never a stream operation: safe while a
// graph captures).  A grid of more clusters runs the rest in a second
// wave, which doubles a privatized fold's time.
template <typename Kernel>
int64_t ot_max_clusters(cudaLaunchConfig_t cfg, Kernel kernel) {
  struct Seen {
    const void* fn;
    unsigned cluster, threads;
    size_t smem;
    int fit;
  };
  static Seen seen[64];
  static int n_seen = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const unsigned cluster = cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < n_seen; ++i) {
    const Seen& e = seen[i];
    if (e.fn == fn && e.cluster == cluster && e.threads == cfg.blockDim.x &&
        e.smem == cfg.dynamicSmemBytes) {
      return e.fit;
    }
  }
  cfg.gridDim = dim3(cluster);
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch reports its own status
    fit = 0;
  }
  if (n_seen < 64) {
    seen[n_seen++] = {fn, cluster, cfg.blockDim.x, cfg.dynamicSmemBytes, fit};
  }
  return fit;
}
