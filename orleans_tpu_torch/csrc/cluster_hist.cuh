// Privatized histograms combined over a thread-block cluster, shared by
// K4 seg_sum (segment.cu), K7 attr_fold (attr_fold.cu) and K3 row_scatter
// (scatter.cu).
//
// Every block of a cluster folds its lanes into its own full copy of a
// histogram in shared memory (cluster size times chunk words, chunk a
// multiple of 4).  After a cluster.sync(), block r combines words
// [r * chunk, (r + 1) * chunk) of every block's copy through distributed
// shared memory (map_shared_rank, 16-byte reads) and hands each group of 4
// results to the caller's flush, which applies the touched ones to global
// memory.  The combine is a sum unless the caller names another (K3's
// MAX takes the maximum of int32 words).  Global atomics fall from one per
// lane to one per touched word per cluster; the flushes of a word come
// from as many clusters as the grid holds, never from every lane.
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

// the combines of ot_cluster_sum: an identity and a 4-word step
struct OtSum {
  template <typename V4>
  __device__ static V4 identity() {
    return V4{};
  }
  template <typename V4>
  __device__ static void add(V4& s, const V4& v) {
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
};

struct OtMaxI32 {
  template <typename V4>
  __device__ static V4 identity() {
    return make_int4(INT32_MIN, INT32_MIN, INT32_MIN, INT32_MIN);
  }
  template <typename V4>
  __device__ static void add(V4& s, const V4& v) {
    s.x = max(s.x, v.x);
    s.y = max(s.y, v.y);
    s.z = max(s.z, v.z);
    s.w = max(s.w, v.w);
  }
};

// combines chunk words of the cluster's copies (hist4: this block's copy
// as 16-byte groups; Combine: OtSum unless named) and calls flush(first
// word, 4-word result) for each group of this block's chunk; no block
// leaves while its copy may be read
template <typename T, typename Combine = OtSum, typename Flush>
__device__ __forceinline__ void ot_cluster_sum(
    typename OtVec4<T>::type* hist4, int64_t chunk, Flush&& flush) {
  using V4 = typename OtVec4<T>::type;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's copy is complete
  const int64_t lo = static_cast<int64_t>(cluster.block_rank()) * chunk;
  const unsigned blocks = cluster.num_blocks();
  for (int64_t q = threadIdx.x; q < chunk / 4; q += blockDim.x) {
    V4 s = Combine::template identity<V4>();
    for (unsigned b = 0; b < blocks; ++b) {
      Combine::add(s, cluster.map_shared_rank(hist4, b)[lo / 4 + q]);
    }
    flush(lo + 4 * q, s);
  }
  cluster.sync();  // no block leaves while its copy is read
}

// fill this block's copy of n4 16-byte groups with `fill` (zero unless
// given), then __syncthreads()
template <typename V4>
__device__ __forceinline__ void ot_hist_zero(V4* hist4, int64_t n4,
                                             V4 fill = V4{}) {
  for (int64_t w = threadIdx.x; w < n4; w += blockDim.x) hist4[w] = fill;
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
