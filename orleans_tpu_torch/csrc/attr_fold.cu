// K7 attr_fold: one workload-attribution fold, in place.  For each lane
// with a nonzero increment, add it into counts[row] and into the row's
// hashed bucket at every sketch depth; add the sum of the increments into
// one int32 total (a slot counter, or a plan's lane total).
//
// Replaces, from orleans_tpu/tensor/attribution.py:
//   fold_batch :113      lane mode, counts + sketch + slot (the checked
//                        flush's mismatch folds, gated)
//   fold_counts :133     lane mode with no sketch: the fused window's
//                        per-tick fold (into the window's delta column)
//   fold_cms_dense :161  weighted mode: rows are implicit (row i of a
//                        dense per-row delta), weight = delta[i]; with
//                        counts given it also adds the delta into counts
//                        (the fused window's once-per-window fold)
//   _plan_kernel :174    lane mode into zeroed delta buffers, the lane
//                        total into a device scalar
// Lane mode: a lane counts 1 when valid and 0 <= row < cap.
//
// Optional gate: when given and *gate == 0 every block exits at once,
// before it touches anything (so no block of a cluster waits on one that
// left); otherwise the fold runs and block 0 adds 1 to *stale.  The
// checked flush (K8) writes one gate per stacked entry, so the host never
// learns which entries matched (the JAX lax.cond inside lax.scan).
//
// Bound on an H100: bytes, at the fold's shapes (a row, a valid byte and
// the touched words read and written once), but what holds a fold back
// is its atomics: global atomics on few words serialize in L2.
// Contention: the GameGrain fold lands about 100 lanes on each of 10,000
// rows and about 120 on each sketch bucket.  Design, chosen from shapes
// alone by kernels/attr.py fold_plan (a CUDA graph bakes the launch, so
// nothing is chosen from data):
//   * every path: a persistent grid, 4 lanes a thread, strided by 32 so
//     that each of a warp's loads and atomics covers 32 consecutive lanes
//     (16-byte loads of 4 adjacent lanes measured slower: a warp's atomic
//     then spans 4x the sectors, see PERF.md), the increments summed per
//     block and added into the total with ONE atomic per block;
//   * weighted mode: row i belongs to one thread alone, so counts[i] +=
//     weight[i] is a plain coalesced read-add-write, no atomic;
//   * direct: one global atomic per touched word (the PresenceGrain
//     counts fold: distinct rows over 2M words, nothing to privatize);
//   * cluster: a histogram that many lanes hit (GameGrain's 32,768
//     counts, a 4x8192 sketch) is privatized: every block of a
//     thread-block cluster (one block of 1,024 threads an SM) folds its
//     lanes into its own full copy in shared memory with shared-memory
//     atomics; after cluster.sync() block r sums chunk r of the
//     cluster's copies through distributed shared memory and adds each
//     nonzero sum into global memory with one atomic (cluster_hist.cuh,
//     shared with K4).  Global atomics fall from one per
//     lane and depth to one per touched word per cluster.  (Routing each
//     lane's increment straight into the owning block's words, one
//     remote atomic per lane, measured slower than direct global atomics
//     on an H100: see PERF.md.)
// The slot index and the seeds are kernel arguments, fixed per call site,
// so a CUDA graph may bake them.
#include <cooperative_groups.h>

#include "attr_common.cuh"
#include "cluster_hist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int F_THREADS = 256;           // direct path
constexpr int F_CLUSTER_THREADS = 1024;  // cluster path: one block an SM
constexpr int F_LANES = 4;
// dynamic shared memory a cluster block may take (set once at load)
constexpr int F_SMEM_MAX = 200 * 1024;

struct FoldArgs {
  int32_t* counts;
  int64_t cap;
  int32_t* cms;
  int depth;
  int64_t width;
  OtSeeds seeds;
  int32_t* total;
  const int32_t* rows;
  const uint8_t* valid;
  const int32_t* weight;
  int64_t m;
  const int32_t* gate;
  int32_t* stale;
  bool hist_counts;  // cluster path: the counts live in the histogram
  bool hist_cms;     // cluster path: the sketch lives in the histogram
  int64_t chunk;     // cluster path: words each block sums, a multiple of 4
};

// a warp's 4 lanes a thread: lane base + 32 j + (thread's lane in the
// warp), so each load and each atomic instruction of the warp covers 32
// consecutive lanes (rows in order land in few L2 sectors per atomic
// instruction, and in distinct shared-memory banks).  A run of 128 lanes
// inside m (warp-uniform) loads every lane's words at once, with no
// condition between the loads; weighted rows are implicit
template <bool WEIGHTED>
__device__ __forceinline__ void load_lanes(const FoldArgs& a, int64_t base,
                                           int32_t (&r)[F_LANES],
                                           int32_t (&inc)[F_LANES]) {
  const int64_t lane0 = base + (threadIdx.x & 31);
  const bool full = base + 32 * F_LANES <= a.m;
  if constexpr (WEIGHTED) {
    int32_t c[F_LANES];
#pragma unroll
    for (int j = 0; j < F_LANES; ++j) {
      const int64_t i = lane0 + 32 * j;
      r[j] = static_cast<int32_t>(i);
      const bool in = full || i < a.m;
      inc[j] = in ? a.weight[i] : 0;
      c[j] = in && a.counts != nullptr ? a.counts[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < F_LANES; ++j) {
      if (a.counts != nullptr && inc[j] != 0) a.counts[r[j]] = c[j] + inc[j];
    }
  } else {
    uint8_t v[F_LANES];
#pragma unroll
    for (int j = 0; j < F_LANES; ++j) {
      const int64_t i = lane0 + 32 * j;
      const bool in = full || i < a.m;
      r[j] = in ? a.rows[i] : -1;
      v[j] = in ? a.valid[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < F_LANES; ++j) {
      inc[j] = (v[j] != 0 && r[j] >= 0 && r[j] < a.cap) ? 1 : 0;
    }
  }
}

template <bool WEIGHTED, bool CLUSTER>
__global__ void __launch_bounds__(CLUSTER ? F_CLUSTER_THREADS : F_THREADS)
attr_fold_kernel(FoldArgs a) {
  if (a.gate != nullptr && *a.gate == 0) return;  // uniform: every block
  // cluster path: this block's copy of the histogram, the counts' rows
  // first when held, then the sketch's d * width + bucket; cluster size
  // times chunk words
  extern __shared__ int4 hist4[];
  int32_t* hist = reinterpret_cast<int32_t*>(hist4);
  __shared__ int warp_sums[32];
  const int64_t cms_word = a.hist_counts ? a.cap : 0;
  if (CLUSTER) {
    ot_hist_zero(hist4, cg::this_cluster().num_blocks() * a.chunk / 4);
  }
  const uint32_t width_mask = static_cast<uint32_t>(a.width - 1);
  int local = 0;
  // warp-uniform loop over runs of 32 * F_LANES lanes
  const int64_t run = 32 * F_LANES;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / 32 *
                         run;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / 32 * run;
       base < a.m; base += stride) {
    int32_t r[F_LANES], inc[F_LANES];
    load_lanes<WEIGHTED>(a, base, r, inc);
#pragma unroll
    for (int j = 0; j < F_LANES; ++j) {
      if (inc[j] == 0) continue;
      local += inc[j];
      if (!WEIGHTED) {
        if (CLUSTER && a.hist_counts) atomicAdd(hist + r[j], inc[j]);
        else atomicAdd(a.counts + r[j], inc[j]);
      }
      if (a.cms != nullptr) {
        for (int d = 0; d < a.depth; ++d) {
          const int64_t w = d * a.width +
                            ot_cms_bucket(r[j], a.seeds.s[d], width_mask);
          if (CLUSTER && a.hist_cms) atomicAdd(hist + cms_word + w, inc[j]);
          else atomicAdd(a.cms + w, inc[j]);
        }
      }
    }
  }
  if (a.total != nullptr) {
    const int sum = ot_block_sum(local, warp_sums);
    if (threadIdx.x == 0 && sum != 0) atomicAdd(a.total, sum);
  }
  if (CLUSTER) {
    const int64_t words = (a.hist_counts ? a.cap : 0) +
                          (a.hist_cms ? a.depth * a.width : 0);
    const auto add = [&](int64_t w, int32_t v) {
      if (w >= words || v == 0) return;
      if (w < cms_word) atomicAdd(a.counts + w, v);
      else atomicAdd(a.cms + (w - cms_word), v);
    };
    ot_cluster_sum<int32_t>(hist4, a.chunk, [&](int64_t w, int4 s) {
      add(w, s.x);
      add(w + 1, s.y);
      add(w + 2, s.z);
      add(w + 3, s.w);
    });
  }
  if (a.gate != nullptr && a.stale != nullptr && blockIdx.x == 0 &&
      threadIdx.x == 0) {
    atomicAdd(a.stale, 1);
  }
}

// blocks: whole clusters, cut to the clusters the card holds at once
template <bool WEIGHTED>
cudaError_t launch_cluster(const FoldArgs& a, unsigned blocks, int cluster,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(F_CLUSTER_THREADS);
  cfg.dynamicSmemBytes = sizeof(int32_t) * cluster * a.chunk;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int64_t fit = ot_max_clusters(cfg, attr_fold_kernel<WEIGHTED, true>);
  if (fit > 0 && fit * cluster < blocks) blocks = fit * cluster;
  cfg.gridDim = dim3(blocks);
  return cudaLaunchKernelEx(&cfg, attr_fold_kernel<WEIGHTED, true>, a);
}

}  // namespace

// Once, when the library loads (never while a graph captures): let the
// cluster variants take up to F_SMEM_MAX of dynamic shared memory and
// clusters of 16 where the card grants them.
OT_EXPORT int attr_fold_init() {
  for (const void* fn : {reinterpret_cast<const void*>(
                             attr_fold_kernel<false, true>),
                         reinterpret_cast<const void*>(
                             attr_fold_kernel<true, true>)}) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    // optional: a card without it keeps the portable 8
    if (cudaFuncSetAttribute(fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();
    }
  }
  return 0;
}

// rows/valid (lane mode) or weight (weighted mode, m == its length) is
// null; counts, cms, total, gate and stale may each be null.  cluster == 0
// takes the direct path; otherwise hist_counts/hist_cms say which targets
// the blocks' histograms hold, and each block of a cluster sums chunk
// words of them.  blocks_per_sm sizes the persistent grid.
OT_EXPORT int attr_fold(int32_t* counts, int64_t cap, int32_t* cms,
                        int depth, int64_t width, const uint32_t* seeds,
                        int32_t* total, const int32_t* rows,
                        const uint8_t* valid, const int32_t* weight,
                        int64_t m, const int32_t* gate, int32_t* stale,
                        int cluster, int hist_counts, int hist_cms,
                        int64_t chunk, int blocks_per_sm, void* stream) {
  const bool weighted = weight != nullptr;
  FoldArgs a{counts, cap, cms, depth, width, ot_seeds(seeds, depth), total,
             rows, valid, weight, m, gate, stale,
             cluster > 0 && hist_counts != 0, cluster > 0 && hist_cms != 0,
             chunk};
  const int64_t groups = (m + F_LANES - 1) / F_LANES;
  const int64_t sms = ot_sm_count();
  int threads = cluster > 0 ? F_CLUSTER_THREADS : F_THREADS;
  // direct path: smaller blocks for few lanes, so they spread over the
  // SMs (a weighted fold of 32,768 rows: 256 blocks of 32 threads, not
  // 32 blocks of 256)
  while (cluster == 0 && threads > 32 && groups < sms * threads) {
    threads /= 2;
  }
  int64_t blocks = (groups + threads - 1) / threads;
  const int64_t cap_blocks = sms * blocks_per_sm;
  blocks = blocks < cap_blocks ? blocks : cap_blocks;
  if (blocks < 1) blocks = 1;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (cluster > 0) {
    // whole clusters, at most blocks_per_sm blocks an SM
    blocks = (blocks + cluster - 1) / cluster;
    const int64_t most = cap_blocks / cluster > 0 ? cap_blocks / cluster : 1;
    blocks = (blocks < most ? blocks : most) * cluster;
    err = weighted ? launch_cluster<true>(a, blocks, cluster, st)
                   : launch_cluster<false>(a, blocks, cluster, st);
  } else if (weighted) {
    attr_fold_kernel<true, false><<<blocks, threads, 0, st>>>(a);
  } else {
    attr_fold_kernel<false, false><<<blocks, threads, 0, st>>>(a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
