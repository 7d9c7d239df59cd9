// K4 seg_sum, the scatter path of a tick's fan-in: out[rows[i]] +=
// values[i] (each lane an [inner] vector) into a zero-initialised
// [n_rows, inner] output, dropping lanes whose row is < 0 (padding, an
// unresolved miss) or >= n_rows.
//
// Replaces orleans_tpu/tensor/vector_grain.py seg_sum :164, its scatter
// path (jax.ops.segment_sum).
//
// Bound on an H100: bytes (a value and a row read per lane, the output
// written once), but what holds a fan-in back is its atomics: global
// atomics on one word serialize in its L2 slice, so a word that many lanes
// hit costs their count in turn, and where the output lands among the
// slices sets the time (over 256 sinks one launch read 0.27 ms with its
// output 1 KiB-aligned and 0.13 ms 512 B past that).  Presence's game
// fan-in lands ~100 lanes on each of 10,000 rows; the routing sample's
// sinks take 4,096 lanes a word, its hot sink all 1,048,576 on one.
// Design, chosen from shapes alone by kernels/segment.py seg_plan (a CUDA
// graph bakes the launch, so nothing is chosen from data):
//   * direct (few lanes a word: Chirper's followers, banking's accounts,
//     columns as long as their lanes): one global atomic per element, one
//     element a thread per step of a grid of up to 32 blocks an SM (4
//     elements a thread strided by 32, as K7's direct path takes them,
//     measured 5% slower on Chirper's fan-in: see PERF.md);
//   * privatized (at least SEG_MIN_PER_WORD elements a word, an output
//     that fits a block's shared memory): a persistent grid sized from
//     the SM count, 4 elements a thread strided by 32, so each of a
//     warp's loads and shared-memory atomics covers 32 consecutive
//     elements (rows in order fall in distinct banks); every block folds
//     its elements into its own copy of the whole output with
//     shared-memory atomics;
//     a warp whose 32 elements share one word (the hot sink) first sums
//     them with shuffles and adds once.  Then the copies go to global
//     memory with one atomic per nonzero word: summed over a thread-block
//     cluster through distributed shared memory first (cluster_hist.cuh,
//     shared with K7; a cluster of 1 is a block flushing its own copy).
//     Global atomics fall from one per lane to one per touched word per
//     cluster, and with them the hot spots that made the time follow the
//     address.  The grid stops at the clusters the card holds at once.
// int32 sums are exact in any order; float32 sums come out in an order
// that changes from run to run (the caller's tolerance is Higham's bound
// for recursive summation, (k - 1) * 2^-24 * sum|x| for k terms).
#include <cooperative_groups.h>

#include "cluster_hist.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int S_LANES = 4;
constexpr int S_MAX_THREADS = 1024;
// dynamic shared memory a privatized block may take (set once at load)
constexpr int S_SMEM_MAX = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct SegArgs {
  const T* values;
  const int32_t* rows;
  int64_t m;
  int64_t inner;
  T* out;
  int64_t n_rows;
  int64_t chunk;  // privatized: words each block of a cluster flushes
};

// a warp's S_LANES elements a thread: element base + 32 j + (the thread's
// lane in the warp); w is the element's output word, -1 where its row is
// dropped or it lies past the end.  A run of 128 elements inside the
// input (warp-uniform) loads with no condition between the loads.
template <typename T>
__device__ __forceinline__ void load_elems(const SegArgs<T>& a, int64_t base,
                                           int64_t (&w)[S_LANES],
                                           T (&v)[S_LANES]) {
  const int64_t total = a.m * a.inner;
  const int64_t e0 = base + (threadIdx.x & 31);
  const bool full = base + 32 * S_LANES <= total;
  int32_t r[S_LANES];
  int64_t lane[S_LANES];
#pragma unroll
  for (int j = 0; j < S_LANES; ++j) {
    const int64_t e = e0 + 32 * j;
    const bool in = full || e < total;
    lane[j] = a.inner == 1 ? e : e / a.inner;
    r[j] = in ? a.rows[lane[j]] : -1;
    v[j] = in ? a.values[e] : T(0);
  }
#pragma unroll
  for (int j = 0; j < S_LANES; ++j) {
    const int64_t e = e0 + 32 * j;
    w[j] = r[j] >= 0 && r[j] < a.n_rows
               ? static_cast<int64_t>(r[j]) * a.inner + (e - lane[j] * a.inner)
               : -1;
  }
}

// the element runs of this warp: base, base + stride, ...
__device__ __forceinline__ int64_t run_start() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
         (32 * S_LANES);
}

__device__ __forceinline__ int64_t run_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x / 32 * (32 * S_LANES);
}

// one element a thread per step of a grid-stride loop: consecutive
// threads read consecutive lanes and add into their rows
template <typename T>
__global__ void __launch_bounds__(S_MAX_THREADS)
seg_direct_kernel(SegArgs<T> a) {
  const int64_t total = a.m * a.inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += stride) {
    const int64_t lane = a.inner == 1 ? e : e / a.inner;
    const int32_t r = a.rows[lane];
    if (r >= 0 && r < a.n_rows) {
      atomicAdd(a.out + static_cast<int64_t>(r) * a.inner + (e - lane * a.inner),
                a.values[e]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void flush_word(T* out, int64_t w, int64_t words,
                                           T v) {
  if (w < words && v != T(0)) atomicAdd(out + w, v);
}

// one element into this block's copy: a warp whose 32 elements share one
// word (every lane runs this together) sums them with shuffles and adds
// once; otherwise each element adds on its own
template <typename T>
__device__ __forceinline__ void fold_word(T* hist, int32_t w, T v) {
  const int32_t w0 = __shfl_sync(FULL, w, 0);
  if (__all_sync(FULL, w == w0)) {
    if (w0 >= 0) {
      const T s = warp_sum(v);
      if ((threadIdx.x & 31) == 0) atomicAdd(hist + w0, s);
    }
  } else if (w >= 0) {
    atomicAdd(hist + w, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(S_MAX_THREADS)
seg_private_kernel(SegArgs<T> a) {
  using V4 = typename OtVec4<T>::type;
  extern __shared__ int4 smem4[];
  V4* hist4 = reinterpret_cast<V4*>(smem4);
  T* hist = reinterpret_cast<T*>(smem4);
  ot_hist_zero(hist4, cg::this_cluster().num_blocks() * a.chunk / 4);
  const int64_t total = a.m * a.inner;
  for (int64_t base = run_start(); base < total; base += run_stride()) {
    int64_t w[S_LANES];
    T v[S_LANES];
    load_elems(a, base, w, v);
#pragma unroll
    for (int j = 0; j < S_LANES; ++j) {
      fold_word(hist, static_cast<int32_t>(w[j]), v[j]);
    }
  }
  const int64_t words = a.n_rows * a.inner;
  const auto flush4 = [&](int64_t w, const V4& s) {
    flush_word(a.out, w, words, s.x);
    flush_word(a.out, w + 1, words, s.y);
    flush_word(a.out, w + 2, words, s.z);
    flush_word(a.out, w + 3, words, s.w);
  };
  ot_cluster_sum<T>(hist4, a.chunk, flush4);
}

template <typename T>
cudaError_t launch(const SegArgs<T>& a, int cluster, int threads,
                   int blocks_per_sm, cudaStream_t stream) {
  const int64_t total = a.m * a.inner;
  const int64_t sms = ot_sm_count();
  // elements a thread takes per step: one on the direct path
  const int64_t groups = cluster == 0 ? total
                                      : (total + S_LANES - 1) / S_LANES;
  if (cluster == 0) {
    // few elements: smaller blocks, so they spread over the SMs
    while (threads > 32 && groups < sms * threads) threads /= 2;
  }
  int64_t blocks = (groups + threads - 1) / threads;
  const int64_t cap = sms * blocks_per_sm;
  blocks = blocks < cap ? blocks : cap;
  if (blocks < 1) blocks = 1;
  if (cluster == 0) {
    seg_direct_kernel<T><<<blocks, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(T) * cluster * a.chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // whole clusters, no more than the card holds at once: a grid past
  // that runs its last clusters in a second wave
  int64_t most = cap / cluster > 0 ? cap / cluster : 1;
  const int64_t fit = ot_max_clusters(cfg, seg_private_kernel<T>);
  if (fit > 0 && fit < most) most = fit;
  const int64_t want = (blocks + cluster - 1) / cluster;
  blocks = (want < most ? want : most) * cluster;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  return cudaLaunchKernelEx(&cfg, seg_private_kernel<T>, a);
}

template <typename T>
int seg_sum(const T* values, const int32_t* rows, int64_t m, int64_t inner,
            T* out, int64_t n_rows, int cluster, int64_t chunk, int threads,
            int blocks_per_sm, void* stream) {
  if (threads < 32 || threads > S_MAX_THREADS || threads % 32 ||
      cluster < 0 || (cluster > 0 && (chunk < 4 || chunk % 4 ||
                                      cluster * chunk < n_rows * inner))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SegArgs<T> a{values, rows, m, inner, out, n_rows, chunk};
  const cudaError_t err = launch(a, cluster, threads, blocks_per_sm,
                                 static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Once, when the library loads (never while a graph captures): let the
// privatized variants take up to S_SMEM_MAX of dynamic shared memory and
// clusters of 16 where the card grants them.
OT_EXPORT int seg_sum_init() {
  for (const void* fn : {
           reinterpret_cast<const void*>(seg_private_kernel<int32_t>),
           reinterpret_cast<const void*>(seg_private_kernel<float>)}) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cudaFuncSetAttribute(fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();  // optional: a card without it keeps 8
    }
  }
  return 0;
}

// out: zero-initialised by the caller.  cluster == 0 takes the direct
// path; otherwise every block holds a copy of cluster * chunk words
// (>= n_rows * inner, chunk a multiple of 4) and block r of a cluster
// flushes words [r * chunk, (r + 1) * chunk).  threads a block (a multiple
// of 32, at most 1,024), at most blocks_per_sm blocks an SM.
OT_EXPORT int seg_sum_i32(const int32_t* values, const int32_t* rows,
                          int64_t m, int64_t inner, int32_t* out,
                          int64_t n_rows, int cluster, int64_t chunk,
                          int threads, int blocks_per_sm, void* stream) {
  return seg_sum<int32_t>(values, rows, m, inner, out, n_rows, cluster,
                          chunk, threads, blocks_per_sm, stream);
}

OT_EXPORT int seg_sum_f32(const float* values, const int32_t* rows,
                          int64_t m, int64_t inner, float* out,
                          int64_t n_rows, int cluster, int64_t chunk,
                          int threads, int blocks_per_sm, void* stream) {
  return seg_sum<float>(values, rows, m, inner, out, n_rows, cluster, chunk,
                        threads, blocks_per_sm, stream);
}
