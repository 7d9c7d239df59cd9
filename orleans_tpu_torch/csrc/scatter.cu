// K3 row_scatter: col[rows] = v, += v or max= v into an arena state
// column in place, dropping every lane whose row is < 0 (padding, an
// unresolved miss) or >= n.  Each lane carries inner elements.
//
// Replaces orleans_tpu/tensor/vector_grain.py scatter_rows :238 and
// scatter_add_rows :253 and orleans_tpu/tensor/arena.py _touch_kernel :34;
// seg_max's scatter path (:194) is MAX into a column filled with the
// dtype's minimum.
//
// Bound on an H100: bytes (a row and a value read per lane, the touched
// words read and written once), but what holds ADD and MAX back is their
// atomics: global atomics on one word serialize in the L2 slice that owns
// it, so a word that many lanes hit costs their count in turn.  Presence's
// touch of its games lands ~100 lanes on each of 10,000 rows, the routing
// sample's touch of its sinks 4,096 lanes on each of 256 rows, its hot sink
// all 1,048,576 on one.  Design, chosen from shapes alone by
// kernels/scatter.py scatter_plan (a CUDA graph bakes the launch, so
// nothing is chosen from data):
//   * SET of one element a lane: 4 lanes a thread, 16-byte loads of rows
//     and values (values word by word where their address differs from
//     the rows' modulo 16), lanes before the rows' first 16-byte boundary
//     and after the last whole group taken one by one; 4 rows in a row
//     that start on a 16-byte boundary of the column store as one 16-byte
//     write.  Duplicate rows keep one writer, not a chosen one;
//   * direct ADD and MAX (and SET of [inner] lanes): 4 elements a thread
//     strided by 32, so each of a warp's loads and atomics covers 32
//     consecutive elements (4 adjacent elements a thread made a warp's
//     atomic span 4x the L2 sectors, see PERF.md).  A warp where no
//     lane shares its word with its neighbour or with lane 0 issues one
//     atomic an element (a match on every warp of random rows cost the
//     routing sweep 12%); otherwise lanes that share a word find each
//     other (__match_any_sync), combine by shuffles (a sum, or a maximum)
//     and one lane of each group issues the atomic.  MAX of a broadcast
//     scalar (the touch) in a warp whose words repeat first reads the word
//     from L2 (__ldcg) and skips the atomic where it already holds the
//     scalar or more: a stale read costs one atomic, never a wrong value
//     (on distinct words the read only added its latency: 0.0135 ms
//     against 0.0106 for Presence's players);
//   * privatized ADD and MAX (many elements a word, an output that fits a
//     block's shared memory): K4's shape (segment.cu).  A persistent grid
//     of thread-block clusters, cut to the clusters the card holds at once;
//     every block folds its elements into its own copy of the whole output
//     (ADD: sums, a warp on one word summing by shuffles first; MAX of
//     values: maxima of order-preserving int32 keys, from INT32_MIN; MAX of
//     a broadcast scalar: a mask of touched words, a plain store), the
//     cluster combines its copies through distributed shared memory
//     (cluster_hist.cuh) and flushes one global atomic per touched word.
// A scalar value (the heartbeat's tick) rides as a kernel argument, or,
// inside a CUDA graph, as ONE device element every thread reads through a
// pointer (values_step 0), so a replay reads the tick written before it.
// int32 ADD wraps; float32 MAX propagates NaN like XLA's max; float32 ADD
// sums in an order that changes from run to run (within Higham's bound).
#include <cooperative_groups.h>

#include "cluster_hist.cuh"

namespace cg = cooperative_groups;

namespace {

enum { OP_SET = 0, OP_ADD = 1, OP_MAX = 2 };
// privatized copies: sums, maxima of keys, a mask of touched words
enum { P_ADD = 0, P_MAX = 1, P_TOUCH = 2 };

constexpr int S_LANES = 4;
constexpr int S_MAX_THREADS = 1024;
// dynamic shared memory a privatized block may take (set once at load)
constexpr int S_SMEM_MAX = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t NAN_KEY = INT32_MAX;

template <typename T>
struct ScatterArgs {
  T* col;
  int64_t n;  // rows of the column
  const int32_t* rows;
  int64_t m;
  int64_t inner;
  const T* values;      // null: scalar for every element
  int64_t values_step;  // 0: every element reads *values, 1: values[e]
  T scalar;
  int64_t head;       // SET of one element a lane: lanes taken one by one
  bool vec_values;    // ... values 16-byte aligned where the rows are
  int64_t chunk;      // privatized: words each block of a cluster flushes
};

// (the launch asks it too)
template <typename T>
__host__ __device__ __forceinline__ bool lane_values(const ScatterArgs<T>& a) {
  return a.values != nullptr && a.values_step != 0;
}

// the value every element takes when no lane carries its own
template <typename T>
__device__ __forceinline__ T broadcast(const ScatterArgs<T>& a) {
  return a.values != nullptr && a.values_step == 0 ? *a.values : a.scalar;
}

// -- MAX --------------------------------------------------------------------
// an order-preserving int32 key of a value: int32 as it is; a float32's
// bits with the magnitude flipped where negative, NaN above everything.
// INT32_MIN is no float's key, so it marks an untouched word.
__device__ __forceinline__ int32_t max_key(int32_t v) { return v; }
__device__ __forceinline__ int32_t max_key(float v) {
  if (isnan(v)) return NAN_KEY;
  const int32_t b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

template <typename T>
__device__ __forceinline__ T from_key(int32_t k);
template <>
__device__ __forceinline__ int32_t from_key<int32_t>(int32_t k) {
  return k;
}
template <>
__device__ __forceinline__ float from_key<float>(int32_t k) {
  if (k == NAN_KEY) return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// whether max(old, v) differs from old (NaN propagates)
__device__ __forceinline__ bool raises(int32_t old, int32_t v) {
  return old < v;
}
__device__ __forceinline__ bool raises(float old, float v) {
  return !isnan(old) && (isnan(v) || old < v);
}

__device__ __forceinline__ void atomic_max(int32_t* addr, int32_t v) {
  atomicMax(addr, v);
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  if (isnan(v)) {  // max with NaN is NaN
    atomicExch(addr, v);
    return;
  }
  int* word = reinterpret_cast<int*>(addr);
  int old = atomicAdd(word, 0);  // coherent read of the current value
  while (!isnan(__int_as_float(old)) && __int_as_float(old) < v) {
    const int seen = atomicCAS(word, old, __float_as_int(v));
    if (seen == old) break;
    old = seen;
  }
}

// -- the element runs of a warp ----------------------------------------------
// S_LANES elements a thread: element base + 32 j + (the thread's lane in
// the warp); w is the element's column word, -1 where its row is dropped
// or it lies past the end.  A run of 128 elements inside the input
// (warp-uniform) loads with no condition between the loads.
template <typename T>
__device__ __forceinline__ void load_elems(const ScatterArgs<T>& a,
                                           int64_t base, T s,
                                           int64_t (&w)[S_LANES],
                                           T (&v)[S_LANES]) {
  const int64_t total = a.m * a.inner;
  const int64_t e0 = base + (threadIdx.x & 31);
  const bool full = base + 32 * S_LANES <= total;
  const bool own = lane_values(a);
  int32_t r[S_LANES];
  int64_t lane[S_LANES];
#pragma unroll
  for (int j = 0; j < S_LANES; ++j) {
    const int64_t e = e0 + 32 * j;
    const bool in = full || e < total;
    lane[j] = a.inner == 1 ? e : e / a.inner;
    r[j] = in ? a.rows[lane[j]] : -1;
    v[j] = in && own ? a.values[e] : s;
  }
#pragma unroll
  for (int j = 0; j < S_LANES; ++j) {
    const int64_t e = e0 + 32 * j;
    w[j] = r[j] >= 0 && r[j] < a.n
               ? static_cast<int64_t>(r[j]) * a.inner + (e - lane[j] * a.inner)
               : -1;
  }
}

__device__ __forceinline__ int64_t run_start() {
  return (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
         (32 * S_LANES);
}

__device__ __forceinline__ int64_t run_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x / 32 * (32 * S_LANES);
}

// -- combining inside a warp ------------------------------------------------
// x combined (op) over the lanes of `peers` (this lane's group, from
// __match_any_sync); the group's lowest lane ends with the whole.  Every
// lane of the warp calls it: a tree over each group, log2 of its size
// rounds.
template <typename U, typename Op>
__device__ __forceinline__ U combine_peers(unsigned peers, U x, Op op) {
  const unsigned lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, above != 0)) {
    const int next = __ffs(above);  // the nearest peer above, 1-based
    const U t = __shfl_sync(FULL, x, next > 0 ? next - 1 : lane);
    if (next > 0) x = op(x, t);
    // the lanes at odd places are summed into their left neighbours
    above &= __ballot_sync(FULL, (rel & 1) == 0);
    rel >>= 1;
  }
  return x;
}

struct Plus {
  template <typename U>
  __device__ U operator()(U a, U b) const { return a + b; }
};

struct Max {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return max(a, b);
  }
};

// one element of every lane of the warp into the column with global
// atomics (OP_ADD or OP_MAX; TOUCH: v is the broadcast scalar); every lane
// of the warp calls it
template <typename T, int OP, bool TOUCH>
__device__ __forceinline__ void issue(T* col, int64_t w, T v) {
  const unsigned lane = threadIdx.x & 31;
  // a warp combines where a lane shares its word with its neighbour or
  // with lane 0 (the low 32 bits compared: a false match only costs the
  // match below); repeats this misses go uncombined, never wrong
  const int32_t lo = static_cast<int32_t>(w);
  // every lane shuffles (a shuffle some lanes skip is undefined)
  const int32_t beside = __shfl_xor_sync(FULL, lo, 1);
  const int32_t first = __shfl_sync(FULL, lo, 0);
  const bool near = lo == beside || (lane != 0 && lo == first);
  const bool shared = __any_sync(FULL, w >= 0 && near);
  if (shared) {  // some lanes share a word
    const unsigned peers =
        __match_any_sync(FULL, static_cast<unsigned long long>(w));
    if constexpr (OP == OP_ADD) {
      v = combine_peers(peers, v, Plus());
    } else if constexpr (!TOUCH) {
      v = from_key<T>(combine_peers(peers, max_key(v), Max()));
    }
    if (peers & ((1u << lane) - 1u)) return;  // not the group's first lane
  }
  if (w < 0) return;
  if constexpr (OP == OP_ADD) {
    atomicAdd(col + w, v);
  } else if (!TOUCH || !shared || raises(__ldcg(col + w), v)) {
    // the touch reads first only where its words repeat: distinct words
    // rarely hold the tick already, and the read would cost its latency
    atomic_max(col + w, v);
  }
}

// -- direct paths -----------------------------------------------------------
template <typename T>
__device__ __forceinline__ void set_one(const ScatterArgs<T>& a, int64_t i,
                                        T s) {
  const int32_t r = a.rows[i];
  if (r >= 0 && r < a.n) a.col[r] = lane_values(a) ? a.values[i] : s;
}

// SET of one element a lane: lanes [head, head + 4 groups) as 16-byte
// groups, the few before and after one by one
template <typename T>
__global__ void __launch_bounds__(S_MAX_THREADS)
scatter_set_kernel(ScatterArgs<T> a) {
  using V4 = typename OtVec4<T>::type;
  const T s = broadcast(a);
  const int64_t groups = (a.m - a.head) / 4;
  const int64_t tail = a.m - a.head - 4 * groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (first < a.head + tail) {  // at most 6 lanes
    set_one(a, first < a.head ? first : a.m - tail + (first - a.head), s);
  }
  const int4* rows4 = reinterpret_cast<const int4*>(a.rows + a.head);
  const V4* vals4 = reinterpret_cast<const V4*>(a.values + a.head);
  const bool own = lane_values(a);
  for (int64_t g = first; g < groups; g += stride) {
    const int4 r4 = rows4[g];
    V4 v4;
    if (!own) {
      v4 = V4{s, s, s, s};
    } else if (a.vec_values) {
      v4 = vals4[g];
    } else {
      const T* v = a.values + a.head + 4 * g;
      v4 = V4{v[0], v[1], v[2], v[3]};
    }
    if (r4.x >= 0 && r4.w < a.n && r4.y == r4.x + 1 && r4.z == r4.x + 2 &&
        r4.w == r4.x + 3 &&
        (reinterpret_cast<uintptr_t>(a.col + r4.x) & 15) == 0) {
      *reinterpret_cast<V4*>(a.col + r4.x) = v4;  // 4 rows in a row
      continue;
    }
    if (r4.x >= 0 && r4.x < a.n) a.col[r4.x] = v4.x;
    if (r4.y >= 0 && r4.y < a.n) a.col[r4.y] = v4.y;
    if (r4.z >= 0 && r4.z < a.n) a.col[r4.z] = v4.z;
    if (r4.w >= 0 && r4.w < a.n) a.col[r4.w] = v4.w;
  }
}

// SET of [inner] lanes, and direct ADD / MAX: runs of 128 elements a warp
template <typename T, int OP, bool TOUCH>
__global__ void __launch_bounds__(S_MAX_THREADS)
scatter_direct_kernel(ScatterArgs<T> a) {
  const T s = broadcast(a);
  const int64_t total = a.m * a.inner;
  for (int64_t base = run_start(); base < total; base += run_stride()) {
    int64_t w[S_LANES];
    T v[S_LANES];
    load_elems(a, base, s, w, v);
#pragma unroll
    for (int j = 0; j < S_LANES; ++j) {
      if constexpr (OP == OP_SET) {
        if (w[j] >= 0) a.col[w[j]] = v[j];
      } else {
        issue<T, OP, TOUCH>(a.col, w[j], v[j]);
      }
    }
  }
}

// -- the privatized path ----------------------------------------------------
template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// one element of every lane into this block's copy (every lane calls it):
// a warp whose 32 elements share one word combines them by shuffles and
// updates the word once; otherwise each element updates its own
template <typename T, int MODE>
__device__ __forceinline__ void fold_word(void* hist, int32_t w, T v) {
  if constexpr (MODE == P_TOUCH) {
    if (w >= 0) static_cast<int32_t*>(hist)[w] = 1;
    return;
  }
  const int32_t w0 = __shfl_sync(FULL, w, 0);
  const bool one = __all_sync(FULL, w == w0);
  if constexpr (MODE == P_ADD) {
    T* h = static_cast<T*>(hist);
    if (one) {
      if (w0 >= 0) {
        const T sum = warp_sum(v);
        if ((threadIdx.x & 31) == 0) atomicAdd(h + w0, sum);
      }
    } else if (w >= 0) {
      atomicAdd(h + w, v);
    }
  } else {
    int32_t* h = static_cast<int32_t*>(hist);
    const int32_t k = max_key(v);
    if (one) {
      if (w0 >= 0) {
        const int32_t top = warp_max(k);
        if ((threadIdx.x & 31) == 0) atomicMax(h + w0, top);
      }
    } else if (w >= 0) {
      atomicMax(h + w, k);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(S_MAX_THREADS)
scatter_private_kernel(ScatterArgs<T> a) {
  using V4 = typename OtVec4<T>::type;
  extern __shared__ int4 smem4[];
  const int64_t n4 = cg::this_cluster().num_blocks() * a.chunk / 4;
  if constexpr (MODE == P_MAX) {
    ot_hist_zero(smem4, n4, make_int4(INT32_MIN, INT32_MIN, INT32_MIN,
                                      INT32_MIN));
  } else {
    ot_hist_zero(smem4, n4);  // zero in int32 and float32 alike
  }
  const T s = broadcast(a);
  const int64_t total = a.m * a.inner;
  for (int64_t base = run_start(); base < total; base += run_stride()) {
    int64_t w[S_LANES];
    T v[S_LANES];
    load_elems(a, base, s, w, v);
#pragma unroll
    for (int j = 0; j < S_LANES; ++j) {
      fold_word<T, MODE>(smem4, static_cast<int32_t>(w[j]), v[j]);
    }
  }
  const int64_t words = a.n * a.inner;
  T* col = a.col;
  if constexpr (MODE == P_ADD) {
    const auto add = [&](int64_t w, T x) {
      if (w < words && x != T(0)) atomicAdd(col + w, x);
    };
    ot_cluster_sum<T>(reinterpret_cast<V4*>(smem4), a.chunk,
                      [&](int64_t w, const V4& x) {
                        add(w, x.x);
                        add(w + 1, x.y);
                        add(w + 2, x.z);
                        add(w + 3, x.w);
                      });
  } else if constexpr (MODE == P_TOUCH) {
    const auto touch = [&](int64_t w, int32_t hit) {
      if (w < words && hit != 0) atomic_max(col + w, s);
    };
    ot_cluster_sum<int32_t>(smem4, a.chunk, [&](int64_t w, const int4& x) {
      touch(w, x.x);
      touch(w + 1, x.y);
      touch(w + 2, x.z);
      touch(w + 3, x.w);
    });
  } else {
    const auto top = [&](int64_t w, int32_t k) {
      if (w < words && k != INT32_MIN) atomic_max(col + w, from_key<T>(k));
    };
    ot_cluster_sum<int32_t, OtMaxI32>(smem4, a.chunk,
                                      [&](int64_t w, const int4& x) {
                                        top(w, x.x);
                                        top(w + 1, x.y);
                                        top(w + 2, x.z);
                                        top(w + 3, x.w);
                                      });
  }
}

// -- launches ---------------------------------------------------------------
template <typename Kernel, typename T>
cudaError_t launch_private(Kernel kernel, const ScatterArgs<T>& a,
                           int cluster, int threads, int64_t blocks,
                           int64_t cap, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = sizeof(int32_t) * cluster * a.chunk;
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
  const int64_t fit = ot_max_clusters(cfg, kernel);
  if (fit > 0 && fit < most) most = fit;
  const int64_t want = (blocks + cluster - 1) / cluster;
  cfg.gridDim = dim3(static_cast<unsigned>((want < most ? want : most) *
                                           cluster));
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// a direct grid stops at the blocks the card holds at once (40 registers
// a thread hold 6 blocks of 256 an SM, not 8): a second wave would run
// its blocks after the first
template <typename Kernel, typename T>
cudaError_t launch_direct(Kernel kernel, const ScatterArgs<T>& a,
                          int threads, int64_t blocks, int blocks_per_sm,
                          cudaStream_t stream) {
  const int fit = ot_max_blocks(kernel, threads);
  const int64_t cap = static_cast<int64_t>(ot_sm_count()) *
                      (fit < blocks_per_sm ? fit : blocks_per_sm);
  blocks = blocks < cap ? blocks : cap;
  kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), threads, 0,
           stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(ScatterArgs<T> a, int op, int cluster, int threads,
                   int blocks_per_sm, cudaStream_t stream) {
  const int64_t total = a.m * a.inner;
  const int64_t sms = ot_sm_count();
  const bool touch = op == OP_MAX && !lane_values(a);
  const bool set_vec = op == OP_SET && a.inner == 1;
  // threads each covering S_LANES elements
  int64_t work = (total + S_LANES - 1) / S_LANES;
  if (set_vec) {
    const auto addr = reinterpret_cast<uintptr_t>(a.rows);
    a.head = static_cast<int64_t>((16 - addr % 16) % 16 / 4);
    if (a.head > a.m) a.head = a.m;
    a.vec_values = lane_values(a) &&
                   reinterpret_cast<uintptr_t>(a.values + a.head) % 16 == 0;
    work = (a.m - a.head) / 4 + 6;  // groups, and the lanes around them
  }
  // few elements: smaller blocks, so they spread over the SMs
  while (cluster == 0 && threads > 32 && work < sms * threads) threads /= 2;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = sms * blocks_per_sm;
  if (cluster > 0) {
    blocks = blocks < cap ? blocks : cap;
    if (op == OP_ADD) {
      return launch_private(scatter_private_kernel<T, P_ADD>, a, cluster,
                            threads, blocks, cap, stream);
    }
    if (touch) {
      return launch_private(scatter_private_kernel<T, P_TOUCH>, a, cluster,
                            threads, blocks, cap, stream);
    }
    return launch_private(scatter_private_kernel<T, P_MAX>, a, cluster,
                          threads, blocks, cap, stream);
  }
  const auto direct = [&](auto kernel) {
    return launch_direct(kernel, a, threads, blocks, blocks_per_sm, stream);
  };
  if (set_vec) return direct(scatter_set_kernel<T>);
  if (op == OP_SET) return direct(scatter_direct_kernel<T, OP_SET, false>);
  if (op == OP_ADD) return direct(scatter_direct_kernel<T, OP_ADD, false>);
  if (touch) return direct(scatter_direct_kernel<T, OP_MAX, true>);
  return direct(scatter_direct_kernel<T, OP_MAX, false>);
}

template <typename T>
int row_scatter(T* col, int64_t n, const int32_t* rows, int64_t m,
                int64_t inner, const T* values, int64_t values_step,
                T scalar, int op, int cluster, int64_t chunk, int threads,
                int blocks_per_sm, void* stream) {
  if (op < OP_SET || op > OP_MAX || threads < 32 ||
      threads > S_MAX_THREADS || threads % 32 || blocks_per_sm < 1 ||
      cluster < 0 ||
      (cluster > 0 && (op == OP_SET || chunk < 4 || chunk % 4 ||
                       cluster * chunk < n * inner ||
                       4 * cluster * chunk > S_SMEM_MAX))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const ScatterArgs<T> a{col,    n,      rows,   m, inner, values,
                         values_step, scalar, 0, false, chunk};
  const cudaError_t err = launch(a, op, cluster, threads, blocks_per_sm,
                                 static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
cudaError_t allow_private() {
  const void* fn = reinterpret_cast<const void*>(
      scatter_private_kernel<T, MODE>);
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM_MAX);
  if (err != cudaSuccess) return err;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();  // optional: a card without it keeps 8
  }
  return cudaSuccess;
}

}  // namespace

// Once, when the library loads (never while a graph captures): let the
// privatized variants take up to S_SMEM_MAX of dynamic shared memory and
// clusters of 16 where the card grants them.
OT_EXPORT int row_scatter_init() {
  for (const cudaError_t err :
       {allow_private<int32_t, P_ADD>(), allow_private<int32_t, P_MAX>(),
        allow_private<int32_t, P_TOUCH>(), allow_private<float, P_ADD>(),
        allow_private<float, P_MAX>(), allow_private<float, P_TOUCH>()}) {
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// values == nullptr broadcasts `scalar` to every element; values_step 0
// broadcasts the one element `values` points to, 1 reads values[e].
// cluster == 0 takes a direct path; otherwise (ADD and MAX) every block
// holds a copy of cluster * chunk words (>= n * inner, chunk a multiple of
// 4) and block r of a cluster flushes words [r * chunk, (r + 1) * chunk).
// threads a block (a multiple of 32, at most 1,024), at most
// blocks_per_sm blocks an SM.
OT_EXPORT int row_scatter_i32(int32_t* col, int64_t n, const int32_t* rows,
                              int64_t m, int64_t inner,
                              const int32_t* values, int64_t values_step,
                              int32_t scalar, int op, int cluster,
                              int64_t chunk, int threads, int blocks_per_sm,
                              void* stream) {
  return row_scatter<int32_t>(col, n, rows, m, inner, values, values_step,
                              scalar, op, cluster, chunk, threads,
                              blocks_per_sm, stream);
}

OT_EXPORT int row_scatter_f32(float* col, int64_t n, const int32_t* rows,
                              int64_t m, int64_t inner, const float* values,
                              int64_t values_step, float scalar, int op,
                              int cluster, int64_t chunk, int threads,
                              int blocks_per_sm, void* stream) {
  return row_scatter<float>(col, n, rows, m, inner, values, values_step,
                            scalar, op, cluster, chunk, threads,
                            blocks_per_sm, stream);
}
