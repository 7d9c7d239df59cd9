// Key -> row resolution of emitted messages against an arena's device
// directory mirror, plus the count of messages whose key is not active.
//
// Replaces orleans_tpu/tensor/engine.py _resolve_rows_dense_kernel (K1,
// resolve_dense) and _resolve_rows_kernel (K2, resolve_sorted).
//
// Bound on an H100: bytes.  Per lane the kernel reads a key (4 B) and a
// valid flag (1 B) and writes a row (4 B); the directory (dense map or
// sorted keys/rows) is small enough to sit in the 50 MB L2 after the
// first touches.  The miss count stays on the device (the engine reads it
// only at its miss-check drain).
//
// K1: one thread a lane (a 4-byte key load, a 1-byte valid load and a
// dependent gather) leaves few bytes in flight.  So each thread carries 4
// lanes: one 16-byte key load, one 4-byte load of their valid flags, 4
// independent gathers through L1 (__ldg), one 16-byte row store.  Lanes
// before the keys' first 16-byte boundary (head) are taken one by one, as
// are the lanes of the last partial group; where keys, valid flags and
// rows do not share their offset from those boundaries, every group loads
// word by word.  A persistent grid cut to the blocks the card holds at
// once; the miss count is summed per block and lands with ONE atomicAdd
// per block.  (Staging Presence's 64 KiB map in every block's shared
// memory measured slower on an H100: the copies cost more L2 traffic than
// the gathers they save, see PERF.md.)
//
// K2: a lower-bound search is a chain of dependent loads, and one search
// per thread leaves each warp waiting on one L1/L2 round trip a step,
// its lanes diverging on the loop's trip count.  So: a persistent grid
// (one or two blocks of 512 threads an SM) whose blocks each load the top
// of the search into shared memory once, as an Eytzinger tree of at most
// 4,095 splitters (every s-th key, s a power of two >= 8; the whole
// mirror when it has at most 4,095 keys); every lane descends it in the
// same number of branch-free steps; the last log2(s) steps run in L2,
// lifting over runs of 8 keys and ending on one 32-byte run read as two
// int4.  Each thread carries 4 lanes (16-byte key loads, 4-byte valid
// loads, a 16-byte row store where aligned), so 4 independent searches
// overlap their loads.  The miss count is summed per block and lands
// with ONE atomicAdd per block.
#include "common.cuh"
#include "resolve_tree.cuh"

namespace {

struct DenseArgs {
  const int32_t* dense;
  int32_t size;
  const int32_t* keys;
  const uint8_t* valid;
  int32_t* rows;
  int32_t* miss_count;
  int64_t m;
  int64_t head;  // lanes before the 16-byte groups (0 unless vec)
  bool vec;      // keys, rows + head 16-byte, valid + head 4-byte aligned
};

// one lane's row (-1 unless it resolves), counting a miss
__device__ __forceinline__ int32_t dense_row(const DenseArgs& a, int32_t k,
                                             bool v, int& misses) {
  const bool live = v && k < OT_KEY_SENTINEL;
  const bool in_range = live && k >= 0 && k < a.size;
  const int32_t r = in_range ? __ldg(a.dense + k) : -1;
  misses += (in_range && r >= 0) != live;
  return r;
}

__global__ void __launch_bounds__(1024)
resolve_dense_kernel(DenseArgs a) {
  __shared__ int warp_sums[32];
  int local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (first < a.head) {
    a.rows[first] = dense_row(a, a.keys[first], a.valid[first], local);
  }
  const int64_t groups = (a.m - a.head + 3) / 4;
  for (int64_t g = first; g < groups; g += stride) {
    const int64_t base = a.head + 4 * g;
    const bool full = a.vec && base + 4 <= a.m;
    int32_t k[4];
    bool v[4];
    if (full) {
      const int4 kk = *reinterpret_cast<const int4*>(a.keys + base);
      const uchar4 vv = *reinterpret_cast<const uchar4*>(a.valid + base);
      k[0] = kk.x; k[1] = kk.y; k[2] = kk.z; k[3] = kk.w;
      v[0] = vv.x; v[1] = vv.y; v[2] = vv.z; v[3] = vv.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = base + j < a.m;
        k[j] = in ? a.keys[base + j] : 0;
        v[j] = in && a.valid[base + j];
      }
    }
    int32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = dense_row(a, k[j], v[j], local);
    if (full) {
      *reinterpret_cast<int4*>(a.rows + base) = make_int4(r[0], r[1], r[2],
                                                          r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base + j < a.m) a.rows[base + j] = r[j];
      }
    }
  }
  // one atomic per block
  const int sum = ot_block_sum(local, warp_sums);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(a.miss_count, sum);
}

// -- K2 ----------------------------------------------------------------------
// The sorted mirror's search tree (resolve_tree.cuh), its splitters the
// first key of every bucket after the first (LAST = 0): the leaf b holds
// the lower bound in (b << log_s, (b + 1) << log_s], searched in global
// memory (L2) by lifting over sub-buckets of 8 keys, then one 32-byte run
// of 8 keys loaded as two int4.
constexpr int R_THREADS = 512;
constexpr int R_LANES = 4;
constexpr int32_t R_INF = OT_TREE_INF;

struct SortedArgs {
  const int32_t* sk;
  const int32_t* sr;
  int32_t n;
  int levels;      // the tree's depth: 2**levels - 1 nodes
  int log_s;       // bucket width 2**log_s (>= 8 unless WHOLE)
  bool vec_lanes;  // keys 16-byte, valid 4-byte and rows 16-byte aligned
  bool vec_bucket; // sk 16-byte aligned and n % 8 == 0
  const int32_t* keys;
  const uint8_t* valid;
  int32_t* rows;
  int32_t* miss_count;
  int64_t m;
};

// the lower bound of k, and the key there (R_INF past the end), for one
// lane, given the tree leaf b and the successor `upper` the descent found
template <bool WHOLE>
__device__ __forceinline__ int32_t bucket_search(const SortedArgs& a,
                                                 int32_t k, int32_t b,
                                                 int32_t& upper) {
  if (WHOLE) return b;
  int32_t pos = b << a.log_s;
  // lift over sub-buckets of 8: sk[pos] < k (or pos == 0) and
  // sk[pos + step] == upper hold at every step
  for (int step = (1 << a.log_s) >> 1; step >= 8; step >>= 1) {
    const int32_t cand = pos + step;
    const int32_t v = cand < a.n ? __ldg(a.sk + cand) : R_INF;
    const bool lt = v < k;
    pos = lt ? cand : pos;
    upper = lt ? upper : v;
  }
  int32_t vals[8];
  if (a.vec_bucket) {
    const int4 lo = __ldg(reinterpret_cast<const int4*>(a.sk + pos));
    const int4 hi = __ldg(reinterpret_cast<const int4*>(a.sk + pos) + 1);
    vals[0] = lo.x; vals[1] = lo.y; vals[2] = lo.z; vals[3] = lo.w;
    vals[4] = hi.x; vals[5] = hi.y; vals[6] = hi.z; vals[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vals[j] = pos + j < a.n ? __ldg(a.sk + pos + j) : R_INF;
    }
  }
  int32_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool lt = vals[j] < k;
    c += lt;
    upper = (!lt && vals[j] < upper) ? vals[j] : upper;
  }
  return pos + c;
}

template <bool WHOLE>
__global__ void __launch_bounds__(R_THREADS)
resolve_sorted_kernel(SortedArgs a) {
  extern __shared__ int32_t tree[];  // nodes 1 .. 2**levels - 1
  __shared__ int warp_sums[R_THREADS / 32];
  ot_tree_fill(tree, a.levels, WHOLE, a.log_s, 0, a.sk, a.n);
  __syncthreads();

  int local = 0;
  const int64_t groups = (a.m + R_LANES - 1) / R_LANES;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t base = g * R_LANES;
    const bool full = a.vec_lanes && base + R_LANES <= a.m;
    int32_t k[R_LANES];
    bool v[R_LANES];
    if (full) {
      const int4 kk = *reinterpret_cast<const int4*>(a.keys + base);
      const uchar4 vv = *reinterpret_cast<const uchar4*>(a.valid + base);
      k[0] = kk.x; k[1] = kk.y; k[2] = kk.z; k[3] = kk.w;
      v[0] = vv.x; v[1] = vv.y; v[2] = vv.z; v[3] = vv.w;
    } else {
#pragma unroll
      for (int j = 0; j < R_LANES; ++j) {
        const bool in = base + j < a.m;
        k[j] = in ? a.keys[base + j] : 0;
        v[j] = in && a.valid[base + j];
      }
    }
    // the four descents interleaved
    int32_t node[R_LANES], upper[R_LANES];
    ot_tree_descend<R_LANES>(tree, a.levels, k, node, upper);
    int32_t out[R_LANES];
#pragma unroll
    for (int j = 0; j < R_LANES; ++j) {
      const int32_t idx =
          bucket_search<WHOLE>(a, k[j], node[j] - (1 << a.levels), upper[j]);
      const bool live = v[j] && k[j] < OT_KEY_SENTINEL;
      // past the end the clipped index holds a key below k: a miss
      const bool hit = live && idx < a.n && upper[j] == k[j];
      out[j] = hit ? __ldg(a.sr + idx) : -1;
      local += hit != live;
    }
    if (full) {
      *reinterpret_cast<int4*>(a.rows + base) =
          make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < R_LANES; ++j) {
        if (base + j < a.m) a.rows[base + j] = out[j];
      }
    }
  }
  // one atomic per block
  const int sum = ot_block_sum(local, warp_sums);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(a.miss_count, sum);
}

}  // namespace

// threads a block (a multiple of 32, at most 1,024), at most
// blocks_per_sm blocks an SM (fewer where the SM holds fewer at once)
OT_EXPORT int resolve_dense(const int32_t* dense, int32_t size,
                            const int32_t* keys, const uint8_t* valid,
                            int32_t* rows, int32_t* miss_count, int64_t m,
                            int threads, int blocks_per_sm, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || blocks_per_sm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto at = [](const void* p) {
    return static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) % 16);
  };
  // keys' lanes before their first 16-byte boundary; the 4-lane groups
  // after it are 16-byte loads and stores where rows and valid agree
  int64_t head = (16 - at(keys)) % 16 / 4;
  if (head > m) head = m;
  const bool vec = head < m && (at(rows) + 4 * head) % 16 == 0 &&
                   (at(valid) + head) % 4 == 0;
  if (!vec) head = 0;
  const DenseArgs a{dense, size, keys, valid, rows, miss_count, m, head, vec};
  const int64_t groups = (m - head + 3) / 4;
  int64_t blocks = (groups + threads - 1) / threads;
  const int fit = ot_max_blocks(resolve_dense_kernel, threads);
  const int64_t cap = static_cast<int64_t>(ot_sm_count()) *
                      (fit < blocks_per_sm ? fit : blocks_per_sm);
  blocks = blocks < cap ? blocks : cap;
  if (blocks < 1) blocks = 1;
  resolve_dense_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// levels/log_s/whole: the tree plan of kernels/resolve.py resolve_plan;
// blocks_per_sm: the persistent grid's blocks on each SM
OT_EXPORT int resolve_sorted(const int32_t* sorted_keys,
                             const int32_t* sorted_rows, int32_t n_sorted,
                             const int32_t* keys, const uint8_t* valid,
                             int32_t* rows, int32_t* miss_count, int64_t m,
                             int whole, int levels, int log_s,
                             int blocks_per_sm, void* stream) {
  const auto aligned = [](const void* p, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(p) % to == 0;
  };
  SortedArgs a{sorted_keys, sorted_rows, n_sorted, levels, log_s,
               aligned(keys, 16) && aligned(valid, 4) && aligned(rows, 16),
               aligned(sorted_keys, 16) && n_sorted % 8 == 0,
               keys, valid, rows, miss_count, m};
  const int64_t groups = (m + R_LANES - 1) / R_LANES;
  int64_t blocks = (groups + R_THREADS - 1) / R_THREADS;
  const int64_t cap = static_cast<int64_t>(ot_sm_count()) * blocks_per_sm;
  blocks = blocks < cap ? blocks : cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(int32_t) << levels;
  const auto st = static_cast<cudaStream_t>(stream);
  if (whole) {
    resolve_sorted_kernel<true><<<blocks, R_THREADS, smem, st>>>(a);
  } else {
    resolve_sorted_kernel<false><<<blocks, R_THREADS, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
