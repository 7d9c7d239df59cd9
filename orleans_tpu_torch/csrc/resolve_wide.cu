// Wide (hi, lo) key -> row resolution of emitted messages against an
// arena's two-level wide-key mirror, plus the count of messages whose key
// is not active.
//
// Replaces orleans_tpu/tensor/engine.py _resolve_rows_wide_kernel with its
// hash _mix32_dev (K10, resolve_wide).  A grain key in [0, 2^63) rides as
// two int32 words; the mirror holds the 30-bit hashes of the live keys in
// ascending order (padded with INT32_MAX), the row of each hash, and the
// two words of the key of every row.  Per lane: hash the words (uint32
// multiply, xor, shift — CUDA's unsigned multiply wraps mod 2^32, which is
// exactly the reference's uint32 arithmetic), lower-bound the hash in the
// sorted hashes, then check up to WIDE_PROBES candidates at idx .. idx+3
// (each index clipped to n-1, as the reference clips) against the full
// words; the first match wins.  The hashes are sorted, so a probe whose
// hash differs ends the lane's probes: no later one can match.
//
// Narrow-into-wide mode (hi == nullptr): an int32 key k is the wide key
// (0, k), and keys >= the sentinel are padding, never lookups.
//
// Bound on an H100: bytes.  Per lane the kernel reads two words (8 B) and a
// valid flag (1 B) and writes a row (4 B); the mirror (16 B per arena row)
// sits in the 50 MB L2 after the first touches.  A lower-bound search is a
// chain of dependent loads, and one lane a thread (the port's first
// version) left each warp waiting on one L1/L2 round trip a step.
// Design, K2's search (resolve_tree.cuh) with its plan from
// kernels/resolve.py resolve_plan:
//   * a persistent grid (one or two blocks of 512 threads an SM), each
//     block loading the top of the search into shared memory once, its
//     threads' first lanes already in flight: the whole mirror when it has
//     at most 4,095 keys, else the LAST key of every bucket of s = 2**log_s
//     >= 8 keys, so the leaf is the bucket that holds the lower bound;
//   * 4 lanes a thread: 16-byte word loads and row stores, a 4-byte valid
//     load, four descents interleaved, so four searches' loads overlap;
//     the lanes before the words' first 16-byte boundary (head) and the
//     last partial group go one by one, and every group does where the
//     views do not share their offset from those boundaries;
//   * the bucket lifted in L2 over sub-buckets of 8 by their last keys,
//     then one 32-byte run of the hashes and, in parallel, the same run
//     of rows_by_h: the first probe's hash and candidate row come from
//     registers (in whole mode the descent's successor is the hash, and
//     the row one gather), so the only other dependent load is the
//     candidate's key, one 8-byte load where the arena keeps the two word
//     columns interleaved (tensor/arena.py device_index_wide); a collision
//     or a missing row probes on in global memory;
//   * the miss count summed per block and landed with ONE atomicAdd per
//     block into the given counter (a fused window's running total, or a
//     fresh zeroed scalar from the wrapper's pool).
#include "common.cuh"
#include "resolve_tree.cuh"

namespace {

constexpr int WIDE_PROBES = 4;
constexpr int W_THREADS = 512;
constexpr int W_LANES = 4;
constexpr int W_RUN = 8;  // keys of the 32-byte run

__device__ __forceinline__ int32_t mix32(uint32_t hi, uint32_t lo) {
  uint32_t h = (hi * 0x85EBCA6Bu) ^ (lo * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x27D4EB2Fu;
  h ^= h >> 13;
  return static_cast<int32_t>(h & 0x3FFFFFFFu);
}

struct WideArgs {
  const int32_t* sorted_h;
  const int32_t* rows_by_h;
  int32_t n;
  const int32_t* hi_col;
  const int32_t* lo_col;
  int32_t cap;
  int col_stride;  // words between a column's rows: 1, or 2 interleaved
  bool pair;       // interleaved and 8-byte aligned: one int2 a row
  const int32_t* hi;  // nullptr: narrow mode
  const int32_t* lo;
  const uint8_t* valid;
  int32_t* rows;
  int32_t* miss_count;
  int64_t m;
  int64_t head;   // lanes before the W_LANES groups (0 unless vec)
  int64_t groups; // the head (when there is one), then groups of 4 lanes
  bool vec;       // lo, hi, rows + head 16-byte, valid + head 4-byte aligned
  int levels;     // the tree's depth: 2**levels - 1 nodes
  int log_s;      // bucket width 2**log_s (>= 8 unless WHOLE)
  bool vec_run;   // sorted_h, rows_by_h 16-byte aligned and n % 8 == 0
};

// one thread's lanes [base, end): the key words and valid flags
struct Group {
  int64_t base, end;
  bool full;
  int32_t lo[W_LANES], hi[W_LANES];
  bool v[W_LANES];
};

__device__ __forceinline__ void load_group(const WideArgs& a, int64_t g,
                                           Group& x) {
  const bool has_head = a.head > 0;
  const bool is_head = has_head && g == 0;
  x.base = is_head ? 0 : a.head + W_LANES * (g - has_head);
  x.end = is_head ? a.head
                  : (x.base + W_LANES < a.m ? x.base + W_LANES : a.m);
  x.full = a.vec && !is_head && x.end - x.base == W_LANES;
  if (x.full) {
    const int4 l4 = *reinterpret_cast<const int4*>(a.lo + x.base);
    const int4 h4 = a.hi != nullptr
                        ? *reinterpret_cast<const int4*>(a.hi + x.base)
                        : make_int4(0, 0, 0, 0);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(a.valid + x.base);
    x.lo[0] = l4.x; x.lo[1] = l4.y; x.lo[2] = l4.z; x.lo[3] = l4.w;
    x.hi[0] = h4.x; x.hi[1] = h4.y; x.hi[2] = h4.z; x.hi[3] = h4.w;
    x.v[0] = v4.x; x.v[1] = v4.y; x.v[2] = v4.z; x.v[3] = v4.w;
  } else {
#pragma unroll
    for (int j = 0; j < W_LANES; ++j) {
      const bool in = x.base + j < x.end;
      x.lo[j] = in ? a.lo[x.base + j] : 0;
      x.hi[j] = in && a.hi != nullptr ? a.hi[x.base + j] : 0;
      x.v[j] = in && a.valid[x.base + j];
    }
  }
}

__device__ __forceinline__ int32_t select8(const int32_t (&v)[W_RUN],
                                           int c) {
  int32_t out = v[0];
#pragma unroll
  for (int q = 1; q < W_RUN; ++q) out = c == q ? v[q] : out;
  return out;
}

// the two words of the key of row cr (clipped): one 8-byte load where the
// columns are interleaved
__device__ __forceinline__ int2 key_words(const WideArgs& a, int32_t cr) {
  if (a.pair) {
    return __ldg(reinterpret_cast<const int2*>(a.hi_col) + cr);
  }
  const int64_t at = static_cast<int64_t>(cr) * a.col_stride;
  return make_int2(__ldg(a.hi_col + at), __ldg(a.lo_col + at));
}

// probes k0 .. WIDE_PROBES - 1 from the lower bound idx, in global memory:
// the rare path (a collision of 30-bit hashes, a missing row, or a lower
// bound the run did not hold)
__device__ int32_t probe_from(const WideArgs& a, int32_t idx, int k0,
                              int32_t h, int32_t w_hi, int32_t w_lo) {
  for (int k = k0; k < WIDE_PROBES; ++k) {
    const int64_t jj = static_cast<int64_t>(idx) + k;
    const int32_t j = jj < a.n - 1 ? static_cast<int32_t>(jj) : a.n - 1;
    if (__ldg(a.sorted_h + j) != h) return -1;  // sorted: none later
    const int32_t cand = __ldg(a.rows_by_h + j);
    if (cand < 0) continue;
    const int2 w = key_words(a, cand < a.cap - 1 ? cand : a.cap - 1);
    if (w.x == w_hi && w.y == w_lo) return cand;
  }
  return -1;
}

// one group's rows; adds its misses to local
template <bool WHOLE>
__device__ __forceinline__ void resolve_group(const WideArgs& a,
                                              const int32_t* tree,
                                              const Group& x, int& local) {
  bool v[W_LANES];
  int32_t h[W_LANES];
#pragma unroll
  for (int j = 0; j < W_LANES; ++j) {
    v[j] = x.v[j] && (a.hi != nullptr || x.lo[j] < OT_KEY_SENTINEL);
    h[j] = mix32(static_cast<uint32_t>(x.hi[j]),
                 static_cast<uint32_t>(x.lo[j]));
  }
  int32_t node[W_LANES], upper[W_LANES];
  ot_tree_descend<W_LANES>(tree, a.levels, h, node, upper);

  // the lower bound idx, the hash there (hv) and its row (cand); slow
  // where the run did not hold the lower bound
  int32_t idx[W_LANES], hv[W_LANES], cand[W_LANES];
  bool slow[W_LANES];
#pragma unroll
  for (int j = 0; j < W_LANES; ++j) {
    const int32_t leaf = node[j] - (1 << a.levels);
    slow[j] = false;
    if (WHOLE) {
      idx[j] = leaf;
      hv[j] = upper[j];  // OT_TREE_INF past the end: never a hash
      cand[j] = v[j] && hv[j] == h[j] ? __ldg(a.rows_by_h + leaf) : -1;
      continue;
    }
    int32_t pos = leaf << a.log_s;
    // lift: the lower bound lies in [pos, pos + 2 * step)
    for (int step = (1 << a.log_s) >> 1; step >= W_RUN; step >>= 1) {
      const int32_t c = pos + step;
      const int32_t last = c - 1 < a.n ? __ldg(a.sorted_h + c - 1)
                                       : OT_TREE_INF;
      pos = last < h[j] ? c : pos;
    }
    int32_t rh[W_RUN], rr[W_RUN];
    if (a.vec_run && pos < a.n) {
      const int4* h4 = reinterpret_cast<const int4*>(a.sorted_h + pos);
      const int4* r4 = reinterpret_cast<const int4*>(a.rows_by_h + pos);
      const int4 h0 = __ldg(h4), h1 = __ldg(h4 + 1);
      const int4 r0 = __ldg(r4), r1 = __ldg(r4 + 1);
      rh[0] = h0.x; rh[1] = h0.y; rh[2] = h0.z; rh[3] = h0.w;
      rh[4] = h1.x; rh[5] = h1.y; rh[6] = h1.z; rh[7] = h1.w;
      rr[0] = r0.x; rr[1] = r0.y; rr[2] = r0.z; rr[3] = r0.w;
      rr[4] = r1.x; rr[5] = r1.y; rr[6] = r1.z; rr[7] = r1.w;
    } else {
#pragma unroll
      for (int q = 0; q < W_RUN; ++q) {
        const bool in = pos + q < a.n;
        rh[q] = in ? __ldg(a.sorted_h + pos + q) : OT_TREE_INF;
        rr[q] = in ? __ldg(a.rows_by_h + pos + q) : -1;
      }
    }
    int c = 0;
#pragma unroll
    for (int q = 0; q < W_RUN; ++q) c += rh[q] < h[j];
    idx[j] = pos + c;
    slow[j] = c == W_RUN;
    hv[j] = select8(rh, c);
    cand[j] = select8(rr, c);
  }
  // the first candidate's key words, every lane's loads in flight
  int32_t col_hi[W_LANES], col_lo[W_LANES];
#pragma unroll
  for (int j = 0; j < W_LANES; ++j) {
    col_hi[j] = 0;
    col_lo[j] = 0;
    if (v[j] && !slow[j] && hv[j] == h[j] && cand[j] >= 0) {
      const int2 w = key_words(a, cand[j] < a.cap - 1 ? cand[j]
                                                      : a.cap - 1);
      col_hi[j] = w.x;
      col_lo[j] = w.y;
    }
  }
  int32_t r[W_LANES];
#pragma unroll
  for (int j = 0; j < W_LANES; ++j) {
    if (!v[j]) {
      r[j] = -1;
    } else if (slow[j]) {
      r[j] = probe_from(a, idx[j], 0, h[j], x.hi[j], x.lo[j]);
    } else if (hv[j] != h[j]) {
      r[j] = -1;
    } else if (cand[j] >= 0 && col_hi[j] == x.hi[j] &&
               col_lo[j] == x.lo[j]) {
      r[j] = cand[j];
    } else {
      r[j] = probe_from(a, idx[j], 1, h[j], x.hi[j], x.lo[j]);
    }
    local += v[j] && r[j] < 0;
  }
  if (x.full) {
    *reinterpret_cast<int4*>(a.rows + x.base) =
        make_int4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < W_LANES; ++j) {
      if (x.base + j < x.end) a.rows[x.base + j] = r[j];
    }
  }
}

template <bool WHOLE>
__global__ void __launch_bounds__(W_THREADS)
resolve_wide_kernel(WideArgs a) {
  extern __shared__ int32_t tree[];  // nodes 1 .. 2**levels - 1
  __shared__ int warp_sums[W_THREADS / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the first group's words are in flight while the block fills its tree
  Group cur;
  if (g < a.groups) load_group(a, g, cur);
  ot_tree_fill(tree, a.levels, WHOLE, a.log_s, 1, a.sorted_h, a.n);
  __syncthreads();

  int local = 0;
  for (bool first = true; g < a.groups; g += stride, first = false) {
    if (!first) load_group(a, g, cur);
    resolve_group<WHOLE>(a, tree, cur, local);
  }
  // one atomic per block
  const int sum = ot_block_sum(local, warp_sums);
  if (threadIdx.x == 0 && sum != 0) atomicAdd(a.miss_count, sum);
}

}  // namespace

// whole/levels/log_s: the tree plan of kernels/resolve.py resolve_plan;
// blocks_per_sm: the persistent grid's blocks on each SM
OT_EXPORT int resolve_wide(const int32_t* sorted_h, const int32_t* rows_by_h,
                           int32_t n, const int32_t* hi_col,
                           const int32_t* lo_col, int32_t cap,
                           int col_stride, const int32_t* hi,
                           const int32_t* lo, const uint8_t* valid,
                           int32_t* rows, int32_t* miss_count, int64_t m,
                           int whole,
                           int levels, int log_s, int blocks_per_sm,
                           void* stream) {
  if (levels < 1 || levels > 12 || blocks_per_sm < 1 ||
      (!whole && log_s < 3) || (col_stride != 1 && col_stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto at = [](const void* p) {
    return static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) % 16);
  };
  // lo's lanes before its first 16-byte boundary; the 4-lane groups after
  // it are 16-byte loads and stores where hi, rows and valid agree
  int64_t head = (16 - at(lo)) % 16 / 4;
  if (head > m) head = m;
  const bool vec = head < m && at(lo) % 4 == 0 &&
                   (hi == nullptr || at(hi) == at(lo)) &&
                   at(rows) == at(lo) && (at(valid) + head) % 4 == 0;
  if (!vec) head = 0;
  const int64_t groups = (head > 0) + (m - head + W_LANES - 1) / W_LANES;
  const bool pair = col_stride == 2 && lo_col == hi_col + 1 &&
                    at(hi_col) % 8 == 0;
  const WideArgs a{sorted_h, rows_by_h, n, hi_col, lo_col, cap, col_stride,
                   pair, hi, lo, valid, rows, miss_count, m, head, groups,
                   vec, levels, log_s,
                   at(sorted_h) == 0 && at(rows_by_h) == 0 && n % 8 == 0};
  int64_t blocks = (groups + W_THREADS - 1) / W_THREADS;
  const size_t smem = sizeof(int32_t) << levels;
  const auto kernel = whole ? resolve_wide_kernel<true>
                            : resolve_wide_kernel<false>;
  // one wave: at most the blocks an SM holds at once
  const int fit = ot_max_blocks(kernel, W_THREADS, smem);
  const int64_t cap_blocks = static_cast<int64_t>(ot_sm_count()) *
                             (fit < blocks_per_sm ? fit : blocks_per_sm);
  blocks = blocks < cap_blocks ? blocks : cap_blocks;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), W_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
