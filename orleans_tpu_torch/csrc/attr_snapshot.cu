// K9 attr_snapshot: the device half of an attribution snapshot of one
// arena's counts column, every output reduced on the device so the host
// reads a few dozen int64 words.
//
// Replaces orleans_tpu/tensor/attribution.py _snapshot_kernel :257:
//   total, nnz (rows with a count > 0), per-shard sums; top_k of the
//   counts with ties ordered lower row first (jax.lax.top_k's order); p99
//   of the ascending counts at clip(cap - nnz + (nnz - 1) * 99 // 100);
//   Gini over the nonzero rows, sum((2·rank - nnz - 1)·s) / (nnz·total)
//   in float32; mean over the nonzero rows; and the count-min estimate of
//   each top row, the minimum of its hashed buckets over the depths.
// Output, int64 [3k + n_shards + 5]: vals[k] | rows[k] | est[k] |
// shard[n_shards] | total | nnz | p99 | gini | mean_nz, the last two as
// the bit patterns of float32 values.
//
// What bounds it on an H100: bytes.  The least any design moves is the
// counts read once (4 B a row, 0.0025 ms for both Presence arenas), but
// p99 and Gini need the ascending order of the counts, and no sort reaches
// one read.  The first design sorted (count, row) pairs as 8-byte keys
// with a bitonic network, O(n log² n) work in ~55 dependent launches at
// 2^21 rows; its time was those launches.  This design:
//   1. one pass over the counts: total, nnz, the shard sums and the four
//      8-bit digit histograms of the order key u = count ^ 0x80000000
//      (negative counts order right), built per block in shared memory
//      with warp-aggregated atomics and merged with global atomics; the
//      last block to land writes which digits need a pass;
//   2. an LSD radix sort of the 4-byte keys alone, no row payload: a
//      digit whose histogram has one nonzero bin is skipped on the device
//      (counts below 2^16 take two passes, a column of two values one;
//      a skipped pass is a launch whose blocks leave at once).
//      Each pass is one sweep: a block takes the next tile of 4096 keys
//      (an atomic tile counter, so every tile it waits on is running),
//      ranks them stably by digit in shared memory (__match_any_sync per
//      warp, per-warp bin prefixes), finds its global offset per bin by
//      decoupled look-back over the earlier tiles' published counts, and
//      scatters into a ping-pong buffer.  Gini and p99 read the ascending
//      values; ties do not change the Gini sum, whose float64 partials sit
//      on a fixed grid summed in order, so it does not depend on
//      scheduling;
//   3. the top-k without sorting the rows: T = s[cap - k] is the k-th
//      largest count; a compaction over the counts in row order keeps
//      every row with c > T (fewer than k) and the first k - n_above rows
//      with c == T, at positions from per-block counts; then one block
//      sorts the k candidates in shared memory by (count descending, row
//      ascending) and gathers the sketch estimates.  A k above kSmallK
//      sorts its candidates with the same radix passes carrying the row.
// About 8 launches and 50-60 MB at 2^21 rows, against ~65 launches before.
#include "attr_common.cuh"

namespace {

constexpr int kThreads = 256;   // every multi-block kernel; == kBins
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerThread = 16;
constexpr int kTile = kThreads * kKeysPerThread;  // keys a pass block ranks
constexpr int kBins = 256;
constexpr int kDigits = 4;
constexpr int kGiniBlocks = 264;  // fixed: the partials' order, the chunks
constexpr int kSmallK = 2048;     // candidates one block sorts itself
constexpr uint32_t kAsc = 0x80000000u;   // count ^ kAsc: ascending order
constexpr uint32_t kDesc = 0x7fffffffu;  // count ^ kDesc: descending
constexpr unsigned kFull = 0xffffffffu;

// the digits of a sort that need a pass (histogram with more than one
// nonzero bin), in ascending order: the scan's last block writes them as
// int32 words n | digit[4], which every later kernel reads
struct Plan {
  int n;
  int digit[kDigits];
};

__device__ Plan load_plan(const int32_t* __restrict__ words) {
  Plan p{};
  p.n = words[0];
  for (int d = 0; d < kDigits; ++d) p.digit[d] = words[1 + d];
  return p;
}

// where a sort's ascending keys ended: the input itself when no digit
// needed a pass (every key equal), else the last pass's buffer
struct Sorted {
  const uint32_t* keys;
  uint32_t flip;  // value = key ^ flip
  const int32_t* rows;
  __device__ int32_t value(int64_t i) const {
    return static_cast<int32_t>(keys[i] ^ flip);
  }
};

__device__ Sorted sorted_of(const Plan& p, const int32_t* in, uint32_t flip,
                            uint32_t* const* keys, const int32_t* rows_in,
                            int32_t* const* rows) {
  if (p.n == 0) {
    return {reinterpret_cast<const uint32_t*>(in), 0u, rows_in};
  }
  const int b = (p.n - 1) & 1;
  return {keys[b], flip, rows == nullptr ? nullptr : rows[b]};
}

// exclusive prefix of v over the block's threads in order; `total` gets
// the block's sum.  `scratch` has a slot per warp.
template <typename T>
__device__ T block_excl_scan(T v, T* scratch, T* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  T x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  T before = 0, all = 0;
  for (int i = 0; i < kWarps; ++i) {
    const T s = scratch[i];
    if (i < w) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned long long* p,
                                               unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// grid (x, n_shards): the digit histograms of key = c ^ flip over the
// rows of shard y of `counts[n]`, 4 rows a thread a step; with `shard`
// given, also the shard's sum and its rows with c > 0.  The last block to
// finish writes the sort's plan.
__global__ void __launch_bounds__(kThreads) snap_scan_kernel(
    const int32_t* __restrict__ counts, int64_t n, uint32_t flip,
    uint32_t* __restrict__ hist, unsigned long long* __restrict__ shard,
    unsigned long long* __restrict__ nnz, unsigned int* __restrict__ done,
    int32_t* __restrict__ plan) {
  __shared__ uint32_t h[kDigits * kBins];
  __shared__ long long sums[kWarps];
  __shared__ long long nzs[kWarps];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kDigits * kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const int64_t per = n / gridDim.y;
  const int64_t lo = per * blockIdx.y;
  const int64_t hi = lo + per;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  long long sum = 0;
  long long nz = 0;
  // 4 consecutive rows a thread a step, one 16-byte load where aligned;
  // the trip count is the block's, so whole warps reach the match
  for (int64_t at = lo + static_cast<int64_t>(blockIdx.x) * kThreads * 4;
       at < hi; at += 4 * stride) {
    const int64_t i = at + 4 * threadIdx.x;
    int32_t c[4] = {0, 0, 0, 0};
    int nv = 0;
    if (i + 3 < hi && (reinterpret_cast<uintptr_t>(counts + i) & 15) == 0) {
      const int4 v = *reinterpret_cast<const int4*>(counts + i);
      c[0] = v.x;
      c[1] = v.y;
      c[2] = v.z;
      c[3] = v.w;
      nv = 4;
    } else {
      for (int j = 0; j < 4 && i + j < hi; ++j) {
        c[j] = counts[i + j];
        nv = j + 1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = j < nv;
      const unsigned active = __ballot_sync(kFull, ok);
      if (!ok) continue;
      sum += c[j];
      nz += c[j] > 0;
      const uint32_t u = static_cast<uint32_t>(c[j]) ^ flip;
      for (int d = 0; d < kDigits; ++d) {
        const uint32_t dig = (u >> (8 * d)) & 0xffu;
        const unsigned peers = __match_any_sync(active, dig);
        if (__ffs(peers) - 1 == lane) {
          atomicAdd(&h[d * kBins + dig],
                    static_cast<uint32_t>(__popc(peers)));
        }
      }
    }
  }
  if (shard != nullptr) {
    sum = ot_block_sum(sum, sums);
    nz = ot_block_sum(nz, nzs);
    if (threadIdx.x == 0) {
      if (sum) {
        atomicAdd(shard + blockIdx.y, static_cast<unsigned long long>(sum));
      }
      if (nz) atomicAdd(nnz, static_cast<unsigned long long>(nz));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kBins; i += kThreads) {
    if (h[i]) atomicAdd(hist + i, h[i]);
  }
  // the last block to land its histogram writes the plan
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  Plan p{};
  for (int d = 0; d < kDigits; ++d) {
    const int nonzero = __syncthreads_count(
        threadIdx.x < kBins && __ldcg(hist + d * kBins + threadIdx.x) != 0);
    if (nonzero > 1) p.digit[p.n++] = d;
  }
  if (threadIdx.x == 0) {
    plan[0] = p.n;
    for (int d = 0; d < kDigits; ++d) plan[1 + d] = p.digit[d];
  }
}

// One LSD pass: the pass-th live digit of the sort whose histograms are
// `hist`.  A stable scatter of keys_in[n] (^ flip) into keys_out, and of
// the row payload when kPayload.  Blocks take tiles in start order from
// *tile_counter; flags holds a word per (tile, bin): tag << 32 | count,
// tag 2·pass + 1 for the tile's own count, 2·pass + 2 for its inclusive
// prefix over tiles (lower tags, from earlier passes or the zeroing, are
// not yet published).
template <bool kPayload>
__global__ void __launch_bounds__(kThreads) radix_pass_kernel(
    const uint32_t* __restrict__ keys_in, uint32_t flip,
    const int32_t* __restrict__ rows_in, uint32_t* __restrict__ keys_out,
    int32_t* __restrict__ rows_out, int64_t n, int pass,
    const int32_t* __restrict__ plan_words,
    const uint32_t* __restrict__ hist, uint32_t* __restrict__ tile_counter,
    unsigned long long* __restrict__ flags) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ int32_t s_rows[kPayload ? kTile : 1];
  __shared__ uint32_t s_warp[kWarps][kBins];  // per-warp bin counts
  __shared__ uint32_t s_start[kBins];         // bin's first tile position
  __shared__ uint32_t s_global[kBins];        // bin's first output position
  __shared__ uint32_t s_scan[kWarps];
  __shared__ uint32_t s_tile;

  const Plan plan = load_plan(plan_words);
  if (pass >= plan.n) return;  // a skipped digit: the whole block leaves
  const int d = plan.digit[pass];
  const int shift = 8 * d;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1u);
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&s_warp[0][0])[i] = 0;
  }
  __syncthreads();
  const uint32_t tile = s_tile;
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  // warp w ranks tile positions [w·512, (w + 1)·512) in order, 32 a step:
  // (w, j, lane) order is tile order, so the ranks are stable
  uint32_t key[kKeysPerThread];
  int32_t row[kKeysPerThread];
  uint32_t rank[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int64_t i = base + w * (32 * kKeysPerThread) + j * 32 + lane;
    const bool ok = i < n;
    key[j] = ok ? keys_in[i] ^ flip : 0u;
    if (kPayload) row[j] = ok ? rows_in[i] : 0;
    const uint32_t dig = ok ? (key[j] >> shift) & 0xffu : kBins;
    const unsigned peers = __match_any_sync(kFull, dig);
    const uint32_t before = __popc(peers & lt);
    const uint32_t old = ok ? s_warp[w][dig] : 0u;
    __syncwarp();
    if (ok && before == 0) s_warp[w][dig] = old + __popc(peers);
    __syncwarp();
    rank[j] = old + before;
  }
  __syncthreads();
  // thread b: bin b's prefix over the warps, the tile's count, and its
  // start in the tile
  const int b = threadIdx.x;
  uint32_t cnt = 0;
  for (int v = 0; v < kWarps; ++v) {
    const uint32_t c = s_warp[v][b];
    s_warp[v][b] = cnt;
    cnt += c;
  }
  uint32_t tile_total;
  s_start[b] = block_excl_scan<uint32_t>(cnt, s_scan, &tile_total);
  // decoupled look-back: bin b's count over the earlier tiles
  const unsigned long long agg = 2ull * pass + 1;
  const unsigned long long pre = agg + 1;
  unsigned long long* mine = flags + static_cast<int64_t>(tile) * kBins + b;
  unsigned long long excl = 0;
  if (tile == 0) {
    store_volatile(mine, (pre << 32) | cnt);
  } else {
    store_volatile(mine, (agg << 32) | cnt);
    for (int64_t t = static_cast<int64_t>(tile) - 1; t >= 0;) {
      const unsigned long long word = load_volatile(flags + t * kBins + b);
      const unsigned long long tag = word >> 32;
      if (tag < agg) continue;  // tile t has not published yet
      excl += word & 0xffffffffull;
      if (tag == pre) break;
      --t;
    }
    store_volatile(mine, (pre << 32) | (excl + cnt));
  }
  uint32_t n_all;
  const uint32_t gstart =
      block_excl_scan<uint32_t>(hist[d * kBins + b], s_scan, &n_all);
  s_global[b] = gstart + static_cast<uint32_t>(excl);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int64_t i = base + w * (32 * kKeysPerThread) + j * 32 + lane;
    if (i < n) {
      const uint32_t dig = (key[j] >> shift) & 0xffu;
      const uint32_t pos = s_start[dig] + s_warp[w][dig] + rank[j];
      s_keys[pos] = key[j];
      if (kPayload) s_rows[pos] = row[j];
    }
  }
  __syncthreads();
  const int64_t left = n - base;
  const int tile_n = static_cast<int>(left < kTile ? left : kTile);
  for (int i = threadIdx.x; i < tile_n; i += kThreads) {
    const uint32_t k = s_keys[i];
    const uint32_t dig = (k >> shift) & 0xffu;
    const uint32_t pos = s_global[dig] + (static_cast<uint32_t>(i) -
                                          s_start[dig]);
    keys_out[pos] = k;
    if (kPayload) rows_out[pos] = s_rows[i];
  }
}

struct SortBufs {
  const int32_t* in;       // the sort's input values
  uint32_t flip;           // key = value ^ flip
  const uint32_t* hist;    // [kDigits][kBins]
  const int32_t* plan;     // the plan's words
  uint32_t* keys[2];       // ping-pong
  const int32_t* rows_in;  // payload (candidate sort only)
  int32_t* rows[2];
  __device__ Sorted sorted(const Plan& p) const {
    return sorted_of(p, in, flip, keys, rows_in,
                     rows_in == nullptr ? nullptr : rows);
  }
};

// fixed grid of kGiniBlocks: the block's float64 Gini partial over the
// descending positions j < nnz, (nnz - 2j - 1)·s[cap - 1 - j]; and over
// its chunk of rows, the rows with c > T and with c == T, T = s[cap - k]
__global__ void __launch_bounds__(kThreads) snap_rank_kernel(
    const int32_t* __restrict__ counts, int64_t cap, int k, SortBufs main,
    const unsigned long long* __restrict__ nnz_p,
    double* __restrict__ partials, uint2* __restrict__ block_counts) {
  __shared__ double dsums[kWarps];
  __shared__ long long gsums[kWarps];
  __shared__ long long esums[kWarps];
  const Plan plan = load_plan(main.plan);
  const Sorted s = main.sorted(plan);
  const int64_t nnz = static_cast<int64_t>(*nnz_p);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       j < nnz; j += stride) {
    acc += static_cast<double>(nnz - 2 * j - 1) *
           static_cast<double>(s.value(cap - 1 - j));
  }
  acc = ot_block_sum(acc, dsums);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  const int32_t t = s.value(cap - k);
  const int64_t chunk = (cap + gridDim.x - 1) / gridDim.x;
  const int64_t lo = chunk * blockIdx.x;
  const int64_t hi = lo + chunk < cap ? lo + chunk : cap;
  long long gt = 0;
  long long eq = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int32_t c = counts[i];
    gt += c > t;
    eq += c == t;
  }
  gt = ot_block_sum(gt, gsums);
  eq = ot_block_sum(eq, esums);
  if (threadIdx.x == 0) {
    block_counts[blockIdx.x] =
        make_uint2(static_cast<uint32_t>(gt), static_cast<uint32_t>(eq));
  }
}

// the k candidates in row order: every row with c > T and the first
// need = k - n_above rows with c == T; a row's place is (rows > T before
// it) + min(rows == T before it, need)
__global__ void __launch_bounds__(kThreads) snap_compact_kernel(
    const int32_t* __restrict__ counts, int64_t cap, int k, SortBufs main,
    const uint2* __restrict__ block_counts, int32_t* __restrict__ cand_counts,
    int32_t* __restrict__ cand_rows) {
  __shared__ long long red[3][kWarps];
  __shared__ long long bcast[3];
  __shared__ unsigned long long scan[kWarps];
  const Plan plan = load_plan(main.plan);
  const int32_t t = main.sorted(plan).value(cap - k);
  long long gt_before = 0, eq_before = 0, gt_all = 0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    const uint2 bc = block_counts[i];
    gt_all += bc.x;
    if (i < static_cast<int>(blockIdx.x)) {
      gt_before += bc.x;
      eq_before += bc.y;
    }
  }
  gt_before = ot_block_sum(gt_before, red[0]);
  eq_before = ot_block_sum(eq_before, red[1]);
  gt_all = ot_block_sum(gt_all, red[2]);
  if (threadIdx.x == 0) {
    bcast[0] = gt_before;
    bcast[1] = eq_before;
    bcast[2] = gt_all;
  }
  __syncthreads();
  gt_before = bcast[0];
  eq_before = bcast[1];
  const long long need = k - bcast[2];
  const uint2 mine = block_counts[blockIdx.x];
  if (mine.x == 0 && (mine.y == 0 || eq_before >= need)) return;
  uint32_t gt_seen = 0;
  const int64_t chunk = (cap + gridDim.x - 1) / gridDim.x;
  const int64_t lo = chunk * blockIdx.x;
  const int64_t hi = lo + chunk < cap ? lo + chunk : cap;
  for (int64_t at = lo; at < hi; at += kThreads) {
    const int64_t i = at + threadIdx.x;
    const int32_t c = i < hi ? counts[i] : 0;
    const bool g = i < hi && c > t;
    const bool e = i < hi && c == t;
    unsigned long long round;
    const unsigned long long r = block_excl_scan<unsigned long long>(
        (static_cast<unsigned long long>(g) << 32) | e, scan, &round);
    const long long gpos = gt_before + static_cast<long long>(r >> 32);
    const long long epos = eq_before + static_cast<long long>(r & 0xffffffffu);
    long long pos = -1;
    if (g) pos = gpos + (epos < need ? epos : need);
    if (e && epos < need) pos = gpos + epos;
    if (pos >= 0) {
      cand_counts[pos] = c;
      cand_rows[pos] = static_cast<int32_t>(i);
    }
    gt_before += static_cast<long long>(round >> 32);
    eq_before += static_cast<long long>(round & 0xffffffffu);
    gt_seen += static_cast<uint32_t>(round >> 32);
    if (gt_seen == mine.x && eq_before >= need) break;  // nothing left
  }
}

__device__ __forceinline__ int64_t sketch_estimate(
    int32_t row, const int32_t* __restrict__ cms, int depth, int64_t width,
    const OtSeeds& seeds) {
  const uint32_t width_mask = static_cast<uint32_t>(width - 1);
  int32_t est = 0;
  for (int dd = 0; dd < depth; ++dd) {
    const int32_t v = cms[dd * width + ot_cms_bucket(row, seeds.s[dd],
                                                     width_mask)];
    est = dd == 0 ? v : (v < est ? v : est);
  }
  return est;
}

// k > kSmallK: the candidates, radix sorted by count descending (ties in
// row order, as compacted), to vals | rows | est
__global__ void __launch_bounds__(kThreads) snap_emit_kernel(
    SortBufs cand, int k, const int32_t* __restrict__ cms, int depth,
    int64_t width, OtSeeds seeds, int64_t* __restrict__ out) {
  const Plan plan = load_plan(cand.plan);
  const Sorted s = cand.sorted(plan);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < k; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int32_t row = s.rows[i];
    out[i] = plan.n == 0 ? static_cast<int32_t>(s.keys[i])
                         : static_cast<int32_t>(s.keys[i] ^ kDesc);
    out[k + i] = row;
    out[2 * k + i] = sketch_estimate(row, cms, depth, width, seeds);
  }
}

// one block: (k <= kSmallK) the candidates sorted in shared memory as
// (INT32_MAX - count) << 32 | row, then vals | rows | est; always the
// shard sums and the tail
__global__ void __launch_bounds__(kThreads) snap_final_kernel(
    int64_t cap, int k, bool sort_here,
    const int32_t* __restrict__ cand_counts,
    const int32_t* __restrict__ cand_rows, SortBufs main,
    const int32_t* __restrict__ cms, int depth, int64_t width, OtSeeds seeds,
    int n_shards, const unsigned long long* __restrict__ shard,
    const unsigned long long* __restrict__ nnz_p,
    const double* __restrict__ partials, int64_t* __restrict__ out) {
  __shared__ unsigned long long keys[kSmallK];
  __shared__ double gsums[kWarps];
  const Plan plan = load_plan(main.plan);
  const Sorted s = main.sorted(plan);
  if (sort_here) {
    int k2 = 1;
    while (k2 < k) k2 <<= 1;
    for (int i = threadIdx.x; i < k2; i += kThreads) {
      keys[i] = i < k
                    ? (static_cast<unsigned long long>(
                           static_cast<int64_t>(INT32_MAX) - cand_counts[i])
                       << 32) |
                          static_cast<uint32_t>(cand_rows[i])
                    : ~0ull;
    }
    __syncthreads();
    for (int kk = 2; kk <= k2; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        for (int p = threadIdx.x; p < k2 / 2; p += kThreads) {
          const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const bool up = (lo & kk) == 0;
          const unsigned long long a = keys[lo];
          const unsigned long long b = keys[lo + j];
          if ((a > b) == up) {
            keys[lo] = b;
            keys[lo + j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < k; i += kThreads) {
      const unsigned long long key = keys[i];
      const int32_t row = static_cast<int32_t>(key & 0xffffffffull);
      out[i] = static_cast<int64_t>(INT32_MAX) -
               static_cast<int64_t>(key >> 32);
      out[k + i] = row;
      out[2 * k + i] = sketch_estimate(row, cms, depth, width, seeds);
    }
  }
  // the Gini partials in a fixed order: thread t's in order, then the
  // block's fixed shuffle tree
  double g = 0.0;
  for (int b = threadIdx.x; b < kGiniBlocks; b += kThreads) g += partials[b];
  g = ot_block_sum(g, gsums);
  if (threadIdx.x != 0) return;
  int64_t* tail = out + 3 * static_cast<int64_t>(k) + n_shards;
  int64_t total = 0;
  for (int sh = 0; sh < n_shards; ++sh) {
    const int64_t v = static_cast<int64_t>(shard[sh]);
    out[3 * static_cast<int64_t>(k) + sh] = v;
    total += v;
  }
  const int64_t nnz = static_cast<int64_t>(*nnz_p);
  const int64_t a = (nnz - 1) * 99;
  const int64_t q = a >= 0 ? a / 100 : -((-a + 99) / 100);
  int64_t pos = cap - nnz + q;
  pos = pos < 0 ? 0 : (pos > cap - 1 ? cap - 1 : pos);
  const float nnz_f = static_cast<float>(nnz > 1 ? nnz : 1);
  const float total_f = static_cast<float>(total > 1 ? total : 1);
  const float gini = static_cast<float>(g) / (nnz_f * total_f);
  const float mean = total_f / nnz_f;
  tail[0] = total;
  tail[1] = nnz;
  tail[2] = s.value(pos);
  tail[3] = static_cast<int64_t>(__float_as_uint(gini));
  tail[4] = static_cast<int64_t>(__float_as_uint(mean));
}

// the scratch, carved in order; the first `zeroed` bytes start at zero
struct Layout {
  int64_t hist_main, hist_cand, counters, plans, shard, nnz, flags_main,
      flags_cand, zeroed, keys_main, partials, block_counts, cand_counts,
      cand_rows, keys_cand, rows_cand, bytes;
};

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }


Layout layout_of(int64_t cap, int k, int n_shards) {
  Layout l{};
  int64_t at = 0;
  auto take = [&at](int64_t bytes) {
    const int64_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  l.hist_main = take(4 * kDigits * kBins);
  l.hist_cand = take(4 * kDigits * kBins);
  l.counters = take(4 * 2 * (kDigits + 1));  // tiles per pass, done
  l.plans = take(4 * 2 * 8);
  l.shard = take(8 * static_cast<int64_t>(n_shards));
  l.nnz = take(8);
  l.flags_main = take(8 * kBins * tiles_of(cap));
  l.flags_cand = take(k > kSmallK ? 8 * kBins * tiles_of(k) : 0);
  l.zeroed = at;
  l.keys_main = take(2 * 4 * cap);
  l.partials = take(8 * kGiniBlocks);
  l.block_counts = take(8 * kGiniBlocks);
  l.cand_counts = take(4 * static_cast<int64_t>(k));
  l.cand_rows = take(4 * static_cast<int64_t>(k));
  l.keys_cand = take(k > kSmallK ? 2 * 4 * static_cast<int64_t>(k) : 0);
  l.rows_cand = take(k > kSmallK ? 2 * 4 * static_cast<int64_t>(k) : 0);
  l.bytes = at;
  return l;
}

template <typename T>
T* carve(void* base, int64_t off) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + off);
}

void sort_passes(const SortBufs& b, bool payload, int64_t n,
                 uint32_t* counters, unsigned long long* flags,
                 cudaStream_t s) {
  const unsigned int tiles = static_cast<unsigned int>(tiles_of(n));
  for (int p = 0; p < kDigits; ++p) {
    const uint32_t* in = p == 0 ? reinterpret_cast<const uint32_t*>(b.in)
                                : b.keys[(p - 1) & 1];
    const uint32_t flip = p == 0 ? b.flip : 0u;
    if (payload) {
      radix_pass_kernel<true><<<tiles, kThreads, 0, s>>>(
          in, flip, p == 0 ? b.rows_in : b.rows[(p - 1) & 1], b.keys[p & 1],
          b.rows[p & 1], n, p, b.plan, b.hist, counters + p, flags);
    } else {
      radix_pass_kernel<false><<<tiles, kThreads, 0, s>>>(
          in, flip, nullptr, b.keys[p & 1], nullptr, n, p, b.plan, b.hist,
          counters + p, flags);
    }
  }
}

}  // namespace

// bytes of scratch attr_snapshot needs, into *bytes
OT_EXPORT int attr_snapshot_scratch(int64_t cap, int k, int n_shards,
                                    int64_t* bytes) {
  *bytes = layout_of(cap, k, n_shards).bytes;
  return 0;
}

// 1 <= k <= cap < 2^31; n_shards divides cap; scratch of
// attr_snapshot_scratch() bytes, 256-byte aligned
OT_EXPORT int attr_snapshot(const int32_t* counts, int64_t cap,
                            const int32_t* cms, int depth, int64_t width,
                            const uint32_t* seeds, int k, int n_shards,
                            void* scratch, int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout_of(cap, k, n_shards);
  cudaMemsetAsync(scratch, 0, static_cast<size_t>(l.zeroed), s);
  uint32_t* counters = carve<uint32_t>(scratch, l.counters);
  auto* shard = carve<unsigned long long>(scratch, l.shard);
  auto* nnz = carve<unsigned long long>(scratch, l.nnz);
  uint32_t* hist = carve<uint32_t>(scratch, l.hist_main);
  int32_t* plans = carve<int32_t>(scratch, l.plans);
  SortBufs main{};
  main.in = counts;
  main.flip = kAsc;
  main.hist = hist;
  main.plan = plans;
  main.keys[0] = carve<uint32_t>(scratch, l.keys_main);
  main.keys[1] = main.keys[0] + cap;
  const int64_t per = cap / n_shards;
  const dim3 scan_grid(ot_blocks((per + 3) / 4, 1024), n_shards);
  snap_scan_kernel<<<scan_grid, kThreads, 0, s>>>(
      counts, cap, kAsc, hist, shard, nnz, counters + 2 * kDigits,
      plans);
  sort_passes(main, false, cap, counters,
              carve<unsigned long long>(scratch, l.flags_main), s);
  auto* partials = carve<double>(scratch, l.partials);
  auto* block_counts = carve<uint2>(scratch, l.block_counts);
  auto* cand_counts = carve<int32_t>(scratch, l.cand_counts);
  auto* cand_rows = carve<int32_t>(scratch, l.cand_rows);
  snap_rank_kernel<<<kGiniBlocks, kThreads, 0, s>>>(
      counts, cap, k, main, nnz, partials, block_counts);
  snap_compact_kernel<<<kGiniBlocks, kThreads, 0, s>>>(
      counts, cap, k, main, block_counts, cand_counts, cand_rows);
  const OtSeeds sd = ot_seeds(seeds, depth);
  const bool small = k <= kSmallK;
  if (!small) {
    SortBufs cand{};
    cand.in = cand_counts;
    cand.flip = kDesc;
    uint32_t* cand_hist = carve<uint32_t>(scratch, l.hist_cand);
    cand.hist = cand_hist;
    cand.plan = plans + 8;
    cand.keys[0] = carve<uint32_t>(scratch, l.keys_cand);
    cand.keys[1] = cand.keys[0] + k;
    cand.rows_in = cand_rows;
    cand.rows[0] = carve<int32_t>(scratch, l.rows_cand);
    cand.rows[1] = cand.rows[0] + k;
    snap_scan_kernel<<<dim3(ot_blocks((k + 3) / 4, 1024), 1), kThreads, 0,
                       s>>>(
        cand_counts, k, kDesc, cand_hist, nullptr, nullptr,
        counters + 2 * kDigits + 1, plans + 8);
    sort_passes(cand, true, k, counters + kDigits,
                carve<unsigned long long>(scratch, l.flags_cand), s);
    snap_emit_kernel<<<ot_blocks(k, 1024), kThreads, 0, s>>>(
        cand, k, cms, depth, width, sd, out);
  }
  snap_final_kernel<<<1, kThreads, 0, s>>>(
      cap, k, small, cand_counts, cand_rows, main, cms, depth, width, sd,
      n_shards, shard, nnz, partials, out);
  return static_cast<int>(cudaGetLastError());
}
