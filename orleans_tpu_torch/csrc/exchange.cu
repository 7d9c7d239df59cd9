// K23 exchange_classify and K24 exchange_buckets: the cross-shard exchange
// between the shard blocks of one arena on one card.
//
// Lanes are rows int32[m] and mask bool[m], padded conceptually to n * L
// (lanes >= m are invalid; nothing is copied to pad them).  Lane i lies
// in source chunk s = i / L; its destination block is d = rows[i] / sc
// when it is valid (mask, 0 <= row < n * sc), else n.  A valid lane is
// local when d == s and cross otherwise.
//
// K23 replaces orleans_tpu/tensor/exchange.py classify_lanes (:83) and
// demand_per_dest (:101), as the probe (_probe :368-409) and the cap-0
// branches of _traced (:629-654) and apply_traced (:888-918) run them.
// Probe mode writes stats int32[3 + 2n] = (sum cross, 0, sum valid, g, g),
// g[d] the cross lanes bound for block d; cap-0 mode writes (0, sum cross,
// sum local, g, g) and, over the n * L lanes, where(local, rows, -1),
// local and cross.  Bound on an H100: bytes, 5 B a lane read (6 B more
// written in cap-0 mode) over 3.35 TB/s.  Design: one pass; a warp counts
// its valid lanes with a ballot and its cross lanes per destination with
// __match_any_sync, the warps of a block add into a block-local histogram
// of the n + 1 bins in shared memory, and each block adds each nonzero
// bin into the stats with one atomic — two blocks an SM, since those
// atomics all land on the same 3 + 2n words.  Integer counts: exact in
// any order.
//
// K24 replaces the two shard_map bodies of ShardExchange, _traced's
// per_shard (:656-733, whose buckets end in lax.all_to_all at :693-698)
// and _traced_perdest's (:772-861, all_gather at :801-803): on one card
// the collective is the write itself.  Receiver d's region of the output
// is lanes [d * W, (d + 1) * W).  Its first L lanes hold chunk d's lanes
// in place (every payload leaf copied, the row kept only where local, -1
// elsewhere).  A cross lane of chunk s bound for d has its stable rank pos
// among the lanes of chunk s bound for d, in lane order (jnp.argsort is
// stable, so the JAX buckets keep input order), and goes to
//   legacy:   lane L + s * cap + pos            when pos < cap;
//   per-dest: lane L + sum_{s' < s} fills[s'][d] + pos
//             when pos < caps[d] and that rank < R (fills = min(need, caps));
// otherwise it is dropped, its input lane set in dropped[m].  Empty lanes
// hold row -1, mask false and zero leaves.  stats int32[3 + 2n] = (sum
// cross, sum dropped, sum valid - sum dropped, max_s need, sum_s need),
// need[s][d] the cross lanes of chunk s bound for d, overflow included.
// Every leaf of the payload (any trailing shape and type) moves in the
// same launch through a table of pieces, as K22's (router.cu).
//
// Bound on an H100: bytes, the n * L input lanes read (row, mask, leaves)
// and the n * W output lanes written (row, mask, leaves) over 3.35 TB/s.
// Design, deterministic and with no atomics in the ranks, three launches:
// (1) a histogram per (chunk, tile of 1024 lanes) of the destinations of
// its cross lanes and its valid count; (2) an exclusive scan over the
// tiles of each (chunk, bin), and one block that sums the need matrix and
// writes the stats and the per-destination offsets; (3) per tile, the
// in-tile stable rank of each cross lane among its destination's — warp
// match and __popc of the lower lanes, then a prefix over the block's
// warps — added to the tile's offset, then the writes; extra blocks of
// the same launch fill the empty bucket lanes.
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kMaxLeaves = 32;
constexpr int kTile = 1024;              // lanes per block in K24
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kClassifyBlocks = 264;  // 2 per SM of an H100

struct Leaves {
  const char* src[kMaxLeaves];
  char* dst[kMaxLeaves];
  int64_t row_bytes[kMaxLeaves];
  int32_t unit[kMaxLeaves];
  int32_t n;
};

struct Plan {
  int64_t m;      // input lanes
  int64_t L;      // lanes per source chunk
  int64_t W;      // output lanes per receiver
  int64_t tiles;  // tiles per chunk
  int32_t n;      // shard blocks
  int32_t sc;     // rows per shard block
  int32_t cap;    // legacy per-(source, destination) cap; -1: per-dest
  int32_t R;      // per-destination receive rung
  int32_t caps[kMaxShards];
};

// the lane's row and destination block (n when the lane is invalid)
__device__ __forceinline__ int classify(const int32_t* __restrict__ rows,
                                        const uint8_t* __restrict__ mask,
                                        int64_t i, int64_t m, int32_t sc,
                                        int n, int32_t* row) {
  int32_t r = -1;
  bool mk = false;
  if (i < m) {
    r = rows[i];
    mk = mask[i] != 0;
  }
  *row = r;
  if (!mk || r < 0) return n;
  const int32_t d = r / sc;
  return d < n ? d : n;
}

__device__ __forceinline__ void copy_row(const char* src, char* dst,
                                         int64_t bytes, int unit) {
  for (int64_t b = 0; b < bytes; b += unit) {
    if (unit == 16) {
      *reinterpret_cast<int4*>(dst + b) =
          *reinterpret_cast<const int4*>(src + b);
    } else if (unit == 8) {
      *reinterpret_cast<int2*>(dst + b) =
          *reinterpret_cast<const int2*>(src + b);
    } else if (unit == 4) {
      *reinterpret_cast<int32_t*>(dst + b) =
          *reinterpret_cast<const int32_t*>(src + b);
    } else {
      dst[b] = src[b];
    }
  }
}

__device__ __forceinline__ void zero_row(char* dst, int64_t bytes,
                                         int unit) {
  for (int64_t b = 0; b < bytes; b += unit) {
    if (unit == 16) {
      *reinterpret_cast<int4*>(dst + b) = make_int4(0, 0, 0, 0);
    } else if (unit == 8) {
      *reinterpret_cast<int2*>(dst + b) = make_int2(0, 0);
    } else if (unit == 4) {
      *reinterpret_cast<int32_t*>(dst + b) = 0;
    } else {
      dst[b] = 0;
    }
  }
}

// input lane i (or zeros past m) into output lane o, every leaf
__device__ __forceinline__ void move_leaves(const Leaves& lv, int64_t i,
                                            int64_t m, int64_t o) {
  for (int k = 0; k < lv.n; ++k) {
    const int64_t rb = lv.row_bytes[k];
    if (i < m) {
      copy_row(lv.src[k] + i * rb, lv.dst[k] + o * rb, rb, lv.unit[k]);
    } else {
      zero_row(lv.dst[k] + o * rb, rb, lv.unit[k]);
    }
  }
}

// ---- K23 ------------------------------------------------------------------

__global__ void classify_kernel(const int32_t* __restrict__ rows,
                                const uint8_t* __restrict__ mask, int64_t m,
                                int64_t L, int64_t total, int n, int32_t sc,
                                int cap0, int32_t* __restrict__ stats,
                                int32_t* __restrict__ out_rows,
                                uint8_t* __restrict__ out_local,
                                uint8_t* __restrict__ out_cross) {
  __shared__ int32_t h[kMaxShards + 1];
  for (int b = threadIdx.x; b <= n; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // i0 is uniform over the block, so every warp op sees all 32 lanes
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       i0 < total; i0 += stride) {
    const int64_t i = i0 + threadIdx.x;
    int32_t r = -1;
    int d = n;
    if (i < total) d = classify(rows, mask, i, m, sc, n, &r);
    const bool valid = d < n;
    // 32-bit division: the host entry keeps n * L below 2**31
    const bool local = valid &&
        d == static_cast<int>(static_cast<uint32_t>(i) /
                              static_cast<uint32_t>(L));
    const bool cross = valid && !local;
    if (cap0 && i < total) {
      out_rows[i] = local ? r : -1;
      out_local[i] = local;
      out_cross[i] = cross;
    }
    const unsigned vb = __ballot_sync(kFull, valid);
    if (lane == 0 && vb) atomicAdd(&h[n], __popc(vb));
    const unsigned peers = __match_any_sync(kFull, cross ? d : -1);
    if (cross && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t cross_sum = 0;
    for (int b = 0; b < n; ++b) {
      if (h[b]) {
        atomicAdd(&stats[3 + b], h[b]);
        atomicAdd(&stats[3 + n + b], h[b]);
        cross_sum += h[b];
      }
    }
    if (cross_sum) atomicAdd(&stats[cap0 ? 1 : 0], cross_sum);
    const int32_t v = cap0 ? h[n] - cross_sum : h[n];
    if (v) atomicAdd(&stats[2], v);
  }
}

// ---- K24 ------------------------------------------------------------------

// (1) per (chunk, tile): cross lanes per destination, valid lanes in bin n
__global__ void bucket_hist_kernel(const int32_t* __restrict__ rows,
                                   const uint8_t* __restrict__ mask,
                                   const Plan p, int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxShards + 1];
  const int n = p.n;
  for (int b = threadIdx.x; b <= n; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int64_t s = blockIdx.x / p.tiles;
  const int64_t j = (blockIdx.x % p.tiles) * kTile + threadIdx.x;
  int32_t r;
  int d = n;
  if (j < p.L) d = classify(rows, mask, s * p.L + j, p.m, p.sc, n, &r);
  const bool valid = d < n;
  const bool cross = valid && d != static_cast<int>(s);
  const int lane = threadIdx.x & 31;
  const unsigned vb = __ballot_sync(kFull, valid);
  if (lane == 0 && vb) atomicAdd(&h[n], __popc(vb));
  const unsigned peers = __match_any_sync(kFull, cross ? d : -1);
  if (cross && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  __syncthreads();
  for (int b = threadIdx.x; b <= n; b += blockDim.x) {
    hist[static_cast<int64_t>(blockIdx.x) * (n + 1) + b] = h[b];
  }
}

// exclusive block scan of one value per thread (blockDim.x == kTile);
// returns the block total in *total
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* warp_sums,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int32_t ws = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, ws, o);
      if (lane >= o) ws += y;
    }
    warp_sums[lane] = ws;  // inclusive over warps
  }
  __syncthreads();
  const int32_t before = w ? warp_sums[w - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next round
  return before + x - v;
}

// (2) blocks [0, n (n + 1)): the exclusive scan over the tiles of one
// (chunk, bin); the last block: need, stats and the per-dest offsets
__global__ void bucket_scan_kernel(const Plan p,
                                   const int32_t* __restrict__ hist,
                                   int32_t* __restrict__ off,
                                   int32_t* __restrict__ need,
                                   int32_t* __restrict__ before,
                                   int32_t* __restrict__ stats) {
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int32_t sh_need[kMaxShards * kMaxShards];
  __shared__ int32_t sh_valid;
  const int n = p.n;
  const int nb = n + 1;
  if (blockIdx.x < static_cast<unsigned>(n * nb)) {
    const int64_t s = blockIdx.x / nb;
    const int b = blockIdx.x % nb;
    int32_t carry = 0;
    for (int64_t t0 = 0; t0 < p.tiles; t0 += kTile) {
      const int64_t t = t0 + threadIdx.x;
      const int64_t at = (s * p.tiles + t) * nb + b;
      const int32_t v = t < p.tiles ? hist[at] : 0;
      int32_t total;
      const int32_t ex = block_exclusive_scan(v, warp_sums, &total);
      if (t < p.tiles) off[at] = carry + ex;
      carry += total;
    }
    return;
  }
  // the stats block: need[s][d] and the valid count summed over tiles
  if (threadIdx.x == 0) sh_valid = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < n * nb; q += blockDim.x) {
    const int s = q / nb, b = q % nb;
    int32_t acc = 0;
    for (int64_t t = 0; t < p.tiles; ++t) {
      acc += hist[(static_cast<int64_t>(s) * p.tiles + t) * nb + b];
    }
    if (b < n) {
      sh_need[s * n + b] = acc;
    } else {
      atomicAdd(&sh_valid, acc);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n * n; q += blockDim.x) need[q] = sh_need[q];
  if (threadIdx.x == 0) {
    int32_t cross = 0, dropped = 0;
    for (int d = 0; d < n; ++d) {
      int32_t mx = 0, sum = 0, fill_sum = 0;
      const int32_t cd = p.cap >= 0 ? p.cap : p.caps[d];
      for (int s = 0; s < n; ++s) {
        const int32_t v = sh_need[s * n + d];
        mx = v > mx ? v : mx;
        sum += v;
        const int32_t fill = v < cd ? v : cd;
        before[s * n + d] = fill_sum;
        fill_sum += fill;
        dropped += v - fill;
      }
      before[n * n + d] = fill_sum;  // receiver d's inbound, all sources
      if (p.cap < 0 && fill_sum > p.R) dropped += fill_sum - p.R;
      cross += sum;
      stats[3 + d] = mx;
      stats[3 + n + d] = sum;
    }
    stats[0] = cross;
    stats[1] = dropped;
    stats[2] = sh_valid - dropped;
  }
}

// (3) blocks [0, n * tiles): the writes of one tile; the rest: the empty
// bucket lanes
__global__ void bucket_write_kernel(const int32_t* __restrict__ rows,
                                    const uint8_t* __restrict__ mask,
                                    const Plan p, const Leaves lv,
                                    const int32_t* __restrict__ off,
                                    const int32_t* __restrict__ need,
                                    const int32_t* __restrict__ before,
                                    int32_t* __restrict__ out_rows,
                                    uint8_t* __restrict__ out_mask,
                                    uint8_t* __restrict__ dropped) {
  __shared__ int32_t wc[kWarps][kMaxShards];
  const int n = p.n;
  const int64_t work_blocks = static_cast<int64_t>(n) * p.tiles;
  if (blockIdx.x >= work_blocks) {
    const int64_t region = p.W - p.L;
    const int64_t total = static_cast<int64_t>(n) * region;
    const int64_t stride = (gridDim.x - work_blocks) * blockDim.x;
    for (int64_t k = (blockIdx.x - work_blocks) * blockDim.x + threadIdx.x;
         k < total; k += stride) {
      const int64_t d = k / region, q = k % region;
      bool empty;
      if (p.cap >= 0) {
        const int64_t s = q / p.cap, pos = q % p.cap;
        const int32_t v = need[s * n + d];
        empty = pos >= (v < p.cap ? v : p.cap);
      } else {
        const int32_t tin = before[n * n + d];
        empty = q >= (tin < p.R ? tin : p.R);
      }
      if (empty) {
        const int64_t o = d * p.W + p.L + q;
        out_rows[o] = -1;
        out_mask[o] = 0;
        for (int l = 0; l < lv.n; ++l) {
          zero_row(lv.dst[l] + o * lv.row_bytes[l], lv.row_bytes[l],
                   lv.unit[l]);
        }
      }
    }
    return;
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = threadIdx.x; q < kWarps * n; q += blockDim.x) {
    wc[q / n][q % n] = 0;
  }
  __syncthreads();
  const int64_t s = blockIdx.x / p.tiles, t = blockIdx.x % p.tiles;
  const int64_t j = t * kTile + threadIdx.x;
  const int64_t i = s * p.L + j;
  int32_t r = -1;
  int d = n;
  if (j < p.L) d = classify(rows, mask, i, p.m, p.sc, n, &r);
  const bool valid = d < n;
  const bool local = valid && d == static_cast<int>(s);
  const bool cross = valid && !local;
  const unsigned peers = __match_any_sync(kFull, cross ? d : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (cross && rank == 0) wc[w][d] = __popc(peers);
  __syncthreads();
  // exclusive prefix over the block's warps, per destination
  for (int dd = threadIdx.x; dd < n; dd += blockDim.x) {
    int32_t run = 0;
    for (int ww = 0; ww < kWarps; ++ww) {
      const int32_t c = wc[ww][dd];
      wc[ww][dd] = run;
      run += c;
    }
  }
  __syncthreads();
  if (j >= p.L) return;
  const int64_t own = s * p.W + j;
  out_rows[own] = local ? r : -1;
  out_mask[own] = local;
  move_leaves(lv, i, p.m, own);
  bool drop = false;
  if (cross) {
    const int64_t pos =
        static_cast<int64_t>(off[(s * p.tiles + t) * (n + 1) + d]) +
        wc[w][d] + rank;
    int64_t slot = -1;
    if (p.cap >= 0) {
      if (pos < p.cap) slot = d * p.W + p.L + s * p.cap + pos;
    } else if (pos < p.caps[d]) {
      const int64_t rk = before[s * n + d] + pos;
      if (rk < p.R) slot = d * p.W + p.L + rk;
    }
    if (slot >= 0) {
      out_rows[slot] = r;
      out_mask[slot] = 1;
      move_leaves(lv, i, p.m, slot);
    } else {
      drop = true;
    }
  }
  if (i < p.m) dropped[i] = drop;
}

}  // namespace

// K23: stats int32[3 + 2n]; cap-0 mode also out_rows int32[n L], out_local
// and out_cross bool[n L] (probe mode: pass nulls)
OT_EXPORT int exchange_classify(const int32_t* rows, const uint8_t* mask,
                                int64_t m, int64_t L, int32_t n,
                                int32_t shard_capacity, int32_t cap0,
                                int32_t* stats, int32_t* out_rows,
                                uint8_t* out_local, uint8_t* out_cross,
                                void* stream) {
  if (n < 1 || n > kMaxShards || L < 1 || shard_capacity < 1 || m < 0 ||
      m > n * L || n * L >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(stats, 0, sizeof(int32_t) * (3 + 2 * n), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(n) * L;
  // two blocks of 1024 lanes an SM: every block ends with one atomic per
  // nonzero bin into the same few stats words, so fewer blocks contend
  // less there
  int64_t blocks = (total + 1023) / 1024;
  blocks = blocks < kClassifyBlocks ? blocks : kClassifyBlocks;
  classify_kernel<<<static_cast<unsigned>(blocks), 1024, 0, st>>>(
      rows, mask, m, L, total, n, shard_capacity, cap0, stats, out_rows,
      out_local, out_cross);
  return static_cast<int>(cudaGetLastError());
}

// K24 scratch (int32): hist and off n * tiles * (n + 1) each, need n * n,
// before n * n + n; tiles = ceil(L / 1024)
OT_EXPORT int exchange_buckets_scratch(int64_t L, int32_t n) {
  const int64_t tiles = (L + kTile - 1) / kTile;
  const int64_t words = 2 * n * tiles * (n + 1) + 2 * n * n + n;
  return words > 0x7fffffff ? -1 : static_cast<int>(words);
}

// K24: cap >= 0 is the legacy layout (W = L + n cap), cap < 0 the
// per-destination one (caps[n], receive rung R, W = L + R); n_leaves
// pieces (<= 32), leaf k row_bytes[k] bytes a lane, copied in units of
// unit[k] bytes; outputs out_rows int32[n W], out_mask bool[n W], the
// leaves' [n W] outputs, dropped bool[m], stats int32[3 + 2n]
OT_EXPORT int exchange_buckets(const int32_t* rows, const uint8_t* mask,
                               int64_t m, int64_t L, int32_t n,
                               int32_t shard_capacity, int32_t cap,
                               const int32_t* caps, int32_t R,
                               int32_t n_leaves, const int64_t* src,
                               const int64_t* dst, const int64_t* row_bytes,
                               const int32_t* unit, int32_t* scratch,
                               int32_t* out_rows, uint8_t* out_mask,
                               uint8_t* dropped, int32_t* stats,
                               void* stream) {
  if (n < 1 || n > kMaxShards || L < 1 || shard_capacity < 1 || m < 0 ||
      m > n * L || n_leaves < 0 || n_leaves > kMaxLeaves ||
      (cap < 0 && R < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  p.m = m;
  p.L = L;
  p.n = n;
  p.sc = shard_capacity;
  p.cap = cap;
  p.R = R;
  p.tiles = (L + kTile - 1) / kTile;
  p.W = L + (cap >= 0 ? static_cast<int64_t>(n) * cap : R);
  for (int d = 0; d < kMaxShards; ++d) {
    p.caps[d] = (cap < 0 && d < n) ? caps[d] : 0;
  }
  Leaves lv;
  lv.n = n_leaves;
  for (int k = 0; k < kMaxLeaves; ++k) {
    const bool on = k < n_leaves;
    lv.src[k] = on ? reinterpret_cast<const char*>(src[k]) : nullptr;
    lv.dst[k] = on ? reinterpret_cast<char*>(dst[k]) : nullptr;
    lv.row_bytes[k] = on ? row_bytes[k] : 0;
    lv.unit[k] = on ? unit[k] : 1;
  }
  const int64_t cells = static_cast<int64_t>(n) * p.tiles * (n + 1);
  int32_t* hist = scratch;
  int32_t* off = hist + cells;
  int32_t* need = off + cells;
  int32_t* before = need + n * n;
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned work = static_cast<unsigned>(n * p.tiles);
  bucket_hist_kernel<<<work, kTile, 0, st>>>(rows, mask, p, hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_scan_kernel<<<n * (n + 1) + 1, kTile, 0, st>>>(p, hist, off, need,
                                                       before, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t empty_lanes = static_cast<int64_t>(n) * (p.W - p.L);
  const unsigned fill = empty_lanes ? ot_blocks(empty_lanes, 1 << 12) : 0;
  bucket_write_kernel<<<work + fill, kTile, 0, st>>>(
      rows, mask, p, lv, off, need, before, out_rows, out_mask, dropped);
  return static_cast<int>(cudaGetLastError());
}
