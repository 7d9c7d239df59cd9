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
// Design, deterministic and with no atomics in the ranks, three launches
// of 256-thread blocks over tiles of 1024 lanes:
// (1) per (chunk, tile) a histogram of the destinations of its cross
// lanes and its valid count, 4 tiles a block, 4 consecutive lanes a
// thread (one 16-byte row load and one 4-byte mask load a tile);
// (2) per (chunk, bin) an exclusive scan over the tiles, whose block also
// writes its total: the need matrix and the valid counts, from which
// every later block derives what it needs (its per-destination start, the
// fill ranges, the stats) in an n x n step of its own — no block walks
// the tiles alone;
// (3) per tile, the own-region copy 4 consecutive lanes a thread (16-byte
// row stores, leaves 16 bytes at a time where the addresses allow); then
// 4 lanes a thread strided by 32, each cross lane's in-tile stable rank
// among its destination's (a ballot per destination, or a warp match, and
// __popc of the lower lanes per round, the warp's running count, a prefix
// over the warps); the tile's cross lanes ordered by destination in
// shared memory, so the bucket writes go one lane a thread, consecutive
// threads on consecutive slots; then dropped, 4 lanes a thread.
// Blocks after the tiles in the same launch write the empty bucket lanes
// as contiguous ranges — legacy [L + s cap + min(need, cap), L + (s + 1)
// cap) per (source, destination), per-destination [L + min(inbound, R),
// W) per receiver — in 16-byte stores with no division per lane, and the
// first of them writes the stats.  A row's block is a multiply-high by a
// host multiplier, exact below 2**31 (no division per lane).  Phases 2
// and 3 are programmatic dependent launches: each starts while the one
// ahead of it ends, and phase 3's tiles copy their own region before they
// wait for phase 2's offsets.
#include "common.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kMaxLeaves = 32;
constexpr int kTile = 1024;              // lanes per K24 tile
constexpr int kThreads = 256;            // K24's blocks: 4 lanes a thread
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// phase 3's blocks an SM the compiler must fit (their registers)
constexpr int kWriteBlocks = 4;
constexpr int kFillBlocks = 264;         // about 2 per SM of an H100
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
  int32_t cap;    // legacy per-(source, destination) cap; -1: per-dest
  int32_t R;      // per-destination receive rung
  uint64_t div_m;       // row / sc as (row * div_m) >> div_s (row < 2**31)
  int32_t div_s;
  int32_t fill_per;     // K24 fill blocks per range of empty lanes
  int32_t fill_blocks;  // K24 fill blocks in all
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

// programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it on the stream ends; wait_prior blocks until that
// kernel has completed and its writes are visible, and let_next lets the
// next such kernel start now
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// a lane's destination block, n when it is invalid
__device__ __forceinline__ int dest_of(const Plan& p, int32_t r, bool mk) {
  if (!mk || r < 0) return p.n;
  const int d = static_cast<int>((static_cast<uint64_t>(r) * p.div_m) >>
                                 p.div_s);
  return d < p.n ? d : p.n;
}

// the 4 consecutive lanes j0 .. j0 + 3 of chunk s (input lanes i0 ..):
// rows and destination blocks (n: invalid); lanes past L or m are invalid
__device__ __forceinline__ void load_group(const int32_t* __restrict__ rows,
                                           const uint8_t* __restrict__ mask,
                                           const Plan& p, int64_t s,
                                           int64_t j0, int32_t r[4],
                                           int d[4]) {
  const int64_t i0 = s * p.L + j0;
  int64_t lim = p.L - j0;
  if (p.m - i0 < lim) lim = p.m - i0;
  bool mk[4];
  if (lim >= 4 && (reinterpret_cast<uintptr_t>(rows + i0) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(mask + i0) & 3) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(rows + i0);
    const uchar4 b = *reinterpret_cast<const uchar4*>(mask + i0);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
    mk[0] = b.x != 0;
    mk[1] = b.y != 0;
    mk[2] = b.z != 0;
    mk[3] = b.w != 0;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = -1;
      mk[k] = false;
      if (k < lim) {
        r[k] = rows[i0 + k];
        mk[k] = mask[i0 + k] != 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = dest_of(p, r[k], mk[k]);
}

// bytes [0, bytes) from src to dst in the widest unit both addresses and
// the length allow
__device__ __forceinline__ void copy_bytes(const char* src, char* dst,
                                           int64_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(bytes);
  if ((a & 15) == 0) {
    copy_row(src, dst, bytes, 16);
  } else if ((a & 7) == 0) {
    copy_row(src, dst, bytes, 8);
  } else if ((a & 3) == 0) {
    copy_row(src, dst, bytes, 4);
  } else {
    copy_row(src, dst, bytes, 1);
  }
}

__device__ __forceinline__ void zero_bytes(char* dst, int64_t bytes) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(bytes);
  int64_t b = 0;
  if ((a & 15) == 0) {
    for (; b < bytes; b += 16) {
      *reinterpret_cast<int4*>(dst + b) = make_int4(0, 0, 0, 0);
    }
  } else if ((a & 3) == 0) {
    for (; b < bytes; b += 4) *reinterpret_cast<int32_t*>(dst + b) = 0;
  } else {
    for (; b < bytes; ++b) dst[b] = 0;
  }
}

// bytes [b0, b1) of dst set to v (0 or 0xff), thread g of G: the head and
// tail outside 16-byte alignment byte by byte, the rest in 16-byte stores
__device__ __forceinline__ void fill_bytes(char* dst, int64_t b0, int64_t b1,
                                           int v, int64_t g, int64_t G) {
  if (b1 <= b0) return;
  char* p0 = dst + b0;
  char* p1 = dst + b1;
  const uintptr_t u0 = (reinterpret_cast<uintptr_t>(p0) + 15) &
                       ~static_cast<uintptr_t>(15);
  const uintptr_t u1 =
      reinterpret_cast<uintptr_t>(p1) & ~static_cast<uintptr_t>(15);
  const char byte = static_cast<char>(v);
  if (u0 >= u1) {
    for (int64_t k = g; k < b1 - b0; k += G) p0[k] = byte;
    return;
  }
  char* a0 = reinterpret_cast<char*>(u0);
  char* a1 = reinterpret_cast<char*>(u1);
  if (g < a0 - p0) p0[g] = byte;
  if (g < p1 - a1) a1[g] = byte;
  const int w = v ? -1 : 0;
  const int4 word = make_int4(w, w, w, w);
  int4* q = reinterpret_cast<int4*>(a0);
  const int64_t units = (a1 - a0) >> 4;
  for (int64_t k = g; k < units; k += G) q[k] = word;
}

__device__ __forceinline__ int32_t cap_of(const Plan& p, int d) {
  return p.cap >= 0 ? p.cap : p.caps[d];
}

// sum over sources q < s of min(need[q][d], cap of d): where chunk s's
// lanes bound for d start in d's per-destination bucket (s = n: d's
// inbound, all sources); need[q][d] = totals[q (n + 1) + d]
__device__ __forceinline__ int32_t before_of(
    const Plan& p, const int32_t* __restrict__ totals, int s, int d) {
  const int32_t cd = p.cap >= 0 ? p.cap : p.caps[d];
  int32_t acc = 0;
  for (int q = 0; q < s; ++q) {
    const int32_t v = totals[q * (p.n + 1) + d];
    acc += v < cd ? v : cd;
  }
  return acc;
}

// one tile's counts into h[0, n]: the cross lanes per destination of a
// thread's 4 lanes d[4] (chunk s) and the valid lanes in bin n.  kSmall
// (n <= 8): a warp's counts in 8 fields of 8 bits summed by two warp
// reductions (a thread adds at most 4 to a field, a warp at most 128);
// else a match per destination
template <bool kSmall>
__device__ __forceinline__ void count_tile(const int d[4], int n, int s,
                                           int32_t* h) {
  const int lane = threadIdx.x & 31;
  int valid = 0;
  if constexpr (kSmall) {
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      valid += d[k] < n;
      if (d[k] < n && d[k] != s) {
        if (d[k] < 4) {
          lo += 1u << (8 * d[k]);
        } else {
          hi += 1u << (8 * (d[k] - 4));
        }
      }
    }
    lo = __reduce_add_sync(kFull, lo);
    hi = __reduce_add_sync(kFull, hi);
    if (lane == 0) {
      for (int b = 0; b < n; ++b) {
        const unsigned v = ((b < 4 ? lo : hi) >> (8 * (b & 3))) & 0xffu;
        if (v) atomicAdd(&h[b], static_cast<int>(v));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      valid += d[k] < n;
      const bool cross = d[k] < n && d[k] != s;
      const unsigned peers = __match_any_sync(kFull, cross ? d[k] : -1);
      if (cross && lane == __ffs(peers) - 1) {
        atomicAdd(&h[d[k]], __popc(peers));
      }
    }
  }
  valid = __reduce_add_sync(kFull, valid);
  if (lane == 0 && valid) atomicAdd(&h[n], valid);
}

// (1) grid (tiles, n): per (chunk, tile of 1024 lanes) the cross lanes per
// destination and the valid lanes in bin n, 4 consecutive lanes a thread
// (one 16-byte row load and one 4-byte mask load)
template <bool kSmall>
__global__ void __launch_bounds__(kThreads)
    bucket_hist_kernel(const int32_t* __restrict__ rows,
                       const uint8_t* __restrict__ mask, const Plan p,
                       int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxShards + 1];
  const int n = p.n;
  for (int b = threadIdx.x; b <= n; b += kThreads) h[b] = 0;
  __syncthreads();
  const int s = blockIdx.y;
  const int64_t t = blockIdx.x;
  int32_t r[4];
  int d[4];
  load_group(rows, mask, p, s, t * kTile + 4 * threadIdx.x, r, d);
  count_tile<kSmall>(d, n, s, h);
  __syncthreads();
  int32_t* out = hist + (s * p.tiles + t) * (n + 1);
  for (int b = threadIdx.x; b <= n; b += kThreads) out[b] = h[b];
}

// exclusive block scan of one value per thread (blockDim.x ==
// kScanThreads); returns the block total in *total
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
  *total = warp_sums[kScanThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next round
  return before + x - v;
}

// (2) block (s, b) of n (n + 1): the exclusive scan over the tiles of one
// (chunk, bin) into off, and its total into totals[s (n + 1) + b] — the
// need matrix (b < n) and the chunk's valid lanes (b = n)
__global__ void __launch_bounds__(kScanThreads)
    bucket_scan_kernel(const Plan p, const int32_t* __restrict__ hist,
                       int32_t* __restrict__ off,
                       int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  let_next();  // phase 3's own-region copy needs nothing of this launch
  wait_prior();
  const int nb = p.n + 1;
  const int64_t s = blockIdx.x / nb;
  const int b = blockIdx.x % nb;
  int32_t carry = 0;
  for (int64_t t0 = 0; t0 < p.tiles; t0 += kScanThreads) {
    const int64_t t = t0 + threadIdx.x;
    const int64_t at = (s * p.tiles + t) * nb + b;
    const int32_t v = t < p.tiles ? hist[at] : 0;
    int32_t total;
    const int32_t ex = block_exclusive_scan(v, warp_sums, &total);
    if (t < p.tiles) off[at] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// receiver d's empty bucket lanes [lo, hi) of its region: row -1, mask 0,
// zero leaves; thread g of G
__device__ __forceinline__ void fill_lanes(const Plan& p, const Leaves& lv,
                                           int32_t* out_rows,
                                           uint8_t* out_mask, int64_t d,
                                           int64_t lo, int64_t hi, int64_t g,
                                           int64_t G) {
  if (hi <= lo) return;
  const int64_t o0 = d * p.W + lo, o1 = d * p.W + hi;
  fill_bytes(reinterpret_cast<char*>(out_rows), o0 * 4, o1 * 4, 0xff, g, G);
  fill_bytes(reinterpret_cast<char*>(out_mask), o0, o1, 0, g, G);
  for (int k = 0; k < lv.n; ++k) {
    const int64_t rb = lv.row_bytes[k];
    fill_bytes(lv.dst[k], o0 * rb, o1 * rb, 0, g, G);
  }
}

// the fill blocks of (3): fill_per blocks a range of empty bucket lanes —
// legacy (s, d): [L + s cap + min(need[s][d], cap), L + (s + 1) cap);
// per-destination d: [L + min(inbound of d, R), W); fill block 0 first
// writes the stats from the totals
__device__ void fill_block(const Plan& p, const Leaves& lv, unsigned f,
                           const int32_t* __restrict__ totals,
                           int32_t* __restrict__ out_rows,
                           uint8_t* __restrict__ out_mask,
                           int32_t* __restrict__ stats) {
  const int n = p.n;
  if (f == 0) {
    __shared__ int32_t sums[3];  // cross, dropped, valid
    if (threadIdx.x < 3) sums[threadIdx.x] = 0;
    __syncthreads();
    for (int d = threadIdx.x; d < n; d += kThreads) {
      const int32_t cd = cap_of(p, d);
      int32_t mx = 0, sum = 0, fill_sum = 0;
      for (int s = 0; s < n; ++s) {
        const int32_t v = totals[s * (n + 1) + d];
        mx = v > mx ? v : mx;
        sum += v;
        fill_sum += v < cd ? v : cd;
      }
      int32_t dropped = sum - fill_sum;
      if (p.cap < 0 && fill_sum > p.R) dropped += fill_sum - p.R;
      stats[3 + d] = mx;
      stats[3 + n + d] = sum;
      atomicAdd(&sums[0], sum);
      atomicAdd(&sums[1], dropped);
      atomicAdd(&sums[2], totals[d * (n + 1) + n]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      stats[0] = sums[0];
      stats[1] = sums[1];
      stats[2] = sums[2] - sums[1];
    }
  }
  const unsigned q = f / p.fill_per;
  const int64_t g = static_cast<int64_t>(f % p.fill_per) * kThreads +
                    threadIdx.x;
  const int64_t G = static_cast<int64_t>(p.fill_per) * kThreads;
  if (p.cap >= 0) {
    const int s = q / n, d = q % n;
    const int32_t v = totals[s * (n + 1) + d];
    const int64_t lo = p.L + static_cast<int64_t>(s) * p.cap +
                       (v < p.cap ? v : p.cap);
    fill_lanes(p, lv, out_rows, out_mask, d, lo,
               p.L + static_cast<int64_t>(s + 1) * p.cap, g, G);
  } else {
    const int d = q;
    const int32_t in = before_of(p, totals, n, d);
    fill_lanes(p, lv, out_rows, out_mask, d, p.L + (in < p.R ? in : p.R),
               p.W, g, G);
  }
}

// (3) blocks [0, n tiles), one tile each: the own-region copy, the stable
// ranks, the tile's cross lanes ordered by destination in shared memory,
// then the bucket writes, consecutive threads on consecutive slots; the
// rest: the empty bucket lanes and the stats.  kSmall (n <= 8): a round's
// ranks from one ballot per destination and the warp's running counts in
// registers; else a match
template <bool kSmall>
__global__ void __launch_bounds__(kThreads, kWriteBlocks)
    bucket_write_kernel(const int32_t* __restrict__ rows,
                        const uint8_t* __restrict__ mask, const Plan p,
                        const Leaves lv, const int32_t* __restrict__ off,
                        const int32_t* __restrict__ totals,
                        int32_t* __restrict__ out_rows,
                        uint8_t* __restrict__ out_mask,
                        uint8_t* __restrict__ dropped,
                        int32_t* __restrict__ stats) {
  const unsigned work = static_cast<unsigned>(p.n * p.tiles);
  if (blockIdx.x >= work) {
    const unsigned f = blockIdx.x - work;
    wait_prior();
    fill_block(p, lv, f, totals, out_rows, out_mask, stats);
    return;
  }
  __shared__ int32_t wc[kWarps][kMaxShards];  // warp counts, then offsets
  __shared__ int32_t at[kMaxShards + 1];      // the tile's runs by dest
  __shared__ int32_t keep[kMaxShards];        // lanes of a run that fit
  __shared__ int64_t slot0[kMaxShards];       // slot of a run's first lane
  __shared__ int32_t rr[kTile];
  __shared__ uint16_t order[kTile];
  __shared__ uint8_t code[kTile];
  __shared__ uint8_t drop[kTile];
  const int n = p.n;
  const unsigned blk = blockIdx.x;
  const unsigned tiles = static_cast<unsigned>(p.tiles);
  const int64_t s = blk / tiles, t = blk - (blk / tiles) * tiles;
  for (int q = threadIdx.x; q < kWarps * kMaxShards; q += kThreads) {
    (&wc[0][0])[q] = 0;
  }
  // (a) 4 consecutive lanes a thread: the own region (row kept where
  // local, -1 elsewhere; every leaf copied, zeros past m)
  const int64_t j0 = t * kTile + 4 * threadIdx.x;
  const int64_t i0 = s * p.L + j0;
  int32_t r[4];
  int d[4];
  load_group(rows, mask, p, s, j0, r, d);
  int64_t lanes = p.L - j0;
  lanes = lanes < 0 ? 0 : (lanes > 4 ? 4 : lanes);
  int64_t have = p.m - i0;
  have = have < 0 ? 0 : (have > lanes ? lanes : have);
  const int64_t o0 = s * p.W + j0;
  int32_t orow[4];
  uint8_t omask[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool local = d[k] == static_cast<int>(s);
    orow[k] = local ? r[k] : -1;
    omask[k] = local;
    code[4 * threadIdx.x + k] =
        static_cast<uint8_t>(d[k] < n && !local ? d[k] : n);
    rr[4 * threadIdx.x + k] = r[k];
  }
  if (lanes == 4 &&
      (reinterpret_cast<uintptr_t>(out_rows + o0) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out_mask + o0) & 3) == 0) {
    *reinterpret_cast<int4*>(out_rows + o0) =
        make_int4(orow[0], orow[1], orow[2], orow[3]);
    *reinterpret_cast<uchar4*>(out_mask + o0) =
        make_uchar4(omask[0], omask[1], omask[2], omask[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < lanes) {
        out_rows[o0 + k] = orow[k];
        out_mask[o0 + k] = omask[k];
      }
    }
  }
  if (lanes > 0) {
    for (int k = 0; k < lv.n; ++k) {
      const int64_t rb = lv.row_bytes[k];
      char* dst = lv.dst[k] + o0 * rb;
      copy_bytes(lv.src[k] + i0 * rb, dst, have * rb);
      zero_bytes(dst + have * rb, (lanes - have) * rb);
    }
  }
  // the offsets and totals of phase 2 from here on
  wait_prior();
  __syncthreads();
  // (b) 4 lanes a thread strided by 32 (warp w holds tile lanes [128 w,
  // 128 w + 128)): each cross lane's stable rank among the tile's lanes
  // bound for its destination — per round its lower lanes that share it
  // plus the warp's running count, then the warps' offsets
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int c[4], rank[4];
  if constexpr (kSmall) {
    int run[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = code[w * 128 + k * 32 + lane];
      unsigned mine = 0;
      int ahead = 0;
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        if (dd < n) {
          const unsigned b = __ballot_sync(kFull, c[k] == dd);
          if (c[k] == dd) {
            mine = b;
            ahead = run[dd];
          }
          run[dd] += __popc(b);
        }
      }
      rank[k] = ahead + __popc(mine & lower);
    }
    if (lane == 0) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        if (dd < n) wc[w][dd] = run[dd];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = code[w * 128 + k * 32 + lane];
      const bool cross = c[k] < n;
      const unsigned peers = __match_any_sync(kFull, cross ? c[k] : -1);
      rank[k] = cross ? wc[w][c[k]] + __popc(peers & lower) : 0;
      __syncwarp();
      if (cross && lane == __ffs(peers) - 1) wc[w][c[k]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // per destination: the warps' offsets, the run's length and how many of
  // it fit (the first ones: ranks are dense), and its first slot
  for (int dd = threadIdx.x; dd < n; dd += kThreads) {
    int32_t total = 0;
    for (int ww = 0; ww < kWarps; ++ww) {
      const int32_t v = wc[ww][dd];
      wc[ww][dd] = total;
      total += v;
    }
    const int32_t start = off[(s * p.tiles + t) * (n + 1) + dd];
    int64_t room, first;
    if (p.cap >= 0) {
      room = static_cast<int64_t>(p.cap) - start;
      first = dd * p.W + p.L + s * p.cap + start;
    } else {
      const int32_t before = before_of(p, totals, static_cast<int>(s), dd);
      room = p.caps[dd] - static_cast<int64_t>(start);
      const int64_t recv = static_cast<int64_t>(p.R) - before - start;
      room = recv < room ? recv : room;
      first = dd * p.W + p.L + before + start;
    }
    room = room < 0 ? 0 : room;
    keep[dd] = static_cast<int32_t>(room < total ? room : total);
    slot0[dd] = first;
    at[dd + 1] = total;  // lengths; the prefix follows
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    at[0] = 0;
    for (int dd = 0; dd < n; ++dd) at[dd + 1] += at[dd];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int jj = w * 128 + k * 32 + lane;
    bool dr = false;
    if (c[k] < n) {
      const int q = wc[w][c[k]] + rank[k];
      order[at[c[k]] + q] = static_cast<uint16_t>(jj);
      dr = q >= keep[c[k]];
    }
    drop[jj] = dr;
  }
  __syncthreads();
  // (c) the bucket writes: the tile's cross lanes in destination order,
  // one a thread, so a run's slots are written by consecutive threads
  const int64_t tile0 = s * p.L + t * kTile;
  for (int x = threadIdx.x; x < at[n]; x += kThreads) {
    int dd = 0;
    while (at[dd + 1] <= x) ++dd;
    const int q = x - at[dd];
    if (q >= keep[dd]) continue;
    const int jj = order[x];
    const int64_t slot = slot0[dd] + q;
    out_rows[slot] = rr[jj];
    out_mask[slot] = 1;
    const int64_t i = tile0 + jj;
    for (int l = 0; l < lv.n; ++l) {
      const int64_t rb = lv.row_bytes[l];
      copy_row(lv.src[l] + i * rb, lv.dst[l] + slot * rb, rb, lv.unit[l]);
    }
  }
  // (d) dropped, 4 consecutive input lanes a thread
  const uint8_t* dg = drop + 4 * threadIdx.x;
  if (have == 4 && (reinterpret_cast<uintptr_t>(dropped + i0) & 3) == 0) {
    *reinterpret_cast<uchar4*>(dropped + i0) =
        make_uchar4(dg[0], dg[1], dg[2], dg[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < have) dropped[i0 + k] = dg[k];
    }
  }
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

// K24 scratch (int32): hist and off n * tiles * (n + 1) each, totals
// n * (n + 1); tiles = ceil(L / 1024)
OT_EXPORT int exchange_buckets_scratch(int64_t L, int32_t n) {
  const int64_t tiles = (L + kTile - 1) / kTile;
  const int64_t words = 2 * n * tiles * (n + 1) + n * (n + 1);
  return words > 0x7fffffff ? -1 : static_cast<int>(words);
}

// K24: cap >= 0 is the legacy layout (W = L + n cap), cap < 0 the
// per-destination one (caps[n], receive rung R, W = L + R); n_leaves
// pieces (<= 32), leaf k row_bytes[k] bytes a lane, a lane's bucket copy
// in units of unit[k] bytes; outputs out_rows int32[n W], out_mask bool[n
// W], the leaves' [n W] outputs, dropped bool[m], stats int32[3 + 2n]
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
      m > n * L || n * L >= (int64_t{1} << 31) || n_leaves < 0 ||
      n_leaves > kMaxLeaves || (cap < 0 && R < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  p.m = m;
  p.L = L;
  p.n = n;
  p.cap = cap;
  p.R = R;
  p.tiles = (L + kTile - 1) / kTile;
  p.W = L + (cap >= 0 ? static_cast<int64_t>(n) * cap : R);
  for (int d = 0; d < kMaxShards; ++d) {
    p.caps[d] = (cap < 0 && d < n) ? caps[d] : 0;
  }
  // the division by sc of a row below 2**31, exact (Granlund and
  // Montgomery, N = 31): l = ceil(log2 sc), m = floor(2**(31 + l) / sc) + 1
  int l = 0;
  while ((int64_t{1} << l) < shard_capacity) ++l;
  p.div_s = 31 + l;
  p.div_m = ((uint64_t{1} << p.div_s) / static_cast<uint64_t>(shard_capacity))
            + 1;
  // fill blocks: about kFillBlocks, the same number for each range
  const int ranges = cap >= 0 ? n * n : n;
  p.fill_per = (kFillBlocks + ranges - 1) / ranges;
  p.fill_blocks = ranges * p.fill_per;
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
  int32_t* totals = off + cells;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(p.tiles), static_cast<unsigned>(n));
  if (n <= 8) {
    bucket_hist_kernel<true><<<grid1, kThreads, 0, st>>>(rows, mask, p, hist);
  } else {
    bucket_hist_kernel<false><<<grid1, kThreads, 0, st>>>(rows, mask, p,
                                                          hist);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // phases 2 and 3 start before the launch ahead of them ends (they wait
  // for its writes where they read them)
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * (n + 1)));
  cfg.blockDim = dim3(kScanThreads);
  cfg.stream = st;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bucket_scan_kernel, p,
                           static_cast<const int32_t*>(hist), off, totals);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(static_cast<unsigned>(p.fill_blocks + n * p.tiles));
  cfg.blockDim = dim3(kThreads);
  const int32_t* c_off = off;
  const int32_t* c_totals = totals;
  err = n <= 8 ? cudaLaunchKernelEx(&cfg, bucket_write_kernel<true>, rows,
                                    mask, p, lv, c_off, c_totals, out_rows,
                                    out_mask, dropped, stats)
               : cudaLaunchKernelEx(&cfg, bucket_write_kernel<false>, rows,
                                    mask, p, lv, c_off, c_totals, out_rows,
                                    out_mask, dropped, stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
