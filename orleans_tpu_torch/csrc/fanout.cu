// Ragged one-to-many expansion of published messages through a CSR
// subscription graph (the follow graph of Chirper, the streams plane's
// push CSR).
//
// Replaces orleans_tpu/tensor/fanout.py _expand_kernel (K11,
// fanout_expand).  Given the sorted source keys of the graph, their edge
// offsets and the destination keys of all edges (the expansion width W is
// the length of the edge table), and m source messages:
//
//   (a) per source lane: find its key in the graph (lower bound, clipped to
//       the last entry), its degree and first edge — 0 when the lane is not
//       valid or the key has no entry;
//   (b) an inclusive scan of the degrees, so lane i owns the output slots
//       [offs[i] - deg[i], offs[i]); a lane with edges whose range ends past
//       W delivers NOTHING (all-or-nothing: a partial prefix would deliver
//       twice on redelivery) and is flagged in src_dropped, counted into
//       n_dropped; total = offs[m - 1];
//   (c) per output slot j: the source lane that owns it (the upper bound of
//       j in the scan, clipped to m - 1), the edge start + (j - before), and
//       the destination key there; slots at or past total, and slots of a
//       dropped lane, are invalid and carry the key sentinel.
//
// Sums are taken mod 2^32 and read as int32, as the reference's int32
// cumsum wraps.
//
// Bound on an H100: bytes.  Per output slot the kernels read one edge
// (4 B) and write a key, a source index and a flag (9 B); per source lane
// they read a key and a flag (5 B) and write a flag (1 B); the graph's
// keys and offsets are read once (8 B per source).  Two launches:
//
//  1. the lane pass, a single-pass scan with decoupled look-back: each
//     block takes the tile of LANE_TILE lanes of its index (blocks are
//     dispatched in index order, so a tile only waits on running ones),
//     searches its keys (the first levels over splitters in shared
//     memory, the rest 4 lanes a thread in lockstep), scans the degrees,
//     publishes its aggregate, and its first warp walks back over the
//     earlier tiles' status words 32 at a time to its exclusive prefix.
//     The scan carries, beside the sum mod 2^32, a WRAP bit: set when a
//     degree is negative or an exact prefix passes 2^31 - 1, i.e. when
//     offs is not monotone.  The tile writes offs, start, the drop flags
//     and n_dropped (one atomic a block), the last tile writes total and
//     the wrap bit, and every lane whose slot range holds the first slot
//     of a slot tile writes itself as that tile's first owner;
//  2. the slot pass, one block per SLOT_TILE output slots, 4 a thread
//     (launched early: it waits for the lane pass's writes where it reads
//     them).  With offs monotone, a block stages the window of offs and
//     start from its tile's first owner to the next tile's in shared
//     memory (WINDOW lanes a round, more rounds only where zero-degree
//     lanes crowd it), and gives each group of 4 slots its owner by one
//     search in shared memory, searching again only where the owner
//     changes; it stores 16-byte groups and gathers csr_dst contiguously
//     along an owner's run.  When the
//     wrap bit is set (the reference's searchsorted on a non-monotone
//     offs), the block takes the reference's own fixed-depth bisection
//     per slot over offs in global memory instead: the choice is made on the device, so a CUDA
//     graph holds one plan.  The slot pass also zeroes the look-back
//     state the lane pass used, so the next launch finds it clean.
//
// Scratch (start, offs, the tile owners) comes from the wrapper, and so
// does the look-back state: a zeroed block of 64-bit words (one status
// word a lane tile) that every launch leaves zeroed.
#include "common.cuh"

namespace {

constexpr int LANE_THREADS = 256;
constexpr int LANE_ITEMS = 4;
constexpr int LANE_TILE = LANE_THREADS * LANE_ITEMS;
constexpr int SLOT_THREADS = 256;
constexpr int SLOT_TILE = SLOT_THREADS * 4;  // 4 consecutive slots a thread
constexpr int WINDOW = 2048;             // owner lanes staged a round
constexpr unsigned FULL = 0xffffffffu;

// a look-back status word: flag (bits 62-63), wrap bit (32), sum mod 2^32
constexpr uint64_t ST_AGGREGATE = 1ull << 62;
constexpr uint64_t ST_PREFIX = 2ull << 62;
constexpr uint64_t ST_FLAGS = 3ull << 62;
constexpr uint64_t ST_WRAP = 1ull << 32;
constexpr uint64_t LOW32 = 0xffffffffull;
constexpr uint64_t INT32_TOP = 0x7fffffffull;

// programmatic dependent launch (Hopper): the slot pass may start before
// the lane pass ends; wait_prior blocks until the lane pass has completed
// and its writes are visible
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(p) = v;
}

// exclusive prefix of v over the block (blockDim.x <= 1024, a multiple of
// 32), and the block's total; every thread of the block must call it
__device__ uint64_t block_exclusive_scan(uint64_t v, uint64_t* total) {
  __shared__ uint64_t warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint64_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint64_t s = lane < n_warps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const uint64_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[n_warps - 1];
  return before + x - v;
}

// the exclusive prefix of `tile` as (wrap bit | sum mod 2^32), found by
// warp 0 walking back over the status words of the tiles before it; the
// sums of the words it combines are exact while no wrap bit is set, so the
// prefix wraps when one does or when their exact sum passes 2^31 - 1
__device__ uint64_t look_back(const uint64_t* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint64_t sum = 0;
  bool wrap = false;
  for (int64_t base = tile - 1;; base -= 32) {
    const int64_t p = base - lane;
    uint64_t w = p >= 0 ? load_status(status + p) : ST_PREFIX;
    while (__any_sync(FULL, (w & ST_FLAGS) == 0)) {
      if ((w & ST_FLAGS) == 0) {
        __nanosleep(32);
        w = load_status(status + p);
      }
    }
    const unsigned prefixes =
        __ballot_sync(FULL, (w & ST_FLAGS) == ST_PREFIX);
    // the nearest prefix ends the walk; the aggregates before it add in
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    uint64_t v = lane <= stop ? (w & LOW32) : 0;
    bool wr = lane <= stop && (w & ST_WRAP);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    sum += v;
    wrap |= __any_sync(FULL, wr) != 0;
    if (prefixes) break;
  }
  return ((wrap || sum > INT32_TOP) ? ST_WRAP : 0) | (sum & LOW32);
}

// two scans combined: the sum mod 2^32 and the wrap bit of the whole
__device__ __forceinline__ uint64_t combine(uint64_t a, uint64_t b) {
  const uint64_t sum = (a & LOW32) + (b & LOW32);
  const bool wrap = (a & ST_WRAP) || (b & ST_WRAP) || sum > INT32_TOP;
  return (wrap ? ST_WRAP : 0) | (sum & LOW32);
}

// 1: the lane pass
__global__ void __launch_bounds__(LANE_THREADS)
fanout_lanes_kernel(const int32_t* __restrict__ csr_keys,
                    const int32_t* __restrict__ csr_offsets, int32_t n_src,
                    const int32_t* __restrict__ src_keys,
                    const uint8_t* __restrict__ valid, int64_t m,
                    int32_t width, int64_t n_tiles, int64_t n_slot_tiles,
                    uint64_t* __restrict__ lookback,
                    int32_t* __restrict__ start, int32_t* __restrict__ offs,
                    uint8_t* __restrict__ src_dropped,
                    int32_t* __restrict__ tile_owner,
                    int32_t* __restrict__ wrapped,
                    int32_t* __restrict__ total,
                    int32_t* __restrict__ n_dropped) {
  __shared__ int32_t splitters[LANE_THREADS];
  __shared__ uint64_t prefix_s;
  uint64_t* status = lookback;
  // tiles in block order: a tile waits only on blocks dispatched before it
  const int64_t tile = blockIdx.x;
  const int64_t first = tile * LANE_TILE
      + static_cast<int64_t>(threadIdx.x) * LANE_ITEMS;
  // splitter q is csr_keys[q * step], one a thread, loaded beside the keys
  const int32_t step = (n_src + LANE_THREADS - 1) / LANE_THREADS;
  const int32_t n_spl = (n_src + step - 1) / step;
  if (threadIdx.x < n_spl) {
    splitters[threadIdx.x] =
        __ldg(csr_keys + static_cast<int64_t>(threadIdx.x) * step);
  }
  int32_t key[LANE_ITEMS], lo[LANE_ITEMS], len[LANE_ITEMS];
  bool lane_ok[LANE_ITEMS];
#pragma unroll
  for (int k = 0; k < LANE_ITEMS; ++k) {
    const int64_t i = first + k;
    key[k] = i < m ? src_keys[i] : 0;
    lane_ok[k] = i < m && valid[i];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LANE_ITEMS; ++k) {
    // the first splitter >= key puts the key's lower bound in
    // (step * (a - 1), step * a]: the search's first levels in shared
    // memory, the rest over at most step - 1 keys in global memory
    int32_t a = 0, n = n_spl;
    while (n > 1) {
      const int32_t half = n >> 1;
      a = splitters[a + half] < key[k] ? a + half : a;
      n -= half;
    }
    a += splitters[a] < key[k];
    lo[k] = a > 0 ? (a - 1) * step + 1 : 0;
    len[k] = (a < n_spl ? a * step : n_src) - lo[k];
  }
  bool more = true;
  while (more) {
    more = false;
#pragma unroll
    for (int k = 0; k < LANE_ITEMS; ++k) {
      if (len[k] > 0) {
        const int32_t half = len[k] >> 1;
        if (__ldg(csr_keys + lo[k] + half) < key[k]) {
          lo[k] += half + 1;
          len[k] -= half + 1;
        } else {
          len[k] = half;
        }
        more |= len[k] > 0;
      }
    }
  }
  uint32_t deg[LANE_ITEMS];
  uint64_t sum = 0;
  bool negative = false;
#pragma unroll
  for (int k = 0; k < LANE_ITEMS; ++k) {
    const int64_t i = first + k;
    uint32_t d = 0;
    if (i < m) {
      const int32_t idx = lo[k] < n_src - 1 ? lo[k] : n_src - 1;
      const bool hit = lane_ok[k] && __ldg(csr_keys + idx) == key[k];
      const int32_t s0 = hit ? __ldg(csr_offsets + idx) : 0;
      d = hit ? static_cast<uint32_t>(__ldg(csr_offsets + idx + 1))
              - static_cast<uint32_t>(s0) : 0u;
      start[i] = s0;
      negative |= static_cast<int32_t>(d) < 0;
    }
    deg[k] = d;
    sum += d;
  }
  uint64_t tile_sum;
  const uint64_t before = block_exclusive_scan(sum, &tile_sum);
  negative = __syncthreads_or(negative) != 0;
  const uint64_t aggregate =
      ((negative || tile_sum > INT32_TOP) ? ST_WRAP : 0) | (tile_sum & LOW32);
  if (threadIdx.x < 32) {
    uint64_t exclusive = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) store_status(status + tile,
                                         ST_AGGREGATE | aggregate);
      exclusive = look_back(status, tile);
    }
    if (threadIdx.x == 0) {
      store_status(status + tile, ST_PREFIX | combine(exclusive, aggregate));
      prefix_s = exclusive;
      if (tile == n_tiles - 1) {
        *wrapped = (combine(exclusive, aggregate) & ST_WRAP) != 0;
      }
    }
  }
  __syncthreads();
  let_next();
  uint32_t run = static_cast<uint32_t>(prefix_s & LOW32)
      + static_cast<uint32_t>(before);
  int drops = 0;
#pragma unroll
  for (int k = 0; k < LANE_ITEMS; ++k) {
    const int64_t i = first + k;
    if (i >= m) break;
    const int32_t excl = static_cast<int32_t>(run);
    run += deg[k];
    const int32_t incl = static_cast<int32_t>(run);
    offs[i] = incl;
    const bool drop = static_cast<int32_t>(deg[k]) > 0 && incl > width;
    src_dropped[i] = drop;
    drops += drop;
    if (i == m - 1) *total = incl;
    // the slot tiles whose first slot this lane owns (with offs monotone;
    // under a wrap the slot pass does not read them)
    if (static_cast<int32_t>(deg[k]) > 0 && excl >= 0 && incl > excl) {
      const int64_t k1 = (static_cast<int64_t>(incl) - 1) / SLOT_TILE;
      for (int64_t t = (static_cast<int64_t>(excl) + SLOT_TILE - 1)
               / SLOT_TILE;
           t <= k1 && t < n_slot_tiles; ++t) {
        tile_owner[t] = static_cast<int32_t>(i);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) drops += __shfl_xor_sync(FULL, drops, o);
  if ((threadIdx.x & 31) == 0 && drops) atomicAdd(n_dropped, drops);
}

// the reference's answer for slot j when offs may not be monotone: the
// reference's fixed-depth bisection for searchsorted(side="right") (JAX's
// default method): ceil(log2(m + 1)) steps from (low, high) = (0, m), each
// mid = (low + high) / 2 in uint32, going left where j < offs[mid]; the
// answer is high, clipped to m - 1
__device__ void slot_by_search(int64_t j64, const int32_t* __restrict__ offs,
                               int64_t m, const int32_t* __restrict__ start,
                               const int32_t* __restrict__ csr_dst,
                               int32_t width, int32_t total,
                               int32_t* __restrict__ dst,
                               int32_t* __restrict__ src_index,
                               uint8_t* __restrict__ out_valid) {
  const int32_t j = static_cast<int32_t>(j64);
  const int n_levels = 64 - __clzll(static_cast<unsigned long long>(m));
  uint32_t low = 0, high = static_cast<uint32_t>(m);
  for (int l = 0; l < n_levels; ++l) {
    const uint32_t mid = (low + high) >> 1;  // < m while low < high
    const bool go_left = j < offs[mid < m ? mid : m - 1];
    low = go_left ? low : mid;
    high = go_left ? mid : high;
  }
  const int64_t src = high < m - 1 ? high : m - 1;
  const int32_t before = src > 0 ? offs[src - 1] : 0;
  const int32_t e = static_cast<int32_t>(
      static_cast<uint32_t>(start[src]) + static_cast<uint32_t>(j)
      - static_cast<uint32_t>(before));
  const bool ok = j < total && offs[src] <= width;
  const int32_t ec = e < 0 ? 0 : (e > width - 1 ? width - 1 : e);
  dst[j64] = ok ? __ldg(csr_dst + ec) : OT_KEY_SENTINEL;
  src_index[j64] = static_cast<int32_t>(src);
  out_valid[j64] = ok;
}

// 2: the slot pass, one tile of SLOT_TILE slots a block
__global__ void __launch_bounds__(SLOT_THREADS)
fanout_slots_kernel(const int32_t* __restrict__ offs, int64_t m,
                    const int32_t* __restrict__ start,
                    const int32_t* __restrict__ csr_dst, int32_t width,
                    int64_t n_slot_tiles,
                    const int32_t* __restrict__ tile_owner,
                    const int32_t* __restrict__ wrapped,
                    const int32_t* __restrict__ total_p,
                    uint64_t* __restrict__ lookback, int64_t n_words,
                    int32_t* __restrict__ dst,
                    int32_t* __restrict__ src_index,
                    uint8_t* __restrict__ out_valid) {
  __shared__ int32_t ends[WINDOW];
  __shared__ int32_t starts[WINDOW];
  wait_prior();
  // the lane pass is over: leave its look-back state zeroed
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
       + threadIdx.x; i < n_words;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    lookback[i] = 0;
  }
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * SLOT_TILE;
  if (j0 >= width) return;
  const int64_t j_end = j0 + SLOT_TILE < width ? j0 + SLOT_TILE : width;
  const int32_t total = *total_p;
  if (*wrapped) {
    for (int64_t j = j0 + threadIdx.x; j < j_end; j += blockDim.x) {
      slot_by_search(j, offs, m, start, csr_dst, width, total, dst,
                     src_index, out_valid);
    }
    return;
  }
  // offs is monotone: slots in [j0, j_live) have owners, the rest are past
  // total (owner m - 1, invalid)
  const int64_t j_live = total < j_end ? (total > j0 ? total : j0) : j_end;
  // this thread's 4 slots, past total until an owner is found
  const int64_t jg = j0 + 4 * threadIdx.x;
  int32_t r_dst[4], r_src[4];
  uint8_t r_ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r_dst[e] = OT_KEY_SENTINEL;
    r_src[e] = static_cast<int32_t>(m - 1);
    r_ok[e] = 0;
  }
  if (j0 < j_live) {
    // the tile's owners run from its first slot's owner to the next
    // tile's first slot's owner (to the last lane after the last live tile)
    int64_t c0 = tile_owner[blockIdx.x];
    const int64_t next = blockIdx.x + 1;
    const int64_t c_last =
        next < n_slot_tiles && next * SLOT_TILE < total ? tile_owner[next]
                                                        : m - 1;
    while (true) {
      const int64_t c1 = c0 + WINDOW <= c_last ? c0 + WINDOW : c_last + 1;
      const int n = static_cast<int>(c1 - c0);
      {  // all of a thread's loads of the window in flight at once
        int32_t e_v[WINDOW / SLOT_THREADS], s_v[WINDOW / SLOT_THREADS];
#pragma unroll
        for (int r = 0; r < WINDOW / SLOT_THREADS; ++r) {
          const int q = threadIdx.x + r * SLOT_THREADS;
          e_v[r] = q < n ? offs[c0 + q] : 0;
          s_v[r] = q < n ? start[c0 + q] : 0;
        }
#pragma unroll
        for (int r = 0; r < WINDOW / SLOT_THREADS; ++r) {
          const int q = threadIdx.x + r * SLOT_THREADS;
          if (q < n) {
            ends[q] = e_v[r];
            starts[q] = s_v[r];
          }
        }
      }
      const int32_t base = c0 > 0 ? offs[c0 - 1] : 0;
      __syncthreads();
      const int32_t covered = ends[n - 1];  // slots below it have owners here
      if (jg + 3 >= base && jg < j_live && jg < covered) {
        // the first owner by a search over the window
        const int32_t jf = static_cast<int32_t>(jg > base ? jg : base);
        int q = 0, len = n;
        while (len > 0) {
          const int half = len >> 1;
          if (ends[q + half] <= jf) {
            q += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t j = jg + e;
          if (j < base || j >= j_live || j >= covered) continue;
          if (ends[q] <= j) {  // the next owner, past any zero-degree lanes
            int len2 = n - q - 1;
            ++q;
            while (len2 > 0) {
              const int half = len2 >> 1;
              if (ends[q + half] <= j) {
                q += half + 1;
                len2 -= half + 1;
              } else {
                len2 = half;
              }
            }
          }
          const int32_t before = q > 0 ? ends[q - 1] : base;
          const int32_t edge = static_cast<int32_t>(
              static_cast<uint32_t>(starts[q]) + static_cast<uint32_t>(j)
              - static_cast<uint32_t>(before));
          const bool ok = ends[q] <= width;
          const int32_t ec =
              edge < 0 ? 0 : (edge > width - 1 ? width - 1 : edge);
          r_dst[e] = ok ? __ldg(csr_dst + ec) : OT_KEY_SENTINEL;
          r_src[e] = static_cast<int32_t>(c0 + q);
          r_ok[e] = ok;
        }
      }
      if (covered >= j_live || c1 > c_last) break;
      __syncthreads();  // the window is restaged
      c0 = c1;
    }
  }
  if (jg + 4 <= j_end) {
    *reinterpret_cast<int4*>(dst + jg) =
        make_int4(r_dst[0], r_dst[1], r_dst[2], r_dst[3]);
    *reinterpret_cast<int4*>(src_index + jg) =
        make_int4(r_src[0], r_src[1], r_src[2], r_src[3]);
    *reinterpret_cast<uchar4*>(out_valid + jg) =
        make_uchar4(r_ok[0], r_ok[1], r_ok[2], r_ok[3]);
  } else {
    for (int e = 0; e < 4 && jg + e < j_end; ++e) {
      dst[jg + e] = r_dst[e];
      src_index[jg + e] = r_src[e];
      out_valid[jg + e] = r_ok[e];
    }
  }
}

}  // namespace

// lookback: ceil(m / LANE_TILE) zeroed 64-bit words; tile_owner:
// ceil(width / SLOT_TILE) + 1 int32, the last the wrap flag
OT_EXPORT int fanout_expand(const int32_t* csr_keys,
                            const int32_t* csr_offsets, int32_t n_src,
                            const int32_t* csr_dst, int32_t width,
                            const int32_t* src_keys, const uint8_t* valid,
                            int64_t m, int32_t* start, int32_t* offs,
                            uint64_t* lookback, int32_t* tile_owner,
                            int32_t* dst,
                            int32_t* src_index, uint8_t* out_valid,
                            int32_t* total, uint8_t* src_dropped,
                            int32_t* n_dropped, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (m + LANE_TILE - 1) / LANE_TILE;
  const int64_t n_slot_tiles =
      width > 0 ? (static_cast<int64_t>(width) + SLOT_TILE - 1) / SLOT_TILE
                : 0;
  int32_t* wrapped = tile_owner + n_slot_tiles;
  fanout_lanes_kernel<<<static_cast<unsigned int>(n_tiles), LANE_THREADS, 0,
                        s>>>(csr_keys, csr_offsets, n_src, src_keys, valid,
                             m, width, n_tiles, n_slot_tiles, lookback,
                             start, offs, src_dropped, tile_owner, wrapped,
                             total, n_dropped);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_slot_tiles > 0 ? n_slot_tiles
                                                            : 1));
  cfg.blockDim = dim3(SLOT_THREADS);
  cfg.stream = s;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  const int32_t* c_offs = offs;
  const int32_t* c_start = start;
  const int32_t* c_owner = tile_owner;
  const int32_t* c_wrapped = wrapped;
  const int32_t* c_total = total;
  err = cudaLaunchKernelEx(&cfg, fanout_slots_kernel, c_offs, m, c_start,
                           csr_dst, width, n_slot_tiles, c_owner, c_wrapped,
                           c_total, lookback, n_tiles, dst, src_index,
                           out_valid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
