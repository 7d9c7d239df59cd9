// The unseen keys of a cold batch: the sorted unique keys of the lanes
// that were valid, below the sentinel and did not resolve, the smallest
// miss_buf of them, padded with the sentinel; plus the lane mask of those
// dropped messages.  The output equals
//   jnp.unique(where(missing, keys, SENTINEL), size=miss_buf,
//              fill_value=SENTINEL)
// since the sentinel is larger than every key it pads.
//
// Replaces orleans_tpu/tensor/engine.py _miss_keys_kernel (K6, miss_keys).
//
// It runs at the miss-check drain after a batch missed, and on every
// inject of a cluster whose remote keys miss here.  Bound on an H100:
// bytes, a key, a row and a valid flag read and a mask byte written per
// lane, and the miss_buf keys written.
//
// Design, three launches on one stream, no host synchronisation:
//  1. mark: each block takes a chunk of lanes, each thread 4 lanes 32
//     apart (a warp covers 128 consecutive lanes); it writes the missing
//     mask, and the missing lanes of a warp that share a key elect one
//     leader (__match_any_sync).  A leader reads its key's hash slot with
//     a plain load first, so a key already in the table costs no atomic;
//     only an empty slot is claimed by atomicCAS (open addressing, linear
//     probing).  Each block's first warp marks 32 lanes alone before the
//     rest (a scout): with every block's scout in, most keys are in the
//     table before the bulk of the lanes read it, so few lanes race for
//     one empty slot.  A claimed key goes to a list in shared memory, and
//     each block appends its list to the compact buffer (the keys and
//     their slots) with one atomic on the global count a round.
//  2. sort, one cooperative launch whose path is chosen on the device from
//     the count n of unique keys: up to SMALL_MAX keys, tiles of TILE keys
//     are sorted each by one block, a key a thread, in a bitonic network
//     (partners under 32 apart through shuffles, farther ones through
//     shared memory), the blocks on different SMs and none waiting on
//     another; above it, an LSD radix sort of the order-mapped
//     keys (signed keys sort as unsigned after flipping the sign bit), 8
//     bits a pass, stable: each block counts its chunk's digits, a grid
//     barrier, each block derives its digits' offsets from every block's
//     counts and scatters its chunk in order, ranked within a warp by
//     __match_any_sync.  Both leave the keys in the compact buffer.
//  3. emit (launched early, under the sort): the padding out[n, miss_buf)
//     and the clean-up of the table's used slots (read from the compact
//     buffer) first; then, once the sort is over, each key's rank places
//     it in out when the rank is below miss_buf: after the radix sort its
//     index; with tiles, its index in its tile plus its lower bound in
//     every other tile (the keys are unique), searched in a copy of all
//     the tiles in the block's shared memory (at most SMALL_MAX keys).
//     The last block to finish zeroes the count.
// The sort makes the output independent of the insertion order.  The
// table and the count are the wrapper's pool, made once (the table filled
// with the sentinel) and left that way by every launch: no call fills
// the table.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MARK_THREADS = 256;
constexpr int MARK_LANES = 4 * MARK_THREADS;  // lanes a block a round
constexpr int SORT_THREADS = 512;
constexpr int TILE = SORT_THREADS;            // keys a tile, one a thread
constexpr int MAX_TILES = 32;
constexpr int64_t SMALL_MAX = MAX_TILES * TILE;  // tiles to here, else radix
constexpr int RADIX = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int EMIT_THREADS = 256;

// programmatic dependent launch (Hopper): the emit starts under the sort
// and waits for it only where it reads the sorted keys
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void let_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ uint32_t slot_of(int32_t key, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(key) * 0x9E3779B1u;
  h ^= h >> 16;
  return h & mask;
}

// the missing mask of lanes warp_first + 32 k + lane (k < kc, below hi),
// and the keys this thread's leaders claimed appended to the block's list
__device__ void mark_lanes(const int32_t* __restrict__ keys,
                           const int32_t* __restrict__ rows,
                           const uint8_t* __restrict__ valid,
                           int64_t warp_first, int kc, int64_t hi,
                           uint8_t* __restrict__ missing, int32_t* table,
                           uint32_t mask, int32_t* new_keys,
                           int32_t* new_slots, int* n_new) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int32_t key[4];
  bool miss[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t i = warp_first + 32 * k + lane;
    key[k] = 0;
    miss[k] = false;
    if (k < kc && i < hi) {  // the three loads in flight together
      key[k] = keys[i];
      const int32_t row = rows[i];
      const uint8_t ok = valid[i];
      miss[k] = row < 0 && ok != 0 && key[k] < OT_KEY_SENTINEL;
      missing[i] = miss[k];
    }
  }
  // one leader a key a warp, and its slot read before any atomic (a plain
  // load: a stale sentinel only sends the leader to the CAS, which reads
  // the slot as it is; within a launch a slot never returns to the
  // sentinel)
  bool lead[4];
  uint32_t s[4];
  int32_t cur[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned active = __ballot_sync(FULL, miss[k]);
    lead[k] = false;
    if (miss[k]) {
      lead[k] = (__match_any_sync(active, key[k]) & below) == 0;
    }
    s[k] = slot_of(key[k], mask);
    cur[k] = lead[k] ? table[s[k]] : 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!lead[k]) continue;
    while (cur[k] != key[k]) {
      if (cur[k] == OT_KEY_SENTINEL) {
        const int32_t prev = atomicCAS(table + s[k], OT_KEY_SENTINEL,
                                       key[k]);
        if (prev == OT_KEY_SENTINEL) {  // first sight of this key
          const int q = atomicAdd(n_new, 1);
          new_keys[q] = key[k];
          new_slots[q] = static_cast<int32_t>(s[k]);
          break;
        }
        if (prev == key[k]) break;
      }
      s[k] = (s[k] + 1) & mask;
      cur[k] = table[s[k]];
    }
  }
}

// the block's claimed keys (and their slots) appended to the compact
// buffer with one atomic on the count; every thread of the block calls it
__device__ void flush_new(const int32_t* new_keys, const int32_t* new_slots,
                          int* n_new, int* base, int32_t* __restrict__ uniq,
                          int32_t* __restrict__ slots,
                          int32_t* __restrict__ count) {
  __syncthreads();
  if (threadIdx.x == 0 && *n_new) *base = atomicAdd(count, *n_new);
  __syncthreads();
  for (int q = threadIdx.x; q < *n_new; q += blockDim.x) {
    uniq[*base + q] = new_keys[q];
    slots[*base + q] = new_slots[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) *n_new = 0;
  __syncthreads();
}

// each block takes one contiguous chunk of lanes: first its first warp
// alone marks 32 lanes (a scout: with every block's scout in, most keys
// are in the table before the bulk of the lanes look, so few lanes race
// for an empty slot), then the rest, 4 lanes a thread
__global__ void __launch_bounds__(MARK_THREADS)
miss_mark_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ rows,
                 const uint8_t* __restrict__ valid, int64_t m,
                 uint8_t* __restrict__ missing, int32_t* __restrict__ table,
                 uint32_t mask, int32_t* __restrict__ uniq,
                 int32_t* __restrict__ slots,
                 int32_t* __restrict__ count) {
  __shared__ int32_t new_keys[MARK_LANES];
  __shared__ int32_t new_slots[MARK_LANES];
  __shared__ int n_new, base;
  const int64_t chunk = (m + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * chunk;
  const int64_t hi = lo + chunk < m ? lo + chunk : m;
  if (threadIdx.x == 0) n_new = 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    mark_lanes(keys, rows, valid, lo, 1, hi, missing, table, mask,
               new_keys, new_slots, &n_new);
  }
  flush_new(new_keys, new_slots, &n_new, &base, uniq, slots, count);
  for (int64_t round = lo + 32; round < hi; round += MARK_LANES) {
    mark_lanes(keys, rows, valid, round + (threadIdx.x >> 5) * 128, 4, hi,
               missing, table, mask, new_keys, new_slots, &n_new);
    flush_new(new_keys, new_slots, &n_new, &base, uniq, slots, count);
  }
}

// one key a thread, sorted ascending over the block's first `len` threads
// (len a power of two <= blockDim; threads past it hold the sentinel) by a
// bitonic network: partners under 32 apart swap through shuffles, farther
// ones through shared memory
__device__ int32_t sort_block(int32_t v, int len, int32_t* s) {
  const int i = threadIdx.x;
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int32_t other;
      if (j < 32) {
        other = __shfl_xor_sync(FULL, v, j);
      } else {
        s[i] = v;
        __syncthreads();
        other = s[i ^ j];
        __syncthreads();
      }
      const bool low = (i & j) == 0, up = (i & k) == 0;
      v = (low == up) ? min(v, other) : max(v, other);
    }
  }
  return v;
}

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift) {
  return ((static_cast<uint32_t>(key) ^ 0x80000000u) >> shift) & (RADIX - 1);
}

// one stable LSD pass of the keys src[0, n) into dst by the digit at
// `shift`; every block of the cooperative grid takes one chunk.  The
// buffers are written earlier in the same launch, so they are read by
// plain loads (never the read-only path), which the grid barriers order.
__device__ void radix_pass(const int32_t* src, int32_t* dst, int64_t n,
                           int shift, int32_t* block_counts,
                           cg::grid_group& grid) {
  __shared__ int32_t counts[SORT_WARPS][RADIX];
  __shared__ int32_t offset[RADIX];
  __shared__ int32_t tile_total[RADIX];
  __shared__ int32_t warp_sums[RADIX / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunk = (n + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * chunk < n ? blockIdx.x * chunk : n;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  if (threadIdx.x < RADIX) offset[threadIdx.x] = 0;
  __syncthreads();
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    atomicAdd(&offset[digit_of(src[i], shift)], 1);
  }
  __syncthreads();
  if (threadIdx.x < RADIX) {
    block_counts[threadIdx.x * gridDim.x + blockIdx.x] = offset[threadIdx.x];
  }
  grid.sync();
  // digit d's first place for this block: the keys of smaller digits
  // anywhere, then those of digit d in the blocks before it
  if (threadIdx.x < RADIX) {
    int64_t all = 0, before = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) {
      const int32_t c = block_counts[threadIdx.x * gridDim.x + b];
      all += c;
      if (b < blockIdx.x) before += c;
    }
    tile_total[threadIdx.x] = static_cast<int32_t>(all);
    offset[threadIdx.x] = static_cast<int32_t>(before);
  }
  __syncthreads();
  // the digits' exclusive prefix: a shuffle scan in each of 8 warps
  if (threadIdx.x < RADIX) {
    const int32_t all = tile_total[threadIdx.x];
    int32_t x = all;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    tile_total[threadIdx.x] = x - all;
  }
  __syncthreads();
  if (threadIdx.x < RADIX) {
    int32_t add = tile_total[threadIdx.x];
    for (int w = 0; w < warp; ++w) add += warp_sums[w];
    offset[threadIdx.x] += add;
  }
  // the chunk in order, blockDim keys at a time
  for (int64_t t0 = lo; t0 < hi; t0 += blockDim.x) {
    for (int q = threadIdx.x; q < SORT_WARPS * RADIX; q += blockDim.x) {
      counts[q / RADIX][q % RADIX] = 0;
    }
    __syncthreads();
    const int64_t i = t0 + threadIdx.x;
    const bool has = i < hi;
    const int32_t key = has ? src[i] : 0;
    const uint32_t d = digit_of(key, shift);
    const unsigned active = __ballot_sync(FULL, has);
    unsigned peers = 0;
    if (has) {
      peers = __match_any_sync(active, d);
      if ((peers & ((1u << lane) - 1)) == 0) counts[warp][d] = __popc(peers);
    }
    __syncthreads();
    if (threadIdx.x < RADIX) {
      int32_t run = 0;
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int32_t c = counts[w][threadIdx.x];
        counts[w][threadIdx.x] = run;
        run += c;
      }
      tile_total[threadIdx.x] = run;
    }
    __syncthreads();
    if (has) {
      dst[offset[d] + counts[warp][d]
          + __popc(peers & ((1u << lane) - 1))] = key;
    }
    __syncthreads();
    if (threadIdx.x < RADIX) offset[threadIdx.x] += tile_total[threadIdx.x];
  }
  grid.sync();
}

__global__ void __launch_bounds__(SORT_THREADS)
miss_sort_kernel(int32_t* uniq, int32_t* spare, const int32_t* count,
                 int32_t* block_counts) {
  __shared__ int32_t s[TILE];
  const int64_t n = *count;
  if (n <= SMALL_MAX) {
    let_next();
    int len = TILE;
    if (n < TILE) {
      len = 32;
      while (len < n) len <<= 1;
    }
    // tile t on block t * spread: the sorting blocks land on different
    // SMs, not several to an SM
    const unsigned spread =
        gridDim.x >= 2 * MAX_TILES ? gridDim.x / MAX_TILES : 1;
    if (blockIdx.x % spread) return;
    for (int64_t t = blockIdx.x / spread; t * TILE < n;
         t += gridDim.x / spread) {
      const int64_t base = t * TILE;
      const int have = static_cast<int>(n - base < TILE ? n - base : TILE);
      const int i = threadIdx.x;
      int32_t v = i < have ? uniq[base + i] : OT_KEY_SENTINEL;
      v = sort_block(v, len, s);
      if (i < have) uniq[base + i] = v;
      __syncthreads();
    }
    return;
  }
  cg::grid_group grid = cg::this_grid();
  let_next();
  for (int shift = 0; shift < 32; shift += 16) {
    radix_pass(uniq, spare, n, shift, block_counts, grid);
    radix_pass(spare, uniq, n, shift + 8, block_counts, grid);
  }
}

__global__ void __launch_bounds__(EMIT_THREADS)
miss_emit_kernel(const int32_t* uniq,
                 const int32_t* __restrict__ slots,
                 int32_t* __restrict__ table, int32_t* __restrict__ state,
                 int32_t* __restrict__ out, int64_t miss_buf) {
  extern __shared__ int4 sorted4[];  // the tiles, on the tile path
  int32_t* sorted = reinterpret_cast<int32_t*>(sorted4);
  const int64_t n = state[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x
      + threadIdx.x;
  for (int64_t j = n + first; j < miss_buf; j += stride) {
    out[j] = OT_KEY_SENTINEL;
  }
  for (int64_t i = first; i < n; i += stride) {
    table[slots[i]] = OT_KEY_SENTINEL;
  }
  wait_prior();
  if (n > SMALL_MAX) {  // the radix sort left the keys in order
    for (int64_t i = first; i < n && i < miss_buf; i += stride) {
      out[i] = uniq[i];
    }
  } else if (first - threadIdx.x < n) {
    // a key's rank: its index in its tile plus its lower bound in every
    // other tile, searched in the block's copy of all the tiles
    const int64_t n4 = n >> 2;
    for (int64_t q = threadIdx.x; q < n4; q += 4 * blockDim.x) {
      int4 v[4];  // 16 keys a thread in flight at once
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t at = q + r * blockDim.x;
        if (at < n4) v[r] = __ldg(reinterpret_cast<const int4*>(uniq) + at);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t at = q + r * blockDim.x;
        if (at < n4) sorted4[at] = v[r];
      }
    }
    for (int64_t q = 4 * n4 + threadIdx.x; q < n; q += blockDim.x) {
      sorted[q] = __ldg(uniq + q);
    }
    __syncthreads();
    const int tiles = static_cast<int>((n + TILE - 1) / TILE);
    const int64_t i = first;
    if (i < n) {
      const int32_t key = sorted[i];
      const int own = static_cast<int>(i / TILE);
      int64_t rank = i - static_cast<int64_t>(own) * TILE;
      for (int t = 0; t < tiles; ++t) {
        if (t == own) continue;
        int lo = t * TILE;
        int len = static_cast<int>(n - t * TILE < TILE ? n - t * TILE
                                                      : TILE);
        while (len > 0) {
          const int half = len >> 1;
          if (sorted[lo + half] < key) {
            lo += half + 1;
            len -= half + 1;
          } else {
            len = half;
          }
        }
        rank += lo - t * TILE;
      }
      if (rank < miss_buf) out[rank] = key;
    }
  }
  // the last block out zeroes the count for the next launch
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&state[1], 1) == static_cast<int32_t>(gridDim.x) - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    state[0] = 0;
    state[1] = 0;
  }
}

}  // namespace

// the emit's shared copy of the tiles takes more than the default 48 KB
OT_EXPORT int miss_keys_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      miss_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMALL_MAX * sizeof(int32_t))));
}

// table (p slots, a power of two >= 2m, all the sentinel) and state (the
// count and the emit's done-counter, both 0) are the wrapper's pool and
// are left so; uniq, slots and spare hold max(m, 1) int32 each;
// block_counts RADIX * max_sort_blocks int32
OT_EXPORT int miss_keys(const int32_t* keys, const int32_t* rows,
                        const uint8_t* valid, int64_t m, uint8_t* missing,
                        int32_t* out, int64_t miss_buf, int32_t* table,
                        int64_t p, int32_t* state, int32_t* uniq,
                        int32_t* slots, int32_t* spare,
                        int32_t* block_counts, int64_t max_sort_blocks,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = ot_sm_count();
  // one resident wave, each block a chunk of at least MARK_LANES lanes
  int64_t mark_grid = sms * static_cast<int64_t>(
      ot_max_blocks(miss_mark_kernel, MARK_THREADS));
  const int64_t rounds = (m + MARK_LANES - 1) / MARK_LANES;
  if (mark_grid > rounds) mark_grid = rounds > 0 ? rounds : 1;
  miss_mark_kernel<<<static_cast<unsigned>(mark_grid), MARK_THREADS, 0, s>>>(
      keys, rows, valid, m, missing, table, static_cast<uint32_t>(p - 1),
      uniq, slots, state);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block resident at once: the cooperative launch's condition
  int64_t sort_grid = sms * static_cast<int64_t>(
      ot_max_blocks(miss_sort_kernel, SORT_THREADS));
  if (sort_grid > max_sort_blocks) sort_grid = max_sort_blocks;
  const int32_t* c_state = state;
  void* args[] = {&uniq, &spare, &c_state, &block_counts};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(miss_sort_kernel),
      dim3(static_cast<unsigned>(sort_grid)), dim3(SORT_THREADS), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  // a thread for every key the tile path can rank
  cfg.gridDim = dim3(static_cast<unsigned>(
      sms * 3 > SMALL_MAX / EMIT_THREADS ? sms * 3
                                         : SMALL_MAX / EMIT_THREADS));
  cfg.blockDim = dim3(EMIT_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(m < SMALL_MAX ? m : SMALL_MAX)
      * sizeof(int32_t);
  cfg.stream = s;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  const int32_t* c_uniq = uniq;
  const int32_t* c_slots = slots;
  err = cudaLaunchKernelEx(&cfg, miss_emit_kernel, c_uniq, c_slots, table,
                           state, out, miss_buf);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
