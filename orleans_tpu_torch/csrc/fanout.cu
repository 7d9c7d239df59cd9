// Ragged one-to-many expansion of published messages through a CSR
// subscription graph (the follow graph of Chirper).
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
// keys and offsets are read once (8 B per source).  Design: the scan runs
// as three launches (a block scan of 1024 lanes per block that also does
// the search of (a), a one-block scan of the block sums, and a pass that
// adds each block's prefix and flags the dropped lanes); (c) is one thread
// per OUTPUT SLOT with a binary search of the scan (an L2-resident 4 B per
// lane), never one thread per source lane looping over its slots: a
// power-law graph puts ~200k edges behind one source, which one thread
// would serialise.  Scratch (start, offs, block sums) comes from the
// wrapper.
#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SUMS_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// exclusive prefix of v over the block (blockDim.x <= 1024, a multiple of
// 32), and the block's total; every thread of the block must call it
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < n_warps ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// (a) + the block-local part of (b): one tile of SCAN_TILE lanes per block
__global__ void fanout_lanes_kernel(const int32_t* __restrict__ csr_keys,
                                    const int32_t* __restrict__ csr_offsets,
                                    int32_t n_src,
                                    const int32_t* __restrict__ src_keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t m, int32_t* __restrict__ start,
                                    int32_t* __restrict__ offs,
                                    uint8_t* __restrict__ has_edges,
                                    uint32_t* __restrict__ block_sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * SCAN_TILE
      + static_cast<int64_t>(threadIdx.x) * SCAN_ITEMS;
  uint32_t deg[SCAN_ITEMS];
  uint32_t sum = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t i = first + k;
    uint32_t d = 0;
    if (i < m) {
      const int32_t key = src_keys[i];
      int32_t a = 0, b = n_src;
      while (a < b) {
        const int32_t mid = a + ((b - a) >> 1);
        if (__ldg(csr_keys + mid) < key) a = mid + 1; else b = mid;
      }
      const int32_t idx = a < n_src - 1 ? a : n_src - 1;
      const bool hit = valid[i] && __ldg(csr_keys + idx) == key;
      const int32_t s0 = hit ? __ldg(csr_offsets + idx) : 0;
      d = hit ? static_cast<uint32_t>(__ldg(csr_offsets + idx + 1))
              - static_cast<uint32_t>(s0) : 0u;
      start[i] = s0;
      has_edges[i] = static_cast<int32_t>(d) > 0;
    }
    deg[k] = d;
    sum += d;
  }
  uint32_t tile_total;
  uint32_t run = block_exclusive_scan(sum, &tile_total);
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t i = first + k;
    run += deg[k];
    if (i < m) offs[i] = static_cast<int32_t>(run);
  }
  if (threadIdx.x == 0) block_sums[blockIdx.x] = tile_total;
}

// (b), the block sums: one block turns them into exclusive block prefixes
__global__ void fanout_block_prefix_kernel(uint32_t* __restrict__ sums,
                                           int64_t n_blocks) {
  uint32_t carry = 0;
  for (int64_t base = 0; base < n_blocks; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const uint32_t v = i < n_blocks ? sums[i] : 0u;
    uint32_t chunk_total;
    const uint32_t ex = block_exclusive_scan(v, &chunk_total);
    if (i < n_blocks) sums[i] = carry + ex;
    carry += chunk_total;
  }
}

// (b), the end: add each block's prefix, flag and count the dropped lanes,
// write the total
__global__ void fanout_finish_kernel(int32_t* __restrict__ offs,
                                     const uint32_t* __restrict__ prefix,
                                     int64_t m, int32_t width,
                                     uint8_t* __restrict__ src_dropped,
                                     int32_t* __restrict__ total,
                                     int32_t* __restrict__ n_dropped) {
  int local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < m; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool drop = false;
    if (i < m) {
      const int32_t o = static_cast<int32_t>(
          static_cast<uint32_t>(offs[i]) + prefix[i / SCAN_TILE]);
      offs[i] = o;
      drop = src_dropped[i] && o > width;  // src_dropped holds deg > 0
      src_dropped[i] = drop;
      if (i == m - 1) *total = o;
    }
    local += __popc(__ballot_sync(FULL, drop));
  }
  if (local && (threadIdx.x & 31) == 0) atomicAdd(n_dropped, local);
}

// (c): one thread per output slot
__global__ void fanout_slots_kernel(const int32_t* __restrict__ offs,
                                    int64_t m,
                                    const int32_t* __restrict__ start,
                                    const int32_t* __restrict__ csr_dst,
                                    int32_t width,
                                    int32_t* __restrict__ dst,
                                    int32_t* __restrict__ src_index,
                                    uint8_t* __restrict__ out_valid) {
  const int32_t total = offs[m - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j64 = static_cast<int64_t>(blockIdx.x) * blockDim.x
       + threadIdx.x; j64 < width; j64 += stride) {
    const int32_t j = static_cast<int32_t>(j64);
    // upper bound == jnp.searchsorted(side="right"): first i, offs[i] > j
    int64_t a = 0, b = m;
    while (a < b) {
      const int64_t mid = a + ((b - a) >> 1);
      if (__ldg(offs + mid) <= j) a = mid + 1; else b = mid;
    }
    const int64_t src = a < m - 1 ? a : m - 1;
    const int32_t before = src > 0 ? __ldg(offs + src - 1) : 0;
    const int32_t e = static_cast<int32_t>(
        static_cast<uint32_t>(__ldg(start + src))
        + static_cast<uint32_t>(j) - static_cast<uint32_t>(before));
    const bool ok = j < total && __ldg(offs + src) <= width;
    const int32_t ec = e < 0 ? 0 : (e > width - 1 ? width - 1 : e);
    dst[j] = ok ? __ldg(csr_dst + ec) : OT_KEY_SENTINEL;
    src_index[j] = static_cast<int32_t>(src);
    out_valid[j] = ok;
  }
}

}  // namespace

OT_EXPORT int fanout_expand(const int32_t* csr_keys,
                            const int32_t* csr_offsets, int32_t n_src,
                            const int32_t* csr_dst, int32_t width,
                            const int32_t* src_keys, const uint8_t* valid,
                            int64_t m, int32_t* start, int32_t* offs,
                            uint32_t* block_sums, int32_t* dst,
                            int32_t* src_index, uint8_t* out_valid,
                            int32_t* total, uint8_t* src_dropped,
                            int32_t* n_dropped, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_blocks = (m + SCAN_TILE - 1) / SCAN_TILE;
  fanout_lanes_kernel<<<static_cast<unsigned int>(n_blocks), SCAN_THREADS,
                        0, s>>>(csr_keys, csr_offsets, n_src, src_keys,
                                valid, m, start, offs, src_dropped,
                                block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fanout_block_prefix_kernel<<<1, SUMS_THREADS, 0, s>>>(block_sums,
                                                        n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fanout_finish_kernel<<<ot_blocks(m), OT_THREADS, 0, s>>>(
      offs, block_sums, m, width, src_dropped, total, n_dropped);
  err = cudaGetLastError();
  if (err != cudaSuccess || width <= 0) return static_cast<int>(err);
  fanout_slots_kernel<<<ot_blocks(width), OT_THREADS, 0, s>>>(
      offs, m, start, csr_dst, width, dst, src_index, out_valid);
  return static_cast<int>(cudaGetLastError());
}
