// The hot-grain replica spread (K18 spread_replicas): delivery lanes whose
// resolved row is a replicated PRIMARY re-point to one of the grain's
// replica rows by lane hash; every other lane (misses, rows < 0, rows of
// unreplicated grains) passes through unchanged.
//
// Replaces orleans_tpu/tensor/arena.py _spread_replicas_kernel:
//   idx    = lower_bound(prim, rows[lane]) clipped to G - 1
//   hit    = prim[idx] == rows[lane] && rows[lane] >= 0
//   h      = ((uint32)lane * 2654435761u) >> 8
//   choice = h % (uint32)counts[idx]
//   alt    = table[idx * 8 + choice]
//   out    = hit && alt >= 0 ? alt : rows[lane]
// ``prim`` holds the sorted primary rows, pow2-padded with 2^31 - 1;
// ``counts`` the group sizes (padded with 1, so the modulus never divides
// by zero); ``table`` the [G, 8] replica rows (padded with -1).  The lane
// number is the position in the rows vector and is taken modulo 2^32 as
// JAX's uint32 iota; the hash is computed in uint32_t, so the product
// wraps exactly as JAX's does (from lane 2 on).
//
// Bound on an H100: bytes, 8 per lane (a row read, a row written) over
// 3.35 TB/s.  The mirror is a few hundred bytes at most (G is the number
// of replicated grains, pow2-padded) and stays in L1 after the first
// touches, so its reads are not counted.  Design: one thread per lane in
// a grid-stride loop, coalesced row reads and writes; the binary search
// over ``prim`` (log2 G steps) and the table read go through the
// read-only cache.
#include "common.cuh"

namespace {

constexpr int kTableWidth = 8;  // GrainArena.REPLICA_TABLE_WIDTH

__global__ void spread_replicas_kernel(const int32_t* __restrict__ prim,
                                       const int32_t* __restrict__ counts,
                                       const int32_t* __restrict__ table,
                                       int32_t n_groups,
                                       const int32_t* __restrict__ rows,
                                       int32_t* __restrict__ out, int64_t m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    const int32_t r = rows[i];
    // lower bound == jnp.searchsorted(side="left"), then clip to G - 1
    int32_t lo = 0, hi = n_groups;
    while (lo < hi) {
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(prim + mid) < r) lo = mid + 1; else hi = mid;
    }
    const int32_t idx = lo < n_groups - 1 ? lo : n_groups - 1;
    int32_t res = r;
    if (r >= 0 && __ldg(prim + idx) == r) {
      const uint32_t h = (static_cast<uint32_t>(i) * 2654435761u) >> 8;
      const uint32_t choice = h % static_cast<uint32_t>(__ldg(counts + idx));
      const int32_t alt = __ldg(table + static_cast<int64_t>(idx) *
                                            kTableWidth + choice);
      if (alt >= 0) res = alt;
    }
    out[i] = res;
  }
}

}  // namespace

OT_EXPORT int spread_replicas(const int32_t* prim, const int32_t* counts,
                              const int32_t* table, int32_t n_groups,
                              const int32_t* rows, int32_t* out, int64_t m,
                              void* stream) {
  spread_replicas_kernel<<<ot_blocks(m), OT_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      prim, counts, table, n_groups, rows, out, m);
  return static_cast<int>(cudaGetLastError());
}
