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
// (each index clipped to n-1, as the reference clips, so repeated probes
// at the end agree) against the full words; the first match wins.
//
// Narrow-into-wide mode (hi == nullptr): an int32 key k is the wide key
// (0, k), and keys >= the sentinel are padding, never lookups.
//
// Bound on an H100: bytes.  Per lane the kernel reads two words (8 B) and a
// valid flag (1 B) and writes a row (4 B); the mirror (16 B per arena row)
// sits in the 50 MB L2 after the first touches at the arena sizes of the
// smoke.  Design: one thread per lane, coalesced lane accesses, binary
// search and probes through the read-only cache; the miss count is reduced
// per warp with __ballot_sync + __popc and lands with one atomicAdd per
// warp into the given counter (a fused window's running total, or a fresh
// zeroed scalar).
#include "common.cuh"

namespace {

constexpr int WIDE_PROBES = 4;

__device__ __forceinline__ int32_t mix32(uint32_t hi, uint32_t lo) {
  uint32_t h = (hi * 0x85EBCA6Bu) ^ (lo * 0xC2B2AE35u);
  h ^= h >> 15;
  h *= 0x27D4EB2Fu;
  h ^= h >> 13;
  return static_cast<int32_t>(h & 0x3FFFFFFFu);
}

__global__ void resolve_wide_kernel(const int32_t* __restrict__ sorted_h,
                                    const int32_t* __restrict__ rows_by_h,
                                    int32_t n,
                                    const int32_t* __restrict__ hi_col,
                                    const int32_t* __restrict__ lo_col,
                                    int32_t cap,
                                    const int32_t* __restrict__ hi,
                                    const int32_t* __restrict__ lo,
                                    const uint8_t* __restrict__ valid,
                                    int32_t* __restrict__ rows,
                                    int32_t* __restrict__ miss_count,
                                    int64_t m) {
  int local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < m; base += stride) {
    const int64_t i = base + threadIdx.x;
    bool miss = false;
    if (i < m) {
      const int32_t w_lo = lo[i];
      const int32_t w_hi = hi != nullptr ? hi[i] : 0;
      const bool v = valid[i] && (hi != nullptr || w_lo < OT_KEY_SENTINEL);
      const int32_t h = mix32(static_cast<uint32_t>(w_hi),
                              static_cast<uint32_t>(w_lo));
      // lower bound == jnp.searchsorted(side="left"), then clip to n-1
      int32_t a = 0, b = n;
      while (a < b) {
        const int32_t mid = a + ((b - a) >> 1);
        if (__ldg(sorted_h + mid) < h) a = mid + 1; else b = mid;
      }
      const int32_t idx = a < n - 1 ? a : n - 1;
      int32_t r = -1;
      if (v) {
        for (int k = 0; k < WIDE_PROBES && r < 0; ++k) {
          const int32_t j = idx + k < n - 1 ? idx + k : n - 1;
          if (__ldg(sorted_h + j) != h) continue;
          const int32_t cand = __ldg(rows_by_h + j);
          if (cand < 0) continue;
          const int32_t cr = cand < cap - 1 ? cand : cap - 1;
          if (__ldg(hi_col + cr) == w_hi && __ldg(lo_col + cr) == w_lo)
            r = cand;
        }
      }
      rows[i] = r;
      miss = (r >= 0) != v;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, miss);
    local += __popc(ballot);
  }
  if (local && (threadIdx.x & 31) == 0) atomicAdd(miss_count, local);
}

}  // namespace

OT_EXPORT int resolve_wide(const int32_t* sorted_h, const int32_t* rows_by_h,
                           int32_t n, const int32_t* hi_col,
                           const int32_t* lo_col, int32_t cap,
                           const int32_t* hi, const int32_t* lo,
                           const uint8_t* valid, int32_t* rows,
                           int32_t* miss_count, int64_t m, void* stream) {
  resolve_wide_kernel<<<ot_blocks(m), OT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sorted_h, rows_by_h, n, hi_col, lo_col, cap, hi, lo, valid, rows,
      miss_count, m);
  return static_cast<int>(cudaGetLastError());
}
