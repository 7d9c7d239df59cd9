// Key -> row resolution of emitted messages against an arena's device
// directory mirror, plus the count of messages whose key is not active.
//
// Replaces orleans_tpu/tensor/engine.py _resolve_rows_dense_kernel (K1,
// resolve_dense) and _resolve_rows_kernel (K2, resolve_sorted).
//
// Bound on an H100: bytes.  Per lane the kernel reads a key (4 B) and a
// valid flag (1 B) and writes a row (4 B); the directory (dense map or
// sorted keys/rows) is small enough to sit in the 50 MB L2 after the
// first touches.  Design: one thread per lane, coalesced key/valid/row
// accesses; the miss count is reduced per warp with __ballot_sync +
// __popc and lands with ONE atomicAdd per warp, so the count costs no
// second pass and stays on the device (the engine reads it only at its
// miss-check drain).
#include "common.cuh"

namespace {

// all 32 lanes of every warp reach the ballot: the loop bound is
// block-uniform (base < m), and out-of-range lanes vote false
__device__ __forceinline__ void add_warp_misses(int local, int32_t* count) {
  if (local && (threadIdx.x & 31) == 0) atomicAdd(count, local);
}

__global__ void resolve_dense_kernel(const int32_t* __restrict__ dense,
                                     int32_t size,
                                     const int32_t* __restrict__ keys,
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
      const int32_t k = keys[i];
      const bool v = valid[i] && k < OT_KEY_SENTINEL;
      const bool in_range = v && k >= 0 && k < size;
      const int32_t r = in_range ? __ldg(dense + k) : -1;
      rows[i] = r;
      miss = (in_range && r >= 0) != v;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, miss);
    local += __popc(ballot);
  }
  add_warp_misses(local, miss_count);
}

__global__ void resolve_sorted_kernel(const int32_t* __restrict__ sorted_keys,
                                      const int32_t* __restrict__ sorted_rows,
                                      int32_t n_sorted,
                                      const int32_t* __restrict__ keys,
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
      const int32_t k = keys[i];
      const bool v = valid[i] && k < OT_KEY_SENTINEL;
      // lower bound == jnp.searchsorted(side="left"), then clip to n-1
      int32_t lo = 0, hi = n_sorted;
      while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (__ldg(sorted_keys + mid) < k) lo = mid + 1; else hi = mid;
      }
      const int32_t idx = lo < n_sorted - 1 ? lo : n_sorted - 1;
      const bool hit = v && __ldg(sorted_keys + idx) == k;
      rows[i] = hit ? __ldg(sorted_rows + idx) : -1;
      miss = hit != v;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, miss);
    local += __popc(ballot);
  }
  add_warp_misses(local, miss_count);
}

}  // namespace

OT_EXPORT int resolve_dense(const int32_t* dense, int32_t size,
                            const int32_t* keys, const uint8_t* valid,
                            int32_t* rows, int32_t* miss_count, int64_t m,
                            void* stream) {
  resolve_dense_kernel<<<ot_blocks(m), OT_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      dense, size, keys, valid, rows, miss_count, m);
  return static_cast<int>(cudaGetLastError());
}

OT_EXPORT int resolve_sorted(const int32_t* sorted_keys,
                             const int32_t* sorted_rows, int32_t n_sorted,
                             const int32_t* keys, const uint8_t* valid,
                             int32_t* rows, int32_t* miss_count, int64_t m,
                             void* stream) {
  resolve_sorted_kernel<<<ot_blocks(m), OT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, sorted_rows, n_sorted, keys, valid, rows, miss_count, m);
  return static_cast<int>(cudaGetLastError());
}
