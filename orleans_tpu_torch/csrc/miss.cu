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
// A cold path: it runs only at the miss-check drain, after a batch missed.
// What matters is that the output is exact and deterministic; speed does
// not.  Bound on an H100: bytes for the mark pass (a key, a row and a
// valid flag read, a mask byte written per lane); the sort moves
// O(n2 log^2 n2) words for n2 = the unique misses padded to a power of
// two.
//
// Design, all on one stream and with no host synchronisation:
//  1. init: the hash table (P slots, a power of two >= 2m) and the compact
//     buffer (C slots, a power of two >= m) fill with the sentinel, which
//     no inserted key can equal (they are all below it); the counter is 0.
//  2. mark: one thread per lane writes the missing mask and inserts a
//     missing key into the table by open addressing (atomicCAS, linear
//     probing).  The thread whose CAS claimed the empty slot appends the
//     key to the compact buffer through an atomic counter, so each unique
//     key lands there exactly once, in no fixed order.
//  3. bitonic sort of the compact buffer's prefix of n2 keys, n2 the
//     power of two at or above the counter (the tail past the counter
//     still holds the sentinel and sorts last, and the buffer past n2 is
//     all sentinel, so sorting the prefix sorts the buffer).  The host
//     does not know the counter, so the whole sort is ONE cooperative
//     kernel that reads it on the device: stages up to a 2048-key tile
//     run in shared memory, one tile per block in turn; each longer stage
//     makes one grid-wide pass per step down to the tile size, a grid
//     barrier between passes, then finishes in shared memory.  The work
//     and the barriers follow the unique keys found, not the lane count.
//  4. emit: the first miss_buf keys of the sorted buffer, padded with the
//     sentinel when the buffer is shorter.
// The sort makes the output independent of the insertion order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 2048;        // keys per shared-memory tile
constexpr int kSortThreads = 512;  // threads per sort block

__global__ void miss_init_kernel(int32_t* __restrict__ table, int64_t p,
                                 int32_t* __restrict__ compact, int64_t c,
                                 int32_t* __restrict__ counter) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < p; i += stride) {
    table[i] = OT_KEY_SENTINEL;
    if (i < c) compact[i] = OT_KEY_SENTINEL;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
}

__device__ __forceinline__ uint32_t slot_of(int32_t key, uint32_t mask) {
  uint32_t h = static_cast<uint32_t>(key) * 0x9E3779B1u;
  h ^= h >> 16;
  return h & mask;
}

__global__ void miss_mark_kernel(const int32_t* __restrict__ keys,
                                 const int32_t* __restrict__ rows,
                                 const uint8_t* __restrict__ valid, int64_t m,
                                 uint8_t* __restrict__ missing,
                                 int32_t* __restrict__ table, uint32_t mask,
                                 int32_t* __restrict__ compact,
                                 int32_t* __restrict__ counter) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    const int32_t k = keys[i];
    const bool miss = rows[i] < 0 && valid[i] != 0 && k < OT_KEY_SENTINEL;
    missing[i] = miss;
    if (!miss) continue;
    uint32_t s = slot_of(k, mask);
    while (true) {
      const int32_t prev = atomicCAS(table + s, OT_KEY_SENTINEL, k);
      if (prev == OT_KEY_SENTINEL) {  // first sight of this key
        compact[atomicAdd(counter, 1)] = k;
        break;
      }
      if (prev == k) break;
      s = (s + 1) & mask;
    }
  }
}

// pair p of a bitonic step of width j: (i, i + j) with bit j of i clear
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// n2: the power of two >= max(counter, 2), the prefix the sort must cover
__device__ __forceinline__ int64_t sorted_span(const int32_t* counter) {
  const int32_t n = *counter;
  int64_t n2 = 2;
  while (n2 < n) n2 <<= 1;
  return n2;
}

__device__ __forceinline__ void order(int32_t& a, int32_t& b, bool up) {
  if ((a > b) == up) {
    const int32_t t = a;
    a = b;
    b = t;
  }
}

// stages 2..tile of the bitonic network over one tile in shared memory
// (directions by the keys' global positions base + i)
__device__ void sort_tile(int32_t* s, int64_t base, int tile) {
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int lo = static_cast<int>(pair_low(p, j));
        order(s[lo], s[lo + j], ((base + lo) & k) == 0);
      }
      __syncthreads();
    }
  }
}

// the steps j < tile of a stage longer than the tile: one direction
__device__ void merge_tile(int32_t* s, int tile, bool up) {
  for (int j = tile >> 1; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int lo = static_cast<int>(pair_low(p, j));
      order(s[lo], s[lo + j], up);
    }
    __syncthreads();
  }
}

// The whole sort of data[0, n2).  Launched cooperatively with every block
// resident, so grid.sync() orders the passes (it also fences memory).
__global__ void bitonic_sort_kernel(int32_t* data,
                                    const int32_t* __restrict__ counter) {
  __shared__ int32_t s[kTile];
  cg::grid_group grid = cg::this_grid();
  const int64_t n2 = sorted_span(counter);
  const int tile = static_cast<int>(n2 < kTile ? n2 : kTile);
  const int64_t tiles = n2 / tile;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = data[base + i];
    __syncthreads();
    sort_tile(s, base, tile);
    for (int i = threadIdx.x; i < tile; i += blockDim.x) data[base + i] = s[i];
    __syncthreads();
  }
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= n2; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile; j >>= 1) {
      grid.sync();
      for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
           p < (n2 >> 1); p += stride) {
        const int64_t lo = pair_low(p, j);
        order(data[lo], data[lo + j], (lo & k) == 0);
      }
    }
    grid.sync();
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t base = t * tile;
      for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        s[i] = data[base + i];
      }
      __syncthreads();
      merge_tile(s, tile, (base & k) == 0);
      for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        data[base + i] = s[i];
      }
      __syncthreads();
    }
  }
}

__global__ void miss_emit_kernel(const int32_t* __restrict__ sorted,
                                 int64_t c, int32_t* __restrict__ out,
                                 int64_t miss_buf) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < miss_buf; i += stride) {
    out[i] = i < c ? sorted[i] : OT_KEY_SENTINEL;
  }
}

}  // namespace

// p and c are powers of two, p >= 2 * m, c >= max(m, 2); table, compact
// and counter are the wrapper's scratch
OT_EXPORT int miss_keys(const int32_t* keys, const int32_t* rows,
                        const uint8_t* valid, int64_t m, uint8_t* missing,
                        int32_t* out, int64_t miss_buf, int32_t* table,
                        int64_t p, int32_t* compact, int64_t c,
                        int32_t* counter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  miss_init_kernel<<<ot_blocks(p), OT_THREADS, 0, s>>>(table, p, compact, c,
                                                       counter);
  miss_mark_kernel<<<ot_blocks(m), OT_THREADS, 0, s>>>(
      keys, rows, valid, m, missing, table, static_cast<uint32_t>(p - 1),
      compact, counter);
  // every block resident at once: the cooperative launch's condition
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bitonic_sort_kernel, kSortThreads, 0);
    grid = sms * (per_sm < 1 ? 1 : per_sm);
  }
  void* args[] = {&compact, &counter};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bitonic_sort_kernel), dim3(grid),
      dim3(kSortThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  miss_emit_kernel<<<ot_blocks(miss_buf), OT_THREADS, 0, s>>>(compact, c,
                                                              out, miss_buf);
  return static_cast<int>(cudaGetLastError());
}
