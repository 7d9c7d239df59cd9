// Shared helpers of the orleans_tpu_torch kernels.  Every entry point has
// a plain C interface (pointers, sizes, the stream), launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define OT_EXPORT extern "C" __attribute__((visibility("default")))

// the device-path key sentinel (orleans_tpu_torch.tensor.vector_grain):
// keys >= this are padding, never lookups
constexpr int32_t OT_KEY_SENTINEL = 2147483647;

constexpr int OT_THREADS = 256;

// blocks for a grid-stride loop over `work` items, capped so very large
// launches loop inside the block instead of growing the grid
inline unsigned int ot_blocks(int64_t work, int64_t cap = 1 << 16) {
  int64_t b = (work + OT_THREADS - 1) / OT_THREADS;
  if (b < 1) b = 1;
  return static_cast<unsigned int>(b < cap ? b : cap);
}

// streaming multiprocessors of the current device, read once per library
// (a host query, never a stream operation: safe while a graph captures)
inline int ot_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1) {
      cudaGetLastError();  // clear it: the launch reports its own status
      sms = 132;
    }
  }
  return sms;
}

// blocks of `threads` threads (and `smem` bytes of dynamic shared memory)
// one SM holds at once for `kernel`, 1 when the query fails; asked once per
// kernel and shape (a host query, never a stream operation: safe while a
// graph captures).  A persistent grid past that runs in a second wave.
template <typename Kernel>
int ot_max_blocks(Kernel kernel, int threads, size_t smem = 0) {
  struct Seen {
    const void* fn;
    int threads;
    size_t smem;
    int fit;
  };
  static Seen seen[64];
  static int n_seen = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].fn == fn && seen[i].threads == threads &&
        seen[i].smem == smem) {
      return seen[i].fit;
    }
  }
  int fit = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                    smem) != cudaSuccess ||
      fit < 1) {
    cudaGetLastError();  // clear it: the launch reports its own status
    fit = 1;
  }
  if (n_seen < 64) seen[n_seen++] = {fn, threads, smem, fit};
  return fit;
}

// sum of v over the block (every thread must call it); thread 0 holds the
// result.  `scratch` has a slot per warp.
template <typename T>
__device__ __forceinline__ T ot_block_sum(T v, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      total += scratch[w];
    }
  }
  return total;
}

// error text for the wrapper's exception
OT_EXPORT const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
