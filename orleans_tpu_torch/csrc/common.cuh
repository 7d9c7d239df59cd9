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

// error text for the wrapper's exception
OT_EXPORT const char* ot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
