// Masked count into one cell of the latency ledger's histogram:
// hist[cell] += count(base[i] && (rows == nullptr || rows[i] >= 0)).
//
// Replaces orleans_tpu/tensor/ledger.py _count_rows_kernel (K5,
// hist_count) and the fused window's in-window ledger add,
// orleans_tpu/tensor/fused.py hist.at[slot, 0].add(sum(mask)), which is
// the same count with no rows.  The fused window also adds its delivered
// and spilled lane counts into its totals with it.
//
// Bound on an H100: bytes.  Per lane one byte of mask and, with rows, a
// four-byte row are read; one int32 is written.  Design: a grid-stride
// loop whose bound is block-uniform, so every lane of a warp reaches
// __ballot_sync; __popc per warp, one shared-memory sum per block and ONE
// atomicAdd per block.  The grid is capped at 1024 blocks, so a 1M-lane
// batch lands at most 1024 atomics on the one cell.  The cell is a kernel
// argument: it is fixed per call site, so it is safe to bake into a CUDA
// graph.
#include "common.cuh"

namespace {

constexpr int kWarps = OT_THREADS / 32;

__global__ void hist_count_kernel(int32_t* __restrict__ hist, int64_t cell,
                                  const uint8_t* __restrict__ base,
                                  const int32_t* __restrict__ rows,
                                  int64_t m) {
  __shared__ int warp_sums[kWarps];
  int local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       start < m; start += stride) {
    const int64_t i = start + threadIdx.x;
    bool hit = false;
    if (i < m) hit = base[i] != 0 && (rows == nullptr || rows[i] >= 0);
    local += __popc(__ballot_sync(0xffffffffu, hit));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    if (total) atomicAdd(hist + cell, total);
  }
}

}  // namespace

// rows == nullptr counts the mask alone
OT_EXPORT int hist_count(int32_t* hist, int64_t cell, const uint8_t* base,
                         const int32_t* rows, int64_t m, void* stream) {
  hist_count_kernel<<<ot_blocks(m, 1024), OT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(hist, cell, base,
                                                           rows, m);
  return static_cast<int>(cudaGetLastError());
}
