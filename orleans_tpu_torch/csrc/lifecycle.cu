// The grain lifecycle's two device passes: victim selection for idle
// collection (K12 idle_mask) and the clamped row gather of write-back,
// eviction retirement and the clock re-check (K13 gather_rows).
//
// K12 replaces orleans_tpu/tensor/arena.py _idle_mask_kernel:
//   victim[r] = live[r] && max(last_use_dev[r], host_clock[r]) < cutoff.
// The host has already clipped its clock to [0, 2^31 - 1] and the cutoff
// to [-2^31 + 1, 2^31 - 1], as the JAX arena does, so the compare is a
// plain int32 one.  Bound on an H100: bytes, 10 per row (two int32
// clocks and one live byte read, one victim byte written), over
// 3.35 TB/s.  Design: one thread per row in a grid-stride loop; every
// access is coalesced and nothing is reused, so there is nothing to
// stage in shared memory.  Only the one-byte mask crosses to the host.
//
// K13 replaces orleans_tpu/tensor/attribution.py _gather_counts and the
// eager gathers of arena.py rows_to_host and deactivate_idle_rows:
//   out[i, e] = col[clip(rows[i], 0, n - 1), e]
// over 4-byte elements (int32, float32 and any other 4-byte type the
// wrapper views as int32), with trailing widths flattened to `inner`.
// Pad lanes carry row 0 and the caller slices them off.  Bound on an
// H100: bytes, 12 per lane of width 1 (a row read, a value read, a value
// written); a random row read costs a 32-byte DRAM sector, which the
// bound does not count.  Design: one thread per (lane, element), so a
// wide row's elements are read by neighbouring threads.
#include "common.cuh"

namespace {

__global__ void idle_mask_kernel(const int32_t* __restrict__ dev_clock,
                                 const int32_t* __restrict__ host_clock,
                                 const uint8_t* __restrict__ live,
                                 int32_t cutoff, uint8_t* __restrict__ out,
                                 int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n; r += stride) {
    const int32_t a = dev_clock[r];
    const int32_t b = host_clock[r];
    out[r] = (live[r] != 0 && (a > b ? a : b) < cutoff) ? 1 : 0;
  }
}

__global__ void gather_rows_kernel(const int32_t* __restrict__ col,
                                   int64_t n,
                                   const int32_t* __restrict__ rows,
                                   int64_t m, int64_t inner,
                                   int32_t* __restrict__ out) {
  const int64_t total = m * inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t lane = inner == 1 ? i : i / inner;
    int64_t r = rows[lane];
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    out[i] = col[r * inner + (i - lane * inner)];
  }
}

}  // namespace

OT_EXPORT int idle_mask(const int32_t* dev_clock, const int32_t* host_clock,
                        const uint8_t* live, int32_t cutoff, uint8_t* out,
                        int64_t n, void* stream) {
  idle_mask_kernel<<<ot_blocks(n), OT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dev_clock, host_clock, live, cutoff, out, n);
  return static_cast<int>(cudaGetLastError());
}

OT_EXPORT int gather_rows(const int32_t* col, int64_t n, const int32_t* rows,
                          int64_t m, int64_t inner, int32_t* out,
                          void* stream) {
  gather_rows_kernel<<<ot_blocks(m * inner), OT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(col, n, rows, m,
                                                            inner, out);
  return static_cast<int>(cudaGetLastError());
}
