// Segment sum on the scatter path: out[rows[i]] += values[i] into a
// zero-initialised [n_rows, inner] output, dropping lanes whose row is
// < 0 (padding / unresolved miss) or >= n_rows.
//
// Replaces orleans_tpu/tensor/vector_grain.py seg_sum's scatter path
// (jax.ops.segment_sum) (K4, seg_sum).
//
// Bound on an H100: bytes and atomic contention.  Per lane: a value and a
// row (8 B) read coalesced, and an atomicAdd into the output.  The output
// is small (Presence: 10k games of a 32,768-row arena) and stays in L2,
// where the atomics resolve; with ~100 lanes hitting each game row per
// tick, the same-address atomics serialise in the L2 slices — a
// warp-level pre-aggregation of equal rows is the next step.  int32 sums
// are exact in any order; float32 sums come out in atomic order, which
// changes from run to run (the caller's tolerance is Higham's bound for
// recursive summation, (k - 1) * 2^-24 * sum|x| for k terms).
#include "common.cuh"

namespace {

template <typename T>
__global__ void seg_sum_kernel(const T* __restrict__ values,
                               const int32_t* __restrict__ rows, int64_t m,
                               int64_t inner, T* __restrict__ out,
                               int64_t n_rows) {
  const int64_t total = m * inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t lane = inner == 1 ? i : i / inner;
    const int32_t r = rows[lane];
    if (r < 0 || r >= n_rows) continue;
    atomicAdd(out + static_cast<int64_t>(r) * inner + (i - lane * inner),
              values[i]);
  }
}

template <typename T>
int launch(const T* values, const int32_t* rows, int64_t m, int64_t inner,
           T* out, int64_t n_rows, void* stream) {
  seg_sum_kernel<T><<<ot_blocks(m * inner), OT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      values, rows, m, inner, out, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

OT_EXPORT int seg_sum_i32(const int32_t* values, const int32_t* rows,
                          int64_t m, int64_t inner, int32_t* out,
                          int64_t n_rows, void* stream) {
  return launch<int32_t>(values, rows, m, inner, out, n_rows, stream);
}

OT_EXPORT int seg_sum_f32(const float* values, const int32_t* rows,
                          int64_t m, int64_t inner, float* out,
                          int64_t n_rows, void* stream) {
  return launch<float>(values, rows, m, inner, out, n_rows, stream);
}
