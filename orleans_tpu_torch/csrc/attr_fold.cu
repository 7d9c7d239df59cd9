// K7 attr_fold: one workload-attribution fold, in place.  For each lane
// with a nonzero increment, add it into counts[row] and into the row's
// hashed bucket at every sketch depth; add the sum of the increments into
// one int32 total (a slot counter, or a plan's lane total).
//
// Replaces, from orleans_tpu/tensor/attribution.py:
//   fold_batch :113      lane mode, counts + sketch + slot (the checked
//                        flush's mismatch folds, gated)
//   fold_counts :133     lane mode with no sketch: the fused window's
//                        per-tick fold (into the window's delta column)
//   fold_cms_dense :161  weighted mode: rows are implicit (row i of a
//                        dense per-row delta), weight = delta[i]; with
//                        counts given it also adds the delta into counts
//                        (the fused window's once-per-window fold)
//   _plan_kernel :174    lane mode into zeroed delta buffers, the lane
//                        total into a device scalar
// Lane mode: a lane counts 1 when valid and 0 <= row < cap.
//
// Optional gate: when given and *gate == 0 every block exits at once;
// otherwise the fold runs and block 0 adds 1 to *stale.  The checked
// flush (K8) writes one gate per stacked entry, so the host never learns
// which entries matched (the JAX lax.cond inside lax.scan).
//
// Bound on an H100: atomics.  Per lane a row, a valid byte and, per
// depth, a random 4-byte atomic into a 32 KB sketch row; the counts atomic
// is a random 4-byte access too.  Contention: the GameGrain fold lands
// about 100 lanes on each of 10,000 rows and about 120 on each sketch
// bucket.  Design: a grid-stride loop, atomicAdd per touched word (L2
// atomics), a warp-shuffle + shared-memory block sum of the increments
// and ONE atomicAdd per block into the total.  A shared-memory histogram
// of the sketch is left for a later change.  The slot index and the
// seeds are kernel arguments, fixed per call site, so a CUDA graph may
// bake them.
#include "attr_common.cuh"

namespace {

__global__ void attr_fold_kernel(int32_t* __restrict__ counts, int64_t cap,
                                 int32_t* __restrict__ cms, int depth,
                                 int64_t width, OtSeeds seeds,
                                 int32_t* __restrict__ total,
                                 const int32_t* __restrict__ rows,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ weight,
                                 int64_t m, const int32_t* __restrict__ gate,
                                 int32_t* __restrict__ stale) {
  if (gate != nullptr && *gate == 0) return;  // uniform: every block exits
  __shared__ int warp_sums[OT_THREADS / 32];
  const uint32_t width_mask = static_cast<uint32_t>(width - 1);
  int local = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    int32_t r;
    int32_t inc;
    if (weight != nullptr) {
      r = static_cast<int32_t>(i);
      inc = weight[i];
    } else {
      r = rows[i];
      inc = (valid[i] != 0 && r >= 0 && r < cap) ? 1 : 0;
    }
    if (inc == 0) continue;
    if (counts != nullptr) atomicAdd(counts + r, inc);
    if (cms != nullptr) {
      for (int d = 0; d < depth; ++d) {
        atomicAdd(cms + d * width + ot_cms_bucket(r, seeds.s[d], width_mask),
                  inc);
      }
    }
    local += inc;
  }
  if (total != nullptr) {
    const int sum = ot_block_sum(local, warp_sums);
    if (threadIdx.x == 0 && sum != 0) atomicAdd(total, sum);
  }
  if (gate != nullptr && stale != nullptr && blockIdx.x == 0 &&
      threadIdx.x == 0) {
    atomicAdd(stale, 1);
  }
}

}  // namespace

// rows/valid (lane mode) or weight (weighted mode, m == its length) is
// null; counts, cms, total, gate and stale may each be null.
OT_EXPORT int attr_fold(int32_t* counts, int64_t cap, int32_t* cms,
                        int depth, int64_t width, const uint32_t* seeds,
                        int32_t* total, const int32_t* rows,
                        const uint8_t* valid, const int32_t* weight,
                        int64_t m, const int32_t* gate, int32_t* stale,
                        void* stream) {
  attr_fold_kernel<<<ot_blocks(m, 4096), OT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      counts, cap, cms, depth, width, ot_seeds(seeds, depth), total, rows,
      valid, weight, m, gate, stale);
  return static_cast<int>(cudaGetLastError());
}
