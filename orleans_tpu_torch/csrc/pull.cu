// The streams plane's pull-mode passes: the row-aligned segment reduction
// of a pull delivery (K16 seg_pull) and its dense use-clock touch
// (K17 touch_dense).
//
// K16 replaces the `segments` branches of orleans_tpu/tensor/
// vector_grain.py seg_sum (:164, an exclusive cumulative sum and the
// difference z[seg[r+1]] - z[seg[r]]) and seg_max (:194, a segmented
// (flag, value) max scan and one gather at each row's last lane), and the
// `segments` branch of orleans_tpu/tensor/attribution.py fold_counts
// (:133, the same difference over the valid mask plus the slot counter).
// For every row r it reduces the lanes [offsets[r], offsets[r+1]):
//   sum: out[r] = (accumulate ? out[r] : 0) + sum(values[lanes]);
//   max: out[r] = max(values[lanes]), or fill for a row with no lanes.
// With a total pointer, a second pass adds sum(values[0:m]) over every
// lane (lanes past offsets[n_rows] included, as JAX's jnp.sum(inc)) into
// it: the attribution slot counter.  int32 and bool sums run in uint32_t,
// so they wrap modulo 2^32 and equal JAX's int32 cumsum difference bit
// for bit whatever the batch total; a float32 sum is a direct per-row sum
// in lane order, whose error is bounded by the row's own terms, never by
// the batch total as the prefix-sum difference's is.
//
// Bound on an H100: bytes.  At the chat shape (1,461,322 lanes, about
// 1.05M rows) one launch reads the values once (4 B a lane) and the
// offsets once (4 B a row) and writes the output once (4 B a row, 8 with
// accumulate): about 14 MB, 0.0042 ms at 3.35 TB/s.  Design: one thread
// per row in a grid-stride loop.  Subscriber degrees there are at most
// 7-8, so a row's lanes sit in one or two 32-byte sectors next to its
// neighbours' and the reads of a warp coalesce; a row with a very large
// degree would serialise on one thread (a warp-per-row variant is the
// next step if a path brings one).
//
// K17 replaces orleans_tpu/tensor/arena.py _touch_dense_kernel (:43):
//   last_use[r] = max(last_use[r], offsets[r+1] > offsets[r] ? tick : 0)
// in place.  Bound on an H100: bytes, 12 per row (the clock read and
// written, the offsets read once), about 12.6 MB at the chat shape.
// Design: one elementwise grid-stride pass; offsets[r+1] is the next
// thread's offsets[r], so the two reads share sectors.
#include "common.cuh"

namespace {

template <typename T>
struct SumAcc {
  using type = uint32_t;  // int32 and bool: wrap modulo 2^32
};
template <>
struct SumAcc<float> {
  using type = float;
};

template <typename T, typename Out>
__global__ void seg_pull_sum_kernel(const T* __restrict__ values,
                                    const int32_t* __restrict__ offsets,
                                    int64_t n_rows, Out* __restrict__ out,
                                    int accumulate) {
  using Acc = typename SumAcc<T>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n_rows; r += stride) {
    const int32_t a = offsets[r];
    const int32_t b = offsets[r + 1];
    Acc s = accumulate ? static_cast<Acc>(out[r]) : Acc(0);
    for (int32_t i = a; i < b; ++i) s += static_cast<Acc>(values[i]);
    out[r] = static_cast<Out>(s);
  }
}

template <typename T>
__device__ __forceinline__ T max_nan(T m, T v) {
  return v > m ? v : m;
}
template <>
__device__ __forceinline__ float max_nan<float>(float m, float v) {
  // NaN propagates, as jnp.maximum's does
  return (v > m || v != v) ? v : m;
}

template <typename T>
__global__ void seg_pull_max_kernel(const T* __restrict__ values,
                                    const int32_t* __restrict__ offsets,
                                    int64_t n_rows, T fill,
                                    T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n_rows; r += stride) {
    const int32_t a = offsets[r];
    const int32_t b = offsets[r + 1];
    T m = fill;
    if (b > a) {
      m = values[a];
      if (m == m) {
        for (int32_t i = a + 1; i < b; ++i) m = max_nan(m, values[i]);
      }
    }
    out[r] = m;
  }
}

// sum(values[0:m]) into *total (uint32 atomics: wraps as int32 does),
// one atomic per warp
template <typename T>
__global__ void seg_pull_total_kernel(const T* __restrict__ values,
                                      int64_t m, uint32_t* total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t s = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m; i += stride) {
    s += static_cast<uint32_t>(values[i]);
  }
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(total, s);
}

__global__ void touch_dense_kernel(int32_t* __restrict__ last_use,
                                   const int32_t* __restrict__ offsets,
                                   int64_t n_rows, int32_t tick) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n_rows; r += stride) {
    const int32_t stamp = offsets[r + 1] > offsets[r] ? tick : 0;
    const int32_t cur = last_use[r];
    if (stamp > cur) last_use[r] = stamp;
  }
}

template <typename T, typename Out>
int launch_sum(const T* values, const int32_t* offsets, int64_t n_rows,
               Out* out, int accumulate, int32_t* total, int64_t m,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows > 0) {
    seg_pull_sum_kernel<T, Out><<<ot_blocks(n_rows), OT_THREADS, 0, s>>>(
        values, offsets, n_rows, out, accumulate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (total != nullptr && m > 0) {
    seg_pull_total_kernel<T><<<ot_blocks(m, 1024), OT_THREADS, 0, s>>>(
        values, m, reinterpret_cast<uint32_t*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_max(const T* values, const int32_t* offsets, int64_t n_rows,
               T fill, T* out, void* stream) {
  if (n_rows > 0) {
    seg_pull_max_kernel<T><<<ot_blocks(n_rows), OT_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        values, offsets, n_rows, fill, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

OT_EXPORT int seg_pull_sum_i32(const int32_t* values, const int32_t* offsets,
                               int64_t n_rows, int32_t* out, int accumulate,
                               int32_t* total, int64_t m, void* stream) {
  return launch_sum<int32_t, int32_t>(values, offsets, n_rows, out,
                                      accumulate, total, m, stream);
}

OT_EXPORT int seg_pull_sum_u8(const uint8_t* values, const int32_t* offsets,
                              int64_t n_rows, int32_t* out, int accumulate,
                              int32_t* total, int64_t m, void* stream) {
  return launch_sum<uint8_t, int32_t>(values, offsets, n_rows, out,
                                      accumulate, total, m, stream);
}

OT_EXPORT int seg_pull_sum_f32(const float* values, const int32_t* offsets,
                               int64_t n_rows, float* out, int accumulate,
                               int32_t* total, int64_t m, void* stream) {
  return launch_sum<float, float>(values, offsets, n_rows, out, accumulate,
                                  nullptr, m, stream);
}

OT_EXPORT int seg_pull_max_i32(const int32_t* values, const int32_t* offsets,
                               int64_t n_rows, int32_t fill, int32_t* out,
                               void* stream) {
  return launch_max<int32_t>(values, offsets, n_rows, fill, out, stream);
}

OT_EXPORT int seg_pull_max_f32(const float* values, const int32_t* offsets,
                               int64_t n_rows, float fill, float* out,
                               void* stream) {
  return launch_max<float>(values, offsets, n_rows, fill, out, stream);
}

OT_EXPORT int touch_dense(int32_t* last_use, const int32_t* offsets,
                          int64_t n_rows, int32_t tick, void* stream) {
  if (n_rows > 0) {
    touch_dense_kernel<<<ot_blocks(n_rows), OT_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        last_use, offsets, n_rows, tick);
  }
  return static_cast<int>(cudaGetLastError());
}
