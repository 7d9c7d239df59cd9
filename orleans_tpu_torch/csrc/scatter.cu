// Row scatter into an arena state column: col[rows] = v, += v or max= v,
// dropping every lane whose row is < 0 (padding / unresolved miss) or
// >= n.  The column is updated in place.
//
// Replaces orleans_tpu/tensor/vector_grain.py scatter_rows /
// scatter_add_rows and orleans_tpu/tensor/arena.py _touch_kernel (K3,
// row_scatter); seg_max's scatter path is MAX into a column filled with
// the dtype minimum.
//
// Bound on an H100: bytes, and for ADD/MAX the atomics.  Per lane: a row
// (4 B), a value (4 B, or none when a scalar is broadcast), and a 4-byte
// random access into the column, which costs a whole 32-byte sector of
// DRAM traffic.  Design: one thread per (lane, element), coalesced reads
// of rows and values; a scalar value (the heartbeat's tick) rides as a
// kernel argument instead of a materialised lane vector, or, inside a
// CUDA graph, as ONE device element read by every lane through a pointer
// (values_step 0), so a replay reads the tick written before it; ADD uses
// atomicAdd, MAX atomicMax (a CAS loop for float32, NaN-propagating like
// XLA's max).  SET with duplicate rows keeps one writer, not a chosen
// one — the JAX package's own contract for scatter_rows.
#include "common.cuh"

namespace {

enum { OP_SET = 0, OP_ADD = 1, OP_MAX = 2 };

__device__ __forceinline__ void atomic_max(int32_t* addr, int32_t v) {
  atomicMax(addr, v);
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  if (isnan(v)) {  // max with NaN is NaN
    atomicExch(addr, v);
    return;
  }
  int* word = reinterpret_cast<int*>(addr);
  int old = atomicAdd(word, 0);  // coherent read of the current value
  while (!isnan(__int_as_float(old)) && __int_as_float(old) < v) {
    const int seen = atomicCAS(word, old, __float_as_int(v));
    if (seen == old) break;
    old = seen;
  }
}

template <typename T, int OP>
__global__ void row_scatter_kernel(T* __restrict__ col, int64_t n,
                                   const int32_t* __restrict__ rows,
                                   int64_t m, int64_t inner,
                                   const T* __restrict__ values,
                                   int64_t values_step, T scalar) {
  const int64_t total = m * inner;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t lane = inner == 1 ? i : i / inner;
    const int32_t r = rows[lane];
    if (r < 0 || r >= n) continue;
    const T v = values != nullptr ? values[i * values_step] : scalar;
    T* dst = col + static_cast<int64_t>(r) * inner + (i - lane * inner);
    if (OP == OP_SET) {
      *dst = v;
    } else if (OP == OP_ADD) {
      atomicAdd(dst, v);
    } else {
      atomic_max(dst, v);
    }
  }
}

template <typename T>
int launch(T* col, int64_t n, const int32_t* rows, int64_t m, int64_t inner,
           const T* values, int64_t values_step, T scalar, int op,
           void* stream) {
  const unsigned int blocks = ot_blocks(m * inner);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_SET:
      row_scatter_kernel<T, OP_SET><<<blocks, OT_THREADS, 0, s>>>(
          col, n, rows, m, inner, values, values_step, scalar);
      break;
    case OP_ADD:
      row_scatter_kernel<T, OP_ADD><<<blocks, OT_THREADS, 0, s>>>(
          col, n, rows, m, inner, values, values_step, scalar);
      break;
    case OP_MAX:
      row_scatter_kernel<T, OP_MAX><<<blocks, OT_THREADS, 0, s>>>(
          col, n, rows, m, inner, values, values_step, scalar);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values == nullptr broadcasts `scalar` to every lane; values_step 0
// broadcasts the one element `values` points to, 1 reads values[i]
OT_EXPORT int row_scatter_i32(int32_t* col, int64_t n, const int32_t* rows,
                              int64_t m, int64_t inner,
                              const int32_t* values, int64_t values_step,
                              int32_t scalar, int op, void* stream) {
  return launch<int32_t>(col, n, rows, m, inner, values, values_step, scalar,
                         op, stream);
}

OT_EXPORT int row_scatter_f32(float* col, int64_t n, const int32_t* rows,
                              int64_t m, int64_t inner, const float* values,
                              int64_t values_step, float scalar, int op,
                              void* stream) {
  return launch<float>(col, n, rows, m, inner, values, values_step, scalar,
                       op, stream);
}
