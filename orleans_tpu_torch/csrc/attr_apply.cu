// K8, the flush of buffered attribution folds against one delta plan.
//
// attr_apply (a), replacing orleans_tpu/tensor/attribution.py
// _apply_coalesced :192 and the k·delta half of _apply_checked_stack
// :205: counts += k·cdelta, cms += k·sdelta, *total += k·(*n), in place,
// where k is a host integer or read from a device scalar (the checked
// flush's match count, which the host never reads).  k repeated integer
// adds are one multiply-add, bit for bit (int32 wraps in both).
// Bound on an H100: bytes.  Per counts row the delta is read, and where it
// is nonzero the count is read and written; the sketch likewise.  Design:
// one grid-stride pass over counts and sketch as one index space; every
// block exits at once when k is 0.
//
// attr_match (b), replacing the exact compare of _apply_checked_stack:
// for each of up to 32 stacked entries, whether its rows and valid flags
// equal the plan's over all m lanes.  Each entry's mismatch flag is 0 or
// 1, and km starts at the entry count and loses one per mismatched entry.
// The entries' pointers ride in the kernel's parameters, so nothing is
// stacked: a 32-entry stack of 1M lanes would be 160 MB.
// Bound on an H100: bytes, 5 per lane per entry.  Design: a 2-D grid,
// blockIdx.y the entry and blockIdx.x a chunk of lanes; a block that sees
// a mismatch (__syncthreads_or) sets the entry's flag with atomicExch,
// and the block whose exchange turned it from 0 to 1 takes one off km.
// The mismatched entries' full folds are then K7 launches gated on their
// flags (kernels/attr.py).
#include "attr_common.cuh"

namespace {

constexpr int kMaxStack = 32;

struct OtStack {
  const int32_t* rows[kMaxStack];
  const uint8_t* valid[kMaxStack];
};

__global__ void attr_apply_kernel(int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ cdelta,
                                  int64_t cap, int32_t* __restrict__ cms,
                                  const int32_t* __restrict__ sdelta,
                                  int64_t cms_n, int32_t* __restrict__ total,
                                  const int32_t* __restrict__ n,
                                  int32_t k_host,
                                  const int32_t* __restrict__ k_dev) {
  const uint32_t k = static_cast<uint32_t>(k_dev != nullptr ? *k_dev
                                                            : k_host);
  if (k == 0) return;  // uniform
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < cap + cms_n; i += stride) {
    if (i < cap) {
      const uint32_t d = static_cast<uint32_t>(cdelta[i]);
      if (d) counts[i] = static_cast<int32_t>(
                 static_cast<uint32_t>(counts[i]) + k * d);
    } else {
      const uint32_t d = static_cast<uint32_t>(sdelta[i - cap]);
      if (d) cms[i - cap] = static_cast<int32_t>(
                 static_cast<uint32_t>(cms[i - cap]) + k * d);
    }
  }
  if (total != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned int*>(total),
              k * static_cast<uint32_t>(*n));
  }
}

__global__ void attr_match_init_kernel(int32_t* __restrict__ flags, int k,
                                       int32_t* __restrict__ km) {
  if (threadIdx.x < k) flags[threadIdx.x] = 0;
  if (threadIdx.x == 0) *km = k;
}

__global__ void attr_match_kernel(OtStack stack,
                                  const int32_t* __restrict__ plan_rows,
                                  const uint8_t* __restrict__ plan_valid,
                                  int64_t m, int32_t* __restrict__ flags,
                                  int32_t* __restrict__ km) {
  const int e = blockIdx.y;
  const int32_t* rows = stack.rows[e];
  const uint8_t* valid = stack.valid[e];
  int differs = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < m && !differs; i += stride) {
    differs = rows[i] != plan_rows[i] ||
              (valid[i] != 0) != (plan_valid[i] != 0);
  }
  if (__syncthreads_or(differs) && threadIdx.x == 0) {
    if (atomicExch(flags + e, 1) == 0) atomicSub(km, 1);
  }
}

}  // namespace

// k_dev null: k = k_host.  total (with n) may be null.
OT_EXPORT int attr_apply(int32_t* counts, const int32_t* cdelta, int64_t cap,
                         int32_t* cms, const int32_t* sdelta, int64_t cms_n,
                         int32_t* total, const int32_t* n, int32_t k_host,
                         const int32_t* k_dev, void* stream) {
  attr_apply_kernel<<<ot_blocks(cap + cms_n, 4096), OT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      counts, cdelta, cap, cms, sdelta, cms_n, total, n, k_host, k_dev);
  return static_cast<int>(cudaGetLastError());
}

// rows_ptrs / valid_ptrs: host arrays of k device addresses, 1 <= k <= 32
OT_EXPORT int attr_match(const int64_t* rows_ptrs, const int64_t* valid_ptrs,
                         int k, const int32_t* plan_rows,
                         const uint8_t* plan_valid, int64_t m,
                         int32_t* flags, int32_t* km, void* stream) {
  if (k < 1 || k > kMaxStack) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  OtStack stack{};
  for (int e = 0; e < k; ++e) {
    stack.rows[e] = reinterpret_cast<const int32_t*>(rows_ptrs[e]);
    stack.valid[e] = reinterpret_cast<const uint8_t*>(valid_ptrs[e]);
  }
  attr_match_init_kernel<<<1, kMaxStack, 0, s>>>(flags, k, km);
  if (m > 0) {
    const dim3 grid(ot_blocks(m, 1024), k);
    attr_match_kernel<<<grid, OT_THREADS, 0, s>>>(stack, plan_rows,
                                                  plan_valid, m, flags, km);
  }
  return static_cast<int>(cudaGetLastError());
}
