// K8, the flush of buffered attribution folds against one delta plan.
//
// attr_apply (a), replacing orleans_tpu/tensor/attribution.py
// _apply_coalesced :192 and the k·delta half of _apply_checked_stack
// :205: counts += k·cdelta, cms += k·sdelta, *total += k·(*n), in place,
// where k is a host integer or read from a device scalar (the checked
// flush's match count, which the host never reads).  k repeated integer
// adds are one multiply-add, bit for bit (int32 wraps in both).
// Bound on an H100: bytes.  Per word the delta is read; where it is
// nonzero the accumulator is read and written.  The PresenceGrain flush of
// 16 reads 8 MB of delta and rewrites the 4 MB of counts that its 1M
// players touch.  Design:
//   * counts and sketch are two ranges, each with blocks of its own
//     (kernels/attr.py apply_plan shares a persistent grid sized from the
//     SM count by their lengths), so no element branches on its array;
//   * the delta is read as 16-byte groups of 4 words, A_UNROLL of them in
//     flight per thread before any accumulator is touched; a group of 4
//     accumulator words is read and written, again 16 bytes, only where
//     its delta is nonzero, so the sectors of rows the fold never touched
//     are neither read nor written.  A small flush (GameGrain's 32,768
//     rows and its sketch) is bound by latency, not bytes: it reads each
//     accumulator group with its delta (one round trip instead of two)
//     and takes blocks of as few as 64 threads, so it spreads over the
//     SMs (kernels/attr.py apply_plan);
//   * a range whose accumulator and delta do not share their address
//     modulo 16 bytes goes word by word, as do its words before the
//     first 16-byte boundary (head) and its last (n - head) mod 4 (tail)
//     (kernels/attr.py apply_split);
//   * every block leaves at once when k is 0; one thread adds the total.
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

constexpr int A_UNROLL = 4;  // 16-byte delta groups in flight a thread

// one array of the flush: acc[i] += k·delta[i] for i < n; words
// [head, head + 4·groups) go as 16-byte groups over `blocks` blocks
struct ApplyRange {
  int32_t* acc;
  const int32_t* delta;
  int64_t n;
  int64_t head;
  unsigned blocks;
};

__device__ __forceinline__ int32_t mad32(int32_t a, int32_t d, uint32_t k) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              k * static_cast<uint32_t>(d));
}

__device__ __forceinline__ void apply_words(const ApplyRange& r, int64_t lo,
                                            int64_t hi, unsigned block,
                                            uint32_t k) {
  const int64_t stride = static_cast<int64_t>(r.blocks) * blockDim.x;
  for (int64_t i = lo + static_cast<int64_t>(block) * blockDim.x +
                   threadIdx.x;
       i < hi; i += stride) {
    const int32_t d = r.delta[i];
    if (d) r.acc[i] = mad32(r.acc[i], d, k);
  }
}

__device__ __forceinline__ void apply_range(const ApplyRange& r,
                                            unsigned block, uint32_t k,
                                            bool eager) {
  const int64_t groups = (r.n - r.head) / 4;
  const int64_t tail0 = r.head + 4 * groups;
  apply_words(r, 0, r.head, block, k);
  apply_words(r, tail0, r.n, block, k);
  const int4* d4 = reinterpret_cast<const int4*>(r.delta + r.head);
  int4* a4 = reinterpret_cast<int4*>(r.acc + r.head);
  const int64_t step = static_cast<int64_t>(blockDim.x) * A_UNROLL;
  for (int64_t base = static_cast<int64_t>(block) * step + threadIdx.x;
       base < groups; base += static_cast<int64_t>(r.blocks) * step) {
    int4 d[A_UNROLL], a[A_UNROLL];
#pragma unroll
    for (int j = 0; j < A_UNROLL; ++j) {
      const int64_t g = base + j * static_cast<int64_t>(blockDim.x);
      d[j] = g < groups ? __ldg(d4 + g) : make_int4(0, 0, 0, 0);
      if (eager && g < groups) a[j] = a4[g];
    }
#pragma unroll
    for (int j = 0; j < A_UNROLL; ++j) {
      if (!eager && (d[j].x | d[j].y | d[j].z | d[j].w)) {
        a[j] = a4[base + j * static_cast<int64_t>(blockDim.x)];
      }
    }
    // every accumulator load issues before the first store (the compiler
    // cannot tell that the groups of one thread never alias)
    asm volatile("" ::: "memory");
#pragma unroll
    for (int j = 0; j < A_UNROLL; ++j) {
      if (d[j].x | d[j].y | d[j].z | d[j].w) {
        a[j].x = mad32(a[j].x, d[j].x, k);
        a[j].y = mad32(a[j].y, d[j].y, k);
        a[j].z = mad32(a[j].z, d[j].z, k);
        a[j].w = mad32(a[j].w, d[j].w, k);
        a4[base + j * static_cast<int64_t>(blockDim.x)] = a[j];
      }
    }
  }
}

// blocks [0, counts.blocks) take the counts, the rest the sketch
__global__ void attr_apply_kernel(ApplyRange counts, ApplyRange cms,
                                  int32_t* __restrict__ total,
                                  const int32_t* __restrict__ n,
                                  int32_t k_host,
                                  const int32_t* __restrict__ k_dev,
                                  bool eager) {
  const uint32_t k = static_cast<uint32_t>(k_dev != nullptr ? *k_dev
                                                            : k_host);
  if (k == 0) return;  // uniform
  if (blockIdx.x < counts.blocks) {
    apply_range(counts, blockIdx.x, k, eager);
  } else {
    apply_range(cms, blockIdx.x - counts.blocks, k, eager);
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

// k_dev null: k = k_host.  total (with n) may be null.  head_c / head_s:
// the words of each range taken one by one before its 16-byte groups (n:
// every word); blocks_c + blocks_s blocks of threads threads.  eager: read
// each accumulator group with its delta, not after it.
OT_EXPORT int attr_apply(int32_t* counts, const int32_t* cdelta, int64_t cap,
                         int64_t head_c, int blocks_c, int32_t* cms,
                         const int32_t* sdelta, int64_t cms_n,
                         int64_t head_s, int blocks_s, int32_t* total,
                         const int32_t* n, int32_t k_host,
                         const int32_t* k_dev, int threads, int eager,
                         void* stream) {
  const ApplyRange rc{counts, cdelta, cap, head_c,
                      static_cast<unsigned>(blocks_c)};
  const ApplyRange rs{cms, sdelta, cms_n, head_s,
                      static_cast<unsigned>(blocks_s)};
  int blocks = blocks_c + blocks_s;
  if (blocks < 1) blocks = 1;  // the total alone
  attr_apply_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rc, rs, total, n, k_host, k_dev, eager != 0);
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
