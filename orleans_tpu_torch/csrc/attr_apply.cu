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
// 1, and km is the count of matching entries.  The entries' pointers ride
// in the kernel's parameters, so nothing is stacked: a 32-entry stack of
// 1M lanes would be 160 MB.
// Bound on an H100: bytes, 5 per lane for the plan and 5 per lane per
// entry, (k + 1)·5·m.  The port's first version read the plan again for
// every entry (a 2-D grid, blockIdx.y the entry), one lane a thread with a
// 1-byte valid load, behind a launch of its own that cleared flags and km.
// Design, one launch:
//   * a persistent grid over chunks of M_THREADS·16 lanes; a thread holds
//     16 lanes of the plan in registers (four 16-byte row loads and one
//     16-byte valid load) and compares every entry with them in turn, two
//     entries' loads in flight at once, so the plan is read once;
//   * an entry whose rows and valid do not share the plan's offsets from a
//     16-byte boundary goes lane by lane, as do the lanes before the plan's
//     first boundary (head) and the last partial group (tail);
//   * each block ORs its entries' mismatch bits (a warp OR, then shared)
//     into a per-launch mask between chunks and reads the mask back, so an
//     entry known to differ skips the block's remaining chunks;
//   * the last block to take a ticket writes flags and km from the mask and
//     leaves the mask and the ticket zero: the two state words are a pool
//     per stream that every launch finds clean (kernels/attr.py), so no
//     launch clears flags or km first.
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

constexpr int M_THREADS = 256;
constexpr int M_LANES = 16;  // lanes a thread: 4 int4 of rows, 16 B of valid
constexpr int M_STEP = 2;    // entries whose loads are in flight at once

struct MatchArgs {
  OtStack stack;
  const int32_t* plan_rows;
  const uint8_t* plan_valid;
  int64_t m;
  int64_t head;      // lanes before the 16-lane groups (0 unless vec_plan)
  int64_t units;     // the head (when there is one), then groups of 16
  int64_t chunks;    // of M_THREADS units
  bool vec_plan;     // the 16-lane groups are 16-byte loads of the plan
  int k;
  uint32_t vec;      // entries that share the plan's offsets (bit e)
  int32_t* flags;
  int32_t* km;
  uint32_t* state;   // [mismatch mask, ticket]: zero, and left so
};

// 16 lanes: rows, and the valid bytes as 0x80 where nonzero
struct Lanes16 {
  int32_t r[M_LANES];
  uint32_t v[M_LANES / 4];
};

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// lanes [base, end) of one array pair; full: one 16-lane group, 16-byte
// aligned.  Lanes at or past end read as 0 in both the plan and entries.
__device__ __forceinline__ void load16(const int32_t* __restrict__ rows,
                                       const uint8_t* __restrict__ valid,
                                       int64_t base, int64_t end, bool full,
                                       Lanes16& out) {
  if (full) {
    const int4* r4 = reinterpret_cast<const int4*>(rows + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = __ldg(r4 + q);
      out.r[4 * q] = x.x;
      out.r[4 * q + 1] = x.y;
      out.r[4 * q + 2] = x.z;
      out.r[4 * q + 3] = x.w;
    }
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(valid + base));
    out.v[0] = nonzero_bytes(v.x);
    out.v[1] = nonzero_bytes(v.y);
    out.v[2] = nonzero_bytes(v.z);
    out.v[3] = nonzero_bytes(v.w);
    return;
  }
#pragma unroll
  for (int q = 0; q < M_LANES / 4; ++q) out.v[q] = 0;
#pragma unroll
  for (int j = 0; j < M_LANES; ++j) {
    const bool in = base + j < end;
    out.r[j] = in ? rows[base + j] : 0;
    const uint32_t nz = in && valid[base + j] != 0 ? 0x80u : 0u;
    out.v[j >> 2] |= nz << (8 * (j & 3));
  }
}

__device__ __forceinline__ bool differs(const Lanes16& a, const Lanes16& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < M_LANES; ++j) d |= a.r[j] ^ b.r[j];
#pragma unroll
  for (int q = 0; q < M_LANES / 4; ++q) d |= a.v[q] ^ b.v[q];
  return d != 0;
}

__global__ void __launch_bounds__(M_THREADS)
attr_match_kernel(MatchArgs a) {
  __shared__ uint32_t s_mask, s_known;
  if (threadIdx.x == 0) {
    s_mask = 0;
    s_known = 0;
  }
  __syncthreads();
  const uint32_t all = a.k == 32 ? 0xFFFFFFFFu : (1u << a.k) - 1;
  const bool has_head = a.head > 0;
  uint32_t known = 0;  // entries known to differ, the same in every thread
  for (int64_t c = blockIdx.x; c < a.chunks && known != all;
       c += gridDim.x) {
    const int64_t u = c * M_THREADS + threadIdx.x;
    uint32_t d = 0;
    if (u < a.units) {
      const bool is_head = has_head && u == 0;
      const int64_t base = is_head ? 0 : a.head + M_LANES * (u - has_head);
      const int64_t end = is_head ? a.head
                                  : (base + M_LANES < a.m ? base + M_LANES
                                                          : a.m);
      const bool full = a.vec_plan && !is_head && end - base == M_LANES;
      Lanes16 plan;
      load16(a.plan_rows, a.plan_valid, base, end, full, plan);
      // M_STEP entries at a time: all their loads issue before the first
      // compare waits on them
#pragma unroll
      for (int e0 = 0; e0 < kMaxStack; e0 += M_STEP) {
        if (e0 < a.k) {
          Lanes16 x[M_STEP];
          bool on[M_STEP];
#pragma unroll
          for (int q = 0; q < M_STEP; ++q) {
            const int e = e0 + q;
            on[q] = e < a.k && !((known >> e) & 1u);
            if (on[q]) {
              load16(a.stack.rows[e], a.stack.valid[e], base, end,
                     full && ((a.vec >> e) & 1u), x[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < M_STEP; ++q) {
            if (on[q] && differs(x[q], plan)) d |= 1u << (e0 + q);
          }
        }
      }
    }
    d = __reduce_or_sync(0xFFFFFFFFu, d);
    if ((threadIdx.x & 31) == 0 && d) atomicOr(&s_mask, d);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t fresh = s_mask & ~s_known;
      uint32_t g = *reinterpret_cast<volatile uint32_t*>(a.state);
      if (fresh & ~g) g = atomicOr(a.state, fresh) | fresh;
      s_known = g | s_mask;
    }
    __syncthreads();
    known = s_known & all;
  }
  // the last block to finish writes the answer and leaves the state clean
  if (threadIdx.x == 0) {
    __threadfence();
    const uint32_t ticket = atomicAdd(a.state + 1, 1u);
    if (ticket == gridDim.x - 1) {
      const uint32_t mask = atomicExch(a.state, 0u) & all;
      atomicExch(a.state + 1, 0u);
      for (int e = 0; e < a.k; ++e) a.flags[e] = (mask >> e) & 1u;
      *a.km = a.k - __popc(mask);
    }
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

// rows_ptrs / valid_ptrs: host arrays of k device addresses, 1 <= k <= 32;
// state: two uint32 words, zero, which the launch leaves zero
OT_EXPORT int attr_match(const int64_t* rows_ptrs, const int64_t* valid_ptrs,
                         int k, const int32_t* plan_rows,
                         const uint8_t* plan_valid, int64_t m,
                         int32_t* flags, int32_t* km, uint32_t* state,
                         void* stream) {
  if (k < 1 || k > kMaxStack || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto at = [](const void* p) {
    return static_cast<int64_t>(reinterpret_cast<uintptr_t>(p) % 16);
  };
  MatchArgs a{};
  for (int e = 0; e < k; ++e) {
    a.stack.rows[e] = reinterpret_cast<const int32_t*>(rows_ptrs[e]);
    a.stack.valid[e] = reinterpret_cast<const uint8_t*>(valid_ptrs[e]);
  }
  // the plan's lanes before the first lane whose row and valid both start
  // a 16-byte group; none when no lane does
  int64_t head = (16 - at(plan_valid)) % 16;
  const bool vec_plan = at(plan_rows) % 4 == 0 &&
                        (at(plan_rows) + 4 * head) % 16 == 0 && head < m;
  if (!vec_plan) head = 0;
  for (int e = 0; e < k && vec_plan; ++e) {
    if (at(a.stack.rows[e]) == at(plan_rows) &&
        at(a.stack.valid[e]) == at(plan_valid)) {
      a.vec |= 1u << e;
    }
  }
  a.plan_rows = plan_rows;
  a.plan_valid = plan_valid;
  a.m = m;
  a.head = head;
  a.vec_plan = vec_plan;
  a.units = (head > 0) + (m - head + M_LANES - 1) / M_LANES;
  a.chunks = (a.units + M_THREADS - 1) / M_THREADS;
  a.k = k;
  a.flags = flags;
  a.km = km;
  a.state = state;
  // one wave of the blocks the card holds at once, at most one a chunk
  const int64_t cap_blocks =
      static_cast<int64_t>(ot_sm_count()) *
      ot_max_blocks(attr_match_kernel, M_THREADS);
  int64_t blocks = a.chunks < cap_blocks ? a.chunks : cap_blocks;
  if (blocks < 1) blocks = 1;  // m = 0: the answer alone
  attr_match_kernel<<<static_cast<unsigned>(blocks), M_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
