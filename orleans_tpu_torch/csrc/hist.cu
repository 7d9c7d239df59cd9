// Masked counts into cells of the latency ledger's histogram:
// *cell += count(base[i] && (rows == nullptr || rows[i] >= 0)).
//
// Replaces orleans_tpu/tensor/ledger.py _count_rows_kernel (K5,
// hist_count) and the fused window's in-window ledger add,
// orleans_tpu/tensor/fused.py hist.at[slot, 0].add(sum(mask)), which is
// the same count with no rows.  The fused window also adds its delivered
// and spilled lane counts into its totals with it, and gathers a tick's
// counts into one launch of up to kMaxEntries (hist_count_many).
//
// Bound on an H100: bytes.  Per lane one byte of mask and, with rows, a
// four-byte row are read; one int32 is written per count.  At 1M lanes
// that is 0.0015 ms, so launch, ramp-up and tail set the time.  Design:
// a thread takes 16 lanes, one 16-byte mask load and, with rows, four
// 16-byte row loads, all in flight together; a scalar head and tail frame
// the 16-byte groups of a base at any offset (rows that do not share the
// mask's alignment are read 4 bytes at a time).  The grid is one wave of
// the card (the blocks one SM holds at once, from an occupancy query,
// times the SMs), cut to the groups there are, so a thread makes one pass
// at the main path's sizes.  A block sums by warp shuffles and makes ONE
// atomicAdd.  One launch takes a table of up to kMaxEntries counts; the
// wrapper splits the blocks over them in proportion to their lanes
// (kernels/hist.py count_plan, from shapes alone), and the table, cells
// included, goes by value, so a CUDA graph bakes it.
// Integer counts: exact in any order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEntries = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Entry {
  int32_t* cell;
  const uint8_t* base;
  const int32_t* rows;  // nullptr: the mask alone
  int64_t m;
};

struct Table {
  Entry e[kMaxEntries];
  int32_t first[kMaxEntries + 1];  // entry k's blocks [first[k], first[k+1])
  int32_t n;
};

__device__ __forceinline__ int hit(uint8_t b, int32_t r) {
  return b != 0 && r >= 0;
}

// bytes of w that are nonzero
__device__ __forceinline__ int nonzero_bytes(unsigned w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;
}

// lanes of one entry counted by thread g of G
__device__ __forceinline__ int count_entry(const Entry& e, int64_t g,
                                           int64_t G) {
  const int64_t m = e.m;
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(e.base) & 15)) & 15;
  head = head < m ? head : m;
  const int64_t groups = (m - head) >> 4;
  const int64_t tail0 = head + (groups << 4);
  int acc = 0;
  // head and tail: fewer than 16 lanes each
  if (g < head) {
    acc += hit(e.base[g], e.rows ? e.rows[g] : 0);
  }
  if (g < m - tail0) {
    const int64_t i = tail0 + g;
    acc += hit(e.base[i], e.rows ? e.rows[i] : 0);
  }
  const uint4* mask16 = reinterpret_cast<const uint4*>(e.base + head);
  if (e.rows == nullptr) {
    for (int64_t q = g; q < groups; q += G) {
      const uint4 v = __ldg(mask16 + q);
      acc += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
             nonzero_bytes(v.w);
    }
    return acc;
  }
  const int32_t* rows = e.rows + head;
  const bool rows16 = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  for (int64_t q = g; q < groups; q += G) {
    const uint4 v = __ldg(mask16 + q);
    int32_t r[16];
    if (rows16) {
      const int4* p = reinterpret_cast<const int4*>(rows + 16 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int4 x = __ldg(p + k);
        r[4 * k] = x.x;
        r[4 * k + 1] = x.y;
        r[4 * k + 2] = x.z;
        r[4 * k + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) r[k] = __ldg(rows + 16 * q + k);
    }
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      acc += hit(static_cast<uint8_t>(words[k >> 2] >> (8 * (k & 3))), r[k]);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    hist_count_kernel(const Table t) {
  __shared__ int warp_sums[kWarps];
  int k = 0;
  while (k + 1 < t.n && static_cast<int>(blockIdx.x) >= t.first[k + 1]) ++k;
  const Entry& e = t.e[k];
  const int64_t nb = t.first[k + 1] - t.first[k];
  const int64_t g =
      static_cast<int64_t>(blockIdx.x - t.first[k]) * kThreads + threadIdx.x;
  int v = count_entry(e, g, nb * kThreads);
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    if (total) atomicAdd(e.cell, total);
  }
}

}  // namespace

// blocks one wave of the card holds (the multi-count's cap on blocks;
// the split is planned on the host, kernels/hist.py count_plan)
OT_EXPORT int hist_count_wave() {
  return ot_max_blocks(hist_count_kernel, kThreads) * ot_sm_count();
}

// n entries (1..8): cells[k] += count over bases[k][0, ms[k]) (rows[k]
// null: the mask alone) by blocks[k] blocks (0 for an entry of no lanes)
OT_EXPORT int hist_count_many(int32_t n, const int64_t* cells,
                              const int64_t* bases, const int64_t* rows,
                              const int64_t* ms, const int32_t* blocks,
                              void* stream) {
  if (n < 1 || n > kMaxEntries) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  t.n = 0;
  int32_t at = 0;
  for (int k = 0; k < n; ++k) {
    if (ms[k] < 0 || blocks[k] < 0 || (ms[k] > 0) != (blocks[k] > 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (blocks[k] == 0) continue;
    t.e[t.n] = {reinterpret_cast<int32_t*>(cells[k]),
                reinterpret_cast<const uint8_t*>(bases[k]),
                reinterpret_cast<const int32_t*>(rows[k]), ms[k]};
    t.first[t.n] = at;
    at += blocks[k];
    ++t.n;
  }
  if (t.n == 0) return static_cast<int>(cudaSuccess);
  for (int k = t.n; k <= kMaxEntries; ++k) t.first[k] = at;
  hist_count_kernel<<<static_cast<unsigned>(at), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
