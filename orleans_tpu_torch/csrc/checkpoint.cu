// The durable state plane's three device passes: the consistent-cut pin
// (K19 pin_columns), the chunk gather of the drain (K20 gather_columns)
// and the delta's dirty-row predicate (K21 dirty_mask).
//
// K19 replaces orleans_tpu/tensor/checkpoint.py _pin_tree (one compiled
// copy of every state column and the device use clock of an arena), and
// serves the counts pin of _commit_snapshot and the journal's copy of a
// batch's device leaves on append (a JAX array cannot change after the
// append; a tensor can, so the port copies).  One launch copies up to 32
// (src, dst, bytes) segments passed by value; the wrapper splits each
// column into a 16-byte body and a 1-byte tail (or 4-byte units where a
// pointer is only 4-byte aligned) and takes more launches for more
// segments.  Bound on an H100: bytes, each byte read once and written
// once, over 3.35 TB/s.  Design: threads stride over the concatenated
// unit range, neighbouring threads on neighbouring 16-byte units, so
// every access is a coalesced vector load or store; a thread finds its
// segment by binary search over the ≤ 33 prefix sums in the parameter
// space.
//
// K20 replaces orleans_tpu/tensor/checkpoint.py _gather_tree:
//   out_c[i] = col_c[clip(idx[i], 0, n - 1)]   for every pinned column c
// in one launch, the outputs packed into one staging buffer (column c at
// byte offset off_c, 16-byte aligned), so one device-to-host copy fetches
// the whole chunk.  Pad lanes read row 0 and the caller slices them off.
// Bound on an H100: bytes, m * sum(row bytes) read and written plus 4 m
// of indices; a random row read costs a 32-byte DRAM sector, which the
// bound does not count.  Design: one thread per (lane, unit) with units
// of 16, 4 or 1 bytes as a column's row width allows, so a wide row's
// units are read by neighbouring threads.
//
// K21 replaces orleans_tpu/tensor/checkpoint.py _dirty_mask_kernel and
// _touched_mask_kernel (one kernel, two modes):
//   dirty[r] = live[r] && (moved[r] || max(clock_dev[r], clock_host[r])
//                                      >= cutoff)
// where moved = counts != pinned in dirty mode and false in touched mode
// (counts null).  The host clips its clock to [0, 2^31 - 1] and the
// cutoff to [-2^31 + 1, 2^31 - 1].  Bound on an H100: bytes, 18 per row
// in dirty mode (four int32 columns and the live byte read, the mask
// byte written), 10 in touched mode, over 3.35 TB/s.  Design: one thread
// per row in a grid-stride loop, every access coalesced; only the
// one-byte mask crosses to the host.
#include "common.cuh"

namespace {

constexpr int kMaxSegments = 32;

// K19's table, passed by value (about 0.9 KB of kernel parameters)
struct PinTable {
  const char* src[kMaxSegments];
  char* dst[kMaxSegments];
  int64_t start[kMaxSegments + 1];  // prefix sums of the segments' units
  int32_t unit[kMaxSegments];       // bytes per unit: 16, 4 or 1
  int32_t n;
};

// K20's table: the columns of one pinned arena
struct GatherTable {
  const char* src[kMaxSegments];
  int64_t out_off[kMaxSegments];    // byte offset of the column's output
  int64_t start[kMaxSegments + 1];  // prefix sums of m * units per row
  int32_t per_row[kMaxSegments];    // units per row
  int32_t unit[kMaxSegments];       // bytes per unit: 16, 4 or 1
  int32_t n;
};

__device__ __forceinline__ int find_segment(const int64_t* start, int n,
                                            int64_t i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void copy_unit(const char* src, char* dst,
                                          int unit) {
  if (unit == 16) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
  } else if (unit == 4) {
    *reinterpret_cast<int32_t*>(dst) =
        *reinterpret_cast<const int32_t*>(src);
  } else {
    *dst = *src;
  }
}

__global__ void pin_columns_kernel(const PinTable t) {
  const int64_t total = t.start[t.n];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int s = find_segment(t.start, t.n, i);
    const int64_t off = (i - t.start[s]) * t.unit[s];
    copy_unit(t.src[s] + off, t.dst[s] + off, t.unit[s]);
  }
}

__global__ void gather_columns_kernel(const GatherTable t,
                                      const int32_t* __restrict__ idx,
                                      int64_t n_rows, char* out) {
  const int64_t total = t.start[t.n];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int c = find_segment(t.start, t.n, i);
    const int64_t j = i - t.start[c];
    const int64_t per_row = t.per_row[c];
    const int64_t lane = per_row == 1 ? j : j / per_row;
    const int64_t e = j - lane * per_row;
    int64_t r = idx[lane];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const int64_t unit = t.unit[c];
    copy_unit(t.src[c] + (r * per_row + e) * unit,
              out + t.out_off[c] + j * unit, static_cast<int>(unit));
  }
}

__global__ void dirty_mask_kernel(const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ pinned,
                                  const int32_t* __restrict__ clock_dev,
                                  const int32_t* __restrict__ clock_host,
                                  const uint8_t* __restrict__ live,
                                  int32_t cutoff, uint8_t* __restrict__ out,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n; r += stride) {
    const int32_t a = clock_dev[r];
    const int32_t b = clock_host[r];
    bool dirty = (a > b ? a : b) >= cutoff;
    if (counts != nullptr) dirty = dirty || counts[r] != pinned[r];
    out[r] = (live[r] != 0 && dirty) ? 1 : 0;
  }
}

}  // namespace

// K19: n segments, src[s] / dst[s] / units[s] / unit_bytes[s] as host
// arrays (the wrapper's table); n <= 32
OT_EXPORT int pin_columns(int32_t n, const int64_t* src, const int64_t* dst,
                          const int64_t* units, const int32_t* unit_bytes,
                          void* stream) {
  if (n < 1 || n > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PinTable t;
  t.n = n;
  t.start[0] = 0;
  for (int s = 0; s < n; ++s) {
    t.src[s] = reinterpret_cast<const char*>(src[s]);
    t.dst[s] = reinterpret_cast<char*>(dst[s]);
    t.unit[s] = unit_bytes[s];
    t.start[s + 1] = t.start[s] + units[s];
  }
  for (int s = n; s < kMaxSegments; ++s) {
    t.src[s] = nullptr;
    t.dst[s] = nullptr;
    t.unit[s] = 1;
    t.start[s + 1] = t.start[n];
  }
  if (t.start[n] == 0) return static_cast<int>(cudaSuccess);
  pin_columns_kernel<<<ot_blocks(t.start[n]), OT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// K20: n columns of n_rows rows each, gathered at idx[m] into out
OT_EXPORT int gather_columns(int32_t n, const int64_t* src,
                             const int64_t* out_off, const int32_t* per_row,
                             const int32_t* unit_bytes, const int32_t* idx,
                             int64_t m, int64_t n_rows, void* out,
                             void* stream) {
  if (n < 1 || n > kMaxSegments || n_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherTable t;
  t.n = n;
  t.start[0] = 0;
  for (int c = 0; c < n; ++c) {
    t.src[c] = reinterpret_cast<const char*>(src[c]);
    t.out_off[c] = out_off[c];
    t.per_row[c] = per_row[c];
    t.unit[c] = unit_bytes[c];
    t.start[c + 1] = t.start[c] + m * static_cast<int64_t>(per_row[c]);
  }
  for (int c = n; c < kMaxSegments; ++c) {
    t.src[c] = nullptr;
    t.out_off[c] = 0;
    t.per_row[c] = 1;
    t.unit[c] = 1;
    t.start[c + 1] = t.start[n];
  }
  if (t.start[n] == 0) return static_cast<int>(cudaSuccess);
  gather_columns_kernel<<<ot_blocks(t.start[n]), OT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      t, idx, n_rows, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K21: counts and pinned null in touched mode
OT_EXPORT int dirty_mask(const int32_t* counts, const int32_t* pinned,
                         const int32_t* clock_dev, const int32_t* clock_host,
                         const uint8_t* live, int32_t cutoff, uint8_t* out,
                         int64_t n, void* stream) {
  dirty_mask_kernel<<<ot_blocks(n), OT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      counts, pinned, clock_dev, clock_host, live, cutoff, out, n);
  return static_cast<int>(cudaGetLastError());
}
