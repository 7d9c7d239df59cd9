// K22 gather_args: the cross-silo router's device-side partition gather.
//
// Replaces orleans_tpu/tensor/router.py _gather_args_dev (router.py:49):
// for every non-scalar leaf a of a message payload tree,
//   out[i] = a[idx[i]]            (rows along axis 0, any trailing shape)
// where idx is the ownership split of a ClusterInjector's key set, laid
// out as a permutation: the local lanes, then each remote destination's.
// One launch serves the whole tree and every segment of the split: a
// table of pieces, one per (segment, leaf), each naming its source, its
// lane range of idx, its row width and its byte offset in one packed
// output buffer (segment-major, every piece 16-byte aligned), so the
// local segment's leaves are views handed to the local injector and the
// remote segments form one contiguous region that crosses to the host
// with one copy.  Indices outside [0, n) clip (the wrapper's lanes never
// leave the range).
//
// Bound on an H100: bytes, m * sum(row bytes) read and written plus 4 m
// of indices over 3.35 TB/s; a random row read costs a 32-byte DRAM
// sector, which the bound does not count.  Design: one thread per
// (lane, unit) in a grid-stride loop, units of 16, 8, 4 or 1 bytes as a
// piece's row width and addresses allow, so the writes are coalesced
// vector stores and a wide row's units are read by neighbouring threads;
// a thread finds its piece by binary search over the piece prefix sums in
// the parameter space (about 2.6 KB of kernel parameters).
#include "common.cuh"

namespace {

constexpr int kMaxPieces = 64;

struct PieceTable {
  const char* src[kMaxPieces];
  int64_t out_off[kMaxPieces];      // byte offset of the piece's output
  int64_t lane0[kMaxPieces];        // first lane of idx the piece reads
  int64_t n_rows[kMaxPieces];       // rows of the source leaf (clip)
  int64_t start[kMaxPieces + 1];    // prefix sums of lanes * units per row
  int32_t per_row[kMaxPieces];      // units per row
  int32_t unit[kMaxPieces];         // bytes per unit: 16, 8, 4 or 1
  int32_t n;
};

__device__ __forceinline__ int find_piece(const int64_t* start, int n,
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
  } else if (unit == 8) {
    *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
  } else if (unit == 4) {
    *reinterpret_cast<int32_t*>(dst) =
        *reinterpret_cast<const int32_t*>(src);
  } else {
    *dst = *src;
  }
}

__global__ void gather_args_kernel(const PieceTable t,
                                   const int32_t* __restrict__ idx,
                                   char* __restrict__ out) {
  const int64_t total = t.start[t.n];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int p = find_piece(t.start, t.n, i);
    const int64_t j = i - t.start[p];
    const int64_t per_row = t.per_row[p];
    const int64_t lane = per_row == 1 ? j : j / per_row;
    const int64_t e = j - lane * per_row;
    int64_t r = idx[t.lane0[p] + lane];
    const int64_t n = t.n_rows[p];
    r = r < 0 ? 0 : (r >= n ? n - 1 : r);
    const int64_t unit = t.unit[p];
    copy_unit(t.src[p] + (r * per_row + e) * unit,
              out + t.out_off[p] + j * unit, static_cast<int>(unit));
  }
}

}  // namespace

// K22: n pieces (n <= 64); piece k reads lanes [lane0[k], lane0[k] +
// lanes[k]) of idx from src[k] (n_rows[k] rows of per_row[k] units of
// unit_bytes[k] bytes) into out + out_off[k]
OT_EXPORT int gather_args(int32_t n, const int64_t* src,
                          const int64_t* out_off, const int64_t* lane0,
                          const int64_t* lanes, const int64_t* n_rows,
                          const int32_t* per_row, const int32_t* unit_bytes,
                          const int32_t* idx, void* out, void* stream) {
  if (n < 1 || n > kMaxPieces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PieceTable t;
  t.n = n;
  t.start[0] = 0;
  for (int k = 0; k < n; ++k) {
    if (n_rows[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.src[k] = reinterpret_cast<const char*>(src[k]);
    t.out_off[k] = out_off[k];
    t.lane0[k] = lane0[k];
    t.n_rows[k] = n_rows[k];
    t.per_row[k] = per_row[k];
    t.unit[k] = unit_bytes[k];
    t.start[k + 1] = t.start[k] + lanes[k] * static_cast<int64_t>(per_row[k]);
  }
  for (int k = n; k < kMaxPieces; ++k) {
    t.src[k] = nullptr;
    t.out_off[k] = 0;
    t.lane0[k] = 0;
    t.n_rows[k] = 1;
    t.per_row[k] = 1;
    t.unit[k] = 1;
    t.start[k + 1] = t.start[n];
  }
  if (t.start[n] == 0) return static_cast<int>(cudaSuccess);
  gather_args_kernel<<<ot_blocks(t.start[n]), OT_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, idx, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}
