// K22 gather_args: the cross-silo router's device-side partition gather.
//
// Replaces orleans_tpu/tensor/router.py _gather_args_dev (router.py:49):
// for every non-scalar leaf a of a message payload tree,
//   out[i] = a[idx[i]]            (rows along axis 0, any trailing shape)
// where idx is the ownership split of a ClusterInjector's key set, laid
// out as a permutation: the local lanes, then each remote destination's.
// One launch serves the whole tree and every segment of the split (up to
// kMaxSegments segments and kMaxLeaves leaves): the output is one packed
// buffer, segment-major, every (segment, leaf) piece 16-byte aligned, so
// the local segment's leaves are views handed to the local injector and
// the remote segments form one contiguous region that crosses to the
// host with one copy.  Indices outside [0, n) clip.
//
// What bounds it on an H100: bytes, m * sum(row bytes) read and written
// plus 4 m of indices over 3.35 TB/s; a random row read costs a 32-byte
// DRAM sector, which the bound does not count.  The first design ran a
// thread per (lane, leaf, 4-byte unit): each thread searched the piece
// table in the parameter space, re-read its lane's index for every leaf,
// and had one 4-byte load in flight before its 4-byte store.  This one:
// - the host plans the blocks (kernels/router.py plan_gather): segment s
//   owns blocks [block0, block0 + ceil(lanes / 1024)), each a run of 1024
//   lanes of that segment for all its leaves, so a block finds its
//   segment from blockIdx alone, the same for every thread;
// - a thread takes 4 consecutive lanes, reads their indices once (one
//   16-byte load where aligned) and keeps them for every leaf; for a row
//   of 1, 2, 4 or 8 bytes it starts its 4 gathers, and those of the
//   next such leaf, before one vector store of 4 lanes (16 bytes for a
//   4-byte leaf), the pieces being 16-byte aligned; a ragged end stores
//   lane by lane;
// - a leaf of any other row width (16 bytes, [n, 4] float32, or wider)
//   copies the block's rows in units of 16, 8, 4 or 1 bytes, a row's
//   units on neighbouring threads, from the block's indices staged in
//   shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 4;
constexpr int kLanesPerBlock = kThreads * kLanesPerThread;
constexpr int kMaxLeaves = 8;
constexpr int kMaxSegments = 16;

struct Leaf {
  const char* src;
  int64_t n_rows;     // rows of the leaf (the clip)
  int32_t row_bytes;
  int32_t unit;       // 0: the 4-lane path; else the row copy's unit
};

struct Segment {
  int64_t lane0;      // first lane of idx
  int64_t lanes;
  int64_t block0;     // first block
  int64_t out_off[kMaxLeaves];  // byte offset of each leaf's piece
};

struct Table {
  Leaf leaf[kMaxLeaves];
  Segment seg[kMaxSegments];
  int32_t n_leaves;
  int32_t n_segments;
};

__device__ __forceinline__ int64_t clip_row(int32_t r, int64_t n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// a row of 1, 2, 4 or 8 bytes, widened
__device__ __forceinline__ unsigned long long load_row(const Leaf& lf,
                                                       int32_t r) {
  const int64_t row = clip_row(r, lf.n_rows);
  switch (lf.row_bytes) {
    case 1: return reinterpret_cast<const uint8_t*>(lf.src)[row];
    case 2: return reinterpret_cast<const uint16_t*>(lf.src)[row];
    case 4: return reinterpret_cast<const uint32_t*>(lf.src)[row];
    default: return reinterpret_cast<const unsigned long long*>(lf.src)[row];
  }
}

// a thread's lanes of one narrow leaf: every gather, before any store
__device__ __forceinline__ void load4(const Leaf& lf, const int32_t* r,
                                      int nl, unsigned long long* v) {
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    if (j < nl) v[j] = load_row(lf, r[j]);
  }
}

// ... then one vector store of the 4 lanes (16 bytes for a 4-byte row),
// or lane by lane at a ragged end
__device__ __forceinline__ void store4(int row_bytes,
                                       const unsigned long long* v, int nl,
                                       char* piece, int64_t first) {
  char* dst = piece + first * row_bytes;
  if (nl == kLanesPerThread) {
    switch (row_bytes) {
      case 1:
        *reinterpret_cast<uint32_t*>(dst) =
            static_cast<uint32_t>(v[0] | (v[1] << 8) | (v[2] << 16) |
                                  (v[3] << 24));
        return;
      case 2:
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(static_cast<uint32_t>(v[0] | (v[1] << 16)),
                       static_cast<uint32_t>(v[2] | (v[3] << 16)));
        return;
      case 4:
        *reinterpret_cast<uint4*>(dst) = make_uint4(
            static_cast<uint32_t>(v[0]), static_cast<uint32_t>(v[1]),
            static_cast<uint32_t>(v[2]), static_cast<uint32_t>(v[3]));
        return;
      default: {
        ulonglong2* d = reinterpret_cast<ulonglong2*>(dst);
        d[0] = make_ulonglong2(v[0], v[1]);
        d[1] = make_ulonglong2(v[2], v[3]);
        return;
      }
    }
  }
  for (int j = 0; j < nl; ++j) {
    switch (row_bytes) {
      case 1: reinterpret_cast<uint8_t*>(dst)[j] =
                  static_cast<uint8_t>(v[j]); break;
      case 2: reinterpret_cast<uint16_t*>(dst)[j] =
                  static_cast<uint16_t>(v[j]); break;
      case 4: reinterpret_cast<uint32_t*>(dst)[j] =
                  static_cast<uint32_t>(v[j]); break;
      default: reinterpret_cast<unsigned long long*>(dst)[j] = v[j];
    }
  }
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

__global__ void __launch_bounds__(kThreads) gather_args_kernel(
    const __grid_constant__ Table t, const int32_t* __restrict__ idx,
    char* __restrict__ out) {
  __shared__ int32_t s_idx[kLanesPerBlock];
  // the block's segment: the last whose first block is at or before it
  // (uniform over the block: parameter-space reads, no per-thread search)
  int s = 0;
  while (s + 1 < t.n_segments &&
         t.seg[s + 1].block0 <= static_cast<int64_t>(blockIdx.x)) {
    ++s;
  }
  const Segment& g = t.seg[s];
  const int64_t blk_lo =
      (static_cast<int64_t>(blockIdx.x) - g.block0) * kLanesPerBlock;
  const int64_t blk_n = g.lanes - blk_lo < kLanesPerBlock
                            ? g.lanes - blk_lo : kLanesPerBlock;
  const int64_t first = blk_lo + threadIdx.x * kLanesPerThread;
  const int64_t left = g.lanes - first;
  const int nl = left >= kLanesPerThread ? kLanesPerThread
                                         : (left > 0 ? static_cast<int>(left)
                                                     : 0);
  int32_t r[kLanesPerThread] = {0, 0, 0, 0};
  const int32_t* ip = idx + g.lane0 + first;
  if (nl == kLanesPerThread &&
      (reinterpret_cast<uintptr_t>(ip) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(ip);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    for (int j = 0; j < nl; ++j) r[j] = ip[j];
  }
  // narrow leaves pipelined by one: the next leaf's gathers are in
  // flight before this leaf's store
  unsigned long long cur[kLanesPerThread], next[kLanesPerThread];
  if (nl > 0 && t.leaf[0].unit == 0) load4(t.leaf[0], r, nl, next);
  bool staged = false;
  for (int l = 0; l < t.n_leaves; ++l) {
    const Leaf& lf = t.leaf[l];
    char* piece = out + g.out_off[l];
    if (lf.unit == 0) {
      if (nl == 0) continue;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) cur[j] = next[j];
      if (l + 1 < t.n_leaves && t.leaf[l + 1].unit == 0) {
        load4(t.leaf[l + 1], r, nl, next);
      }
      store4(lf.row_bytes, cur, nl, piece, first);
      continue;
    }
    if (!staged) {  // uniform: the leaf table is the block's
      for (int j = 0; j < nl; ++j) {
        s_idx[threadIdx.x * kLanesPerThread + j] = r[j];
      }
      __syncthreads();
      staged = true;
    }
    const int unit = lf.unit;
    const int64_t per_row = lf.row_bytes / unit;
    const int64_t total = blk_n * per_row;
    for (int64_t e = threadIdx.x; e < total; e += kThreads) {
      const int64_t lane = e / per_row;
      const int64_t u = e - lane * per_row;
      const int64_t row = clip_row(s_idx[lane], lf.n_rows);
      copy_unit(lf.src + (row * per_row + u) * unit,
                piece + ((blk_lo + lane) * per_row + u) * unit, unit);
    }
    if (nl > 0 && l + 1 < t.n_leaves && t.leaf[l + 1].unit == 0) {
      load4(t.leaf[l + 1], r, nl, next);
    }
  }
}

}  // namespace

// K22, one launch: n_segments (<= 16) segments of idx, segment s at lanes
// [lane0[s], lane0[s] + lanes[s]) and blocks [block0[s], block0[s + 1]),
// its piece of leaf l at out + out_off[s * n_leaves + l]; n_leaves (<= 8)
// leaves, leaf l at src[l] with n_rows[l] rows of row_bytes[l] bytes
// copied by the 4-lane path (unit[l] == 0) or in unit[l]-byte units
OT_EXPORT int gather_args(int32_t n_segments, const int64_t* lane0,
                          const int64_t* lanes, const int64_t* block0,
                          const int64_t* out_off, int32_t n_leaves,
                          const int64_t* src, const int64_t* n_rows,
                          const int32_t* row_bytes, const int32_t* unit,
                          const int32_t* idx, void* out, void* stream) {
  if (n_segments < 1 || n_segments > kMaxSegments || n_leaves < 1 ||
      n_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  t.n_leaves = n_leaves;
  t.n_segments = n_segments;
  for (int l = 0; l < n_leaves; ++l) {
    if (n_rows[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.leaf[l] = {reinterpret_cast<const char*>(src[l]), n_rows[l],
                 row_bytes[l], unit[l]};
  }
  for (int s = 0; s < n_segments; ++s) {
    t.seg[s].lane0 = lane0[s];
    t.seg[s].lanes = lanes[s];
    t.seg[s].block0 = block0[s];
    for (int l = 0; l < n_leaves; ++l) {
      t.seg[s].out_off[l] = out_off[s * n_leaves + l];
    }
  }
  const int64_t blocks = block0[n_segments];
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  gather_args_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      t, idx, static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}
