// The lower-bound search tree of K2 (resolve_sorted) and K10
// (resolve_wide): the top of a sorted int32 mirror in shared memory, in
// Eytzinger (BFS) order, node i with children 2i and 2i + 1, so level l
// of every lane's descent reads the 2**l consecutive words [2**l,
// 2**(l+1)) and a warp's random keys spread over the banks instead of all
// striking the one bank that a sorted array's midpoints at power-of-two
// strides share.  The plan (whole, levels, log_s) is kernels/resolve.py
// resolve_plan's.
//
// WHOLE: the tree holds the mirror itself (n <= 2**levels - 1, padded
// with OT_TREE_INF), and the descent's leaf is the lower bound.
// Otherwise the tree holds one key of every bucket of s = 2**log_s keys:
// its first key after the first bucket, sk[(j + 1) << log_s] (LAST = 0,
// K2), or its last key, sk[((j + 1) << log_s) - 1] (LAST = 1, K10).  The
// leaf b is then the bucket [b << log_s, (b + 1) << log_s) (LAST = 1), or
// the bucket after whose first key (LAST = 0), the lower bound lies.
#pragma once

#include "common.cuh"

constexpr int32_t OT_TREE_INF = 2147483647;

// fill nodes 1 .. 2**levels - 1 from the mirror sk of n keys (every thread
// of the block calls it; the caller synchronises before the descent).  A
// thread's loads all issue before its first store, so the fill costs one
// round trip to L2, not one a node.
constexpr int OT_TREE_FILL_LOADS = 8;

__device__ __forceinline__ void ot_tree_fill(int32_t* tree, int levels,
                                             bool whole, int log_s,
                                             int last,
                                             const int32_t* __restrict__ sk,
                                             int32_t n) {
  const int size = (1 << levels) - 1;
  const int step = static_cast<int>(blockDim.x);
  for (int j0 = threadIdx.x; j0 < size; j0 += OT_TREE_FILL_LOADS * step) {
    int32_t key[OT_TREE_FILL_LOADS];
#pragma unroll
    for (int q = 0; q < OT_TREE_FILL_LOADS; ++q) {
      const int j = j0 + q * step;
      const int64_t src =
          whole ? j : ((static_cast<int64_t>(j) + 1) << log_s) - last;
      key[q] = j < size && src < n ? __ldg(sk + src) : OT_TREE_INF;
    }
#pragma unroll
    for (int q = 0; q < OT_TREE_FILL_LOADS; ++q) {
      const int j = j0 + q * step;
      if (j < size) {
        // in-order element j sits at depth levels-1-t, index q of its level
        const int t = __ffs(j + 1) - 1;
        tree[(1 << (levels - 1 - t)) + ((j + 1) >> (t + 1))] = key[q];
      }
    }
  }
}

// L descents interleaved: the same steps for every lane, no branch, L
// independent shared loads in flight a step.  node ends as 2**levels + the
// leaf; upper as the least node value >= k on the path (OT_TREE_INF where
// none), which is the key at the lower bound in WHOLE mode
template <int L>
__device__ __forceinline__ void ot_tree_descend(const int32_t* tree,
                                                int levels,
                                                const int32_t (&k)[L],
                                                int32_t (&node)[L],
                                                int32_t (&upper)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    node[j] = 1;
    upper[j] = OT_TREE_INF;
  }
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t t = tree[node[j]];
      const bool lt = t < k[j];
      upper[j] = lt ? upper[j] : t;
      node[j] = 2 * node[j] + lt;
    }
  }
}
