// K9 attr_snapshot: the device half of an attribution snapshot of one
// arena's counts column, every output reduced on the device so the host
// reads a few dozen int64 words.
//
// Replaces orleans_tpu/tensor/attribution.py _snapshot_kernel :257:
//   total, nnz (rows with a count > 0), per-shard sums; top_k of the
//   counts with ties ordered lower row first (jax.lax.top_k's order); p99
//   of the ascending counts at clip(cap - nnz + (nnz - 1) * 99 // 100);
//   Gini over the nonzero rows, sum((2·rank - nnz - 1)·s) / (nnz·total)
//   in float32; mean over the nonzero rows; and the count-min estimate of
//   each top row, the minimum of its hashed buckets over the depths.
// Output, int64 [3k + n_shards + 5]: vals[k] | rows[k] | est[k] |
// shard[n_shards] | total | nnz | p99 | gini | mean_nz, the last two as
// the bit patterns of float32 values.
//
// It runs only at snapshots, so determinism and exactness come first.
// Design: one order serves every gauge.  Pack each row as the uint64
// ((INT32_MAX - count) << 32) | row, so ascending keys are descending
// counts with ties by ascending row; sort with a bitonic network (tiles of
// 4096 keys in shared memory, one global compare-exchange pass per longer
// step; no CUB, no torch.sort); then the top-k is the first k keys, the
// ascending order is the reverse, and the Gini term of descending
// position j < nnz is (nnz - 2j - 1)·count.  The Gini sum is taken in
// float64 over a fixed grid with per-block partials summed in order, so
// the result does not depend on scheduling.  The packing pass sums the
// shards and counts the nonzero rows with integer atomics.
// Bound on an H100: bytes, dominated by the sort's passes over 8-byte
// keys (a 2M-row arena: 2^21 keys, 55 launches, ~45 global passes).
#include "attr_common.cuh"

namespace {

constexpr int kTile = 4096;         // keys per shared-memory tile
constexpr int kTileThreads = 512;
constexpr int kGiniBlocks = 264;    // fixed: the partials' order
constexpr int kFinalThreads = 256;

__device__ __forceinline__ int64_t count_of(uint64_t key) {
  return static_cast<int64_t>(INT32_MAX) - static_cast<int64_t>(key >> 32);
}

__global__ void snap_init_kernel(int64_t* __restrict__ out, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = 0;
}

// grid (x, n_shards): block (x, s) packs and sums rows of shard s
__global__ void snap_pack_kernel(const int32_t* __restrict__ counts,
                                 int64_t cap, int64_t n2,
                                 uint64_t* __restrict__ keys,
                                 unsigned long long* __restrict__ shard,
                                 unsigned long long* __restrict__ nnz) {
  __shared__ long long sums[OT_THREADS / 32];
  __shared__ long long nzs[OT_THREADS / 32];
  const int64_t per = cap / gridDim.y;
  const int64_t lo = per * blockIdx.y;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  long long sum = 0;
  long long nz = 0;
  for (int64_t i = lo + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < lo + per; i += stride) {
    const int32_t c = counts[i];
    const uint64_t inv = static_cast<uint32_t>(
        static_cast<int64_t>(INT32_MAX) - static_cast<int64_t>(c));
    keys[i] = (inv << 32) | static_cast<uint64_t>(i);
    sum += c;
    nz += c > 0;
  }
  if (blockIdx.y == 0) {  // the power-of-two padding sorts last
    for (int64_t i = cap + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n2; i += stride) {
      keys[i] = ~0ull;
    }
  }
  sum = ot_block_sum(sum, sums);
  nz = ot_block_sum(nz, nzs);
  if (threadIdx.x == 0) {
    if (sum) {
      atomicAdd(shard + blockIdx.y, static_cast<unsigned long long>(sum));
    }
    if (nz) atomicAdd(nnz, static_cast<unsigned long long>(nz));
  }
}

// pair p of a bitonic step of width j: (i, i + j) with bit j of i clear
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__device__ __forceinline__ void order(uint64_t& a, uint64_t& b, bool up) {
  if ((a > b) == up) {
    const uint64_t t = a;
    a = b;
    b = t;
  }
}

// stages 2..tile of the network over one tile (directions by global
// position)
__global__ void sort_tiles_kernel(uint64_t* keys, int tile) {
  __shared__ uint64_t s[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int lo = static_cast<int>(pair_low(p, j));
        order(s[lo], s[lo + j], ((base + lo) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

// one step j >= tile of stage k, over all n2 keys
__global__ void global_step_kernel(uint64_t* keys, int64_t n2, int64_t j,
                                   int64_t k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < (n2 >> 1); p += stride) {
    const int64_t lo = pair_low(p, j);
    order(keys[lo], keys[lo + j], (lo & k) == 0);
  }
}

// the steps j < tile of stage k > tile: one direction per tile
__global__ void merge_tiles_kernel(uint64_t* keys, int tile, int64_t k) {
  __shared__ uint64_t s[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const bool up = (base & k) == 0;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  for (int j = tile >> 1; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int lo = static_cast<int>(pair_low(p, j));
      order(s[lo], s[lo + j], up);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

// per block: sum over its descending positions j < nnz of
// (nnz - 2j - 1) * count_j, in float64
__global__ void snap_gini_kernel(const uint64_t* __restrict__ keys,
                                 const int64_t* __restrict__ nnz_p,
                                 double* __restrict__ partials) {
  __shared__ double sums[OT_THREADS / 32];
  const int64_t nnz = *nnz_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  double acc = 0.0;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < nnz; j += stride) {
    acc += static_cast<double>(nnz - 2 * j - 1) *
           static_cast<double>(count_of(keys[j]));
  }
  acc = ot_block_sum(acc, sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void snap_final_kernel(const uint64_t* __restrict__ keys,
                                  int64_t cap, const int32_t* __restrict__ cms,
                                  int depth, int64_t width, OtSeeds seeds,
                                  int k, int n_shards,
                                  const double* __restrict__ partials,
                                  int64_t* __restrict__ out) {
  const uint32_t width_mask = static_cast<uint32_t>(width - 1);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = keys[i];
    const int32_t row = static_cast<int32_t>(key & 0xffffffffull);
    out[i] = count_of(key);
    out[k + i] = row;
    int32_t est = 0;
    for (int d = 0; d < depth; ++d) {
      const int32_t v = cms[d * width + ot_cms_bucket(row, seeds.s[d],
                                                      width_mask)];
      est = d == 0 ? v : (v < est ? v : est);
    }
    out[2 * k + i] = est;
  }
  if (threadIdx.x != 0) return;
  int64_t* tail = out + 3 * k + n_shards;
  int64_t total = 0;
  for (int s = 0; s < n_shards; ++s) total += out[3 * k + s];
  const int64_t nnz = tail[1];
  double g = 0.0;
  for (int b = 0; b < kGiniBlocks; ++b) g += partials[b];
  // p99: ascending position clip(cap - nnz + floor((nnz-1)*99/100)), i.e.
  // descending position cap - 1 - pos
  const int64_t a = (nnz - 1) * 99;
  const int64_t q = a >= 0 ? a / 100 : -((-a + 99) / 100);
  int64_t pos = cap - nnz + q;
  pos = pos < 0 ? 0 : (pos > cap - 1 ? cap - 1 : pos);
  const float nnz_f = static_cast<float>(nnz > 1 ? nnz : 1);
  const float total_f = static_cast<float>(total > 1 ? total : 1);
  const float gini = static_cast<float>(g) / (nnz_f * total_f);
  const float mean = total_f / nnz_f;
  tail[0] = total;
  tail[2] = count_of(keys[cap - 1 - pos]);
  tail[3] = static_cast<int64_t>(__float_as_uint(gini));
  tail[4] = static_cast<int64_t>(__float_as_uint(mean));
}

}  // namespace

// n2: the power of two >= cap, keys its scratch; partials: float64
// scratch of attr_snapshot_partials(); 1 <= k <= cap; n_shards divides cap
OT_EXPORT int attr_snapshot_partials() { return kGiniBlocks; }

OT_EXPORT int attr_snapshot(const int32_t* counts, int64_t cap, int64_t n2,
                            const int32_t* cms, int depth, int64_t width,
                            const uint32_t* seeds, int k, int n_shards,
                            uint64_t* keys, double* partials, int64_t* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_out = 3 * static_cast<int64_t>(k) + n_shards + 5;
  snap_init_kernel<<<1, kFinalThreads, 0, s>>>(out, n_out);
  int64_t* tail = out + 3 * k + n_shards;
  const dim3 pack_grid(ot_blocks(cap / n_shards, 1024), n_shards);
  snap_pack_kernel<<<pack_grid, OT_THREADS, 0, s>>>(
      counts, cap, n2, keys,
      reinterpret_cast<unsigned long long*>(out + 3 * k),
      reinterpret_cast<unsigned long long*>(tail + 1));
  const int tile = static_cast<int>(n2 < kTile ? n2 : kTile);
  const unsigned int tiles = static_cast<unsigned int>(n2 / tile);
  sort_tiles_kernel<<<tiles, kTileThreads, 0, s>>>(keys, tile);
  for (int64_t kk = 2 * static_cast<int64_t>(tile); kk <= n2; kk <<= 1) {
    for (int64_t j = kk >> 1; j >= tile; j >>= 1) {
      global_step_kernel<<<ot_blocks(n2 >> 1), OT_THREADS, 0, s>>>(keys, n2,
                                                                  j, kk);
    }
    merge_tiles_kernel<<<tiles, kTileThreads, 0, s>>>(keys, tile, kk);
  }
  snap_gini_kernel<<<kGiniBlocks, OT_THREADS, 0, s>>>(keys, tail + 1,
                                                      partials);
  snap_final_kernel<<<1, kFinalThreads, 0, s>>>(
      keys, cap, cms, depth, width, ot_seeds(seeds, depth), k, n_shards,
      partials, out);
  return static_cast<int>(cudaGetLastError());
}
