// Shared by the workload-attribution kernels: K7 attr_fold
// (attr_fold.cu), K8 attr_apply / attr_match (attr_apply.cu) and K9
// attr_snapshot (attr_snapshot.cu).
#pragma once

#include "common.cuh"

// the JAX package's MAX_CMS_DEPTH (orleans_tpu/tensor/attribution.py:96)
constexpr int OT_MAX_CMS_DEPTH = 8;

// a call's sketch seeds, passed by value: fixed per call site, so a CUDA
// graph may bake them
struct OtSeeds {
  uint32_t s[OT_MAX_CMS_DEPTH];
};

inline OtSeeds ot_seeds(const uint32_t* host, int depth) {
  OtSeeds seeds{};
  for (int d = 0; d < depth && d < OT_MAX_CMS_DEPTH; ++d) seeds.s[d] = host[d];
  return seeds;
}

// cms_hash (orleans_tpu/tensor/attribution.py:103) of one row at one
// depth: a uint32 multiply-xorshift of the row, masked to the width (a
// power of two).  Unsigned arithmetic wraps mod 2**32, as the JAX uint32
// does; a negative row enters as its two's-complement bits.
__device__ __forceinline__ uint32_t ot_cms_bucket(int32_t row, uint32_t seed,
                                                  uint32_t width_mask) {
  uint32_t u = static_cast<uint32_t>(row) * seed;
  u ^= u >> 15;
  u *= 0x27D4EB2Fu;
  u ^= u >> 13;
  return u & width_mask;
}
