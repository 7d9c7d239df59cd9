// The device timers plane's two passes over its int32 slot columns
// (key, due, name, period; slot 0 is the dead slot every pad targets).
//
// K14 timers_write replaces orleans_tpu/tensor/timers_plane.py
// _write_kernel: the batched arm/cancel write of all four columns,
//   key[idx[i]] = k[i], due[idx[i]] = d[i], name[idx[i]] = nm[i],
//   period[idx[i]] = p[i], dropping lanes whose slot is outside [0, n).
// Pad lanes target slot 0 with the sentinel values, so the only
// duplicate slot of a launch is slot 0, always written with identical
// values.  Bound on an H100: bytes, 32 per lane (a slot index and four
// values read, four scattered values written, counted at 4 B each).
// Design: one thread per lane writes all four columns, one launch.
//
// K15 timers_harvest replaces timers_plane.py _harvest_kernel: one
// thread per due-slot lane gathers (key, due, period, name) at its slot
// (index clipped into [0, n), as a JAX gather does), decides
//   fired = key != SENTINEL && due <= now,  rearm = fired && period > 0,
// re-arms a periodic timer on its start + k * period grid
//   due' = due + ((now - due) // max(period, 1) + 1) * period
// and frees a fired one-shot (key := SENTINEL), writing both back to the
// slot (dropped outside [0, n)); it writes the gathered key, name and
// the fired flag of every lane, pads included (a pad reads the dead slot,
// so it never fires).  JAX's int32 arithmetic wraps and its // floors:
// here every step runs in unsigned 32-bit arithmetic, which wraps by
// definition, and the division is corrected from C++'s truncation to
// floor, so dues and clocks at the int32 edges agree bit for bit.  Bound
// on an H100: bytes, about 33 per lane (a slot index, four gathered
// values, two written back, two outputs and one flag byte); the gathers
// are random sector reads.  The harvest is a few hundred thousand lanes
// at most, so one thread per lane with no shared memory is enough.
#include "common.cuh"

namespace {

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// floor(a / b) for b >= 1 (C++ division truncates toward zero)
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && (a < 0)) q -= 1;
  return q;
}

__global__ void timers_write_kernel(int32_t* __restrict__ key,
                                    int32_t* __restrict__ due,
                                    int32_t* __restrict__ name,
                                    int32_t* __restrict__ period, int64_t n,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ k,
                                    const int32_t* __restrict__ d,
                                    const int32_t* __restrict__ nm,
                                    const int32_t* __restrict__ p,
                                    int64_t w) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < w; i += stride) {
    const int32_t s = idx[i];
    if (s < 0 || s >= n) continue;
    key[s] = k[i];
    due[s] = d[i];
    name[s] = nm[i];
    period[s] = p[i];
  }
}

__global__ void timers_harvest_kernel(int32_t* __restrict__ key,
                                      int32_t* __restrict__ due,
                                      const int32_t* __restrict__ period,
                                      const int32_t* __restrict__ name,
                                      int64_t n,
                                      const int32_t* __restrict__ idx,
                                      int64_t w, int32_t now,
                                      int32_t* __restrict__ k_out,
                                      int32_t* __restrict__ nm_out,
                                      uint8_t* __restrict__ fired_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < w; i += stride) {
    const int32_t s = idx[i];
    const int64_t g = s < 0 ? 0 : (s >= n ? n - 1 : s);
    const int32_t k = key[g];
    const int32_t d = due[g];
    const int32_t p = period[g];
    const int32_t nm = name[g];
    const bool fired = k != OT_KEY_SENTINEL && d <= now;
    const bool rearm = fired && p > 0;
    int32_t d2 = d;
    if (rearm) {
      const int32_t steps =
          wrap_add(floor_div(wrap_sub(now, d), p > 1 ? p : 1), 1);
      d2 = wrap_add(d, wrap_mul(steps, p));
    }
    k_out[i] = k;
    nm_out[i] = nm;
    fired_out[i] = fired ? 1 : 0;
    if (s >= 0 && s < n) {
      key[s] = (fired && !rearm) ? OT_KEY_SENTINEL : k;
      due[s] = d2;
    }
  }
}

}  // namespace

OT_EXPORT int timers_write(int32_t* key, int32_t* due, int32_t* name,
                           int32_t* period, int64_t n, const int32_t* idx,
                           const int32_t* k, const int32_t* d,
                           const int32_t* nm, const int32_t* p, int64_t w,
                           void* stream) {
  timers_write_kernel<<<ot_blocks(w), OT_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      key, due, name, period, n, idx, k, d, nm, p, w);
  return static_cast<int>(cudaGetLastError());
}

OT_EXPORT int timers_harvest(int32_t* key, int32_t* due,
                             const int32_t* period, const int32_t* name,
                             int64_t n, const int32_t* idx, int64_t w,
                             int32_t now, int32_t* k_out, int32_t* nm_out,
                             uint8_t* fired_out, void* stream) {
  timers_harvest_kernel<<<ot_blocks(w), OT_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      key, due, period, name, n, idx, w, now, k_out, nm_out, fired_out);
  return static_cast<int>(cudaGetLastError());
}
