// The decoupled look-back shared by the single-pass scans: stuff.cu (K4,
// K5: each tile's stuffed bytes) and seg_merge.cu (K3: each tile's bits
// within its segment). Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", the scan CUB uses.
//
// Each element of the chain has a 64-bit status word: a 2-bit flag (none /
// aggregate / inclusive prefix) and a 62-bit value, so no read can tear. It
// is stored with release (a fence, then the store) and loaded relaxed; the
// word carries all its reader needs, and no other memory is read through
// it. The status words start zeroed (flag none) in every launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

constexpr unsigned long long kAggregate = 1ULL << 62;
constexpr unsigned long long kInclusive = 2ULL << 62;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// The look-back of chain element r (one whole warp): the sum of the
// aggregates of the elements before it back to the nearest inclusive
// prefix, 32 a round, lane k reading element i - k; before element 0 the
// prefix is 0.
__device__ inline long long look_back(
    const unsigned long long* status, long long r, int lane) {
  long long excl = 0;
  for (long long i = r - 1;; i -= 32) {
    unsigned long long st = kInclusive;
    if (i - lane >= 0) {
      do {
        st = observe(&status[i - lane]);
      } while ((st >> 62) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (st >> 62) == 2);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    long long v = lane <= stop ? (long long)(st & kValue) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (incl) break;
  }
  return excl;
}

}  // namespace jt
