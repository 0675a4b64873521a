// Segment-merge kernel v2 (K9): pre-merged MCU bitstreams -> one bitstream
// per restart segment, its last byte 1-padded (ITU-T T.81 F.1.2.3).
//
// Replaces jpegtpu/kernels/entropy_oracles.py:_seg_merge_window_kernel
// (called from seg_merge_v2, after mcu_merge). The TPU kernel walks each
// segment's MCUs serially, one grid step per segment, keeping the cursor
// in a [16, 128] register window that it flushes in 1024-word frames. Here
// one thread block owns one segment: it scans its MCU lengths itself, a
// tile at a time with a running carry (no offsets from outside, and a
// restart-0 segment of 32,400 MCUs is just more tiles), and its warps place
// the MCU rows at the scanned offsets (merge_common.cuh:append_segment).
// Words past the output row are dropped and the bit count stays the true
// one, where jpegtpu clamps a segment that overflows to its last frame.
// The output must be zero-filled before the launch.
//
// Bound: for many segments the atomics of the placement; for one segment
// the single SM that its block runs on.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_common.cuh"

namespace {

constexpr int kThreads = 1024;      // MCUs per tile

__global__ void __launch_bounds__(kThreads)
seg_merge_window_kernel(const int32_t* __restrict__ mwords,
                        const int32_t* __restrict__ mlens,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ seg_bits, long long mps,
                        int mcu_words, long long seg_words) {
  jt::append_segment<kThreads>(mwords, mlens, out, seg_bits, mps, mcu_words,
                               seg_words);
}

}  // namespace

extern "C" int jt_seg_merge_window(const int32_t* mwords,
                                   const int32_t* mlens, int32_t* out,
                                   int32_t* seg_bits, long long n_seg,
                                   long long mps, int mcu_words,
                                   long long seg_words, cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  seg_merge_window_kernel<<<(unsigned)n_seg, kThreads, 0, stream>>>(
      mwords, mlens, out, seg_bits, mps, mcu_words, seg_words);
  return (int)cudaGetLastError();
}
