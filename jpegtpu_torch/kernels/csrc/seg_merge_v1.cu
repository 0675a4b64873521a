// Segment-merge kernel v1 (K10): per-block bitstreams -> one bitstream per
// restart segment, its last byte 1-padded (ITU-T T.81 F.1.2.3).
//
// Replaces jpegtpu/kernels/entropy_oracles.py:_seg_merge_kernel (called
// from seg_merge). The TPU kernel appends a segment's blocks one by one in
// a fori loop, each by a funnel shift, a dynamic lane rotate and a 2-row
// read-modify-write of a VMEM accumulator. Here K9's design runs over the
// 56-word block rows: one thread block per segment scans its block lengths
// itself, a tile at a time with a running carry (1,440 blocks a segment at
// 4K rows, 194,400 in the restart-0 segment), and its warps place the rows
// at the scanned offsets (merge_common.cuh:append_segment). Words past the
// output row are dropped and the bit count stays the true one, where
// jpegtpu writes past its buffer. The output must be zero-filled before
// the launch.
//
// Bound: for many segments the atomics of the placement; for one segment
// the single SM that its block runs on.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_common.cuh"

namespace {

constexpr int kThreads = 1024;      // blocks per tile

__global__ void __launch_bounds__(kThreads)
seg_merge_v1_kernel(const int32_t* __restrict__ words,
                    const int32_t* __restrict__ lens,
                    int32_t* __restrict__ out, int32_t* __restrict__ seg_bits,
                    long long bps, int block_words, long long seg_words) {
  jt::append_segment<kThreads>(words, lens, out, seg_bits, bps, block_words,
                               seg_words);
}

}  // namespace

extern "C" int jt_seg_merge_v1(const int32_t* words, const int32_t* lens,
                               int32_t* out, int32_t* seg_bits,
                               long long n_seg, long long bps,
                               int block_words, long long seg_words,
                               cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  seg_merge_v1_kernel<<<(unsigned)n_seg, kThreads, 0, stream>>>(
      words, lens, out, seg_bits, bps, block_words, seg_words);
  return (int)cudaGetLastError();
}
