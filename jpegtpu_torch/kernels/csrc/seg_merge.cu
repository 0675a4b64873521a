// Segment-merge kernel: MCU bitstreams -> one bitstream per restart segment,
// with the last byte of each segment 1-padded (ITU-T T.81 F.1.2.3).
//
// Replaces jpegtpu/kernels/entropy_pack.py:_seg_merge_v3_kernel (called
// from seg_merge_mcu). The TPU kernel advances up to 32 segments together
// through a register window that it flushes in 1024-word frames, because its
// grid runs in order. Here every MCU is independent: the glue has already
// computed each MCU's exclusive bit offset in its segment, so one warp per
// MCU places the MCU's words at that offset (merge_common.cuh: a funnel
// shift across each word pair, then atomicOr, since bit ranges of different
// MCUs are disjoint). The output must be zero-filled before the launch.
//
// Bound: global atomics, one per output word with a nonzero part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_common.cuh"

namespace {

constexpr int kWarps = 8;           // MCUs per thread block
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
seg_merge_mcu_kernel(const int32_t* __restrict__ mwords,
                     const int32_t* __restrict__ mlens,
                     const int32_t* __restrict__ off, int32_t* __restrict__ out,
                     long long n_mcu, long long mps, int mcu_words,
                     long long seg_words) {
  const int lane = threadIdx.x & 31;
  const long long mcu = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (mcu >= n_mcu) return;
  const long long seg = mcu / mps;
  const int len = mlens[mcu];
  const int o = off[mcu];
  uint32_t* seg_out = reinterpret_cast<uint32_t*>(out) + seg * seg_words;
  jt::place_stream(seg_out, seg_words, o,
                   reinterpret_cast<const uint32_t*>(mwords) + mcu * mcu_words,
                   mcu_words, len, lane);
  // The last MCU of a segment 1-pads the segment's final partial byte.
  if (lane == 0 && mcu % mps == mps - 1)
    jt::pad_ones(seg_out, seg_words, (long long)o + len);
}

}  // namespace

extern "C" int jt_seg_merge_mcu(const int32_t* mwords, const int32_t* mlens,
                                const int32_t* off, int32_t* out,
                                long long n_mcu, long long mps, int mcu_words,
                                long long seg_words, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  const long long blocks = (n_mcu + kWarps - 1) / kWarps;
  seg_merge_mcu_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      mwords, mlens, off, out, n_mcu, mps, mcu_words, seg_words);
  return (int)cudaGetLastError();
}
