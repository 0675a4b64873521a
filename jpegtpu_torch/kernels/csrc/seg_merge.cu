// Segment-merge kernel: MCU bitstreams -> one bitstream per restart segment,
// with the last byte of each segment 1-padded (ITU-T T.81 F.1.2.3).
//
// Replaces jpegtpu/kernels/entropy_pack.py:_seg_merge_v3_kernel (called
// from seg_merge_mcu). The TPU kernel advances up to 32 segments together
// through a register window that it flushes in 1024-word frames, because its
// grid runs in order. Here every MCU is independent: the glue has already
// computed each MCU's exclusive bit offset in its segment, so one warp per
// MCU funnel-shifts the MCU's words by (off & 31) and ORs them into the
// segment at word off >> 5. Bit ranges of different MCUs are disjoint, so
// atomicOr composes them in any order (jpegtpu/entropy/assemble.py:11-13).
// The output must be zero-filled before the launch.
//
// Bound: global atomics, two per MCU word with a nonzero part.

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int s = o & 31;
  const int nw = (len + 31) >> 5;
  unsigned* dst = reinterpret_cast<unsigned*>(out) + seg * seg_words + (o >> 5);
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(mwords) + mcu * mcu_words;
  for (int j = lane; j < nw; j += 32) {
    uint32_t w = src[j];
    const int tail = len - 32 * j;    // valid bits in this word if < 32
    if (tail < 32) w &= ~0u << (32 - tail);
    if (w == 0) continue;
    atomicOr(dst + j, w >> s);
    if (s && (w << (32 - s))) atomicOr(dst + j + 1, w << (32 - s));
  }
  // The last MCU of a segment 1-pads the segment's final partial byte.
  if (lane == 0 && mcu % mps == mps - 1) {
    const int total = o + len;
    const int padb = (8 - (total & 7)) & 7;
    if (padb) {
      const int b_in = total & 31;
      unsigned* seg_out = reinterpret_cast<unsigned*>(out) + seg * seg_words;
      atomicOr(seg_out + (total >> 5),
               ((1u << padb) - 1u) << (32 - b_in - padb));
    }
  }
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
