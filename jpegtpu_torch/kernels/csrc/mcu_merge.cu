// MCU-merge kernel (K8): the bitstreams of g consecutive blocks -> one MCU
// bitstream (big-endian u32 words, MSB first) + its length.
//
// Replaces jpegtpu/kernels/entropy_oracles.py:_mcu_merge_kernel (called
// from mcu_merge). The TPU kernel lays the g blocks of 256 MCUs out as
// g-leading 128-lane tiles and places each block by a per-row lane gather
// per output chunk. Here one warp owns one MCU: lane b holds block b's
// length, a warp shuffle scan gives each block's exclusive bit offset, and
// the lanes place each block's words into the MCU's row in shared memory
// (merge_common.cuh: funnel shift across word pairs, then atomicOr), which
// the warp then writes out whole and coalesced. The row holds mcu_words
// words: with a budget-sized row, words past it are dropped while the
// length stays the full sum, as in jpegtpu. g of any size goes 32 blocks a
// round with a running carry.
//
// Bound: the bytes, the block rows read and the MCU rows written (zeros
// included).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_common.cuh"

namespace {

constexpr int kMaxWarps = 8;        // MCUs per thread block, at most
constexpr size_t kSmemDefault = 48 * 1024;

__global__ void __launch_bounds__(kMaxWarps * 32)
mcu_merge_kernel(const int32_t* __restrict__ words,
                 const int32_t* __restrict__ lens,
                 int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                 long long n_mcu, int g, int row_words, int mcu_words) {
  extern __shared__ uint32_t smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long mcu = (long long)blockIdx.x * warps + warp;
  if (mcu >= n_mcu) return;           // whole warp leaves together
  uint32_t* buf = smem + (size_t)warp * mcu_words;
  for (int j = lane; j < mcu_words; j += 32) buf[j] = 0;
  __syncwarp();

  const long long first = mcu * g;    // the MCU's first block
  const uint32_t* src = reinterpret_cast<const uint32_t*>(words);
  int base = 0;                       // bits of the rounds before
  for (int b0 = 0; b0 < g; b0 += 32) {
    const int nb = g - b0 < 32 ? g - b0 : 32;
    const int len = lane < nb ? lens[first + b0 + lane] : 0;
    const int ex = jt::warp_exclusive_scan(len, lane);
    for (int i = 0; i < nb; ++i) {
      const int li = __shfl_sync(0xffffffffu, len, i);
      const int oi = base + __shfl_sync(0xffffffffu, ex, i);
      jt::place_stream(buf, mcu_words, oi,
                       src + (first + b0 + i) * row_words, row_words, li,
                       lane);
    }
    base += jt::warp_sum(len);
  }
  __syncwarp();
  int32_t* dst = mwords + mcu * mcu_words;
  for (int j = lane; j < mcu_words; j += 32) dst[j] = (int32_t)buf[j];
  if (lane == 0) mlens[mcu] = base;
}

}  // namespace

extern "C" int jt_mcu_merge(const int32_t* words, const int32_t* lens,
                            int32_t* mwords, int32_t* mlens, long long n_mcu,
                            int g, int row_words, int mcu_words,
                            cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  const size_t row_bytes = (size_t)mcu_words * sizeof(uint32_t);
  long long warps = (long long)(kSmemDefault / row_bytes);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) warps = 1;
  const size_t smem = (size_t)warps * row_bytes;
  if (smem > kSmemDefault) {          // one long row: opt in past 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        mcu_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_mcu + warps - 1) / warps;
  mcu_merge_kernel<<<(unsigned)blocks, (unsigned)(warps * 32), smem,
                     stream>>>(words, lens, mwords, mlens, n_mcu, g,
                               row_words, mcu_words);
  return (int)cudaGetLastError();
}
