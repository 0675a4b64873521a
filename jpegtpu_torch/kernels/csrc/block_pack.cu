// Block-pack kernel: quantized zigzag coefficients of each MCU -> the MCU's
// Huffman-coded bitstream (big-endian u32 words, MSB first) + its length.
//
// Replaces jpegtpu/kernels/entropy_pack.py:_block_pack_mcu_kernel (called
// from block_pack_mcu_pairs, helpers _symbolize_pair/_place_pair/_merge_pairs).
// The TPU kernel finds zero runs with log-step rolls and places bits by a
// rank search over prefix sums in 128-lane chunks. Here one warp owns one
// MCU and packs its g blocks in order, each starting where the last ended
// (block_pack.cuh holds the per-block symbolize and pack).
//
// Bound: the serial chain of g blocks per warp and the word traffic of the
// worst-case-sized streams (g*52+2 words written per MCU, zeros included).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_pack.cuh"

namespace {

constexpr int kWarps = 4;           // MCUs per thread block
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
block_pack_mcu_kernel(const int32_t* __restrict__ coeffs,
                      const int32_t* __restrict__ cls,
                      const int32_t* __restrict__ dcdiff,
                      const int32_t* __restrict__ dc_codes,
                      const int32_t* __restrict__ dc_lens,
                      const int32_t* __restrict__ ac_codes,
                      const int32_t* __restrict__ ac_lens,
                      int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                      long long n_mcu, int g, int mcu_words) {
  extern __shared__ uint32_t smem[];
  int* lut = (int*)smem;
  jt::load_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = smem + jt::kLutInts + warp * mcu_words;
  for (int j = lane; j < mcu_words; j += 32) buf[j] = 0;
  __syncthreads();

  const long long mcu = (long long)blockIdx.x * kWarps + warp;
  if (mcu >= n_mcu) return;           // whole warp leaves together

  int base = 0;                       // bits written so far in this MCU
  for (int b = 0; b < g; ++b) {
    const long long blk = mcu * g + b;
    const int32_t* c = coeffs + mcu * (64LL * g) + 64 * b;
    base += jt::pack_block(c[lane], c[lane + 32], cls[blk], dcdiff[blk], lut,
                           buf, base, lane);
  }
  __syncwarp();
  int32_t* dst = mwords + mcu * mcu_words;
  for (int j = lane; j < mcu_words; j += 32) dst[j] = (int32_t)buf[j];
  if (lane == 0) mlens[mcu] = base;
}

}  // namespace

extern "C" int jt_block_pack_mcu(const int32_t* coeffs, const int32_t* cls,
                                 const int32_t* dcdiff, const int32_t* dc_codes,
                                 const int32_t* dc_lens, const int32_t* ac_codes,
                                 const int32_t* ac_lens, int32_t* mwords,
                                 int32_t* mlens, long long n_mcu, int g,
                                 int mcu_words, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  const long long blocks = (n_mcu + kWarps - 1) / kWarps;
  const size_t smem =
      (jt::kLutInts + (size_t)kWarps * mcu_words) * sizeof(uint32_t);
  block_pack_mcu_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      coeffs, cls, dcdiff, dc_codes, dc_lens, ac_codes, ac_lens, mwords, mlens,
      n_mcu, g, mcu_words);
  return (int)cudaGetLastError();
}
