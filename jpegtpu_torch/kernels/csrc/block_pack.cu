// Block-pack kernels: quantized zigzag coefficients -> Huffman-coded
// bitstreams (big-endian u32 words, MSB first) + their lengths; K2 packs one
// stream per MCU, K7 one per block.
//
// K2: replaces jpegtpu/kernels/entropy_pack.py:_block_pack_mcu_kernel
// (called from block_pack_mcu_pairs, helpers _symbolize_pair/_place_pair/
// _merge_pairs). The TPU kernel finds zero runs with log-step rolls and
// places bits by a rank search over prefix sums in 128-lane chunks. Here
// one warp owns one MCU and packs its g blocks in order, each starting
// where the last ended (block_pack.cuh holds the per-block symbolize and
// pack).
//
// Bound: the serial chain of g blocks per warp and the word traffic of the
// worst-case-sized streams (g*52+2 words written per MCU, zeros included).
//
// K7: replaces jpegtpu/kernels/entropy_pack.py:_block_pack_kernel (called
// from block_pack), the oracle tier's per-block pack. The TPU kernel packs
// two blocks per 128-lane row of a 1024-row tile; here one warp packs one
// block from bit 0 with the same jt::pack_block into a zeroed 56-word row
// in shared memory, then writes the whole row (zero past the length). The
// warps of a grid of a few thread blocks per SM stride over the blocks, so
// each thread block loads the Huffman LUTs once.
//
// Bound: the bytes, 256 of coefficients read per block and 224 written (the
// 56-word row, zeros included).

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

constexpr int kBlockWords = 56;     // BLOCK_WORDS: a block's stream row
constexpr int kPackWarps = 8;       // K7: warps (blocks in flight) per block

__global__ void __launch_bounds__(kPackWarps * 32)
block_pack_kernel(const int32_t* __restrict__ coeffs,
                  const int32_t* __restrict__ cls,
                  const int32_t* __restrict__ dcdiff,
                  const int32_t* __restrict__ dc_codes,
                  const int32_t* __restrict__ dc_lens,
                  const int32_t* __restrict__ ac_codes,
                  const int32_t* __restrict__ ac_lens,
                  int32_t* __restrict__ words, int32_t* __restrict__ lens,
                  long long n_blocks) {
  __shared__ int lut[jt::kLutInts];
  __shared__ uint32_t rows[kPackWarps][kBlockWords];
  jt::load_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = rows[warp];
  const long long stride = (long long)gridDim.x * kPackWarps;
  for (long long blk = (long long)blockIdx.x * kPackWarps + warp;
       blk < n_blocks; blk += stride) {   // warp-uniform: whole warps loop
    for (int j = lane; j < kBlockWords; j += 32) buf[j] = 0;
    __syncwarp();
    const int32_t* c = coeffs + blk * 64;
    const int len = jt::pack_block(c[lane], c[lane + 32], cls[blk],
                                   dcdiff[blk], lut, buf, 0, lane);
    __syncwarp();
    int32_t* dst = words + blk * kBlockWords;
    for (int j = lane; j < kBlockWords; j += 32) dst[j] = (int32_t)buf[j];
    if (lane == 0) lens[blk] = len;
    __syncwarp();                     // the row is read before it is zeroed
  }
}

}  // namespace

extern "C" int jt_block_pack(const int32_t* coeffs, const int32_t* cls,
                             const int32_t* dcdiff, const int32_t* dc_codes,
                             const int32_t* dc_lens, const int32_t* ac_codes,
                             const int32_t* ac_lens, int32_t* words,
                             int32_t* lens, long long n_blocks,
                             cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_blocks + kPackWarps - 1) / kPackWarps;
  if (blocks > 8LL * sms) blocks = 8LL * sms;   // 8 x 256 threads fill an SM
  block_pack_kernel<<<(unsigned)blocks, kPackWarps * 32, 0, stream>>>(
      coeffs, cls, dcdiff, dc_codes, dc_lens, ac_codes, ac_lens, words, lens,
      n_blocks);
  return (int)cudaGetLastError();
}

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
