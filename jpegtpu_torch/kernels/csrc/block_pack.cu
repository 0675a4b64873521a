// Block-pack kernel: quantized zigzag coefficients of each MCU -> the MCU's
// Huffman-coded bitstream (big-endian u32 words, MSB first) + its length.
//
// Replaces jpegtpu/kernels/entropy_pack.py:_block_pack_mcu_kernel (called
// from block_pack_mcu_pairs, helpers _symbolize_pair/_place_pair/_merge_pairs).
// The TPU kernel finds zero runs with log-step rolls and places bits by a
// rank search over prefix sums in 128-lane chunks. Here one warp owns one
// MCU: lane l holds slots l and l+32 of a block, a ballot gives the block's
// nonzero mask, count-leading-zeros gives each slot's previous nonzero and
// the last nonzero, a warp scan gives each symbol's bit offset, and
// shared-memory atomicOr places the bits (two symbols can share a word).
// The g blocks of an MCU run in order, each starting where the last ended.
//
// Symbolization is exactly jpegtpu_torch.entropy.scan.block_symbols
// (jpegtpu/entropy/scan.py:97-159): ZRL only when k < last_nz and
// (k - prev) % 16 == 0, EOB only when last_nz < 63, negative magnitudes in
// one's complement. The Huffman LUTs come in as tensors.
//
// Bound: the serial chain of g blocks per warp and the word traffic of the
// worst-case-sized streams (g*52+2 words written per MCU, zeros included).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // MCUs per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kLut = 2 * 16 * 2 + 2 * 256 * 2;

__device__ __forceinline__ int size_category(int v) {
  const int a = v < 0 ? -v : v;
  return a ? 32 - __clz(a) : 0;
}

__device__ __forceinline__ uint32_t magnitude(int v, int size) {
  return (uint32_t)(v < 0 ? v + (1 << size) - 1 : v);
}

// OR `len` (<= 32) right-aligned bits into buf at bit offset `off`.
__device__ __forceinline__ void put_bits(uint32_t* buf, int off, uint32_t bits,
                                         int len) {
  if (len == 0) return;
  const int w = off >> 5, r = off & 31;
  if (r + len <= 32) {
    atomicOr(buf + w, bits << (32 - r - len));
  } else {
    const int rem = r + len - 32;
    atomicOr(buf + w, bits >> rem);
    atomicOr(buf + w + 1, bits << (32 - rem));
  }
}

__device__ __forceinline__ int warp_exclusive_scan(int x, int lane) {
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  return inc - x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Code and length of slot k of a block with coefficient c.
__device__ __forceinline__ void symbolize(
    int k, int c, uint64_t mask, int last_nz, int cls, int dcd,
    const int* dc_codes, const int* dc_lens, const int* ac_codes,
    const int* ac_lens, uint32_t* bits, int* len) {
  if (k == 0) {
    const int s = size_category(dcd);
    const int i = cls * 16 + s;
    *bits = ((uint32_t)dc_codes[i] << s) | magnitude(dcd, s);
    *len = dc_lens[i] + s;
    return;
  }
  // Previous emitted position before k (bit 0 of mask is the DC sentinel).
  const int prev = 63 - __clzll(mask & ((1ull << k) - 1));
  int rs;
  bool emit_nz = false;
  if (c != 0) {
    emit_nz = true;
    rs = (((k - prev - 1) & 15) << 4) | size_category(c);
  } else if (k < last_nz && ((k - prev) & 15) == 0) {
    rs = 0xF0;                        // ZRL
  } else if (k == last_nz + 1 && last_nz < 63) {
    rs = 0x00;                        // EOB
  } else {
    *bits = 0;
    *len = 0;
    return;
  }
  const int i = cls * 256 + rs;
  if (emit_nz) {
    const int s = rs & 15;
    *bits = ((uint32_t)ac_codes[i] << s) | magnitude(c, s);
    *len = ac_lens[i] + s;
  } else {
    *bits = (uint32_t)ac_codes[i];
    *len = ac_lens[i];
  }
}

__global__ void __launch_bounds__(kThreads)
block_pack_mcu_kernel(const int32_t* __restrict__ coeffs,
                      const int32_t* __restrict__ cls,
                      const int32_t* __restrict__ dcdiff,
                      const int32_t* __restrict__ dc_codes_g,
                      const int32_t* __restrict__ dc_lens_g,
                      const int32_t* __restrict__ ac_codes_g,
                      const int32_t* __restrict__ ac_lens_g,
                      int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                      long long n_mcu, int g, int mcu_words) {
  extern __shared__ uint32_t smem[];
  int* dc_codes = (int*)smem;
  int* dc_lens = dc_codes + 32;
  int* ac_codes = dc_lens + 32;
  int* ac_lens = ac_codes + 512;
  for (int t = threadIdx.x; t < 32; t += kThreads) {
    dc_codes[t] = dc_codes_g[t];
    dc_lens[t] = dc_lens_g[t];
  }
  for (int t = threadIdx.x; t < 512; t += kThreads) {
    ac_codes[t] = ac_codes_g[t];
    ac_lens[t] = ac_lens_g[t];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = smem + kLut + warp * mcu_words;
  for (int j = lane; j < mcu_words; j += 32) buf[j] = 0;
  __syncthreads();

  const long long mcu = (long long)blockIdx.x * kWarps + warp;
  if (mcu >= n_mcu) return;           // whole warp leaves together

  int base = 0;                       // bits written so far in this MCU
  for (int b = 0; b < g; ++b) {
    const long long blk = mcu * g + b;
    const int32_t* c = coeffs + mcu * (64LL * g) + 64 * b;
    const int c0 = c[lane], c1 = c[lane + 32];
    const uint32_t lo = __ballot_sync(0xffffffffu, c0 != 0);
    const uint32_t hi = __ballot_sync(0xffffffffu, c1 != 0);
    const uint64_t mask = ((uint64_t)hi << 32) | lo | 1ull;
    const int last_nz = 63 - __clzll(mask);
    const int k_cls = cls[blk], dcd = dcdiff[blk];

    uint32_t bits0, bits1;
    int len0, len1;
    symbolize(lane, c0, mask, last_nz, k_cls, dcd, dc_codes, dc_lens,
              ac_codes, ac_lens, &bits0, &len0);
    symbolize(lane + 32, c1, mask, last_nz, k_cls, dcd, dc_codes, dc_lens,
              ac_codes, ac_lens, &bits1, &len1);
    const int ex0 = warp_exclusive_scan(len0, lane);
    const int ex1 = warp_exclusive_scan(len1, lane);
    const int sum0 = warp_sum(len0), sum1 = warp_sum(len1);
    put_bits(buf, base + ex0, bits0, len0);
    put_bits(buf, base + sum0 + ex1, bits1, len1);
    base += sum0 + sum1;
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
  const size_t smem = (kLut + (size_t)kWarps * mcu_words) * sizeof(uint32_t);
  block_pack_mcu_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      coeffs, cls, dcdiff, dc_codes, dc_lens, ac_codes, ac_lens, mwords, mlens,
      n_mcu, g, mcu_words);
  return (int)cudaGetLastError();
}
