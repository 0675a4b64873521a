// Symbolize and pack one 64-coefficient block with one warp, shared by the
// block-pack kernels (block_pack.cu: per MCU, K2, and per block, K7) and
// the fused pixel + block-pack kernel (fused_px_bp.cu). Lane l holds slots
// l and l+32 of the block; a ballot gives the block's nonzero mask,
// count-leading-zeros gives each slot's previous nonzero and the last
// nonzero, a warp scan gives each symbol's bit offset, and shared-memory
// atomicOr places the bits (two symbols can share a word). Streams are
// big-endian u32 words, MSB first.
//
// Symbolization is exactly jpegtpu_torch.entropy.scan.block_symbols
// (jpegtpu/entropy/scan.py:97-159): ZRL only when k < last_nz and
// (k - prev) % 16 == 0, EOB only when last_nz < 63, negative magnitudes in
// one's complement. The Huffman LUTs come in as tensors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_common.cuh"   // warp_exclusive_scan, warp_sum

namespace jt {

// The packed LUTs in shared memory: dc_codes, dc_lens [2][16], then
// ac_codes, ac_lens [2][256] (index 0 luma, 1 chroma).
constexpr int kLutInts = 2 * 16 * 2 + 2 * 256 * 2;

__device__ __forceinline__ void load_luts(int* lut, const int32_t* dc_codes,
                                          const int32_t* dc_lens,
                                          const int32_t* ac_codes,
                                          const int32_t* ac_lens) {
  for (int t = threadIdx.x; t < 32; t += blockDim.x) {
    lut[t] = dc_codes[t];
    lut[32 + t] = dc_lens[t];
  }
  for (int t = threadIdx.x; t < 512; t += blockDim.x) {
    lut[64 + t] = ac_codes[t];
    lut[576 + t] = ac_lens[t];
  }
}

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

// Code and length of slot k of a block with coefficient c.
__device__ __forceinline__ void symbolize(int k, int c, uint64_t mask,
                                          int last_nz, int cls, int dcd,
                                          const int* lut, uint32_t* bits,
                                          int* len) {
  const int* dc_codes = lut;
  const int* dc_lens = lut + 32;
  const int* ac_codes = lut + 64;
  const int* ac_lens = lut + 576;
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

// One warp packs the block whose slots lane and lane + 32 hold c0 and c1
// into buf from bit `base` on; returns the block's bit count (the same on
// every lane).
__device__ __forceinline__ int pack_block(int c0, int c1, int cls, int dcd,
                                          const int* lut, uint32_t* buf,
                                          int base, int lane) {
  const uint32_t lo = __ballot_sync(0xffffffffu, c0 != 0);
  const uint32_t hi = __ballot_sync(0xffffffffu, c1 != 0);
  const uint64_t mask = ((uint64_t)hi << 32) | lo | 1ull;
  const int last_nz = 63 - __clzll(mask);
  uint32_t bits0, bits1;
  int len0, len1;
  symbolize(lane, c0, mask, last_nz, cls, dcd, lut, &bits0, &len0);
  symbolize(lane + 32, c1, mask, last_nz, cls, dcd, lut, &bits1, &len1);
  const int ex0 = warp_exclusive_scan(len0, lane);
  const int ex1 = warp_exclusive_scan(len1, lane);
  const int sum0 = warp_sum(len0), sum1 = warp_sum(len1);
  put_bits(buf, base + ex0, bits0, len0);
  put_bits(buf, base + sum0 + ex1, bits1, len1);
  return sum0 + sum1;
}

}  // namespace jt
