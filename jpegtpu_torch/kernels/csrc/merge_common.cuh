// Bitstream placement of seg_merge_window.cu (K9), and the warp scans that
// block_pack.cuh uses too.
//
// A stream is big-endian u32 words, MSB first, of `len` bits in a row of
// `row_words` words; bits past len are ignored. To place it at bit offset
// `off` of a zero-filled buffer, each source word is funnel-shifted right by
// off & 31 across the output word pair it lands on (__funnelshift_r). Two
// source words, or two streams, share a word at each boundary, so every
// part goes in by atomicOr: the bit ranges are disjoint, so the order does
// not matter (jpegtpu/entropy/assemble.py:11-13). A part that would land
// outside the buffer is dropped, so no input writes out of bounds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

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

// Word j (0 <= j < row_words) of a stream with the bits past len cleared.
__device__ __forceinline__ uint32_t stream_word(const uint32_t* src, int len,
                                                int j) {
  const int tail = len - 32 * j;          // valid bits in word j if < 32
  const uint32_t w = src[j];
  return tail >= 32 ? w : tail <= 0 ? 0u : w & (~0u << (32 - tail));
}

// The calling warp ORs the stream src (len bits in a row of row_words words)
// into dst at bit offset off; words outside [0, dst_words) are dropped.
// Lane l takes source words j = l, l + 32, ...: word j's value w, as the
// pair (w:0) shifted right by s = off & 31, puts w >> s into output word
// (off >> 5) + j and the low half __funnelshift_r(0, w, s) (0 when s is 0)
// into the next.
__device__ __forceinline__ void place_stream(uint32_t* dst,
                                             long long dst_words,
                                             long long off,
                                             const uint32_t* src,
                                             int row_words, int len,
                                             int lane) {
  const int s = (int)(off & 31);
  const long long q = off >> 5;
  int nw = (len + 31) >> 5;
  if (nw > row_words) nw = row_words;
  for (int j = lane; j < nw; j += 32) {
    const uint32_t w = stream_word(src, len, j);
    const uint32_t hi = w >> s, lo = __funnelshift_r(0u, w, s);
    const long long d = q + j;
    if (hi && d >= 0 && d < dst_words) atomicOr(dst + d, hi);
    if (lo && d + 1 >= 0 && d + 1 < dst_words) atomicOr(dst + d + 1, lo);
  }
}

// 1-pad the final partial byte of a stream of `total` bits in dst (ITU-T
// T.81 F.1.2.3), unless that byte lies past dst_words.
__device__ __forceinline__ void pad_ones(uint32_t* dst, long long dst_words,
                                         long long total) {
  const int padb = (int)((8 - (total & 7)) & 7);
  if (padb && (total >> 5) < dst_words) {
    const int b_in = (int)(total & 31);
    atomicOr(dst + (total >> 5),
             ((1u << padb) - 1u) << (32 - b_in - padb));
  }
}

// One thread block of kThreads threads appends the per_seg streams of
// segment blockIdx.x (rows seg*per_seg .. seg*per_seg + per_seg - 1 of
// `rows`, row_words words each, bit lengths in `lens`) bit-contiguously into
// its zero-filled row of `out` (seg_words words), 1-pads the last byte and
// writes the segment's bit count. The block scans the lengths itself, one
// tile of kThreads streams at a time with a running carry, so a segment of
// any length takes no offsets from outside; then its warps place the tile's
// streams, one warp a stream. Bound: the placement's atomics and, for a
// long segment, the one SM its block runs on.
template <int kThreads>
__device__ __forceinline__ void append_segment(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lens,
    int32_t* __restrict__ out, int32_t* __restrict__ seg_bits,
    long long per_seg, int row_words, long long seg_words) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kWarps <= 32, "block of 1-32 warps");
  __shared__ long long s_off[kThreads];
  __shared__ int s_len[kThreads];
  __shared__ int s_wsum[kWarps];
  __shared__ int s_wex[kWarps];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = blockIdx.x;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + seg * seg_words;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(rows);
  long long carry = 0;                     // bits of the tiles before
  for (long long base = 0; base < per_seg; base += kThreads) {
    const long long i = base + threadIdx.x;
    const int len = i < per_seg ? lens[seg * per_seg + i] : 0;
    const int ex = warp_exclusive_scan(len, lane);
    if (lane == 31) s_wsum[warp] = ex + len;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < kWarps ? s_wsum[lane] : 0;
      const int e = warp_exclusive_scan(v, lane);
      if (lane < kWarps) s_wex[lane] = e;
      if (lane == 31) s_tile = e + v;
    }
    __syncthreads();
    s_off[threadIdx.x] = carry + s_wex[warp] + ex;
    s_len[threadIdx.x] = len;
    __syncthreads();
    const long long left = per_seg - base;
    const int n = left < kThreads ? (int)left : kThreads;
    for (int t = warp; t < n; t += kWarps) {
      place_stream(dst, seg_words, s_off[t],
                   src + (seg * per_seg + base + t) * row_words, row_words,
                   s_len[t], lane);
    }
    carry += s_tile;
    __syncthreads();                       // before the next tile's writes
  }
  if (threadIdx.x == 0) {
    seg_bits[seg] = (int32_t)carry;
    pad_ones(dst, seg_words, carry);
  }
}

}  // namespace jt
