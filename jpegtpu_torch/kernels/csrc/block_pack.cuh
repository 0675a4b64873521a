// Symbolize and pack Huffman-coded blocks with one warp: the bodies shared
// by the block-pack kernels (block_pack.cu: K2 per MCU, K7 per block) and
// the fused pixel + block-pack kernel (fused_px_bp.cu, K11). Streams are
// big-endian u32 words, MSB first.
//
// Lane l holds the adjacent slots 2l and 2l+1 of a block, whose two
// symbols, found without a branch (slot_symbol), go out as one 64-bit run
// (pair_run); a warp scan of the runs' lengths gives each run's offset in
// its block, and put_run ORs it into a row of shared memory.
//
// pack_mcu (K2 and K11): one warp packs a whole MCU. The warp loads all the
// MCU's blocks at once, symbolizes and scans them as independent
// instruction streams, and places them one after another at the running
// sum of the blocks before. store_mcu writes the MCU's valid words,
// ceil(bits / 32), and nothing past them. K7 (block_pack.cu) runs the same
// steps on several blocks at once, each into a row of its own.
//
// Symbolization is exactly jpegtpu_torch.entropy.scan.block_symbols
// (jpegtpu/entropy/scan.py:97-159): ZRL only when k < last_nz and
// (k - prev) % 16 == 0, EOB only when last_nz < 63, negative magnitudes in
// one's complement. The Huffman LUTs come in as tensors.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

// The exclusive prefix sum of x over the warp's lanes.
__device__ __forceinline__ int warp_exclusive_scan(int x, int lane) {
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  return inc - x;
}

// The packed LUTs: (code << 8) | length, DC [2][16] then AC [2][256].
constexpr int kDcBase = 0;
constexpr int kAcBase = 32;
constexpr int kPackedLut = 32 + 512;

__device__ __forceinline__ void load_packed_luts(int* lut,
                                                 const int32_t* dc_codes,
                                                 const int32_t* dc_lens,
                                                 const int32_t* ac_codes,
                                                 const int32_t* ac_lens) {
  for (int t = threadIdx.x; t < 32; t += blockDim.x)
    lut[kDcBase + t] = (dc_codes[t] << 8) | dc_lens[t];
  for (int t = threadIdx.x; t < 512; t += blockDim.x)
    lut[kAcBase + t] = (ac_codes[t] << 8) | ac_lens[t];
}

// Slot k of a block with value v (the coefficient, or for k = 0 the DC
// difference), the previous emitted slot prev and the last nonzero slot
// last_nz: its symbol's code and magnitude bits and its length (0 where it
// emits nothing), without a branch. ZRL only when k < last_nz and
// (k - prev) % 16 == 0, EOB only at last_nz + 1 (which is past slot 63
// when last_nz is 63). zrl and eob are the block class's packed ZRL and
// EOB codes.
__device__ __forceinline__ void slot_symbol(int k, int v, int prev,
                                            int last_nz, int cls, int zrl,
                                            int eob, const int* lut,
                                            uint32_t* bits, int* len) {
  const int s = 32 - __clz(v < 0 ? -v : v);          // size category
  const int e = lut[k == 0 ? kDcBase + cls * 16 + s
                           : kAcBase + cls * 256 +
                                 ((((k - prev - 1) & 15) << 4) | s)];
  const int ent = (k == 0 || v != 0) ? e
                  : (k < last_nz && ((k - prev) & 15) == 0) ? zrl
                  : k == last_nz + 1 ? eob : 0;
  // One's complement of a negative value in its s bits.
  const uint32_t mag = (uint32_t)(v + ((v >> 31) & ((1 << s) - 1)));
  *bits = ((uint32_t)(ent >> 8) << s) | mag;
  *len = (ent & 255) + s;
}

// One warp symbolizes a block whose slots 2l and 2l+1 lane l holds (a, b;
// lane 0's a is replaced by the DC difference dcd): the two symbols as one
// right-aligned run of *len bits (<= 52). Bit l of E and O says slot 2l
// (slot 0 always: the DC sentinel) and slot 2l+1 is nonzero; the previous
// nonzero slot before 2l is the higher of the last even and the last odd
// one below lane l.
__device__ __forceinline__ void pair_run(int a, int b, int cls, int dcd,
                                         const int* lut, int lane,
                                         unsigned long long* run, int* len) {
  const uint32_t E = __ballot_sync(0xffffffffu, a != 0) | 1u;
  const uint32_t O = __ballot_sync(0xffffffffu, b != 0);
  const int last_e = 2 * (31 - __clz(E));
  const int last_nz = O ? max(last_e, 2 * (31 - __clz(O)) + 1) : last_e;
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t eb = E & below, ob = O & below;
  const int pe = eb ? 2 * (31 - __clz(eb)) : -1;
  const int po = ob ? 2 * (31 - __clz(ob)) + 1 : -1;
  const int k0 = 2 * lane;
  const int prev0 = max(pe, po);
  const int prev1 = (a != 0 || lane == 0) ? k0 : prev0;
  const int zrl = lut[kAcBase + cls * 256 + 0xF0];
  const int eob = lut[kAcBase + cls * 256];
  uint32_t b0, b1;
  int l0, l1;
  slot_symbol(k0, lane == 0 ? dcd : a, prev0, last_nz, cls, zrl, eob, lut,
              &b0, &l0);
  slot_symbol(k0 + 1, b, prev1, last_nz, cls, zrl, eob, lut, &b1, &l1);
  *run = ((unsigned long long)b0 << l1) | b1;
  *len = l0 + l1;
}

// OR the right-aligned run of len (1-52) bits into buf at bit off: it
// spans at most three words; only their nonzero parts are ORed.
__device__ __forceinline__ void put_run(uint32_t* buf, int off,
                                        unsigned long long run, int len) {
  const unsigned long long t = run << (64 - len);     // left-aligned
  const int w = off >> 5, r = off & 31;
  const uint32_t w0 = (uint32_t)(t >> (32 + r));
  const uint32_t w1 = (uint32_t)(t >> r);
  const uint32_t w2 = (uint32_t)(t << (32 - r));
  if (w0) atomicOr(buf + w, w0);
  if (w1) atomicOr(buf + w + 1, w1);
  if (w2) atomicOr(buf + w + 2, w2);
}

// One warp packs one MCU of g blocks into buf (zero where it writes) from
// bit 0 and returns its bit count (the same on every lane).
// load(bi, a, b, cls, dcd) gives block bi's slots 2l and 2l + 1 for lane
// l, its class and its DC difference (the same on every lane). kG: the
// blocks an MCU has, fixed, so that its blocks are one straight run of
// code with no branch between them (kChunk of them loaded at once, kChunk
// dividing kG), or 0 for any g, kChunk at a time.
template <int kG, int kChunk, typename Load>
__device__ __forceinline__ int pack_mcu(int g, Load load, const int* lut,
                                        uint32_t* buf, int lane) {
  static_assert(kG % kChunk == 0, "chunks of a fixed MCU");
  int base = 0;                      // bits of the MCU's blocks so far
  for (int b0 = 0; b0 < g; b0 += kChunk) {
    // Load up to kChunk blocks at once.
    int a[kChunk], b[kChunk], bcls[kChunk], dcd[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int bi = b0 + u;
      a[u] = b[u] = bcls[u] = dcd[u] = 0;
      if (kG || bi < g) load(bi, a[u], b[u], bcls[u], dcd[u]);
    }
    // Symbolize and scan each, as independent streams.
    unsigned long long run[kChunk];
    int where[kChunk], total[kChunk];  // in-block offset << 8 | length
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      run[u] = 0;
      where[u] = total[u] = 0;
      if (kG || b0 + u < g) {
        int len;
        pair_run(a[u], b[u], bcls[u], dcd[u], lut, lane, &run[u], &len);
        const int ex = warp_exclusive_scan(len, lane);
        where[u] = (ex << 8) | len;
        total[u] = __shfl_sync(0xffffffffu, ex + len, 31);
      }
    }
    // Place them one after another.
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int len = where[u] & 255;
      if (len) put_run(buf, base + (where[u] >> 8), run[u], len);
      base += total[u];
    }
  }
  return base;
}

// The warp's packed MCU of `bits` bits out of buf: its valid words into
// dst, each zeroed in buf behind it (so buf is zero again), and its length
// into *len.
__device__ __forceinline__ void store_mcu(uint32_t* buf, int32_t* dst,
                                          int32_t* len, int bits, int lane) {
  __syncwarp();
  for (int k = lane; k < (bits + 31) >> 5; k += 32) {
    dst[k] = (int32_t)buf[k];
    buf[k] = 0;
  }
  if (lane == 0) *len = bits;
  __syncwarp();                     // the row is zero before the next MCU
}

}  // namespace jt
