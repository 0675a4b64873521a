// Block-pack kernels: quantized zigzag coefficients -> Huffman-coded
// bitstreams (big-endian u32 words, MSB first) + their lengths; K2 packs one
// stream per MCU, K7 one per block.
//
// K2: replaces jpegtpu/kernels/entropy_pack.py:_block_pack_mcu_kernel
// (called from block_pack_mcu_pairs, helpers _symbolize_pair/_place_pair/
// _merge_pairs). The TPU kernel finds zero runs with log-step rolls and
// places bits by a rank search over prefix sums in 128-lane chunks. Here one
// kernel body, block_pack_mcu_kernel, has two launchers: jt_block_pack_mcu
// takes each block's class and DC difference as arrays (jpegtpu's
// signature), jt_block_pack_mcu_segments derives both in the kernel (the
// encoder's path, so no glue runs before it): the class from the block's
// index in its MCU (luma first), the DC difference from the DC of the
// previous block of the same component in scan order, read from the
// coefficients' slot 0 or from the pixel kernel's DC plane, with the
// predictor reset to 0 where the MCU index is a multiple of the restart
// interval (restart > 0) or at MCU 0 alone (restart 0), as in
// scan.dc_diffs_from_dc and fused_px_bp.cu.
//
// Bound: the bytes, about 50 MB of coefficients in and 3 MB of stream words
// out at 3840x2160 4:2:0 q90 (0.016 ms), or the instruction issue of
// symbolizing 64 slots a block, whichever the card meets first. The design
// cuts both:
// - Only an MCU's valid words, ceil(mlen / 32), are stored, not its
//   worst-case row of g*52+2 words (about 38 MB of zeros at 4K 4:2:0). Bits
//   past mlen in the last word are zero here; callers must not rely on
//   them, nor on any word past it.
// - A persistent grid: each thread block loads the Huffman LUTs once (code
//   and length packed in one int, one shared load a symbol), and its warps
//   stride over the MCUs.
// - Fewer instructions a block: lane l holds the adjacent slots 2l and
//   2l+1, so one warp scan of the pairs' lengths places the block (not two
//   scans and two sums), the pair's two symbols go out as one 64-bit run
//   (at most 52 bits, at most three shared atomics), and a slot's symbol
//   is found without a branch (no divergence between nonzero, ZRL, EOB and
//   empty slots).
// - No chain of blocks: one warp an MCU, which loads all its blocks (up to
//   kPer at once) before it symbolizes any, symbolizes and scans them as
//   independent instruction streams, and only then places them one after
//   another, each at the running sum of the blocks before (an add). So the
//   loads and the symbol work of an MCU's blocks overlap, and no barrier
//   holds a warp. A warp per block, with the blocks' offsets from a scan in
//   shared memory between barriers, was built first and was slower on an
//   H100 than the serial kernel it was to replace (0.105 and 0.149 ms at
//   3840x2160 4:2:0, against 0.081): the barriers and the lower occupancy
//   left the card waiting. So was compacting a block's emitting slots onto
//   lanes by ballot, one symbol a lane (0.070 ms): its ballots, counts and
//   shared-memory round trip cost more than the symbols it saved (PERF.md).
// - The MCU is staged in a per-warp row of shared memory (zeroed once; a
//   warp zeroes what it stored), then its valid words go out coalesced.
//
// K7: replaces jpegtpu/kernels/entropy_pack.py:_block_pack_kernel (called
// from block_pack), the oracle tier's per-block pack. The TPU kernel packs
// two blocks per 128-lane row of a 1024-row tile; here one warp packs one
// block from bit 0 with jt::pack_block (block_pack.cuh) into a zeroed 56-word
// row in shared memory, then writes the whole row (zero past the length).
// The warps of a grid of a few thread blocks per SM stride over the blocks,
// so each thread block loads the Huffman LUTs once.
//
// Bound: the bytes, 256 of coefficients read per block and 224 written (the
// 56-word row, zeros included).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "block_pack.cuh"
#include "grid.cuh"

namespace {

constexpr int kWarps = 4;            // K2: warps (MCUs in flight) a block
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 6;              // K2: blocks an MCU's warp loads at once
constexpr int kMaxG = 48;            // = entropy_pack.BLOCK_PACK_MAX_G
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
// emits nothing), without a branch. The rules of jt::symbolize: ZRL only
// when k < last_nz and (k - prev) % 16 == 0, EOB only at last_nz + 1
// (which is past slot 63 when last_nz is 63). zrl and eob are the block
// class's packed ZRL and EOB codes.
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

// Where the encoder's launcher finds the DC values: dc[m * mcu_stride +
// b * block_step] is block b of MCU m (the coefficients: g*64 and 64; the
// DC plane: its lanes and 1).
struct DcSource {
  const int32_t* dc;
  long long mcu_stride;
  long long block_step;
  int n_luma;
  long long restart;
};

// K2: warp w of block k packs MCUs k * kWarps + w, then every
// gridDim.x * kWarps-th after it. kDerive: class and DC difference from the
// MCU layout and dcs (the encoder's launcher); else from cls and dcdiff
// (jpegtpu's signature). kG: the blocks an MCU has, fixed (the modes' 6,
// 4, 3 and 1, so an MCU's blocks are one straight run of code with no
// branch between them; the encoder's launcher), or 0 for any g up to kMaxG
// (kPer at a time; jpegtpu's signature takes this instance alone).
// Dynamic shared memory: the packed LUTs, then a row of mcu_words words a
// warp.
template <bool kDerive, int kG>
__global__ void __launch_bounds__(kThreads)
block_pack_mcu_kernel(const int32_t* __restrict__ coeffs,
                      const int32_t* __restrict__ cls,
                      const int32_t* __restrict__ dcdiff, DcSource dcs,
                      const int32_t* __restrict__ dc_codes,
                      const int32_t* __restrict__ dc_lens,
                      const int32_t* __restrict__ ac_codes,
                      const int32_t* __restrict__ ac_lens,
                      int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                      long long n_mcu, int g_arg, int mcu_words) {
  constexpr int kChunk = kG ? kG : kPer;
  const int g = kG ? kG : g_arg;
  extern __shared__ uint32_t smem[];
  int* lut = reinterpret_cast<int*>(smem);
  load_packed_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  for (int t = threadIdx.x; t < kWarps * mcu_words; t += kThreads)
    smem[kPackedLut + t] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = smem + kPackedLut + warp * mcu_words;
  const long long stride = (long long)gridDim.x * kWarps;
  long long m = (long long)blockIdx.x * kWarps + warp;
  // m's place in its restart interval, kept by adds (restart > 0).
  const long long rs = kDerive && dcs.restart > 0 ? dcs.restart : 1;
  const long long phase_step = stride % rs;
  long long phase = m % rs;

  for (; m < n_mcu; m += stride) {   // warp-uniform: whole warps loop
    const bool reset = kDerive && (dcs.restart > 0 ? phase == 0 : m == 0);
    // The MCU's DC values (kDerive): block b's at row[b * dc_step], the
    // previous MCU's at row[b * dc_step - mcu_stride].
    const int32_t* row = kDerive ? dcs.dc + m * dcs.mcu_stride : nullptr;
    const int dc_step = kDerive ? (int)dcs.block_step : 0;
    int base = 0;                    // bits of the MCU's blocks so far
    for (int b0 = 0; b0 < g; b0 += kChunk) {
      // Load up to kChunk blocks at once, and each block's DC difference
      // (every lane the same: uniform loads, no divergence before the
      // ballots; only lane 0 uses it).
      int a[kChunk], b[kChunk], bcls[kChunk], dcd[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int bi = b0 + u;
        a[u] = b[u] = bcls[u] = dcd[u] = 0;
        if (kG || bi < g) {
          const long long blk = m * g + bi;
          const int2 pair = reinterpret_cast<const int2*>(coeffs + blk * 64)
              [lane];
          a[u] = pair.x;
          b[u] = pair.y;
          if (kDerive) {
            bcls[u] = bi >= dcs.n_luma;
            // The predictor: the luma block before in this MCU, else (after
            // no reset) the last luma block, or the same chroma block, of
            // the MCU before.
            const bool same = bi > 0 && bi < dcs.n_luma;
            const int pb = same ? bi - 1 : bi == 0 ? dcs.n_luma - 1 : bi;
            int pred = 0;
            if (same || !reset)
              pred = row[pb * dc_step - (same ? 0 : dcs.mcu_stride)];
            dcd[u] = row[bi * dc_step] - pred;
          } else {
            bcls[u] = cls[blk];
            dcd[u] = dcdiff[blk];
          }
        }
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
          const int ex = jt::warp_exclusive_scan(len, lane);
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
    __syncwarp();
    int32_t* dst = mwords + m * mcu_words;
    for (int k = lane; k < (base + 31) >> 5; k += 32) {
      dst[k] = (int32_t)buf[k];
      buf[k] = 0;
    }
    if (lane == 0) mlens[m] = base;
    __syncwarp();                     // the row is zero before the next MCU
    phase += phase_step;
    if (phase >= rs) phase -= rs;
  }
}

// K2's persistent grid: as many blocks as are resident at once, at most one
// for each kWarps MCUs.
template <bool kDerive, int kG>
int launch_grid(const int32_t* coeffs, const int32_t* cls,
                const int32_t* dcdiff, DcSource dcs, const int32_t* dc_codes,
                const int32_t* dc_lens, const int32_t* ac_codes,
                const int32_t* ac_lens, int32_t* mwords, int32_t* mlens,
                long long n_mcu, int g, int mcu_words, cudaStream_t stream) {
  const size_t smem = (kPackedLut + (size_t)kWarps * mcu_words) * 4;
  int resident = 0;
  const int err = jt::resident_blocks(block_pack_mcu_kernel<kDerive, kG>,
                                      kThreads, smem, &resident);
  if (err) return err;
  const long long blocks = (n_mcu + kWarps - 1) / kWarps;
  const long long grid = blocks < resident ? blocks : resident;
  block_pack_mcu_kernel<kDerive, kG>
      <<<(unsigned)grid, kThreads, smem, stream>>>(
          coeffs, cls, dcdiff, dcs, dc_codes, dc_lens, ac_codes, ac_lens,
          mwords, mlens, n_mcu, g, mcu_words);
  return (int)cudaGetLastError();
}

// K2's launch: the instance for g. The coefficients must be 8-byte aligned
// (each lane loads its two slots at once).
template <bool kDerive>
int launch_mcu(const int32_t* coeffs, const int32_t* cls,
               const int32_t* dcdiff, DcSource dcs, const int32_t* dc_codes,
               const int32_t* dc_lens, const int32_t* ac_codes,
               const int32_t* ac_lens, int32_t* mwords, int32_t* mlens,
               long long n_mcu, int g, int mcu_words, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (g < 1 || g > kMaxG || mcu_words != g * 52 + 2)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(coeffs) & 7)
    return (int)cudaErrorMisalignedAddress;
  auto run = [&](auto kernel_g) {
    return launch_grid<kDerive, decltype(kernel_g)::value>(
        coeffs, cls, dcdiff, dcs, dc_codes, dc_lens, ac_codes, ac_lens,
        mwords, mlens, n_mcu, g, mcu_words, stream);
  };
  if constexpr (!kDerive) {
    // jpegtpu's signature is on no encode path: its generic instance alone.
    return run(std::integral_constant<int, 0>());
  } else {
    switch (g) {
      case 6: return run(std::integral_constant<int, 6>());
      case 4: return run(std::integral_constant<int, 4>());
      case 3: return run(std::integral_constant<int, 3>());
      case 1: return run(std::integral_constant<int, 1>());
      default: return run(std::integral_constant<int, 0>());
    }
  }
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


// K2, jpegtpu's signature: class and DC difference of every block given.
extern "C" int jt_block_pack_mcu(const int32_t* coeffs, const int32_t* cls,
                                 const int32_t* dcdiff, const int32_t* dc_codes,
                                 const int32_t* dc_lens, const int32_t* ac_codes,
                                 const int32_t* ac_lens, int32_t* mwords,
                                 int32_t* mlens, long long n_mcu, int g,
                                 int mcu_words, cudaStream_t stream) {
  return launch_mcu<false>(coeffs, cls, dcdiff, DcSource{}, dc_codes,
                           dc_lens, ac_codes, ac_lens, mwords, mlens, n_mcu,
                           g, mcu_words, stream);
}

// K2, the encoder's launcher: the first n_luma blocks of an MCU are luma;
// block b of MCU m has its DC at dc[m * dc_mcu_stride + b * dc_block_step];
// restart is the interval in MCUs, 0 for none.
extern "C" int jt_block_pack_mcu_segments(
    const int32_t* coeffs, const int32_t* dc, long long dc_mcu_stride,
    long long dc_block_step, const int32_t* dc_codes, const int32_t* dc_lens,
    const int32_t* ac_codes, const int32_t* ac_lens, int32_t* mwords,
    int32_t* mlens, long long n_mcu, int g, int n_luma, long long restart,
    int mcu_words, cudaStream_t stream) {
  if (n_luma < 1 || n_luma > g || restart < 0)
    return n_mcu <= 0 ? 0 : (int)cudaErrorInvalidValue;
  return launch_mcu<true>(
      coeffs, nullptr, nullptr,
      DcSource{dc, dc_mcu_stride, dc_block_step, n_luma, restart}, dc_codes,
      dc_lens, ac_codes, ac_lens, mwords, mlens, n_mcu, g, mcu_words, stream);
}
