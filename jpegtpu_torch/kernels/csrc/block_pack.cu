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
// The MCU body (jt::pack_mcu, jt::store_mcu) is block_pack.cuh's, shared
// with K11 (fused_px_bp.cu), which feeds it from a shared coefficient tile.
//
// K7: replaces jpegtpu/kernels/entropy_pack.py:_block_pack_kernel (called
// from block_pack), the oracle tier's per-block pack. The TPU kernel packs
// two blocks per 128-lane row of a 1024-row tile. Here K2's steps run on
// blocks that are streams of their own: a warp takes kPackPer consecutive
// blocks and loads them all at once (lane l slots 2l and 2l+1 of each, one
// 8-byte load), symbolizes and scans them as independent instruction
// streams (jt::pair_run, jt::warp_exclusive_scan), and puts each at bit 0 of
// its own 56-word row in shared memory (jt::put_run). The group's rows are
// consecutive in shared memory and in the output, so the warp then writes
// them as one run of 16-byte stores, 14 a row: a quad that holds valid
// words from shared memory (zeroed behind it, so the rows are zero again),
// the rest as zeros. Every output word is written once; nothing is filled
// before. A persistent grid: each thread block loads the packed LUTs once,
// and its warps stride over the groups. The warp's last group may hold
// fewer blocks.
//
// Bound: the bytes, 256 of coefficients read per block and 224 written
// (the 56-word row, zeros included), against the instruction issue of
// symbolizing 64 slots a block, as in K2.

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
  jt::load_packed_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  for (int t = threadIdx.x; t < kWarps * mcu_words; t += kThreads)
    smem[jt::kPackedLut + t] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = smem + jt::kPackedLut + warp * mcu_words;
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
    // Block bi's slot pair, class and DC difference (every lane the same
    // DC difference: uniform loads, no divergence before the ballots).
    auto load = [&](int bi, int& a, int& b, int& bcls, int& dcd) {
      const long long blk = m * g + bi;
      const int2 pair = reinterpret_cast<const int2*>(coeffs + blk * 64)
          [lane];
      a = pair.x;
      b = pair.y;
      if (kDerive) {
        bcls = bi >= dcs.n_luma;
        // The predictor: the luma block before in this MCU, else (after
        // no reset) the last luma block, or the same chroma block, of
        // the MCU before.
        const bool same = bi > 0 && bi < dcs.n_luma;
        const int pb = same ? bi - 1 : bi == 0 ? dcs.n_luma - 1 : bi;
        int pred = 0;
        if (same || !reset)
          pred = row[pb * dc_step - (same ? 0 : dcs.mcu_stride)];
        dcd = row[bi * dc_step] - pred;
      } else {
        bcls = cls[blk];
        dcd = dcdiff[blk];
      }
    };
    const int bits = jt::pack_mcu<kG, kChunk>(g, load, lut, buf, lane);
    jt::store_mcu(buf, mwords + m * mcu_words, mlens + m, bits, lane);
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
  const size_t smem = (jt::kPackedLut + (size_t)kWarps * mcu_words) * 4;
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

constexpr int kBlockWords = 56;      // BLOCK_WORDS: a block's stream row
constexpr int kRowQuads = kBlockWords / 4;
constexpr int kPackWarps = 8;        // K7: warps a thread block
constexpr int kPackPer = 4;          // K7: blocks a warp loads at once

// K7: warp w of block k packs blocks kPackPer * (k * kPackWarps + w) on,
// then every gridDim.x * kPackWarps-th group of kPackPer after it.
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
  __shared__ int lut[jt::kPackedLut];
  __shared__ __align__(16) uint32_t rows[kPackWarps][kPackPer * kBlockWords];
  jt::load_packed_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  for (int t = threadIdx.x; t < kPackWarps * kPackPer * kBlockWords;
       t += kPackWarps * 32)
    (&rows[0][0])[t] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = rows[warp];
  const long long n_groups = (n_blocks + kPackPer - 1) / kPackPer;
  const long long stride = (long long)gridDim.x * kPackWarps;
  for (long long gi = (long long)blockIdx.x * kPackWarps + warp;
       gi < n_groups; gi += stride) {     // warp-uniform: whole warps loop
    const long long b0 = gi * kPackPer;
    const int nb = (int)min((long long)kPackPer, n_blocks - b0);
    // Load the group's blocks at once (class and DC difference the same on
    // every lane).
    int a[kPackPer], b[kPackPer], bcls[kPackPer], dcd[kPackPer];
#pragma unroll
    for (int u = 0; u < kPackPer; ++u) {
      a[u] = b[u] = bcls[u] = dcd[u] = 0;
      if (u < nb) {
        const int2 pair =
            reinterpret_cast<const int2*>(coeffs + (b0 + u) * 64)[lane];
        a[u] = pair.x;
        b[u] = pair.y;
        bcls[u] = cls[b0 + u];
        dcd[u] = dcdiff[b0 + u];
      }
    }
    // Symbolize and scan each, as independent streams.
    unsigned long long run[kPackPer];
    int where[kPackPer], total[kPackPer];  // in-block offset << 8 | length
#pragma unroll
    for (int u = 0; u < kPackPer; ++u) {
      run[u] = 0;
      where[u] = total[u] = 0;
      if (u < nb) {
        int len;
        jt::pair_run(a[u], b[u], bcls[u], dcd[u], lut, lane, &run[u], &len);
        const int ex = jt::warp_exclusive_scan(len, lane);
        where[u] = (ex << 8) | len;
        total[u] = __shfl_sync(0xffffffffu, ex + len, 31);
      }
    }
    // Each at bit 0 of its own row.
#pragma unroll
    for (int u = 0; u < kPackPer; ++u) {
      const int len = where[u] & 255;
      if (len) jt::put_run(buf + u * kBlockWords, where[u] >> 8, run[u], len);
    }
    __syncwarp();
    // The nb rows out whole: quad q is quad j of row r; it holds valid
    // words if 4j < ceil(bits / 32).
    uint4* src = reinterpret_cast<uint4*>(buf);
    uint4* dst = reinterpret_cast<uint4*>(words + b0 * kBlockWords);
    for (int q = lane; q < nb * kRowQuads; q += 32) {
      const int r = q / kRowQuads, j = q - r * kRowQuads;
      int bits = 0;
#pragma unroll
      for (int u = 0; u < kPackPer; ++u)
        if (r == u) bits = total[u];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (4 * j < (bits + 31) >> 5) {
        v = src[q];
        src[q] = make_uint4(0u, 0u, 0u, 0u);
      }
      dst[q] = v;
    }
    int my_bits = 0;
#pragma unroll
    for (int u = 0; u < kPackPer; ++u)
      if (lane == u) my_bits = total[u];
    if (lane < nb) lens[b0 + lane] = my_bits;
    __syncwarp();                   // the rows are zero before the next group
  }
}

}  // namespace

// K7: blocks [n_blocks, 64] (8-byte aligned), their classes and DC
// differences -> whole rows [n_blocks, 56] (16-byte aligned) and lengths.
extern "C" int jt_block_pack(const int32_t* coeffs, const int32_t* cls,
                             const int32_t* dcdiff, const int32_t* dc_codes,
                             const int32_t* dc_lens, const int32_t* ac_codes,
                             const int32_t* ac_lens, int32_t* words,
                             int32_t* lens, long long n_blocks,
                             cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(coeffs) & 7) ||
      (reinterpret_cast<uintptr_t>(words) & 15))
    return (int)cudaErrorMisalignedAddress;
  int resident = 0;
  const int err = jt::resident_blocks(block_pack_kernel, kPackWarps * 32, 0,
                                      &resident);
  if (err) return err;
  const long long n_groups = (n_blocks + kPackPer - 1) / kPackPer;
  const long long blocks = (n_groups + kPackWarps - 1) / kPackWarps;
  const long long grid = blocks < resident ? blocks : resident;
  block_pack_kernel<<<(unsigned)grid, kPackWarps * 32, 0, stream>>>(
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
