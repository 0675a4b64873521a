// K11, the fused front end: padded u8 RGB image -> each MCU's Huffman-coded
// bitstream (big-endian u32 words, MSB first) and its bit length, with the
// DC differences computed in the kernel, so that the coefficients never
// reach device memory. The streams and lengths of pixel_mma.cu's K1 and
// block_pack.cu's K2 (jt_block_pack_mcu_segments) in turn: the DC predictor
// is 0 where the MCU index is a multiple of the restart interval (restart >
// 0) or at MCU 0 alone (restart 0), jpegtpu's reset_every. 4:2:0, 4:2:2 and
// 4:4:4 (g = 6, 4, 3 blocks). Only each MCU's valid words, ceil(mlen / 32),
// are stored; the bits past mlen in the last one are zero, the words past
// it are never written.
//
// Replaces jpegtpu/kernels/fused_pipeline.py:_fused_px_bp_kernel (called
// from fused_pixel_block_pack_pairs), which carries the DC chain's tail from
// one grid step to the next in VMEM scratch, relying on its steps running in
// order. Here the two proven designs run back to back in one block:
// - K1's product (pixel_common.cuh): a persistent grid of one 12-warp block
//   an SM; each block loads the operators' two factors (lum [192, 64],
//   chroma [192, 128]) once into shared memory in fragment order, stages
//   tiles of kTile consecutive MCUs as u8 with K1's register prefetch
//   (Staging), forms the chroma group sums and runs the float64 tensor-core
//   product (tile_product), whose epilogue rounds into a shared int16
//   coefficient tile [kTile][kCoefStride]. int16 is exact because the
//   wrapper (fused_pipeline.py) refuses an operator whose column bound
//   255 * sum|w| + |bias| exceeds 32,767; jpegtpu's operators stay under
//   3,100 at every quality.
// - K2's pack (block_pack.cuh pack_mcu, store_mcu) on that tile: each warp
//   takes MCUs w, w + 12, ... of the tile, loads all its blocks at once,
//   symbolizes them as independent streams and places them by a running
//   sum in its row of shared memory, then stores the valid words.
// - The DC chain without a halo product: each block takes one contiguous
//   run of tiles, so a tile's first MCU is predicted by the tile before's
//   last MCU (its DC values carried in shared memory). The run's first tile
//   takes its predecessor MCU's three predicting DC values (last luma
//   block, Cb, Cr) from scalar float64 dot products of that MCU's pixels
//   with the factors' DC columns (halo_dc), which equal the tensor-core
//   values bit for bit because every column's sum is exact in any order.
// - The next tile is staged beside the pack (its pieces fetched into
//   registers a tile ahead), so a tile takes three barriers, not four.
// Measured on an H100 (PERF.md, k11_variants.py) and not kept: a halo dot
// product for every tile over K1's strided tiles in place of the run
// carry, and two MCUs a warp in the pack (twice the independent streams);
// both ran slower. The pack phase, at 12 warps an SM, takes about as long
// as the product.
//
// Shared memory a block (232,448 at most; operators 147,456, packed LUTs
// 2,176, two tiles' carried DC values 64, twelve stream rows of g*52+2
// words):
//   4:2:0  kTile 32: + sums 13,312 + pixels 24,576 + int16 tile 25,088
//                    + rows 15,072 = 227,744
//   4:2:2  kTile 32: + 13,312 + 12,288 + 16,896 + 10,080 = 202,272
//   4:4:4  kTile 64: + 26,624 + 12,288 + 25,600 + 7,584 = 221,792
// (4:2:2 at 64 MCUs a tile, or any mode with int32 coefficients, does not
// fit.)
//
// Bound: the float64 tensor-core rate, as K1's (73,728 multiply-adds a
// 4:2:0 MCU, 4.74 GFLOP at 3840x2160, 0.071 ms at 67 TFLOP/s); the bytes,
// 25 MB of pixels in and about 3 MB of valid stream words out, take 0.008
// ms. The 49.8 MB coefficient tensor of the split route is neither written
// nor read back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_pack.cuh"
#include "grid.cuh"
#include "pixel_common.cuh"

namespace {

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

template <int kMh, int kMw, int kTile>
struct Fused {
  using F = jt::Factored<kMh, kMw, 64, kTile>;
  using S = jt::Staging<F, kThreads>;
  static constexpr int kMcuWords = F::kBlocks * 52 + 2;   // a stream row
  static constexpr int kCoefOffset = F::kPixelOffset + F::kTileBytes;
  static constexpr int kLutOffset = kCoefOffset + kTile * F::kCoefStride * 2;
  static constexpr int kCarryOffset = kLutOffset + jt::kPackedLut * 4;
  static constexpr int kRowOffset = kCarryOffset + 2 * jt::kDcLanes * 4;
  static constexpr int kSmemBytes = kRowOffset + kWarps * kMcuWords * 4;
  static_assert(kSmemBytes <= 232448, "shared memory");
  static_assert(kCoefOffset % 16 == 0 && kRowOffset % 16 == 0, "alignment");
};

// The DC values of MCU `mcu` that predict the next MCU's (its last luma
// block's, its Cb's and its Cr's), by one warp: lum's column 0 over the
// last luma block's 192 bytes and chroma's columns 0 and 64 over the MCU's
// 192 exact group sums, six terms a lane each, summed across the warp.
// Every partial sum is exact (pixel_common.cuh), so each value equals the
// tensor-core product's bit for bit. Into carry[kLuma - 1], carry[kLuma]
// and carry[kLuma + 1].
template <typename F>
__device__ void halo_dc(const uint8_t* __restrict__ img,
                        const float* __restrict__ lum,
                        const float* __restrict__ chroma,
                        const float* __restrict__ bias, long long mcu,
                        unsigned nrx, long long row_bytes, int lane,
                        int* carry) {
  constexpr int kLast = F::kLuma - 1;
  constexpr int kBy = kLast / F::kBlocksX, kBx = kLast % F::kBlocksX;
  const unsigned r = (unsigned)mcu / nrx, c = (unsigned)mcu - r * nrx;
  const uint8_t* px = img + (long long)r * F::kMcuH * row_bytes +
                      (long long)c * F::kRowBytes;
  // Luma: lane l takes row l / 4 of the block, bytes 6 (l % 4) .. + 5.
  const int y = lane >> 2, x0 = (lane & 3) * 6;
  const uint8_t* lp = px + (long long)(kBy * 8 + y) * row_bytes + kBx * 24 +
                      x0;
  double dl = 0.0, dcb = 0.0, dcr = 0.0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    dl = fma((double)lp[i], (double)__ldg(lum + (y * 24 + x0 + i) * 64), dl);
  // Chroma: lane l takes sums 6l .. 6l + 5, sum k being channel k % 3 of
  // group k / 3, (gy, gx) in the MCU's kSide x kSide groups.
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int k = 6 * lane + i, grp = k / 3, ch = k - 3 * grp;
    const int gy = grp / F::kSide, gx = grp - gy * F::kSide;
    int s = 0;
#pragma unroll
    for (int dy = 0; dy < F::kGy; ++dy)
#pragma unroll
      for (int dx = 0; dx < F::kGx; ++dx)
        s += px[(long long)(gy * F::kGy + dy) * row_bytes +
                (gx * F::kGx + dx) * 3 + ch];
    dcb = fma((double)s, (double)__ldg(chroma + k * 128), dcb);
    dcr = fma((double)s, (double)__ldg(chroma + k * 128 + 64), dcr);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    dl += __shfl_xor_sync(0xffffffffu, dl, o);
    dcb += __shfl_xor_sync(0xffffffffu, dcb, o);
    dcr += __shfl_xor_sync(0xffffffffu, dcr, o);
  }
  if (lane == 0) {
    carry[kLast] = jt::round_half_away(dl + (double)__ldg(bias + kLast * 64));
    carry[F::kLuma] =
        jt::round_half_away(dcb + (double)__ldg(bias + F::kLuma * 64));
    carry[F::kLuma + 1] =
        jt::round_half_away(dcr + (double)__ldg(bias + F::kLuma * 64 + 64));
  }
}

// Block k takes tiles [k n_tiles / grid, (k + 1) n_tiles / grid). The DC
// predictor resets where the MCU index is a multiple of `interval` (the
// restart interval, or n_mcu for none).
template <int kMh, int kMw, int kTile>
__global__ void __launch_bounds__(kThreads, 1)
fused_px_bp_kernel(const uint8_t* __restrict__ img,
                   const float* __restrict__ lum,
                   const float* __restrict__ chroma,
                   const float* __restrict__ bias,
                   const int32_t* __restrict__ dc_codes,
                   const int32_t* __restrict__ dc_lens,
                   const int32_t* __restrict__ ac_codes,
                   const int32_t* __restrict__ ac_lens,
                   int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                   long long n_mcu, unsigned nrx, long long row_bytes,
                   long long n_tiles, unsigned interval) {
  using K = Fused<kMh, kMw, kTile>;
  using F = typename K::F;
  using S = typename K::S;
  constexpr int kG = F::kBlocks, kLuma = F::kLuma;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* lum_f = reinterpret_cast<float4*>(smem);
  float4* chroma_f = lum_f + F::kLumFloats / 4;
  uint16_t* sums = reinterpret_cast<uint16_t*>(smem + F::kOpBytes);
  uint8_t* px = smem + F::kPixelOffset;
  typename S::Piece* pieces = reinterpret_cast<typename S::Piece*>(px);
  int16_t* coef = reinterpret_cast<int16_t*>(smem + K::kCoefOffset);
  int* lut = reinterpret_cast<int*>(smem + K::kLutOffset);
  int* carry = reinterpret_cast<int*>(smem + K::kCarryOffset);
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + K::kRowOffset);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  jt::load_fragments(lum_f, lum, 192, 64, threadIdx.x, kThreads);
  jt::load_fragments(chroma_f, chroma, F::kChromaK, 128, threadIdx.x,
                     kThreads);
  jt::load_packed_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  for (int t = threadIdx.x; t < kWarps * K::kMcuWords; t += kThreads)
    rows[t] = 0;
  uint32_t* buf = rows + warp * K::kMcuWords;
  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;
  // carry[8 (t & 1) + b]: DC of block b of the MCU before tile t's first.
  if (warp == 0 && t0 > 0 && (t0 * kTile) % interval != 0)
    halo_dc<F>(img, lum, chroma, bias, t0 * kTile - 1, nrx, row_bytes, lane,
               carry + 8 * (int)(t0 & 1));
  typename S::Piece r[S::kPerThread];
  S::template fetch<false>(r, img, t0 * kTile, n_mcu, nrx, row_bytes);
#pragma unroll
  for (int i = 0; i < S::kPerThread; ++i)
    pieces[threadIdx.x + i * kThreads] = r[i];
  if (t0 + 1 < t1)
    S::template fetch<false>(r, img, (t0 + 1) * kTile, n_mcu, nrx, row_bytes);
  __syncthreads();
  jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
  // Per tile: the product, then the pack, and beside the pack the next
  // tile's staging (its pieces already in registers) and the next but
  // one's fetch; its sums after the barrier that ends the pack.
  for (long long tile = t0; tile < t1; ++tile) {
    const long long m0 = tile * kTile;
    __syncthreads();            // the sums are formed, the last pack is done
    jt::tile_product<F>(px, sums, lum_f, chroma_f, bias, coef, m0, n_mcu,
                        warp, kWarps, lane);
    __syncthreads();            // the tile's coefficients are all in coef
    const int* cur = carry + 8 * (int)(tile & 1);
    if (threadIdx.x < kG)
      carry[8 * (int)((tile + 1) & 1) + threadIdx.x] =
          coef[(kTile - 1) * F::kCoefStride + 64 * threadIdx.x];
    if (tile + 1 < t1) {
#pragma unroll
      for (int i = 0; i < S::kPerThread; ++i)
        pieces[threadIdx.x + i * kThreads] = r[i];
      if (tile + 2 < t1)
        S::template fetch<false>(r, img, m0 + 2 * kTile, n_mcu, nrx,
                                 row_bytes);
    }
    const unsigned phase = (unsigned)(m0 % interval);
    for (int j = warp; j < kTile; j += kWarps) {
      const long long m = m0 + j;
      if (m >= n_mcu) break;            // whole warps leave together
      const bool reset = (phase + j) % interval == 0;
      const int16_t* row = coef + j * F::kCoefStride;
      // Block bi's slot pair (one 32-bit word of two int16 a lane), class
      // and DC difference: the predictor is the luma block before in this
      // MCU, else (after no reset) the last luma block, or the same chroma
      // block, of the MCU before (the row before, or cur for j = 0).
      auto load = [&](int bi, int& a, int& b, int& bcls, int& dcd) {
        const uint32_t pair =
            reinterpret_cast<const uint32_t*>(row + 64 * bi)[lane];
        a = (int)(int16_t)(pair & 0xFFFF);
        b = (int)pair >> 16;
        bcls = bi >= kLuma;
        const bool same = bi > 0 && bi < kLuma;
        const int pb = same ? bi - 1 : bi == 0 ? kLuma - 1 : bi;
        int pred = 0;
        if (same)
          pred = row[64 * pb];
        else if (!reset)
          pred = j ? row[64 * pb - F::kCoefStride] : cur[pb];
        dcd = row[64 * bi] - pred;
      };
      const int bits = jt::pack_mcu<kG, kG>(kG, load, lut, buf, lane);
      jt::store_mcu(buf, mwords + m * K::kMcuWords, mlens + m, bits, lane);
    }
    __syncthreads();            // the next tile is staged
    if (tile + 1 < t1) jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
  }
}

template <int kMh, int kMw, int kTile>
int launch(const uint8_t* img, const float* lum, const float* chroma,
           const float* bias, const int32_t* dc_codes,
           const int32_t* dc_lens, const int32_t* ac_codes,
           const int32_t* ac_lens, int32_t* mwords, int32_t* mlens,
           long long n_mcu, long long nrx, long long row_bytes,
           long long restart, int mcu_words, cudaStream_t stream) {
  using K = Fused<kMh, kMw, kTile>;
  const auto kernel = fused_px_bp_kernel<kMh, kMw, kTile>;
  if (mcu_words != K::kMcuWords) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(img) | (uintptr_t)row_bytes) %
      K::S::kBytes)
    return (int)cudaErrorMisalignedAddress;
  int grid = 0;
  const int err = jt::resident_blocks(kernel, kThreads, K::kSmemBytes, &grid);
  if (err) return err;
  const long long n_tiles = (n_mcu + kTile - 1) / kTile;
  if (n_tiles < grid) grid = (int)n_tiles;
  const unsigned interval =
      (unsigned)(restart > 0 && restart < n_mcu ? restart : n_mcu);
  kernel<<<grid, kThreads, K::kSmemBytes, stream>>>(
      img, lum, chroma, bias, dc_codes, dc_lens, ac_codes, ac_lens, mwords,
      mlens, n_mcu, (unsigned)nrx, row_bytes, n_tiles, interval);
  return (int)cudaGetLastError();
}

}  // namespace

// mh x mw is the MCU in pixels: 16x16 (4:2:0), 8x16 (4:2:2) or 8x8 (4:4:4);
// any other geometry, or an MCU stream width other than g*52+2 words, is
// refused before a launch. img is the padded image at a 16-byte (8x8 MCUs:
// 8-byte) aligned address, row pitch row_bytes = W * 3; lum [192, 64] and
// chroma [192, 128] f32, the factors of the mode's operator; restart is the
// interval in MCUs, 0 for none.
extern "C" int jt_fused_px_bp(const uint8_t* img, const float* lum,
                              const float* chroma, const float* bias,
                              const int32_t* dc_codes, const int32_t* dc_lens,
                              const int32_t* ac_codes, const int32_t* ac_lens,
                              int32_t* mwords, int32_t* mlens,
                              long long n_mcu, long long nrx,
                              long long row_bytes, long long restart, int mh,
                              int mw, int mcu_words, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (n_mcu >= (1LL << 31) || nrx >= (1LL << 31) || restart < 0)
    return (int)cudaErrorInvalidValue;
  if (mh == 16 && mw == 16)
    return launch<16, 16, 32>(img, lum, chroma, bias, dc_codes, dc_lens,
                              ac_codes, ac_lens, mwords, mlens, n_mcu, nrx,
                              row_bytes, restart, mcu_words, stream);
  if (mh == 8 && mw == 16)
    return launch<8, 16, 32>(img, lum, chroma, bias, dc_codes, dc_lens,
                             ac_codes, ac_lens, mwords, mlens, n_mcu, nrx,
                             row_bytes, restart, mcu_words, stream);
  if (mh == 8 && mw == 8)
    return launch<8, 8, 64>(img, lum, chroma, bias, dc_codes, dc_lens,
                            ac_codes, ac_lens, mwords, mlens, n_mcu, nrx,
                            row_bytes, restart, mcu_words, stream);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block takes for a geometry (0 for one it
// refuses), for reports.
extern "C" int jt_fused_px_bp_smem(int mh, int mw) {
  if (mh == 16 && mw == 16) return Fused<16, 16, 32>::kSmemBytes;
  if (mh == 8 && mw == 16) return Fused<8, 16, 32>::kSmemBytes;
  if (mh == 8 && mw == 8) return Fused<8, 8, 64>::kSmemBytes;
  return 0;
}
