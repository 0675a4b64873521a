// Fused pixel + block-pack kernel: padded u8 RGB image -> each MCU's
// Huffman-coded bitstream (big-endian u32 words, MSB first, zero past its
// length) and its bit length, with the DC differences computed in the
// kernel, so that the coefficients never reach device memory. Word for word
// the output of pixel_mma.cu, the DC glue (scan.dc_diffs_from_dc) and
// block_pack.cu in turn; 4:2:0, 4:2:2 and 4:4:4 (g = 6, 4, 3 blocks).
//
// Replaces jpegtpu/kernels/fused_pipeline.py:_fused_px_bp_kernel (called
// from fused_pixel_block_pack_pairs). The TPU kernel carries the DC chain's
// tail from one grid step to the next in VMEM scratch, which works because
// its grid steps run in order. CUDA blocks run in no order, so here each
// block needs nothing from another: it stages one halo MCU (the MCU before
// its first) beside its kMcus MCUs and computes the halo's coefficients
// with the same float64 product (pixel_common.cuh, one fixed order), which
// gives the same integers as the block that owns that MCU. The halo's DC
// values start the block's chains: the previous MCU's last luma block
// predicts the first luma block, its Cb and Cr predict Cb and Cr, and the
// predictor is 0 where the MCU index is a multiple of the restart interval
// (restart > 0) or at MCU 0 alone (restart 0), jpegtpu's reset_every.
//
// One block: its kOut threads compute kMcus + 1 MCUs into registers (the
// dense product, pixel_common.cuh's mcu_product), then the pixel staging
// region (48 KiB) is reused for the coefficients, the halo's DC values, the
// Huffman LUTs and one stream buffer per warp, and one warp per MCU
// symbolizes and packs its g blocks as block_pack.cu does (block_pack.cuh).
//
// Bound: the float64 FMAs of the dense product (one MCU in kMcus + 1 is
// the halo's); the coefficient tensor (49.8 MB at 3840x2160 4:2:0) is
// neither written nor read back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_pack.cuh"
#include "pixel_common.cuh"

namespace {

template <int kMh, int kMw, int kOut, int kMcus>
struct Fused {
  using G = jt::PixelGeometry<kMh, kMw, kOut>;
  static constexpr int kSlots = kMcus + 1;          // slot 0: the halo MCU
  static constexpr int kLuma = G::kBlocks - 2;      // luma blocks per MCU
  static constexpr int kWarps = kOut / 32;
  static constexpr int kMcuWords = G::kBlocks * 52 + 2;
  static constexpr int kSmemBytes = G::kIn * kSlots * (int)sizeof(double);
  static constexpr int kReuseBytes =
      (kMcus * kOut + G::kBlocks + jt::kLutInts + kWarps * kMcuWords) * 4;
  static_assert(kSmemBytes <= 48 * 1024, "needs the opt-in attribute");
  static_assert(kReuseBytes <= kSmemBytes, "reuse exceeds the staging");
};

template <int kMh, int kMw, int kOut, int kMcus>
__global__ void __launch_bounds__(kOut)
fused_px_bp_kernel(const uint8_t* __restrict__ img,
                   const float* __restrict__ m, const float* __restrict__ bias,
                   const int32_t* __restrict__ dc_codes,
                   const int32_t* __restrict__ dc_lens,
                   const int32_t* __restrict__ ac_codes,
                   const int32_t* __restrict__ ac_lens,
                   int32_t* __restrict__ mwords, int32_t* __restrict__ mlens,
                   long long n_mcu, long long nrx, long long row_bytes,
                   long long restart) {
  using F = Fused<kMh, kMw, kOut, kMcus>;
  using G = typename F::G;
  constexpr int kS = F::kSlots;
  extern __shared__ double px[];    // [kIn][kS], slot s = MCU m0 - 1 + s
  const long long m0 = (long long)blockIdx.x * kMcus;
  for (int t = threadIdx.x; t < G::kIn * kS; t += blockDim.x) {
    const int s = t / G::kIn;
    const int i = t - s * G::kIn;
    const long long mcu = m0 - 1 + s;
    double v = 0.0;
    if (mcu >= 0 && mcu < n_mcu) {
      const long long r = mcu / nrx, c = mcu - r * nrx;
      const int y = i / G::kRowBytes, xc = i - y * G::kRowBytes;
      v = (double)img[(r * kMh + y) * row_bytes + c * G::kRowBytes + xc];
    }
    px[i * kS + s] = v;
  }
  __syncthreads();

  const int col = threadIdx.x;
  double acc[kS];
  jt::mcu_product<G::kIn, kOut, kS>(px, m, col, acc);
  const double b = (double)bias[col];
  __syncthreads();                  // px is read no more: reuse the region

  int32_t* cf = (int32_t*)px;                     // [kMcus][kOut]
  int32_t* halo_dc = cf + kMcus * kOut;           // [kBlocks]
  int* lut = halo_dc + G::kBlocks;                // [kLutInts]
  uint32_t* bufs = (uint32_t*)(lut + jt::kLutInts);  // [kWarps][kMcuWords]
#pragma unroll
  for (int s = 1; s < kS; ++s)
    cf[(s - 1) * kOut + col] = jt::round_half_away(acc[s] + b);
  if (col % 64 == 0) halo_dc[col / 64] = jt::round_half_away(acc[0] + b);
  jt::load_luts(lut, dc_codes, dc_lens, ac_codes, ac_lens);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = bufs + warp * F::kMcuWords;
  for (int j = warp; j < kMcus; j += F::kWarps) {
    const long long mcu = m0 + j;
    if (mcu >= n_mcu) break;          // whole warp leaves together
    for (int w = lane; w < F::kMcuWords; w += 32) buf[w] = 0;
    __syncwarp();
    const bool reset = restart > 0 ? mcu % restart == 0 : mcu == 0;
    const int32_t* c = cf + j * kOut;
    // DC of block k of the previous MCU: the halo's for the first MCU.
    auto prev_dc = [&](int k) {
      return j ? cf[(j - 1) * kOut + 64 * k] : halo_dc[k];
    };
    int base = 0;                     // bits written so far in this MCU
    for (int blk = 0; blk < G::kBlocks; ++blk) {
      int pred;
      if (blk == 0)
        pred = reset ? 0 : prev_dc(F::kLuma - 1);
      else if (blk < F::kLuma)
        pred = c[64 * (blk - 1)];
      else
        pred = reset ? 0 : prev_dc(blk);
      base += jt::pack_block(c[64 * blk + lane], c[64 * blk + lane + 32],
                             blk >= F::kLuma, c[64 * blk] - pred, lut, buf,
                             base, lane);
    }
    __syncwarp();
    int32_t* dst = mwords + mcu * F::kMcuWords;
    for (int w = lane; w < F::kMcuWords; w += 32) dst[w] = (int32_t)buf[w];
    if (lane == 0) mlens[mcu] = base;
    __syncwarp();                     // before buf is cleared again
  }
}

template <int kMh, int kMw, int kOut, int kMcus>
int launch(const uint8_t* img, const float* m, const float* bias,
           const int32_t* dc_codes, const int32_t* dc_lens,
           const int32_t* ac_codes, const int32_t* ac_lens, int32_t* mwords,
           int32_t* mlens, long long n_mcu, long long nrx, long long row_bytes,
           long long restart, int mcu_words, cudaStream_t stream) {
  using F = Fused<kMh, kMw, kOut, kMcus>;
  if (mcu_words != F::kMcuWords) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_mcu + kMcus - 1) / kMcus;
  fused_px_bp_kernel<kMh, kMw, kOut, kMcus>
      <<<(unsigned)blocks, kOut, F::kSmemBytes, stream>>>(
          img, m, bias, dc_codes, dc_lens, ac_codes, ac_lens, mwords, mlens,
          n_mcu, nrx, row_bytes, restart);
  return (int)cudaGetLastError();
}

}  // namespace

// mh x mw is the MCU in pixels: 16x16 (4:2:0), 8x16 (4:2:2) or 8x8 (4:4:4);
// any other geometry, or an MCU stream width other than g*52+2 words, is
// refused before a launch. row_bytes is the image's row pitch (W * 3);
// restart is the interval in MCUs, 0 for none.
extern "C" int jt_fused_px_bp(const uint8_t* img, const float* m,
                              const float* bias, const int32_t* dc_codes,
                              const int32_t* dc_lens, const int32_t* ac_codes,
                              const int32_t* ac_lens, int32_t* mwords,
                              int32_t* mlens, long long n_mcu, long long nrx,
                              long long row_bytes, long long restart, int mh,
                              int mw, int mcu_words, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (mh == 16 && mw == 16)
    return launch<16, 16, 384, 7>(img, m, bias, dc_codes, dc_lens, ac_codes,
                                  ac_lens, mwords, mlens, n_mcu, nrx,
                                  row_bytes, restart, mcu_words, stream);
  if (mh == 8 && mw == 16)
    return launch<8, 16, 256, 15>(img, m, bias, dc_codes, dc_lens, ac_codes,
                                  ac_lens, mwords, mlens, n_mcu, nrx,
                                  row_bytes, restart, mcu_words, stream);
  if (mh == 8 && mw == 8)
    return launch<8, 8, 192, 31>(img, m, bias, dc_codes, dc_lens, ac_codes,
                                 ac_lens, mwords, mlens, n_mcu, nrx,
                                 row_bytes, restart, mcu_words, stream);
  return (int)cudaErrorInvalidValue;
}
