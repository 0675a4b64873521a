// K1 (jt_pixel), K12 (jt_pixel_dc) and K13 (jt_pixel_i8): padded RGB image
// -> int32 quantized zigzag coefficients of every MCU, round_half_away(tile
// . M + bias), by the factored float64 tensor-core product of
// pixel_common.cuh (mma.sync m16n8k8 .f64 on the operator's two factors,
// lum [192, 64] and chroma [G * 3, 128]), for the fused geometries of
// jpegtpu_torch.kernels.fused_dctq.mcu_operator:
//
//   4:2:0          16x16 MCU, 4 luma blocks, G = 64 2x2 groups, 384 outputs
//   4:2:2          8x16 MCU,  2 luma blocks, G = 64 1x2 groups, 256 outputs
//   4:4:4          8x8 MCU,   1 luma block,  G = 64 1x1 groups, 192 outputs
//   4:4:4s         8x8 MCU,   1 luma block,  G = 16 2x2 groups, 192 outputs
//
// One kernel body, two compile-time options (both off for K1):
//   kDc  K12 also writes the DC plane dc [n_mcu, 8] int32, dc[:, k] the
//        coefficient of column 64k and lanes B..7 zero, in the epilogue
//        (store_tile), every geometry; replaces
//        jpegtpu/kernels/fused_dctq.py:_pixel_kernel_nat_dc.
//   kI8  K13 reads the centred int8 view x ^ 0x80 [rows, 16, nrx, 48] of
//        the padded image (a free reshape: the u8 image's addresses and
//        pitch); each fetched 32-bit word is XORed with 0x80808080 before
//        it is staged, which restores the u8 bytes exactly, so the sums
//        and the product are K1's. 4:2:0 only, as jpegtpu's kernel;
//        replaces _pixel_kernel (encode_blocks_pallas_pairs), which takes
//        i8 because Mosaic cannot cast u8 to f32.
//
// Replaces jpegtpu/kernels/fused_dctq.py:_pixel_kernel_nat (called from
// encode_blocks_pallas_nat_pairs), which tiles row slabs of MCUs in VMEM and
// runs one dense f32 MXU matmul against M. Here a persistent grid (the
// blocks that fit on the card at once, one an SM) walks tiles of kTile
// consecutive MCUs; each block loads the two operators once into shared
// memory, then per tile stages the pixels as u8 (each thread fetches its
// 16- or 8-byte pieces of the next tile into registers before the current
// tile's product, so the loads overlap it), forms the chroma group sums and
// runs the two products in 32 x 32 warp tiles. K11 (fused_px_bp.cu) runs
// the same staging and product into a shared-memory coefficient tile.
//
// Bound: the float64 tensor-core rate. 4:2:0 needs 73,728 multiply-adds an
// MCU (4.78 GFLOP at 3840x2160, 0.071 ms at 67 TFLOP/s) against 25 MB of
// pixels in and 49.8 MB of coefficients out (0.022 ms at 3.35 TB/s; K12's
// plane adds 1.04 MB).
//
// Shared memory and occupancy (12 warps a block, at most 168 registers a
// thread, with which ptxas spills a few; one block an SM; 232,448 bytes a
// block at most; the same for every option):
//   4:2:0   kTile 32:  operators 147,456 + sums 13,312 + pixels 24,576
//                      = 185,344 bytes; 12 warp tiles a tile
//   4:2:2   kTile 96:  147,456 + 39,936 + 36,864 = 224,256; 24 warp tiles
//   4:4:4   kTile 64:  147,456 + 26,624 + 12,288 = 186,368; 12 warp tiles
//   4:4:4s  kTile 128: 73,728 + 12,288 + 24,576 = 110,592; 24 warp tiles
//                      (8 luma of K 192, 16 chroma of K 48)

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "pixel_common.cuh"

namespace {

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

template <int kMh, int kMw, int kGroups, int kTile, bool kI8, bool kDc>
__global__ void __launch_bounds__(kThreads, 1)
pixel_mma_kernel(const uint8_t* __restrict__ img,
                 const float* __restrict__ lum,
                 const float* __restrict__ chroma,
                 const float* __restrict__ bias, int32_t* __restrict__ out,
                 int32_t* __restrict__ dc, long long n_mcu, unsigned nrx,
                 long long row_bytes, long long n_tiles) {
  using F = jt::Factored<kMh, kMw, kGroups, kTile>;
  using S = jt::Staging<F, kThreads>;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* lum_f = reinterpret_cast<float4*>(smem);
  float4* chroma_f = lum_f + F::kLumFloats / 4;
  uint16_t* sums = reinterpret_cast<uint16_t*>(smem + F::kOpBytes);
  uint8_t* px = smem + F::kPixelOffset;
  typename S::Piece* pieces = reinterpret_cast<typename S::Piece*>(px);

  jt::load_fragments(lum_f, lum, 192, 64, threadIdx.x, kThreads);
  jt::load_fragments(chroma_f, chroma, F::kChromaK, 128, threadIdx.x,
                     kThreads);
  typename S::Piece r[S::kPerThread];
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    S::template fetch<kI8>(r, img, tile * kTile, n_mcu, nrx, row_bytes);
  for (; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();            // the last tile's product is done with px
#pragma unroll
    for (int i = 0; i < S::kPerThread; ++i)
      pieces[threadIdx.x + i * kThreads] = r[i];
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      S::template fetch<kI8>(r, img, next * kTile, n_mcu, nrx, row_bytes);
    __syncthreads();
    jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
    __syncthreads();
    jt::tile_product<F, kDc>(px, sums, lum_f, chroma_f, bias, out,
                             tile * kTile, n_mcu, threadIdx.x / 32, kWarps,
                             threadIdx.x % 32, dc);
  }
}

template <int kMh, int kMw, int kGroups, int kTile, bool kI8, bool kDc>
int launch(const uint8_t* img, const float* lum, const float* chroma,
           const float* bias, int32_t* out, int32_t* dc, long long n_mcu,
           long long nrx, long long row_bytes, cudaStream_t stream) {
  using F = jt::Factored<kMh, kMw, kGroups, kTile>;
  using S = jt::Staging<F, kThreads>;
  const auto kernel = pixel_mma_kernel<kMh, kMw, kGroups, kTile, kI8, kDc>;
  if ((reinterpret_cast<uintptr_t>(img) | (uintptr_t)row_bytes) %
      S::kBytes)
    return (int)cudaErrorMisalignedAddress;
  int grid = 0;
  const int err = jt::resident_blocks(kernel, kThreads, S::kSmemBytes, &grid);
  if (err) return err;
  const long long n_tiles = (n_mcu + kTile - 1) / kTile;
  if (n_tiles < grid) grid = (int)n_tiles;
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      img, lum, chroma, bias, out, dc, n_mcu, (unsigned)nrx, row_bytes,
      n_tiles);
  return (int)cudaGetLastError();
}

// The geometry's instance, after the checks every launcher makes.
template <bool kI8, bool kDc>
int dispatch(const uint8_t* img, const float* lum, const float* chroma,
             const float* bias, int32_t* out, int32_t* dc, long long n_mcu,
             long long nrx, long long row_bytes, int mh, int mw, int groups,
             cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (n_mcu >= (1LL << 31) || nrx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (mh == 16 && mw == 16 && groups == 64)
    return launch<16, 16, 64, 32, kI8, kDc>(img, lum, chroma, bias, out, dc,
                                            n_mcu, nrx, row_bytes, stream);
  if constexpr (kI8) return (int)cudaErrorInvalidValue;   // 4:2:0 only
  if (mh == 8 && mw == 16 && groups == 64)
    return launch<8, 16, 64, 96, false, kDc>(img, lum, chroma, bias, out, dc,
                                             n_mcu, nrx, row_bytes, stream);
  if (mh == 8 && mw == 8 && groups == 64)
    return launch<8, 8, 64, 64, false, kDc>(img, lum, chroma, bias, out, dc,
                                            n_mcu, nrx, row_bytes, stream);
  if (mh == 8 && mw == 8 && groups == 16)
    return launch<8, 8, 16, 128, false, kDc>(img, lum, chroma, bias, out, dc,
                                             n_mcu, nrx, row_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mh x mw is the MCU in pixels and groups the chroma groups G of its
// operator: 16x16 / 64 (4:2:0), 8x16 / 64 (4:2:2), 8x8 / 64 (4:4:4) or
// 8x8 / 16 (4:4:4s); any other geometry is refused before a launch. img is
// the padded image at a 16-byte (8x8 MCUs: 8-byte) aligned address, row
// pitch row_bytes = W * 3; lum [192, 64] and chroma [G * 3, 128] f32.
extern "C" int jt_pixel(const uint8_t* img, const float* lum,
                        const float* chroma, const float* bias, int32_t* out,
                        long long n_mcu, long long nrx, long long row_bytes,
                        int mh, int mw, int groups, cudaStream_t stream) {
  return dispatch<false, false>(img, lum, chroma, bias, out, nullptr, n_mcu,
                                nrx, row_bytes, mh, mw, groups, stream);
}

// jt_pixel, and the DC plane into dc [n_mcu, 8] int32.
extern "C" int jt_pixel_dc(const uint8_t* img, const float* lum,
                           const float* chroma, const float* bias,
                           int32_t* out, int32_t* dc, long long n_mcu,
                           long long nrx, long long row_bytes, int mh, int mw,
                           int groups, cudaStream_t stream) {
  return dispatch<false, true>(img, lum, chroma, bias, out, dc, n_mcu, nrx,
                               row_bytes, mh, mw, groups, stream);
}

// jt_pixel at 4:2:0 on the centred int8 view [rows, 16, nrx, 48] of the
// padded image: row_bytes = nrx * 48.
extern "C" int jt_pixel_i8(const int8_t* img, const float* lum,
                           const float* chroma, const float* bias,
                           int32_t* out, long long n_mcu, long long nrx,
                           long long row_bytes, cudaStream_t stream) {
  return dispatch<true, false>(reinterpret_cast<const uint8_t*>(img), lum,
                               chroma, bias, out, nullptr, n_mcu, nrx,
                               row_bytes, 16, 16, 64, stream);
}

// The dynamic shared memory a block takes for a geometry (0 for one it
// refuses), the same for every option, for reports.
extern "C" int jt_pixel_smem(int mh, int mw, int groups) {
  if (mh == 16 && mw == 16 && groups == 64)
    return jt::Staging<jt::Factored<16, 16, 64, 32>, kThreads>::kSmemBytes;
  if (mh == 8 && mw == 16 && groups == 64)
    return jt::Staging<jt::Factored<8, 16, 64, 96>, kThreads>::kSmemBytes;
  if (mh == 8 && mw == 8 && groups == 64)
    return jt::Staging<jt::Factored<8, 8, 64, 64>, kThreads>::kSmemBytes;
  if (mh == 8 && mw == 8 && groups == 16)
    return jt::Staging<jt::Factored<8, 8, 16, 128>, kThreads>::kSmemBytes;
  return 0;
}
