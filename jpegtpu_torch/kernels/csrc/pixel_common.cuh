// The pixel product shared by the pixel kernels (pixel.cu, pixel_dma.cu,
// fused_px_bp.cu): one MCU's quantized zigzag coefficients are
// round_half_away(tile[kIn] . M[kIn, kOut] + bias), summed in float64 in
// one fixed order (i ascending, one fma per term), so that every kernel
// that calls mcu_product gives the same integer for the same MCU. Products
// of u8 pixels and f32 operator entries are exact in float64.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

// The MCU geometries of jpegtpu_torch.kernels.fused_dctq.mcu_operator.
template <int kMh, int kMw, int kOut>
struct PixelGeometry {
  static constexpr int kIn = kMh * kMw * 3;   // MCU pixels, (y, x, c)
  static constexpr int kRowBytes = kMw * 3;   // one MCU row of pixels
  static constexpr int kBlocks = kOut / 64;   // blocks per MCU
};

// Each thread owns output column `col` of kSlots MCUs whose pixels sit in
// px as doubles, laid out [kIn][kSlots]; acc[s] receives the dot product
// of slot s with the column (no bias, no rounding).
template <int kIn, int kOut, int kSlots>
__device__ __forceinline__ void mcu_product(const double* px,
                                            const float* __restrict__ m,
                                            int col, double (&acc)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.0;
  for (int i = 0; i < kIn; ++i) {
    const double w = (double)__ldg(m + i * kOut + col);
    const double* p = px + i * kSlots;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[s] = fma(p[s], w, acc[s]);
  }
}

__device__ __forceinline__ int32_t round_half_away(double a) {
  return (int32_t)copysign(floor(fabs(a) + 0.5), a);
}

}  // namespace jt
