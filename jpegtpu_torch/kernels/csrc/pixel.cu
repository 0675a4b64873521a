// Dense pixel kernels: padded RGB image -> int32 quantized zigzag
// coefficients of every MCU, as round_half_away(tile[kIn] . M[kIn, kOut] +
// bias), for the fused MCU geometries of
// jpegtpu_torch.kernels.fused_dctq.mcu_operator:
//
//   4:2:0           16x16 MCU, 768 inputs -> 6 blocks, 384 outputs
//   4:2:2           8x16 MCU,  384 inputs -> 4 blocks, 256 outputs
//   4:4:4, 4:4:4s   8x8 MCU,   192 inputs -> 3 blocks, 192 outputs
//
// (4:4:4s differs from 4:4:4 only in its operator.) Two launchers share
// one kernel body:
//
//   jt_pixel_dc  the coefficients plus the DC plane dc [nMCU, 8] int32
//                (dc[:, k] = column 64k, lanes B..7 zero); replaces
//                jpegtpu/kernels/fused_dctq.py:_pixel_kernel_nat_dc
//                (encode_blocks_pallas_nat_pairs with with_dc=True). The
//                thread that owns column 64k writes lane k; threads B..7
//                write the zero lanes.
//   jt_pixel_i8  4:2:0 only: the image as its centred int8 view x ^ 0x80
//                (= x - 128), restored exactly by + 128.0 before the sum;
//                replaces _pixel_kernel (encode_blocks_pallas_pairs). The
//                TPU kernel takes i8 because Mosaic cannot cast u8 to f32;
//                the view [rows, mh, nrx, row_bytes] is a free reshape of
//                the image, so its addresses are the u8 image's.
//
// K1 (jt_pixel) and K14 moved to the factored tensor-core product
// (pixel_mma.cu, pixel_dma.cu); these two keep the dense one until their
// own redesign. The TPU kernels tile row slabs into MCUs in VMEM and run
// one f32 MXU matmul; here each block stages the pixels of kMcus MCUs in
// shared memory as doubles and each of its kOut threads owns one output
// column for all of them (pixel_common.cuh's mcu_product).
//
// Bound: float64 FMAs (9.6 G at 3840x2160 4:2:0) and the reads of M, which
// every block streams once from L2 (kIn*kOut*4 bytes). Staging kMcus MCUs
// per block divides the M traffic by kMcus; kMcus is chosen so that every
// geometry stages 48 KiB, the most a block takes without opting in to more.
// The sum is float64 so that no coefficient near x.5 rounds differently
// from jpegtpu's reference (see fused_dctq.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pixel_common.cuh"

namespace {

constexpr int kDcLanes = 8;         // lanes of a DC-plane row

template <int kMh, int kMw, int kOut, int kMcus, typename T, bool kDc>
__global__ void __launch_bounds__(kOut)
pixel_kernel(const T* __restrict__ img, const float* __restrict__ m,
             const float* __restrict__ bias, int32_t* __restrict__ out,
             int32_t* __restrict__ dc, long long n_mcu, long long nrx,
             long long row_bytes) {
  using G = jt::PixelGeometry<kMh, kMw, kOut>;
  extern __shared__ double px[];    // [kIn][kMcus]
  const long long m0 = (long long)blockIdx.x * kMcus;
  for (int t = threadIdx.x; t < G::kIn * kMcus; t += blockDim.x) {
    const int k = t / G::kIn;       // MCU within the block
    const int i = t - k * G::kIn;   // pixel byte within the MCU
    const long long mcu = m0 + k;
    double v = 0.0;
    if (mcu < n_mcu) {
      const long long r = mcu / nrx, c = mcu - r * nrx;
      const int y = i / G::kRowBytes, xc = i - y * G::kRowBytes;
      v = (double)img[(r * kMh + y) * row_bytes + c * G::kRowBytes + xc];
      if constexpr (std::is_same<T, int8_t>::value) v += 128.0;
    }
    px[i * kMcus + k] = v;
  }
  __syncthreads();

  const int col = threadIdx.x;
  double acc[kMcus];
  jt::mcu_product<G::kIn, kOut, kMcus>(px, m, col, acc);
  const double b = (double)bias[col];
#pragma unroll
  for (int k = 0; k < kMcus; ++k) {
    const long long mcu = m0 + k;
    if (mcu < n_mcu) {
      const int32_t q = jt::round_half_away(acc[k] + b);
      out[mcu * kOut + col] = q;
      if constexpr (kDc) {
        if (col % 64 == 0) dc[mcu * kDcLanes + col / 64] = q;
        if (col >= G::kBlocks && col < kDcLanes) dc[mcu * kDcLanes + col] = 0;
      }
    }
  }
}

template <int kMh, int kMw, int kOut, int kMcus, typename T, bool kDc>
int launch(const T* img, const float* m, const float* bias, int32_t* out,
           int32_t* dc, long long n_mcu, long long nrx, long long row_bytes,
           cudaStream_t stream) {
  constexpr int kSmemBytes = kMh * kMw * 3 * kMcus * (int)sizeof(double);
  static_assert(kSmemBytes <= 48 * 1024, "needs the opt-in attribute");
  const long long blocks = (n_mcu + kMcus - 1) / kMcus;
  pixel_kernel<kMh, kMw, kOut, kMcus, T, kDc>
      <<<(unsigned)blocks, kOut, kSmemBytes, stream>>>(
          img, m, bias, out, dc, n_mcu, nrx, row_bytes);
  return (int)cudaGetLastError();
}

template <typename T, bool kDc>
int dispatch(const T* img, const float* m, const float* bias, int32_t* out,
             int32_t* dc, long long n_mcu, long long nrx, long long row_bytes,
             int mh, int mw, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (mh == 16 && mw == 16)
    return launch<16, 16, 384, 8, T, kDc>(img, m, bias, out, dc, n_mcu, nrx,
                                          row_bytes, stream);
  if (mh == 8 && mw == 16)
    return launch<8, 16, 256, 16, T, kDc>(img, m, bias, out, dc, n_mcu, nrx,
                                          row_bytes, stream);
  if (mh == 8 && mw == 8)
    return launch<8, 8, 192, 32, T, kDc>(img, m, bias, out, dc, n_mcu, nrx,
                                         row_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mh x mw is the MCU in pixels: 16x16 (4:2:0), 8x16 (4:2:2) or 8x8 (4:4:4
// and 4:4:4s); any other geometry is refused before a launch. row_bytes is
// the image's row pitch in bytes (W * 3).
extern "C" int jt_pixel_dc(const uint8_t* img, const float* m,
                           const float* bias, int32_t* out, int32_t* dc,
                           long long n_mcu, long long nrx, long long row_bytes,
                           int mh, int mw, cudaStream_t stream) {
  return dispatch<uint8_t, true>(img, m, bias, out, dc, n_mcu, nrx, row_bytes,
                                 mh, mw, stream);
}

// 4:2:0 only, as jpegtpu's kernel.
extern "C" int jt_pixel_i8(const int8_t* img, const float* m,
                           const float* bias, int32_t* out, long long n_mcu,
                           long long nrx, long long row_bytes,
                           cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  return launch<16, 16, 384, 8, int8_t, false>(img, m, bias, out, nullptr,
                                                n_mcu, nrx, row_bytes, stream);
}
