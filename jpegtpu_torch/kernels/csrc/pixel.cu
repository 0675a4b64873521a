// Pixel kernel: padded u8 RGB image -> int32 quantized zigzag coefficients
// of every MCU, as round_half_away(tile[kIn] . M[kIn, kOut] + bias), for the
// fused MCU geometries of jpegtpu_torch.kernels.fused_dctq.mcu_operator:
//
//   4:2:0           16x16 MCU, 768 inputs -> 6 blocks, 384 outputs
//   4:2:2           8x16 MCU,  384 inputs -> 4 blocks, 256 outputs
//   4:4:4, 4:4:4s   8x8 MCU,   192 inputs -> 3 blocks, 192 outputs
//
// (4:4:4s differs from 4:4:4 only in its operator.)
//
// Replaces jpegtpu/kernels/fused_dctq.py:_pixel_kernel_nat (called
// from encode_blocks_pallas_nat_pairs). The TPU kernel tiles row slabs into
// MCUs in VMEM and runs one f32 MXU matmul; here each block stages the
// pixels of kMcus MCUs in shared memory as doubles and each of its kOut
// threads owns one output column for all of them.
//
// Bound: float64 FMAs (9.6 G at 3840x2160 4:2:0) and the reads of M, which
// every block streams once from L2 (kIn*kOut*4 bytes). Staging kMcus MCUs
// per block divides the M traffic by kMcus; kMcus is chosen so that every
// geometry stages 48 KiB, the most a block takes without opting in to more.
// The sum is float64 so that no coefficient near x.5 rounds differently
// from jpegtpu's reference (see fused_dctq.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kMh, int kMw, int kOut, int kMcus>
struct Geometry {
  static constexpr int kIn = kMh * kMw * 3;       // MCU pixels, (y, x, c)
  static constexpr int kRowBytes = kMw * 3;       // one MCU row of pixels
  static constexpr int kSmemBytes = kIn * kMcus * (int)sizeof(double);
  static_assert(kSmemBytes <= 48 * 1024, "needs the opt-in attribute");
};

template <int kMh, int kMw, int kOut, int kMcus>
__global__ void __launch_bounds__(kOut)
pixel_kernel(const uint8_t* __restrict__ img, const float* __restrict__ m,
             const float* __restrict__ bias, int32_t* __restrict__ out,
             long long n_mcu, long long nrx, long long row_bytes) {
  using G = Geometry<kMh, kMw, kOut, kMcus>;
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
    }
    px[i * kMcus + k] = v;
  }
  __syncthreads();

  const int col = threadIdx.x;
  double acc[kMcus];
#pragma unroll
  for (int k = 0; k < kMcus; ++k) acc[k] = 0.0;
  for (int i = 0; i < G::kIn; ++i) {
    const double w = (double)__ldg(m + i * kOut + col);
    const double* p = px + i * kMcus;
#pragma unroll
    for (int k = 0; k < kMcus; ++k) acc[k] = fma(p[k], w, acc[k]);
  }
  const double b = (double)bias[col];
#pragma unroll
  for (int k = 0; k < kMcus; ++k) {
    const long long mcu = m0 + k;
    if (mcu < n_mcu) {
      const double a = acc[k] + b;
      out[mcu * kOut + col] = (int32_t)copysign(floor(fabs(a) + 0.5), a);
    }
  }
}

template <int kMh, int kMw, int kOut, int kMcus>
int launch(const uint8_t* img, const float* m, const float* bias, int32_t* out,
           long long n_mcu, long long nrx, long long row_bytes,
           cudaStream_t stream) {
  using G = Geometry<kMh, kMw, kOut, kMcus>;
  const long long blocks = (n_mcu + kMcus - 1) / kMcus;
  pixel_kernel<kMh, kMw, kOut, kMcus>
      <<<(unsigned)blocks, kOut, G::kSmemBytes, stream>>>(
          img, m, bias, out, n_mcu, nrx, row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// mh x mw is the MCU in pixels: 16x16 (4:2:0), 8x16 (4:2:2) or 8x8 (4:4:4
// and 4:4:4s); any other geometry is refused before a launch.
extern "C" int jt_pixel(const uint8_t* img, const float* m, const float* bias,
                        int32_t* out, long long n_mcu, long long nrx,
                        long long row_bytes, int mh, int mw,
                        cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (mh == 16 && mw == 16)
    return launch<16, 16, 384, 8>(img, m, bias, out, n_mcu, nrx, row_bytes,
                                  stream);
  if (mh == 8 && mw == 16)
    return launch<8, 16, 256, 16>(img, m, bias, out, n_mcu, nrx, row_bytes,
                                  stream);
  if (mh == 8 && mw == 8)
    return launch<8, 8, 192, 32>(img, m, bias, out, n_mcu, nrx, row_bytes,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
