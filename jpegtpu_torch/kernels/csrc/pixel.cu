// Pixel kernel: padded u8 RGB image -> int32 quantized zigzag coefficients
// of every 4:2:0 MCU, as round_half_away(tile[768] . M[768, 384] + bias).
//
// Replaces jpegtpu/kernels/fused_dctq.py:_pixel_kernel_nat (called
// from encode_blocks_pallas_nat_pairs). The TPU kernel tiles row slabs into
// MCUs in VMEM and runs one f32 MXU matmul; here each block stages the
// pixels of kMcus MCUs in shared memory as doubles and each of its 384
// threads owns one output column for all of them.
//
// Bound: float64 FMAs (9.6 G at 3840x2160) and the reads of M, which every
// block streams once from L2 (1.2 MB). Staging kMcus MCUs per block divides
// the M traffic by kMcus. The sum is float64 so that no coefficient near
// x.5 rounds differently from jpegtpu's reference (see fused_dctq.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 16 * 16 * 3;    // MCU pixels, (y, x, c) row-major
constexpr int kOut = 6 * 64;        // 6 blocks x 64 zigzag slots
constexpr int kRowBytes = 16 * 3;   // one MCU row of pixels
constexpr int kMcus = 8;            // MCUs per thread block
constexpr int kSmemBytes = kIn * kMcus * sizeof(double);   // 48 KiB

__global__ void __launch_bounds__(kOut)
pixel_420_kernel(const uint8_t* __restrict__ img, const float* __restrict__ m,
                 const float* __restrict__ bias, int32_t* __restrict__ out,
                 long long n_mcu, long long nrx, long long row_bytes) {
  extern __shared__ double px[];    // [kIn][kMcus]
  const long long m0 = (long long)blockIdx.x * kMcus;
  for (int t = threadIdx.x; t < kIn * kMcus; t += blockDim.x) {
    const int k = t / kIn;          // MCU within the block
    const int i = t - k * kIn;      // pixel byte within the MCU
    const long long mcu = m0 + k;
    double v = 0.0;
    if (mcu < n_mcu) {
      const long long r = mcu / nrx, c = mcu - r * nrx;
      const int y = i / kRowBytes, xc = i - y * kRowBytes;
      v = (double)img[(r * 16 + y) * row_bytes + c * kRowBytes + xc];
    }
    px[i * kMcus + k] = v;
  }
  __syncthreads();

  const int col = threadIdx.x;
  double acc[kMcus];
#pragma unroll
  for (int k = 0; k < kMcus; ++k) acc[k] = 0.0;
  for (int i = 0; i < kIn; ++i) {
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

}  // namespace

extern "C" int jt_pixel_420(const uint8_t* img, const float* m,
                            const float* bias, int32_t* out, long long n_mcu,
                            long long nrx, long long row_bytes,
                            cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  const long long blocks = (n_mcu + kMcus - 1) / kMcus;
  pixel_420_kernel<<<(unsigned)blocks, kOut, kSmemBytes, stream>>>(
      img, m, bias, out, n_mcu, nrx, row_bytes);
  return (int)cudaGetLastError();
}
