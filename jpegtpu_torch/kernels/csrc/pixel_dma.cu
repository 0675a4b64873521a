// Async-copy pixel kernel (4:2:0): the padded u8 RGB image stays in global
// memory and each block stages its own input with asynchronous copies,
// double-buffered, then computes the same coefficients as pixel.cu:
// round_half_away(tile[768] . M[768, 384] + bias), float64 sum in
// pixel_common.cuh's fixed order.
//
// Replaces jpegtpu/kernels/fused_dctq.py:_pixel_kernel_dma (called from
// encode_blocks_pallas_dma_pairs), whose grid steps DMA one slab of MCU
// rows from HBM into VMEM (double-buffered by the kernel, with semaphores)
// while the previous slab is multiplied. Here a grid of at most as many
// blocks as fit on the card at once walks the MCUs in strips of kMcus
// (MCUs strip*kMcus .. +kMcus-1 in raster order; a strip may cross an MCU
// row, and the last may be short): the 16-byte cp.async copies of the
// block's next strip (each MCU is 16 rows of 48 bytes, three copies a row)
// are in flight while it converts and multiplies the current one.
// cp.async needs 16-byte aligned addresses: the row pitch W*3 of a 4:2:0
// image is a multiple of 48, an MCU starts at a multiple of 48 bytes in its
// row, and the wrapper hands over a 16-byte aligned base.
//
// Bound: as pixel.cu, the float64 FMAs; the image is read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pixel_common.cuh"

namespace {

constexpr int kMh = 16, kMw = 16, kOut = 384;
constexpr int kMcus = 8;                              // MCUs per strip
using G = jt::PixelGeometry<kMh, kMw, kOut>;
constexpr int kCopiesPerRow = G::kRowBytes / 16;      // 3
constexpr int kCopies = kMcus * kMh * kCopiesPerRow;  // per strip: 384
constexpr int kStripBytes = kMcus * G::kIn;           // u8, [kMcus][kIn]
constexpr int kPxBytes = G::kIn * kMcus * (int)sizeof(double);
constexpr int kSmemBytes = kPxBytes + 2 * kStripBytes;
static_assert(G::kRowBytes % 16 == 0 && kStripBytes % 16 == 0, "alignment");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the most recent) is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start this thread's copies of strip `strip` into raw [kMcus][kIn].
__device__ __forceinline__ void start_strip(const uint8_t* img, uint8_t* raw,
                                            long long strip, long long n_mcu,
                                            long long nrx,
                                            long long row_bytes) {
  for (int t = threadIdx.x; t < kCopies; t += blockDim.x) {
    const int k = t / (kMh * kCopiesPerRow);
    const int rem = t - k * (kMh * kCopiesPerRow);
    const int y = rem / kCopiesPerRow, part = rem - y * kCopiesPerRow;
    const long long mcu = strip * kMcus + k;
    if (mcu < n_mcu) {
      const long long r = mcu / nrx, c = mcu - r * nrx;
      cp_async16(raw + k * G::kIn + y * G::kRowBytes + part * 16,
                 img + (r * kMh + y) * row_bytes + c * G::kRowBytes +
                     part * 16);
    }
  }
}

__global__ void __launch_bounds__(kOut)
pixel_dma_kernel(const uint8_t* __restrict__ img, const float* __restrict__ m,
                 const float* __restrict__ bias, int32_t* __restrict__ out,
                 long long n_mcu, long long nrx, long long row_bytes,
                 long long n_strips) {
  extern __shared__ double px[];    // [kIn][kMcus], then two raw strips
  uint8_t* raw = (uint8_t*)(px + G::kIn * kMcus);
  const int col = threadIdx.x;
  const double b = (double)bias[col];
  long long strip = blockIdx.x;
  if (strip < n_strips) start_strip(img, raw, strip, n_mcu, nrx, row_bytes);
  cp_async_commit();
  for (int it = 0; strip < n_strips; ++it, strip += gridDim.x) {
    const long long next = strip + gridDim.x;
    if (next < n_strips)
      start_strip(img, raw + ((it + 1) & 1) * kStripBytes, next, n_mcu, nrx,
                  row_bytes);
    cp_async_commit();
    cp_async_wait_all_but_one();      // this thread's copies of `strip`
    __syncthreads();                  // ... and every other thread's
    const uint8_t* cur = raw + (it & 1) * kStripBytes;
    for (int t = threadIdx.x; t < G::kIn * kMcus; t += blockDim.x) {
      const int k = t / G::kIn, i = t - k * G::kIn;
      px[i * kMcus + k] = (double)cur[k * G::kIn + i];
    }
    // After this barrier the raw strip is free for the copies started at the
    // top of the next iteration; the barrier there keeps px until every
    // thread has finished this strip's product.
    __syncthreads();
    double acc[kMcus];
    jt::mcu_product<G::kIn, kOut, kMcus>(px, m, col, acc);
#pragma unroll
    for (int k = 0; k < kMcus; ++k) {
      const long long mcu = strip * kMcus + k;
      if (mcu < n_mcu) out[mcu * kOut + col] = jt::round_half_away(acc[k] + b);
    }
  }
}

}  // namespace

// The 4:2:0 image [rows * 16, nrx * 16, 3] u8 at a 16-byte aligned address,
// row pitch row_bytes = nrx * 48.
extern "C" int jt_pixel_dma(const uint8_t* img, const float* m,
                            const float* bias, int32_t* out, long long n_mcu,
                            long long nrx, long long row_bytes,
                            cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(img) & 15) || row_bytes % 16)
    return (int)cudaErrorMisalignedAddress;
  static int grid_cap = 0;          // blocks resident on the card at once
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        pixel_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, pixel_dma_kernel, kOut, kSmemBytes)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap = sms * per_sm;
  }
  const long long n_strips = (n_mcu + kMcus - 1) / kMcus;
  const long long blocks = n_strips < grid_cap ? n_strips : grid_cap;
  pixel_dma_kernel<<<(unsigned)blocks, kOut, kSmemBytes, stream>>>(
      img, m, bias, out, n_mcu, nrx, row_bytes, n_strips);
  return (int)cudaGetLastError();
}
