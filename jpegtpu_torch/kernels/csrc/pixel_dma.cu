// K14, jt_pixel_dma (4:2:0): the coefficients of pixel_mma.cu's K1, by the
// same factored float64 tensor-core product (pixel_common.cuh), with the
// pixels brought into shared memory by Hopper's bulk copies.
//
// Replaces jpegtpu/kernels/fused_dctq.py:_pixel_kernel_dma (called from
// encode_blocks_pallas_dma_pairs), whose grid steps DMA one slab of MCU rows
// from HBM into VMEM (make_async_copy, double-buffered, with semaphores)
// while the previous slab is multiplied. Here a persistent grid (the blocks
// that fit on the card at once, set up per device) walks tiles of 32
// consecutive MCUs in a ring of two stages. One producer warp issues, for
// each stage, one cp.async.bulk (global -> shared, completing on the stage's
// "full" mbarrier with the byte count) per pixel row of each run of the
// tile's MCUs that lies in one MCU row: that run of 16 rows is contiguous
// in each row, kMcus * 48 bytes, 16-byte aligned (the row pitch W * 3 is a
// multiple of 48 and the wrapper hands over a 16-byte aligned image), so a
// 1-D bulk copy needs no tensor map. Twelve consumer warps wait on "full",
// form the group sums, run the product and arrive on the stage's "empty"
// mbarrier, which the producer waits on before it refills the stage.
//
// Bound: as K1, the float64 tensor-core rate (0.071 ms at 3840x2160); the
// image is read once.
//
// Shared memory (one block an SM, 13 warps; ptxas gives them 128 registers a
// thread and spills a few): operators 147,456 + sums 13,312 + two stages of 24,576 + four
// mbarriers 32 = 209,952 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "pixel_common.cuh"

namespace {

constexpr int kTile = 32;
using F = jt::Factored<16, 16, 64, kTile>;
constexpr int kStages = 2;
constexpr int kConsumers = 12;                 // warps that multiply
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kBarrierOffset = F::kPixelOffset + kStages * F::kTileBytes;
constexpr int kSmemBytes = kBarrierOffset + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Consumer warps only (the producer runs its own loop).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
pixel_dma_kernel(const uint8_t* __restrict__ img,
                 const float* __restrict__ lum,
                 const float* __restrict__ chroma,
                 const float* __restrict__ bias, int32_t* __restrict__ out,
                 long long n_mcu, unsigned nrx, long long row_bytes,
                 long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* lum_f = reinterpret_cast<float4*>(smem);
  float4* chroma_f = lum_f + F::kLumFloats / 4;
  uint16_t* sums = reinterpret_cast<uint16_t*>(smem + F::kOpBytes);
  uint8_t* stage = smem + F::kPixelOffset;      // [kStages][kTileBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarrierOffset);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  jt::load_fragments(lum_f, lum, 192, 64, threadIdx.x, kThreads);
  jt::load_fragments(chroma_f, chroma, F::kChromaK, 128, threadIdx.x,
                     kThreads);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {                     // the producer warp
    int it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles;
         tile += gridDim.x, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty + s, ((it / kStages) - 1) & 1);
      const long long m0 = tile * kTile;
      const int valid = (int)(n_mcu - m0 < kTile ? n_mcu - m0 : kTile);
      if (lane == 0) mbar_expect(full + s, (uint32_t)valid * 768);
      __syncwarp();
      uint8_t* dst = stage + s * F::kTileBytes;
      for (int k = 0; k < valid;) {             // runs within one MCU row
        const unsigned mcu = (unsigned)(m0 + k);
        const unsigned row = mcu / nrx, col = mcu - row * nrx;
        const int run = min(valid - k, (int)(nrx - col));
        if (lane < 16)
          bulk_copy(dst + lane * F::kStripRow + k * 48,
                    img + ((long long)row * 16 + lane) * row_bytes +
                        (long long)col * 48,
                    (uint32_t)run * 48, full + s);
        k += run;
      }
    }
    return;
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int s = it % kStages;
    const uint8_t* px = stage + s * F::kTileBytes;
    mbar_wait(full + s, (it / kStages) & 1);
    consumers_sync();           // every consumer is done with the last sums
    jt::group_sums<F>(px, sums, threadIdx.x, kConsumers * 32);
    consumers_sync();
    jt::tile_product<F>(px, sums, lum_f, chroma_f, bias, out, tile * kTile,
                        n_mcu, warp, kConsumers, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
}

}  // namespace

// The 4:2:0 image [rows * 16, nrx * 16, 3] u8 at a 16-byte aligned address,
// row pitch row_bytes = nrx * 48; lum [192, 64] and chroma [192, 128] f32.
extern "C" int jt_pixel_dma(const uint8_t* img, const float* lum,
                            const float* chroma, const float* bias,
                            int32_t* out, long long n_mcu, long long nrx,
                            long long row_bytes, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (n_mcu >= (1LL << 31) || nrx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(img) & 15) || row_bytes % 16)
    return (int)cudaErrorMisalignedAddress;
  int grid = 0;
  const int err =
      jt::resident_blocks(pixel_dma_kernel, kThreads, kSmemBytes, &grid);
  if (err) return err;
  const long long n_tiles = (n_mcu + kTile - 1) / kTile;
  if (n_tiles < grid) grid = (int)n_tiles;
  pixel_dma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      img, lum, chroma, bias, out, n_mcu, (unsigned)nrx, row_bytes, n_tiles);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of jt_pixel_dma takes, for reports.
extern "C" int jt_pixel_dma_smem() { return kSmemBytes; }
