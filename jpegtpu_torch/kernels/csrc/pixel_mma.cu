// K1 (jt_pixel), K12 (jt_pixel_dc) and K13 (jt_pixel_i8): RGB images ->
// int32 quantized zigzag coefficients of every MCU, round_half_away(tile .
// M + bias), by the factored float64 tensor-core product of
// pixel_common.cuh (mma.sync m16n8k8 .f64 on the operator's two factors,
// lum [192, 64] and chroma [G * 3, 128]), for the fused geometries of
// jpegtpu_torch.kernels.fused_dctq.mcu_operator:
//
//   4:2:0          16x16 MCU, 4 luma blocks, G = 64 2x2 groups, 384 outputs
//   4:2:2          8x16 MCU,  2 luma blocks, G = 64 1x2 groups, 256 outputs
//   4:4:4          8x8 MCU,   1 luma block,  G = 64 1x1 groups, 192 outputs
//   4:4:4s         8x8 MCU,   1 luma block,  G = 16 2x2 groups, 192 outputs
//
// The input is the tall view [n * h, W, 3] of n images of h rows each, my
// = ceil(h / mh) MCU rows an image (the launcher's arguments h and my; an
// image or batch padded to whole MCUs passes h = my * mh). Where h
// is not whole MCUs (1080 rows at 4:2:0) the staging reads each image's
// rows past h from their numpy-symmetric mirror (Staging::fetch with
// kRowFold), so no padded copy is made first; on whole MCUs the mirror is
// never taken and the same bytes are read.
//
// Two compile-time options of either body (both off for K1):
//   kDc  K12 also writes the DC plane dc [n_mcu, 8] int32, dc[:, k] the
//        coefficient of column 64k and lanes B..7 zero, in the epilogue
//        (store_tile, store_half), every geometry; replaces
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
// consecutive MCUs, in one of two bodies that the launcher picks by
// geometry at compile time (Halves<F>::kTakes; jt_pixel_split reports it).
//
// The half-operator body (pixel_mma_kernel_halves: 4:2:0 and 4:4:4, K1,
// K12 and K13 alike). A work item is a tile and a column half: half 0 is
// columns 0-31 of every luma block and Cb's 64, half 1 columns 32-63 and
// Cr's 64, half the multiply-adds each. Block b keeps half b % 2 of the
// operator as float64 fragments in shared memory, converted once at its
// start (the whole operator in float64, 294,912 bytes at 4:2:0, is past a
// block's 232,448), so the product reads B as doubles and converts nothing;
// it takes that half of tiles b / 2, b / 2 + grid / 2, ..., so the two
// halves of a tile run on neighbouring blocks at about the same time and
// the second read of its pixels comes from L2. 4 producer warps (one a
// sub-partition) fetch each tile into registers (Staging::fetch with the
// row fold), stage it and form its group sums in a two-stage ring (full and
// empty mbarriers); 12 consumer warps each keep one 16 x 32 warp tile of
// the half for the whole launch (4:2:0: 8 luma + 4 chroma, 4:4:4: 4 + 8;
// three a sub-partition), multiply, and round and store while the producers
// fill the other stage.
//
// The f32-fragment body (pixel_mma_kernel: 4:2:2 and 4:4:4s) keeps the whole
// operator in f32 fragments (pixel_common.cuh's tile_product, each B value
// converted at every use); 12 warps stage each tile, each thread fetching
// its pieces of the next tile into registers before the current tile's
// product, then form the sums and run the product in 32 x 32 warp tiles.
// K11 (fused_px_bp.cu) and K14 (pixel_dma.cu) run that product too.
//
// Bound: the float64 tensor-core rate. 4:2:0 needs 73,728 multiply-adds an
// MCU (4.78 GFLOP at 3840x2160, 0.071 ms at 67 TFLOP/s) against 25 MB of
// pixels in and 49.8 MB of coefficients out (0.022 ms at 3.35 TB/s; K12's
// plane adds 1.04 MB); a half work item is 1,179,648 multiply-adds at
// 4:2:0 (and at 4:4:4), 9,216 clocks of an SM's 128 a clock.
//
// Shared memory, a block (232,448 bytes at most; one block an SM; the same
// for every option):
//   4:2:0   halves, kTile 32: f64 half operator 147,456 + bias 1,536 + ring
//           2 x (pixels 24,576 + sums 13,312) + 4 mbarriers 32 = 224,800
//   4:4:4   halves, kTile 64: 147,456 + 768 + 2 x (12,288 + 26,624) + 32
//           = 226,080
//   4:2:2   f32 body, kTile 96: f32 operator 147,456 + sums 39,936 + pixels
//           36,864 = 224,256 (a ring of two 96-MCU stages beside the half,
//           147,456 + 2 x 76,800, is past the limit)
//   4:4:4s  f32 body, kTile 128: 73,728 + 12,288 + 24,576 = 110,592 (8 luma
//           and 16 chroma warp tiles of K 48, no depth of the half's warp
//           tiles)
//
// ptxas -v (sm_90a, CUDA 12.8): the half-operator body, 512 threads, 128
// registers (127 for K12), no spill, 2 barriers, in K1, K12 and K13 at
// both geometries; the f32-fragment body, 384 threads, 168 registers with
// spills: 4:2:2 K1 264 / 72 bytes of spill stores / loads (K12 420 / 132),
// 4:4:4s 152 / 56 (K12 296 / 104).

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "pixel_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The f32-fragment body (4:2:2, 4:4:4s): pixel_common.cuh's tile_product.

constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

template <int kMh, int kMw, int kGroups, int kTile, bool kI8, bool kDc>
__global__ void __launch_bounds__(kThreads, 1)
pixel_mma_kernel(const uint8_t* __restrict__ img,
                 const float* __restrict__ lum,
                 const float* __restrict__ chroma,
                 const float* __restrict__ bias, int32_t* __restrict__ out,
                 int32_t* __restrict__ dc, long long n_mcu, unsigned nrx,
                 long long row_bytes, unsigned h, unsigned my,
                 long long n_tiles) {
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
    S::template fetch<kI8, true>(r, img, tile * kTile, n_mcu, nrx,
                                     row_bytes, h, my);
  for (; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();            // the last tile's product is done with px
#pragma unroll
    for (int i = 0; i < S::kPerThread; ++i)
      pieces[threadIdx.x + i * kThreads] = r[i];
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      S::template fetch<kI8, true>(r, img, next * kTile, n_mcu, nrx,
                                       row_bytes, h, my);
    __syncthreads();
    jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
    __syncthreads();
    jt::tile_product<F, kDc>(px, sums, lum_f, chroma_f, bias, out,
                             tile * kTile, n_mcu, threadIdx.x / 32, kWarps,
                             threadIdx.x % 32, dc);
  }
}

// ---------------------------------------------------------------------------
// The half-operator body (4:2:0, 4:4:4).

constexpr int kConsumers = 12;        // warps that multiply, a warp tile each
constexpr int kProducers = 4;         // warps that stage, one a sub-partition
constexpr int kProducerThreads = kProducers * 32;
constexpr int kHalvesThreads = (kConsumers + kProducers) * 32;
constexpr int kStages = 2;
constexpr int kWarpN = 4;             // a warp tile: 16 rows, kWarpN n8 tiles

// A half's layout in shared memory, in this order:
//   lum     f64 fragments of lum[:, 32 half .. + 31], [192, 32]
//   chroma  f64 fragments of chroma[:, 64 half .. + 63], [G * 3, 64]
//   bias    f64 [kHalfCols]: the half's columns, luma block by block, then
//           its chroma channel
//   stages  kStages x (sums u16 [kTile][kSumStride], pixels u8 [kMh][kTile *
//           kRowBytes])
//   full, empty  an mbarrier a stage each
template <typename F>
struct Halves {
  static constexpr int kRows = 16, kCols = 8 * kWarpN;
  static constexpr int kLumaTiles =
      F::kLuma * (F::kTile / kRows) * (32 / kCols);
  static constexpr int kChromaTiles = (F::kTile / kRows) * (64 / kCols);
  static constexpr int kHalfCols = F::kLuma * 32 + 64;
  static constexpr int kLumDoubles = 192 * 32;
  static constexpr int kChromaDoubles = F::kChromaK * 64;
  static constexpr int kBiasOffset = (kLumDoubles + kChromaDoubles) * 8;
  static constexpr int kStageOffset = kBiasOffset + kHalfCols * 8;
  static constexpr int kStageBytes = F::kSumBytes + F::kTileBytes;
  static constexpr int kBarrierOffset = kStageOffset + kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarrierOffset + 2 * kStages * 8;
  // The geometries this body takes: the ring fits beside the half, and the
  // half is kConsumers warp tiles of one depth (K 192), so each consumer
  // warp keeps one warp tile, and the four sub-partitions equal work, for
  // the whole launch.
  static constexpr bool kTakes = kSmemBytes <= 232448 &&
                                 kLumaTiles + kChromaTiles == kConsumers &&
                                 F::kChromaK == 192;
  static_assert(kStageOffset % 16 == 0 && kStageBytes % 16 == 0 &&
                    F::kSumBytes % 16 == 0,
                "alignment");
};

// Columns c0 .. c0 + kN - 1 of the f32 operator src [kK, kSrcN] as float64
// fragments, converted once: double2 ((j * (kN / 8) + nt) * 2 + p) * 32 +
// lane holds B[16j + 4t + 2p + i][c0 + 8nt + g], i = 0, 1, the two B values
// of lane (g, t) in k-step 2j + p (the K order of load_fragments). Unrolled,
// so each thread has several loads in flight.
template <int kK, int kN, int kSrcN>
__device__ __forceinline__ void load_half(double* dst,
                                          const float* __restrict__ src,
                                          int c0, int tid) {
  constexpr int kNts = kN / 8;
  static_assert(kK * kN % kHalvesThreads == 0, "whole rounds");
#pragma unroll 6
  for (int e = tid; e < kK * kN; e += kHalvesThreads) {
    const int i = e & 1, lane = (e >> 1) & 31, p = (e >> 6) & 1;
    const int rest = e >> 7, nt = rest % kNts, j = rest / kNts;
    dst[e] = (double)__ldg(src + (16 * j + 4 * (lane & 3) + 2 * p + i) *
                                     kSrcN + c0 + 8 * nt + (lane >> 2));
  }
}

// One warp tile over kJ pairs of k-steps (K = 16 kJ), as jt::warp_gemm but
// one m16 row of kWarpN n8 tiles and B read as doubles: load(j, hh, v)
// returns the four K values 16j + 4t .. + 3 of the tile's row g + 8hh; bf is
// this lane's double2 of j = 0, p = 0 at the tile's first n8 tile, kNts n8
// tiles across the half's operator.
template <int kJ, int kNts, typename Load>
__device__ __forceinline__ void half_gemm(double (&acc)[kWarpN][4],
                                          Load load, const double2* bf) {
#pragma unroll
  for (int nt = 0; nt < kWarpN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    double a[2][4];                   // [k-step 2j + p][fragment]
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      double v[4];
      load(j, hh, v);
      a[0][hh] = v[0];
      a[0][2 + hh] = v[1];
      a[1][hh] = v[2];
      a[1][2 + hh] = v[3];
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      double2 b[kWarpN];
#pragma unroll
      for (int nt = 0; nt < kWarpN; ++nt)
        b[nt] = bf[(j * kNts + nt) * 64 + p * 32];
#pragma unroll
      for (int nt = 0; nt < kWarpN; ++nt)
        jt::dmma_16x8x8(acc[nt], a[p], b[nt].x, b[nt].y);
    }
  }
}

// Bias, round half away and the coefficients of one warp tile, as
// jt::store_tile: row r is MCU m0 + k0 + r, column c output column col0 + c
// and bias column bcol0 + c of the half; with kDc the DC plane too.
template <typename F, bool kDc>
__device__ __forceinline__ void store_half(
    const double (&acc)[kWarpN][4], const double* bias_h,
    int32_t* __restrict__ out, int32_t* __restrict__ dc, long long m0,
    int k0, int col0, int bcol0, long long n_mcu, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kWarpN; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    const double2 b =
        *reinterpret_cast<const double2*>(bias_h + bcol0 + nt * 8 + 2 * t);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long mcu = m0 + k0 + hh * 8 + g;
      if (mcu < n_mcu) {
        const int2 q =
            make_int2(jt::round_half_away(acc[nt][2 * hh] + b.x),
                      jt::round_half_away(acc[nt][2 * hh + 1] + b.y));
        *reinterpret_cast<int2*>(out + mcu * F::kOut + col) = q;
        if constexpr (kDc) {
          if (col % 64 == 0) {
            const int blk = col / 64;
            int32_t* row = dc + mcu * jt::kDcLanes;
            row[blk] = q.x;
            if (blk == F::kBlocks - 1) {
              for (int k = F::kBlocks; k < jt::kDcLanes; ++k) row[k] = 0;
            }
          }
        }
      }
    }
  }
}

// Producer warps only.
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
}

// Block b holds half b % 2 of the operator and takes that half of tiles
// b / 2, b / 2 + gridDim.x / 2, ... (the grid is even): the two halves of a
// tile go to neighbouring blocks at about the same time, so the tile is
// read from device memory about once and from L2 the second time.
template <int kMh, int kMw, int kGroups, int kTile, bool kI8, bool kDc>
__global__ void __launch_bounds__(kHalvesThreads, 1)
pixel_mma_kernel_halves(const uint8_t* __restrict__ img,
                        const float* __restrict__ lum,
                        const float* __restrict__ chroma,
                        const float* __restrict__ bias,
                        int32_t* __restrict__ out, int32_t* __restrict__ dc,
                        long long n_mcu, unsigned nrx, long long row_bytes,
                        unsigned h, unsigned my, long long n_tiles) {
  using F = jt::Factored<kMh, kMw, kGroups, kTile>;
  using H = Halves<F>;
  using S = jt::Staging<F, kProducerThreads>;
  extern __shared__ __align__(16) unsigned char smem[];
  double* lum_h = reinterpret_cast<double*>(smem);
  double* chroma_h = lum_h + H::kLumDoubles;
  double* bias_h = reinterpret_cast<double*>(smem + H::kBiasOffset);
  unsigned char* stages = smem + H::kStageOffset;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + H::kBarrierOffset);
  uint64_t* empty = full + kStages;
  const int half = blockIdx.x & 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_half<192, 32, 64>(lum_h, lum, 32 * half, threadIdx.x);
  load_half<F::kChromaK, 64, 128>(chroma_h, chroma, 64 * half, threadIdx.x);
  for (int c = threadIdx.x; c < H::kHalfCols; c += kHalvesThreads) {
    const int lum_cols = F::kLuma * 32;
    bias_h[c] = (double)bias[c < lum_cols
                                 ? c / 32 * 64 + 32 * half + c % 32
                                 : F::kLuma * 64 + 64 * half + c - lum_cols];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      jt::mbar_init(full + s, kProducerThreads);
      jt::mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long first = blockIdx.x >> 1, stride = gridDim.x >> 1;
  if (warp < kProducers) {    // fetch, stage and sum each tile of the half
    int it = 0;
    for (long long tile = first; tile < n_tiles; tile += stride, ++it) {
      const int s = it % kStages;
      typename S::Piece r[S::kPerThread];
      S::template fetch<kI8, true>(r, img, tile * kTile, n_mcu, nrx,
                                       row_bytes, h, my);
      if (it >= kStages) jt::mbar_wait(empty + s, ((it / kStages) - 1) & 1);
      unsigned char* stage = stages + s * H::kStageBytes;
      uint8_t* px = stage + F::kSumBytes;
      auto* pieces = reinterpret_cast<typename S::Piece*>(px);
#pragma unroll
      for (int i = 0; i < S::kPerThread; ++i)
        pieces[threadIdx.x + i * kProducerThreads] = r[i];
      producers_sync();
      jt::group_sums<F>(px, reinterpret_cast<uint16_t*>(stage), threadIdx.x,
                        kProducerThreads);
      jt::mbar_arrive(full + s);
    }
    return;
  }

  // This consumer warp's tile of the half, the same for every tile: rows
  // k0 .. k0 + kRows - 1 of the tile's MCUs, columns c .. c + kCols - 1 of
  // one luma block's half or of the chroma half.
  const int w = warp - kProducers, g = lane >> 2, t = lane & 3;
  const bool luma = w < H::kLumaTiles;
  int k0, col0, bcol0, a_off;
  const double2* bf;
  if (luma) {
    constexpr int kPerBlock = (F::kTile / H::kRows) * (32 / H::kCols);
    const int blk = w / kPerBlock, r = w - blk * kPerBlock;
    const int c = r % (32 / H::kCols) * H::kCols;
    const int by = blk / F::kBlocksX, bx = blk - by * F::kBlocksX;
    k0 = r / (32 / H::kCols) * H::kRows;
    col0 = blk * 64 + 32 * half + c;
    bcol0 = blk * 32 + c;
    bf = reinterpret_cast<const double2*>(lum_h) + c / 8 * 64 + lane;
    a_off = by * 8 * F::kStripRow + bx * 24 + (k0 + g) * F::kRowBytes;
  } else {
    const int cw = w - H::kLumaTiles;
    const int c = cw % (64 / H::kCols) * H::kCols;
    k0 = cw / (64 / H::kCols) * H::kRows;
    col0 = F::kLuma * 64 + 64 * half + c;
    bcol0 = F::kLuma * 32 + c;
    bf = reinterpret_cast<const double2*>(chroma_h) + c / 8 * 64 + lane;
    a_off = (k0 + g) * F::kSumStride;
  }
  int it = 0;
  for (long long tile = first; tile < n_tiles; tile += stride, ++it) {
    const int s = it % kStages;
    const unsigned char* stage = stages + s * H::kStageBytes;
    double acc[kWarpN][4];
    jt::mbar_wait(full + s, (it / kStages) & 1);
    if (luma) {
      const uint8_t* base = stage + F::kSumBytes + a_off;
      auto load = [&](int j, int hh, double (&v)[4]) {
        const int q = 16 * j + 4 * t;          // K index (y, x, c) in block
        const int y = q / 24;
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            base + hh * 8 * F::kRowBytes + y * F::kStripRow + q - y * 24);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = jt::small_to_f64(__byte_perm(word, 0, 0x4440 + i));
      };
      half_gemm<12, 4>(acc, load, bf);
    } else {
      const uint16_t* base =
          reinterpret_cast<const uint16_t*>(stage) + a_off;
      auto load = [&](int j, int hh, double (&v)[4]) {
        const uint2 word = *reinterpret_cast<const uint2*>(
            base + hh * 8 * F::kSumStride + 16 * j + 4 * t);
        v[0] = jt::small_to_f64(word.x & 0xFFFF);
        v[1] = jt::small_to_f64(word.x >> 16);
        v[2] = jt::small_to_f64(word.y & 0xFFFF);
        v[3] = jt::small_to_f64(word.y >> 16);
      };
      half_gemm<F::kChromaK / 16, 8>(acc, load, bf);
    }
    __syncwarp();                   // the stage is read; the store is not
    if (lane == 0) jt::mbar_arrive(empty + s);
    store_half<F, kDc>(acc, bias_h, out, dc, tile * kTile, k0, col0, bcol0,
                       n_mcu, lane);
  }
}

template <int kMh, int kMw, int kGroups, int kTile, bool kI8, bool kDc>
int launch(const uint8_t* img, const float* lum, const float* chroma,
           const float* bias, int32_t* out, int32_t* dc, long long n_mcu,
           long long nrx, long long row_bytes, long long h, long long my,
           cudaStream_t stream) {
  using F = jt::Factored<kMh, kMw, kGroups, kTile>;
  using H = Halves<F>;
  if ((reinterpret_cast<uintptr_t>(img) | (uintptr_t)row_bytes) %
      jt::Staging<F, kThreads>::kBytes)
    return (int)cudaErrorMisalignedAddress;
  const long long n_tiles = (n_mcu + kTile - 1) / kTile;
  int grid = 0;
  if constexpr (H::kTakes) {
    const auto kernel =
        pixel_mma_kernel_halves<kMh, kMw, kGroups, kTile, kI8, kDc>;
    const int err = jt::resident_blocks(kernel, kHalvesThreads,
                                        H::kSmemBytes, &grid);
    if (err) return err;
    grid = grid < 2 ? 2 : grid & ~1;              // pairs of blocks
    if (2 * n_tiles < grid) grid = (int)(2 * n_tiles);
    kernel<<<grid, kHalvesThreads, H::kSmemBytes, stream>>>(
        img, lum, chroma, bias, out, dc, n_mcu, (unsigned)nrx, row_bytes,
        (unsigned)h, (unsigned)my, n_tiles);
  } else {
    using S = jt::Staging<F, kThreads>;
    const auto kernel = pixel_mma_kernel<kMh, kMw, kGroups, kTile, kI8, kDc>;
    const int err =
        jt::resident_blocks(kernel, kThreads, S::kSmemBytes, &grid);
    if (err) return err;
    if (n_tiles < grid) grid = (int)n_tiles;
    kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
        img, lum, chroma, bias, out, dc, n_mcu, (unsigned)nrx, row_bytes,
        (unsigned)h, (unsigned)my, n_tiles);
  }
  return (int)cudaGetLastError();
}

// fn(F()) for the Factored instance of a geometry (an mh x mw MCU, `groups`
// chroma groups), or `refused` for a geometry no instance takes.
template <typename Fn>
int for_geometry(int mh, int mw, int groups, int refused, Fn fn) {
  if (mh == 16 && mw == 16 && groups == 64)
    return fn(jt::Factored<16, 16, 64, 32>());
  if (mh == 8 && mw == 16 && groups == 64)
    return fn(jt::Factored<8, 16, 64, 96>());
  if (mh == 8 && mw == 8 && groups == 64)
    return fn(jt::Factored<8, 8, 64, 64>());
  if (mh == 8 && mw == 8 && groups == 16)
    return fn(jt::Factored<8, 8, 16, 128>());
  return refused;
}

// The geometry's instance, after the checks every launcher makes. h and my
// are one image's rows and MCU rows: n_mcu has to cover whole images of my
// MCU rows of nrx MCUs, h has to be past (my - 1) * mh and at most my * mh,
// and the pad my * mh - h shorter than h (numpy's symmetric mirror; its
// edge case is refused).
template <bool kI8, bool kDc>
int dispatch(const uint8_t* img, const float* lum, const float* chroma,
             const float* bias, int32_t* out, int32_t* dc, long long n_mcu,
             long long nrx, long long row_bytes, long long h, long long my,
             int mh, int mw, int groups, cudaStream_t stream) {
  if (n_mcu <= 0) return 0;
  if (n_mcu >= (1LL << 31) || nrx <= 0 || nrx >= (1LL << 31) || my <= 0 ||
      my >= (1LL << 31) || h >= (1LL << 30) || h <= (my - 1) * mh ||
      h > my * mh || 2 * h <= my * mh || n_mcu % (my * nrx))
    return (int)cudaErrorInvalidValue;
  return for_geometry(
      mh, mw, groups, (int)cudaErrorInvalidValue, [&](auto f) {
        using F = decltype(f);
        if constexpr (kI8 && F::kMcuH != 16) {
          return (int)cudaErrorInvalidValue;     // 4:2:0 only
        } else {
          return launch<F::kMcuH, F::kBlocksX * 8, F::kChromaK / 3,
                        F::kTile, kI8, kDc>(img, lum, chroma, bias, out, dc,
                                            n_mcu, nrx, row_bytes, h, my,
                                            stream);
        }
      });
}

}  // namespace

// mh x mw is the MCU in pixels and groups the chroma groups G of its
// operator: 16x16 / 64 (4:2:0), 8x16 / 64 (4:2:2), 8x8 / 64 (4:4:4) or
// 8x8 / 16 (4:4:4s); any other geometry is refused before a launch. img is
// at a 16-byte (8x8 MCUs: 8-byte) aligned address, row pitch row_bytes =
// W * 3: the tall view [n * h, W, 3] of n images of h rows, my = ceil(h /
// mh) MCU rows each (whole MCUs: h = my * mh, a padded image or batch),
// whose last MCU row the kernel completes with the mirrored rows; n_mcu
// = n * my * nrx; lum [192, 64] and chroma [G * 3, 128] f32.
extern "C" int jt_pixel(const uint8_t* img, const float* lum,
                        const float* chroma, const float* bias, int32_t* out,
                        long long n_mcu, long long nrx, long long row_bytes,
                        long long h, long long my, int mh, int mw,
                        int groups, cudaStream_t stream) {
  return dispatch<false, false>(img, lum, chroma, bias, out, nullptr, n_mcu,
                                nrx, row_bytes, h, my, mh, mw, groups,
                                stream);
}

// jt_pixel, and the DC plane into dc [n_mcu, 8] int32.
extern "C" int jt_pixel_dc(const uint8_t* img, const float* lum,
                           const float* chroma, const float* bias,
                           int32_t* out, int32_t* dc, long long n_mcu,
                           long long nrx, long long row_bytes, long long h,
                           long long my, int mh, int mw, int groups,
                           cudaStream_t stream) {
  return dispatch<false, true>(img, lum, chroma, bias, out, dc, n_mcu, nrx,
                               row_bytes, h, my, mh, mw, groups, stream);
}

// jt_pixel at 4:2:0 on the centred int8 view [rows, 16, nrx, 48] of the
// padded image: row_bytes = nrx * 48, one image of n_mcu / nrx whole MCU
// rows.
extern "C" int jt_pixel_i8(const int8_t* img, const float* lum,
                           const float* chroma, const float* bias,
                           int32_t* out, long long n_mcu, long long nrx,
                           long long row_bytes, cudaStream_t stream) {
  return dispatch<true, false>(reinterpret_cast<const uint8_t*>(img), lum,
                               chroma, bias, out, nullptr, n_mcu, nrx,
                               row_bytes, nrx > 0 ? n_mcu / nrx * 16 : 0,
                               nrx > 0 ? n_mcu / nrx : 0, 16, 16, 64,
                               stream);
}

// The dynamic shared memory a block takes for a geometry (0 for one it
// refuses), the same for every option, for reports.
extern "C" int jt_pixel_smem(int mh, int mw, int groups) {
  return for_geometry(mh, mw, groups, 0, [](auto f) {
    using F = decltype(f);
    if constexpr (Halves<F>::kTakes) return Halves<F>::kSmemBytes;
    else return jt::Staging<F, kThreads>::kSmemBytes;
  });
}

// 1 where a geometry takes the half-operator body (4:2:0 and 4:4:4), 0
// where it keeps the f32-fragment body (4:2:2, 4:4:4s) or is refused.
extern "C" int jt_pixel_split(int mh, int mw, int groups) {
  return for_geometry(mh, mw, groups, 0, [](auto f) {
    return (int)Halves<decltype(f)>::kTakes;
  });
}
