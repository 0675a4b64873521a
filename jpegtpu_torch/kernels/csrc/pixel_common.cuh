// The factored pixel product shared by the pixel kernels (pixel_mma.cu's
// K1, K12 and K13, pixel_dma.cu's K14) and the fused front end
// (fused_px_bp.cu's K11): an MCU's quantized zigzag coefficients are
// round_half_away(tile . M + bias), computed from the two factors of M that
// jpegtpu_torch.kernels.fused_dctq.factor_operator checks M against, on the
// float64 tensor cores (mma.sync m16n8k8 .f64):
//   luma    [n_mcu * kLuma, 192] x lum [192, 64]: one row per 8x8 luma block,
//           its pixels (y, x, c); every luma block has the same operator.
//   chroma  [n_mcu, G * 3] x chroma [G * 3, 128]: one row per MCU, the exact
//           integer sums of its G chroma groups (2x2 pixels in 4:2:0 and
//           4:4:4s, 1x2 in 4:2:2, 1x1 in 4:4:4) per channel; Cb's 64
//           columns, then Cr's.
// 73,728 multiply-adds a 4:2:0 MCU instead of the dense operator's 294,912.
//
// Why any order gives the same integers: factor_operator also checks that in
// every column the bound 255 * sum|w| + |bias| and the finest bit set in a
// weight or the bias are at most 53 bits apart (47 at most over q 1-100 in
// every mode). Every partial sum of u8 (or group-sum) x weight terms is then
// a multiple of that finest bit and no larger than the bound, so it is exact
// in float64: the sum is the exact real value whatever the order, the
// association or the fusing the hardware uses, and so are the dense plain
// twins, the factored plain form and K11's scalar DC dot products.
//
// Products of u8 pixels and f32 operator entries are exact in float64.
//
// The staging (Staging::fetch) reads an image of whole MCUs (K11), or,
// with kRowFold (K1, K12 and K13), the tall view [n * h, W, 3] of n images
// of h rows and my MCU rows each (the launcher's arguments h and my): each
// image's rows past h are read from their numpy-symmetric mirror, so a
// height that is not whole MCUs needs no padded copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace jt {

// a rounded half away from zero: a +- 0.5 truncated (one conversion).
__device__ __forceinline__ int32_t round_half_away(double a) {
  return __double2int_rz(a + copysign(0.5, a));
}

// ---------------------------------------------------------------------------
// The factored product.
//
// A tile is kTile consecutive MCUs in raster order (it may cross MCU rows).
// Shared memory, in this order:
//   lum, chroma  the operators in fragment order, f32 (see load_fragments)
//   sums         u16 [kTile][kSumStride]: the tile's chroma group sums
//   pixels       u8 [kMh][kTile * kRowBytes] per stage: row y of the tile
//                holds row y of its MCUs side by side (a strip of the image
//                when the tile lies in one MCU row)
// Each warp computes 32 x 32 output tiles of the two products (2 m16 x 4 n8
// mma tiles, 32 float64 accumulators a thread).

// Lanes of a DC-plane row (K12): lane k the DC of block k, the rest zero.
constexpr int kDcLanes = 8;

template <int kMh, int kMw, int kGroups, int kTileMcus>
struct Factored {
  static constexpr int kTile = kTileMcus;               // MCUs a tile
  static constexpr int kMcuH = kMh;                     // MCU rows
  static constexpr int kBlocksX = kMw / 8;              // luma blocks a row
  static constexpr int kRowBytes = kMw * 3;             // one MCU row
  static constexpr int kStripRow = kTile * kRowBytes;   // one tile row
  static constexpr int kTileBytes = kMh * kStripRow;    // one tile's pixels
  static constexpr int kLuma = (kMh / 8) * (kMw / 8);   // luma blocks / MCU
  static constexpr int kBlocks = kLuma + 2;             // blocks / MCU
  static constexpr int kOut = kBlocks * 64;
  static constexpr int kSide = kGroups == 64 ? 8 : 4;   // groups a side
  static constexpr int kGy = kMh / kSide, kGx = kMw / kSide;
  static constexpr int kChromaK = kGroups * 3;
  // u16 row pitch of the sums: 8-byte aligned rows on distinct banks.
  static constexpr int kSumStride = kGroups == 64 ? 208 : 48;
  // int16 row pitch of a shared coefficient tile (K11): rows 4 banks apart,
  // so the 8 rows and 4 column pairs of a store_tile quad hit 32 banks.
  static constexpr int kCoefStride = kOut + 8;
  static constexpr int kLumFloats = 192 * 64;
  static constexpr int kChromaFloats = kChromaK * 128;
  static constexpr int kLumaTiles = kLuma * kTile / 32 * 2;
  static constexpr int kChromaTiles = kTile / 32 * 4;
  static constexpr int kWarpTiles = kLumaTiles + kChromaTiles;
  static constexpr int kOpBytes = (kLumFloats + kChromaFloats) * 4;
  static constexpr int kSumBytes = kTile * kSumStride * 2;
  static constexpr int kPixelOffset = kOpBytes + kSumBytes;
  static_assert(kTile % 32 == 0 && kChromaK % 16 == 0, "tile shapes");
  static_assert(kPixelOffset % 16 == 0 && kTileBytes % 16 == 0, "alignment");
};

// u8 or u16 value v -> double, exactly: the bits of 2^52 + v, less 2^52 (one
// float64 add, four times the rate of a conversion instruction).
__device__ __forceinline__ double small_to_f64(uint32_t v) {
  return __hiloint2double(0x43300000, (int)v) - 4503599627370496.0;
}

// d += a . b over one 16x8x8 float64 tile. g = lane / 4, t = lane % 4:
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}. Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4], double b0,
                                            double b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// The K order. The sum is exact in any order, so the product walks K in the
// order that lets a thread load its A values four at a time: in k-steps 2j
// and 2j + 1, slot t of lane t holds K index 16j + 4t and 16j + 4t + 2, slot
// t + 4 holds 16j + 4t + 1 and 16j + 4t + 3. So lane t reads the four
// consecutive K indices 16j + 4t .. + 3 of its rows, and the operators are
// stored to match: float4 ((j * kNt + nt) * 32 + lane) holds B[16j + 4t + i]
// [8nt + g], i = 0..3 (kNt n8 tiles across B's n columns).
__device__ __forceinline__ void load_fragments(float4* dst,
                                               const float* __restrict__ src,
                                               int k, int n, int tid,
                                               int threads) {
  float* d = reinterpret_cast<float*>(dst);
  const int nt_count = n / 8;
  for (int e = tid; e < k * n; e += threads) {
    const int i = e & 3, lane = (e >> 2) & 31, rest = e >> 7;
    const int nt = rest % nt_count, j = rest / nt_count;
    d[e] = __ldg(src + (16 * j + 4 * (lane & 3) + i) * n + nt * 8 +
                 (lane >> 2));
  }
}

// The tile's chroma group sums: sums[k][(gy, gx, c)] = the sum of channel c
// over group (gy, gx) of MCU k, at most 4 * 255. A thread takes one 12-byte
// run of an MCU row (4 pixels: 2 groups of 2 or 4 of 1) and its kGy rows,
// three 4-byte loads a row, and stores the run's kGpc * 3 sums as u16 pairs.
template <typename F>
__device__ __forceinline__ void group_sums(const uint8_t* px, uint16_t* sums,
                                           int tid, int threads) {
  constexpr int kRuns = F::kRowBytes / 12;          // runs an MCU row
  constexpr int kGpc = 12 / (3 * F::kGx);           // groups a run
  constexpr int kRows = F::kMcuH / F::kGy;          // group rows an MCU
  for (int e = tid; e < F::kTile * kRows * kRuns; e += threads) {
    const int k = e / (kRows * kRuns), rem = e - k * (kRows * kRuns);
    const int gy = rem / kRuns, run = rem - gy * kRuns;
    const uint8_t* p = px + gy * F::kGy * F::kStripRow + k * F::kRowBytes +
                       run * 12;
    uint32_t s[kGpc * 3] = {};
#pragma unroll
    for (int dy = 0; dy < F::kGy; ++dy) {
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(p + dy * F::kStripRow);
      const uint32_t word[3] = {w[0], w[1], w[2]};
#pragma unroll
      for (int i = 0; i < 12; ++i)   // byte i: pixel i / 3, channel i % 3
        s[i / (3 * F::kGx) * 3 + i % 3] +=
            (word[i / 4] >> (8 * (i % 4))) & 0xFF;
    }
    uint32_t* out = reinterpret_cast<uint32_t*>(
        sums + k * F::kSumStride + (gy * F::kSide + run * kGpc) * 3);
#pragma unroll
    for (int q = 0; q < kGpc * 3 / 2; ++q)
      out[q] = s[2 * q] | (s[2 * q + 1] << 16);
  }
}

// One warp's 32 x 32 tile over kJ pairs of k-steps (K = 16 kJ): rows given
// by load(j, mt, h, v), which returns the four K values 16j + 4t .. + 3 of
// row 16 mt + g + 8h of the tile; B from fragment-ordered bf (this lane's
// float4 of j = 0, the tile's first n8 tile; stride kNt * 32 between j).
template <int kJ, int kNt, typename Load>
__device__ __forceinline__ void warp_gemm(double (&acc)[2][4][4], Load load,
                                          const float4* bf) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    double a[2][2][4];                // [mt][k-step 2j, 2j + 1][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double v[4];
        load(j, mt, h, v);
        a[mt][0][h] = v[0];
        a[mt][0][2 + h] = v[1];
        a[mt][1][h] = v[2];
        a[mt][1][2 + h] = v[3];
      }
    float4 b[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) b[nt] = bf[j * kNt * 32 + nt * 32];
    // k-step 2j on all eight accumulators, then 2j + 1: no product waits
    // on the one just issued.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        dmma_16x8x8(acc[mt][nt], a[mt][0], (double)b[nt].x, (double)b[nt].y);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        dmma_16x8x8(acc[mt][nt], a[mt][1], (double)b[nt].z, (double)b[nt].w);
  }
}

// Bias, round half away, and the coefficients of one warp tile into out:
// row r of the tile is MCU m0 + k0 + r, column c is output column col0 + c.
// Out int32_t: out is [n_mcu, kOut] in device memory, rows past n_mcu are
// not stored; with kDc, also the DC plane dc [n_mcu, kDcLanes]: the lane
// that rounds column 64k (nt 0, t 0, col0 a multiple of 64) writes lane k,
// and the one of the last block also the zero lanes kBlocks..7. Out
// int16_t (K11): out is the tile's shared [kTile][kCoefStride] int16 rows,
// every row stored (rows past n_mcu are never read); the caller proves
// that every coefficient fits in int16.
template <typename F, bool kDc, typename Out>
__device__ __forceinline__ void store_tile(const double (&acc)[2][4][4],
                                           const float* __restrict__ bias,
                                           Out* __restrict__ out,
                                           int32_t* __restrict__ dc,
                                           long long m0, int k0, int col0,
                                           long long n_mcu, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + nt * 8 + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (std::is_same_v<Out, int16_t>) {
          const int row = k0 + mt * 16 + h * 8 + g;
          const int lo = round_half_away(acc[mt][nt][2 * h] + (double)b.x);
          const int hi =
              round_half_away(acc[mt][nt][2 * h + 1] + (double)b.y);
          *reinterpret_cast<uint32_t*>(out + row * F::kCoefStride + col) =
              (uint32_t)(lo & 0xFFFF) | ((uint32_t)hi << 16);
        } else {
          const long long mcu = m0 + k0 + mt * 16 + h * 8 + g;
          if (mcu < n_mcu) {
            const int2 q = make_int2(
                round_half_away(acc[mt][nt][2 * h] + (double)b.x),
                round_half_away(acc[mt][nt][2 * h + 1] + (double)b.y));
            *reinterpret_cast<int2*>(out + mcu * F::kOut + col) = q;
            if constexpr (kDc) {
              if (nt == 0 && t == 0 && col0 % 64 == 0) {
                const int blk = col0 / 64;
                int32_t* row = dc + mcu * kDcLanes;
                row[blk] = q.x;
                if (blk == F::kBlocks - 1) {
                  for (int k = F::kBlocks; k < kDcLanes; ++k) row[k] = 0;
                }
              }
            }
          }
        }
      }
  }
}

// The product of one staged tile (MCUs m0 .. m0 + kTile - 1; rows past
// n_mcu are computed and not stored): warp `warp` of `warps` takes warp
// tiles warp, warp + warps, ...; luma tiles first (block-major: tile rows
// are 32 MCUs of one luma block, then the 32-column half), then chroma.
// With kDc, the DC plane into dc as well; out int32_t device memory, or
// int16_t shared memory (store_tile).
template <typename F, bool kDc = false, typename Out>
__device__ __forceinline__ void tile_product(
    const uint8_t* px, const uint16_t* sums, const float4* lum_f,
    const float4* chroma_f, const float* __restrict__ bias,
    Out* __restrict__ out, long long m0, long long n_mcu, int warp,
    int warps, int lane, int32_t* __restrict__ dc = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  double acc[2][4][4];
  for (int w = warp; w < F::kWarpTiles; w += warps) {
    if (w < F::kLumaTiles) {
      const int rows = w >> 1, half = w & 1;
      const int blk = rows / (F::kTile / 32);
      const int k0 = (rows - blk * (F::kTile / 32)) * 32;
      const int by = blk / F::kBlocksX, bx = blk - by * F::kBlocksX;
      const uint8_t* base = px + by * 8 * F::kStripRow + bx * 24 +
                            (k0 + g) * F::kRowBytes;
      auto load = [&](int j, int mt, int h, double (&v)[4]) {
        const int q = 16 * j + 4 * t;          // K index (y, x, c) in block
        const int y = q / 24;
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            base + (mt * 16 + h * 8) * F::kRowBytes + y * F::kStripRow + q -
            y * 24);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = small_to_f64(__byte_perm(word, 0, 0x4440 + i));
      };
      warp_gemm<12, 8>(acc, load, lum_f + half * 4 * 32 + lane);
      store_tile<F, kDc>(acc, bias, out, dc, m0, k0, blk * 64 + half * 32,
                         n_mcu, lane);
    } else {
      const int c = w - F::kLumaTiles, k0 = (c >> 2) * 32, quarter = c & 3;
      const uint16_t* base = sums + (k0 + g) * F::kSumStride;
      auto load = [&](int j, int mt, int h, double (&v)[4]) {
        const uint2 word = *reinterpret_cast<const uint2*>(
            base + (mt * 16 + h * 8) * F::kSumStride + 16 * j + 4 * t);
        v[0] = small_to_f64(word.x & 0xFFFF);
        v[1] = small_to_f64(word.x >> 16);
        v[2] = small_to_f64(word.y & 0xFFFF);
        v[3] = small_to_f64(word.y >> 16);
      };
      warp_gemm<F::kChromaK / 16, 16>(acc, load,
                                      chroma_f + quarter * 4 * 32 + lane);
      store_tile<F, kDc>(acc, bias, out, dc, m0, k0,
                         F::kLuma * 64 + quarter * 32, n_mcu, lane);
    }
  }
}

// The centred int8 view back to u8 (K13): each byte XOR 0x80 (K13 is 4:2:0
// only, so its pieces are 16 bytes).
__device__ __forceinline__ void flip_bytes(uint4& p) {
  p.x ^= 0x80808080u; p.y ^= 0x80808080u; p.z ^= 0x80808080u;
  p.w ^= 0x80808080u;
}

// A tile's pixels staged by kThreads threads through registers (K1, K12,
// K13 and K11): each thread fetches its pieces of the next tile before the
// current tile's product, so the loads overlap it, and stores them into the
// staged tile after the next barrier.
template <typename F, int kThreads>
struct Staging {
  // 16-byte pieces where an MCU row is 48 bytes, 8-byte where it is 24.
  using Piece = std::conditional_t<F::kRowBytes % 16 == 0, uint4, uint2>;
  static constexpr int kBytes = (int)sizeof(Piece);
  static constexpr int kPerRow = F::kRowBytes / kBytes;   // pieces an MCU row
  static constexpr int kPerThread = F::kTileBytes / kBytes / kThreads;
  static_assert(F::kTileBytes % (kBytes * kThreads) == 0, "pieces");
  // K1's shared memory: the operators, the sums and one staged tile.
  static constexpr int kSmemBytes = F::kPixelOffset + F::kTileBytes;
  static_assert(kSmemBytes <= 232448, "shared memory");

  // This thread's pieces of the tile at MCU m0 (zeros past n_mcu). Piece q
  // is row y, MCU k, part p of the tile, and lands at byte q * kBytes of
  // the staged tile [kMh][kTile * kRowBytes]. kI8: the image is the centred
  // int8 view, restored to u8 here. Without kRowFold, MCU row `row` reads
  // image rows row * kMh + y (whole MCUs). kRowFold: the image is the tall
  // view [n * h, W, 3] of n unpadded images of h rows, my = ceil(h / kMh)
  // MCU rows each, with my * kMh < 2h (the launcher checks); MCU row `row`
  // is MCU row row - i * my of image i = row / my, and its pixel row
  // p = (row - i * my) * kMh + y reads row i * h + min(p, 2h - 1 - p): p
  // itself inside the image, else numpy's symmetric mirror 2h - 1 - p, as
  // jpegtpu_torch.core.ops._pad_index pads (no padded copy is made).
  template <bool kI8, bool kRowFold = false>
  __device__ static void fetch(Piece (&r)[kPerThread],
                               const uint8_t* __restrict__ img, long long m0,
                               long long n_mcu, unsigned nrx,
                               long long row_bytes, unsigned h = 0,
                               unsigned my = 0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int y = q / (F::kTile * kPerRow);
      const int rem = q - y * (F::kTile * kPerRow);
      const int k = rem / kPerRow, part = rem - k * kPerRow;
      const long long mcu = m0 + k;
      r[i] = Piece{};
      if (mcu < n_mcu) {
        const unsigned row = (unsigned)mcu / nrx;
        const unsigned col = (unsigned)mcu - row * nrx;
        long long src = (long long)row * F::kMcuH + y;
        if constexpr (kRowFold) {
          const unsigned image = row / my;
          const unsigned p = (row - image * my) * F::kMcuH + y;
          src = (long long)image * h + min(p, 2 * h - 1 - p);
        }
        r[i] = __ldg(reinterpret_cast<const Piece*>(
            img + src * row_bytes + (long long)col * F::kRowBytes +
            part * kBytes));
        if constexpr (kI8) flip_bytes(r[i]);
      }
    }
  }
};

}  // namespace jt
