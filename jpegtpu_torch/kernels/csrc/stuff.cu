// Stuffing kernel: segment bitstreams -> the finished entropy-coded scan.
// Each segment is trimmed to its byte count, every 0xFF byte is followed by
// a stuffed 0x00, and the RST marker 0xFF, mnum[s] follows segment s where
// mnum[s] != 0 (ITU-T T.81 B.1.1.5, B.2.1.2). The glue's marker table
// numbers the markers within each image and leaves none after an image's
// last segment, so a batch of images is one scan of whole image scans.
//
// Replaces jpegtpu/kernels/compact.py:_compact_stuff_kernel_gkb (called
// from compact_segments_stuffed_grouped) and computes what its single-chain
// siblings _compact_stuff_kernel/_compact_stuff_kernel_kb compute. The TPU
// kernels walk the segments in a serial chain through 4 KB chunks and
// frame-sized windows. Here the glue has computed each segment's stuffed
// start, so one thread block per segment works alone: it walks the
// segment's bytes in tiles of 256 words, carries a block-wide exclusive
// scan of 0xFF counts across tiles, and writes byte i to
// start + i + (#0xFF before i). The output is one contiguous u8 scan.
//
// Bound: the scan's serial tile loop per segment, and byte-wide stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // one segment word per thread per tile
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
stuff_kernel(const int32_t* __restrict__ seg_words,
             const int32_t* __restrict__ nbytes,
             const int64_t* __restrict__ seg_start,
             const int32_t* __restrict__ mnum, uint8_t* __restrict__ out,
             long long seg_stride) {
  __shared__ int warp_tot[kWarps];
  __shared__ long long carry_s;
  const long long seg = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nb = nbytes[seg];
  const long long start = seg_start[seg];
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(seg_words) + seg * seg_stride;
  if (tid == 0) carry_s = 0;
  __syncthreads();

  for (long long base = 0; base < nb; base += 4LL * kThreads) {
    const long long b0 = base + 4LL * tid;        // first byte of my word
    const int nvalid = (int)max(0LL, min(4LL, nb - b0));
    const uint32_t w = nvalid ? src[b0 >> 2] : 0u;
    int ff = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ff += (k < nvalid) && (((w >> (24 - 8 * k)) & 0xFFu) == 0xFFu);

    // Block-wide exclusive scan of ff.
    int inc = ff;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      before += (i < warp) ? warp_tot[i] : 0;
      tile += warp_tot[i];
    }
    const long long carry = carry_s;
    long long pos = start + b0 + carry + before + (inc - ff);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < nvalid) {
        const uint8_t byte = (uint8_t)(w >> (24 - 8 * k));
        out[pos + k] = byte;
        if (byte == 0xFF) {
          out[pos + k + 1] = 0;
          ++pos;
        }
      }
    }
    __syncthreads();                 // everyone has read carry_s, warp_tot
    if (tid == 0) carry_s = carry + tile;
    __syncthreads();
  }
  if (tid == 0 && mnum[seg] != 0) {
    const long long p = start + nb + carry_s;
    out[p] = 0xFF;
    out[p + 1] = (uint8_t)mnum[seg];
  }
}

}  // namespace

extern "C" int jt_stuff_segments(const int32_t* seg_words,
                                 const int32_t* nbytes,
                                 const int64_t* seg_start,
                                 const int32_t* mnum, uint8_t* out,
                                 long long n_seg, long long seg_stride,
                                 cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  if (n_seg > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stuff_kernel<<<(unsigned)n_seg, kThreads, 0, stream>>>(
      seg_words, nbytes, seg_start, mnum, out, seg_stride);
  return (int)cudaGetLastError();
}
