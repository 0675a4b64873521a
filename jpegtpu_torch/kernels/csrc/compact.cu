// Compaction kernel: segment bitstreams -> the segments' bytes back to
// back, with no stuffing and no markers (the host stuffs them,
// jpegtpu_torch.native.stuff_assemble_contig). Segment s is trimmed to its
// nbytes[s] = ceil(bits / 8) bytes (its last byte already 1-padded by the
// segment merge) and lands at off[s], the exclusive prefix sum of nbytes.
//
// Replaces jpegtpu/kernels/compact.py:_compact_kernel (:44), called from
// compact_segments (:163). The TPU kernel walks every 4 KB chunk of every
// segment in one serial chain, funnel-shifting each chunk by the running
// byte offset through a register window of output frames, and writes
// byte-swapped u32 words. Here the offsets need nothing from the bytes
// themselves (the glue's cumsum of nbytes), so no chunk waits for another:
// one thread block per (segment, 4 KB chunk), and blocks past a segment's
// bytes return at once, so one long segment (restart 0) and many short ones
// (restart 1) both spread over the card. Each of 256 threads moves 16
// consecutive bytes: it reads its 4 big-endian words and writes their valid
// bytes in stream order to out[off[s] + 4096 c + 16 t + i]. The output is
// plain u8 in stream order; offsets are 64-bit throughout.
//
// Bound: bytes. The valid bytes are read once and written once, plus the
// n_seg byte counts and offsets. Byte-wide stores are the simple choice
// (a segment starts at any byte, so its words do not land word-aligned);
// funnel-shifted word stores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kChunkWords = kThreads * kWordsPerThread;   // 1024 words, 4 KB
constexpr int kChunkBytes = 4 * kChunkWords;

__global__ void __launch_bounds__(kThreads)
compact_kernel(const int32_t* __restrict__ seg_words,
               const int64_t* __restrict__ nbytes,
               const int64_t* __restrict__ off, uint8_t* __restrict__ out,
               long long seg_stride, long long f) {
  const long long b = blockIdx.x;
  const long long seg = b / f, c = b - seg * f;
  const long long left = nbytes[seg] - c * kChunkBytes;
  if (left <= 0) return;                      // past the segment's bytes
  const int nvalid = (int)min(left, (long long)kChunkBytes);
  const int b0 = 4 * kWordsPerThread * threadIdx.x;   // my first chunk byte
  if (b0 >= nvalid) return;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(seg_words) +
                        seg * seg_stride + c * kChunkWords +
                        kWordsPerThread * threadIdx.x;
  uint8_t* dst = out + off[seg] + c * kChunkBytes + b0;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    if (b0 + 4 * k < nvalid) {                // never read past the data
      const uint32_t w = src[k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (b0 + 4 * k + j < nvalid)
          dst[4 * k + j] = (uint8_t)(w >> (24 - 8 * j));
    }
  }
}

}  // namespace

extern "C" int jt_compact_segments(const int32_t* seg_words,
                                   const int64_t* nbytes, const int64_t* off,
                                   uint8_t* out, long long n_seg,
                                   long long seg_stride, long long f,
                                   cudaStream_t stream) {
  const long long blocks = n_seg * f;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  compact_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg_words, nbytes, off, out, seg_stride, f);
  return (int)cudaGetLastError();
}
