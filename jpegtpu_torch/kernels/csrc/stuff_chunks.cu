// Chunk stuffing kernel: segment bitstreams -> the finished entropy-coded
// scan, one thread block per (segment, 4 KB chunk). Each segment is trimmed
// to its byte count, every 0xFF byte is followed by a stuffed 0x00, and the
// RST marker 0xFF, mnum[s] follows segment s where mnum[s] != 0 (ITU-T T.81
// B.1.1.5, B.2.1.2).
//
// Replaces jpegtpu/kernels/compact.py:_compact_stuff_kernel (:317, one chunk
// per step) and _compact_stuff_kernel_kb (:615, kb chunks per step), called
// from compact_segments_stuffed. The TPU kernels walk every chunk of every
// segment in one serial chain through a register window of output frames.
// Here the glue (stuff_precompute_chunks, jpegtpu's _stuff_precompute) has
// already computed each chunk's stuffed output offset, so the chunks are
// independent: there is no serial chain, and a single segment (restart 0)
// spreads over as many blocks as it has chunks. Inside a block, 256 threads
// take 16 consecutive bytes each, a block-wide exclusive scan of their 0xFF
// counts gives each byte its place, and byte i of the chunk goes to
// chunk_off + i + (#0xFF before i in the chunk), a 0x00 after each 0xFF.
// Blocks of chunks past the segment's data return at once.
//
// Bound: bytes. The valid scan bytes are read once and written once (about
// twice the compressed size with stuffing), plus the chunk tables (12 bytes
// a chunk); the byte-wide stores and the one-block-per-chunk grid are the
// simple choice, wider stores and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = 4;
constexpr int kChunkWords = kThreads * kWordsPerThread;   // 1024 words, 4 KB

__global__ void __launch_bounds__(kThreads)
stuff_chunks_kernel(const int32_t* __restrict__ seg_words,
                    const int64_t* __restrict__ chunk_off,
                    const int32_t* __restrict__ in_chunk,
                    const int64_t* __restrict__ seg_end,
                    const int32_t* __restrict__ nchunks,
                    const int32_t* __restrict__ mnum, uint8_t* __restrict__ out,
                    long long seg_stride, long long f) {
  __shared__ int warp_tot[kWarps];
  const long long b = blockIdx.x;
  const long long seg = b / f, c = b - seg * f;
  const int nch = nchunks[seg];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The block of the segment's last chunk (chunk 0 if it has none) writes
  // the marker; every other block past the data leaves at once.
  if (tid == 0 && c == max(nch - 1, 0) && mnum[seg] != 0) {
    const long long p = seg_end[seg];
    out[p] = 0xFF;
    out[p + 1] = (uint8_t)mnum[seg];
  }
  if (c >= nch) return;

  const long long idx = seg * f + c;
  const int nvalid = in_chunk[idx];                 // valid bytes, <= 4096
  const uint32_t* src = reinterpret_cast<const uint32_t*>(seg_words) +
                        seg * seg_stride + c * kChunkWords +
                        kWordsPerThread * tid;
  const int b0 = 4 * kWordsPerThread * tid;         // my first chunk byte
  uint32_t w[kWordsPerThread];
  int ff = 0;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    w[k] = (b0 + 4 * k < nvalid) ? src[k] : 0u;     // never past the data
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ff += (b0 + 4 * k + j < nvalid) &&
            (((w[k] >> (24 - 8 * j)) & 0xFFu) == 0xFFu);
  }

  // Block-wide exclusive scan of ff.
  int inc = ff;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = inc - ff;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) before += (i < warp) ? warp_tot[i] : 0;

  long long pos = chunk_off[idx] + b0 + before;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (b0 + 4 * k + j < nvalid) {
        const uint8_t byte = (uint8_t)(w[k] >> (24 - 8 * j));
        out[pos + 4 * k + j] = byte;
        if (byte == 0xFF) {
          out[pos + 4 * k + j + 1] = 0;
          ++pos;
        }
      }
    }
  }
}

}  // namespace

extern "C" int jt_stuff_chunks(const int32_t* seg_words,
                               const int64_t* chunk_off,
                               const int32_t* in_chunk, const int64_t* seg_end,
                               const int32_t* nchunks, const int32_t* mnum,
                               uint8_t* out, long long n_seg,
                               long long seg_stride, long long f,
                               cudaStream_t stream) {
  const long long blocks = n_seg * f;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stuff_chunks_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg_words, chunk_off, in_chunk, seg_end, nchunks, mnum, out, seg_stride,
      f);
  return (int)cudaGetLastError();
}
