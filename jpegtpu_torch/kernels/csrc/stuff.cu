// Stuffing kernel: segment bitstreams -> the finished entropy-coded scan,
// in one pass. Each segment keeps its first nbytes = ceil(seg_bits / 8)
// bytes in stream order, every 0xFF byte is followed by a stuffed 0x00, and
// the RST marker 0xFF, mnum[s] follows segment s where mnum[s] != 0 (ITU-T
// T.81 B.1.1.5, B.2.1.2). bounds[i] is the first byte of image i (images of
// spi segments each), bounds[n_img] the scan's length.
//
// Replaces jpegtpu/kernels/compact.py:_compact_stuff_kernel_gkb (:1004,
// launcher jt_stuff_segments, K4) and _compact_stuff_kernel (:317) /
// _compact_stuff_kernel_kb (:615) (launcher jt_stuff_chunks, K5): one
// __global__ body, two thin launchers, so that each TPU kernel keeps its
// own launch count. The TPU kernels walk every 4 KB chunk of every segment
// in one serial chain, after XLA glue (_stuff_precompute, compact.py:192)
// has counted each chunk's 0xFF bytes over the whole worst-case buffer.
// Here the chain is a decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", the scan CUB uses), and
// each tile counts its own 0xFF bytes:
//
// - Chunk c of segment s is 1024 words, 4 KB. It holds clamp(nbytes -
//   4096c, 0, 4096) valid bytes; its aggregate is those bytes, plus its
//   0xFF bytes among them, plus 2 on the segment's last chunk holding data
//   (chunk 0 of a segment of no bytes) where mnum[s] != 0. Tile t = s * f +
//   c runs over every segment's chunks in stream order, where f is the
//   most chunks holding data of any segment (each block reads seg_bits and
//   finds the same f; it is 1 where a segment row is one chunk), so few
//   tiles lie past their segment's data. On an H100 that read costs about
//   4.5 us with 4,629 segments, less than a chain as wide as the rows or
//   than f found by one block and published to the others (both measured
//   slower, PERF.md). A tile's exclusive prefix is
//   stuff_precompute_chunks's chunk_off.
// - A ticket (atomicAdd on a counter, never blockIdx) is a run of `run`
//   consecutive tiles, and the runs are the chain: a run only ever waits
//   for runs of smaller tickets, which running blocks hold. The grid is
//   persistent (as many blocks as fit on the card at once); run is 1 where
//   the tiles fit in one sweep of the grid, up to kMaxRun where they do not,
//   since the counter's atomics (one address) would otherwise set the pace.
// - A block counts each tile of its run in registers (one 16-byte load a
//   thread, __vcmpeq4 / __popc under the tail mask; a tile past its
//   segment's data loads nothing), publishes the run's aggregate, and warp
//   0 looks back, reading 32 earlier runs' status words at a time and
//   summing aggregates back to the nearest inclusive prefix. It publishes
//   the run's inclusive prefix, and a scan of the tiles' aggregates places
//   each tile. A status word is a 2-bit flag (none / aggregate / inclusive
//   prefix) and a 62-bit value in one 64-bit word, so no read can tear; it
//   is stored with release (a fence, then the store) and loaded relaxed.
//   The word carries all its reader needs: no other memory is read
//   through it.
// - The stuffed tile (<= 8194 bytes) is assembled in shared memory at the
//   output's 16-byte phase and written with 16-byte stores; only the
//   unaligned head and tail go bytewise.
//
// Scratch: kScratchHead + n_seg * ceil(W / 1024) int64 words from the
// wrapper (the ticket counter in word 0, a status word a run after), zeroed
// by the launcher with cudaMemsetAsync on the launch's stream; one per
// call, so no state crosses calls or streams.
//
// Bound: bytes. The valid bytes are read once and the stuffed bytes written
// once, plus seg_bits, mnum and bounds; the status words (8 bytes a run of
// at least 4 KB) and the memset are left out. The serial chain the
// TPU walked costs here one look-back a run, overlapped across the runs in
// flight; a run's tiles other than its last are read twice (to count, then
// to write), the second time from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"       // resident_blocks
#include "lookback.cuh"   // publish, look_back

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 4 * kThreads;        // 1024 words, 4 KB a tile
constexpr int kTileBytes = 4 * kTileWords;
constexpr long long kScratchHead = 16;          // = compact.STUFF_SCRATCH_HEAD
constexpr int kMaxRun = 16;                     // tiles a ticket, at most
using jt::kAggregate;
using jt::kInclusive;
using jt::look_back;
using jt::publish;
// The stuffed tile (every byte 0xFF, plus a marker) at its 16-byte phase.
constexpr int kBufBytes = (2 * kTileBytes + 2 + 15 + 15) / 16 * 16;

// Segment s's byte count, at most the cap bytes of its row.
__device__ __forceinline__ long long seg_nbytes(const int32_t* bits,
                                                long long s, long long cap) {
  return min(max(((long long)bits[s] + 7) >> 3, 0LL), cap);
}

// Tiles of a segment in the chain: those holding data, at least tile 0.
__device__ __forceinline__ long long data_tiles(long long nb) {
  return max(1LL, (nb + kTileBytes - 1) / kTileBytes);
}

// My 16 bytes of chunk c of segment s (never a word past the data), and
// the 0xFF bytes among my valid ones: stream byte j of a word is bits
// 31-8j .. 24-8j, so the first m valid bytes are the high m bytes.
__device__ __forceinline__ int load_and_count(const uint32_t* words,
                                              long long s, long long c,
                                              long long seg_stride, int nvalid,
                                              int tid, uint32_t (&w)[4]) {
  const uint32_t* src = words + s * seg_stride + c * kTileWords;
  const int b0 = 16 * tid;
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (b0 + 12 < nvalid && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[tid];
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (b0 + 4 * k < nvalid) w[k] = src[4 * tid + k];
  }
  int ff = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = min(max(nvalid - (b0 + 4 * k), 0), 4);
    const uint32_t mask = m == 4 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (8 * m));
    ff += __popc(__vcmpeq4(w[k], 0xFFFFFFFFu) & mask) >> 3;
  }
  return ff;
}

// Block-wide exclusive scan of ff (one __syncthreads): the 0xFF bytes
// before mine in the tile, and the tile's (in *total).
__device__ __forceinline__ int scan_ff(int ff, int* warp_ff, int lane,
                                       int warp, int* total) {
  int inc = ff;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_ff[warp] = inc;
  __syncthreads();
  int before = inc - ff, sum = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    before += (i < warp) ? warp_ff[i] : 0;
    sum += warp_ff[i];
  }
  *total = sum;
  return before;
}

__global__ void __launch_bounds__(kThreads)
stuff_lookback_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ bits,
                      const int32_t* __restrict__ mnum,
                      uint8_t* __restrict__ out,
                      long long* __restrict__ bounds,
                      unsigned long long* __restrict__ scratch,
                      long long n_seg, long long seg_stride, long long f,
                      long long spi) {
  __shared__ __align__(16) uint8_t buf[kBufBytes];
  // Two scan buffers, taken in turn: a scan's buffer is written again only
  // after the next scan's barrier, which every reader of it has passed.
  __shared__ int warp_ff[2][kWarps];
  __shared__ long long warp_max[kWarps];
  __shared__ long long s_base, s_agg[kMaxRun], s_excl[kMaxRun];
  __shared__ long long s_nb[kMaxRun];       // byte count of each tile's segment
  __shared__ int s_mnum[kMaxRun];           // and its marker
  unsigned long long* ctr = scratch;
  unsigned long long* status = scratch + kScratchHead;
  const long long cap = 4 * seg_stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = 16 * tid;

  // The chain's width: the most data tiles any segment has (every block
  // reads seg_bits and finds the same), so that the chain holds few tiles
  // past a segment's data. It is 1 where a segment row is one tile.
  if (f > 1) {
    long long most = 1;
    for (long long s = tid; s < n_seg; s += kThreads)
      most = max(most, data_tiles(seg_nbytes(bits, s, cap)));
#pragma unroll
    for (int d = 16; d; d >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, d));
    if (lane == 0) warp_max[warp] = most;
    __syncthreads();
    most = 1;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) most = max(most, warp_max[i]);
    f = most;
  }
  const long long n_tiles = n_seg * f;
  // Tiles a ticket: one where the tiles fit in one sweep of the grid, up to
  // kMaxRun where they do not, so that the counter's atomics (one address)
  // do not set the pace.
  const int run = (int)min(max(n_tiles / (long long)gridDim.x, 1LL),
                           (long long)kMaxRun);

  for (;;) {
    if (tid == 0) s_base = (long long)atomicAdd(ctr, (unsigned long long)run);
    __syncthreads();              // also: the last run's shared data is free
    const long long base = s_base;
    if (base >= n_tiles) break;
    const int n = (int)min((long long)run, n_tiles - base);
    if (tid < n) {                // the run's segment data, loaded at once
      const long long s = (base + tid) / f;
      s_nb[tid] = seg_nbytes(bits, s, cap);
      s_mnum[tid] = mnum[s];
    }
    __syncthreads();

    // 1. Count each tile of the run. The last data tile's words and scan
    // stay in registers for step 3.
    uint32_t w[4];
    int held = -1, before = 0, tile_ff = 0, scans = 0;
    for (int k = 0; k < n; ++k) {
      const long long t = base + k, s = t / f, c = t - s * f;
      const long long nb = s_nb[k];
      const long long ft = data_tiles(nb);
      if (c >= ft) {                         // empty: no bytes, no marker
        if (tid == 0) s_agg[k] = -1;
        continue;
      }
      const int nvalid = (int)min(max(nb - c * kTileBytes, 0LL),
                                  (long long)kTileBytes);
      const int ff = load_and_count(words, s, c, seg_stride, nvalid, tid, w);
      before = scan_ff(ff, warp_ff[scans++ & 1], lane, warp, &tile_ff);
      held = k;
      if (tid == 0)
        s_agg[k] = nvalid + tile_ff + (c == ft - 1 && s_mnum[k] != 0 ? 2 : 0);
    }
    __syncthreads();

    // 2. The run's prefixes (warp 0, lane k for tile k): publish the run's
    // aggregate, look back, publish its inclusive prefix; each tile's
    // exclusive prefix from a scan of the tiles' aggregates.
    if (warp == 0) {
      const long long agg = lane < n ? max(s_agg[lane], 0LL) : 0;
      long long inc = agg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
      }
      const long long total = __shfl_sync(0xffffffffu, inc, 31);
      const long long r = base / run;
      long long excl = 0;
      if (r > 0) {
        if (lane == 0) publish(&status[r], kAggregate | total);
        excl = look_back(status, r, lane);
      }
      if (lane == 0) publish(&status[r], kInclusive | (excl + total));
      if (lane < n) s_excl[lane] = excl + inc - agg;
    }
    __syncthreads();

    // 3. Write each data tile, the last counted first (its words and scan
    // are still held), the others loaded and scanned again.
    for (int k = held; k >= 0; --k) {
      if (s_agg[k] < 0) continue;
      const long long t = base + k, s = t / f, c = t - s * f;
      const long long nb = s_nb[k];
      const bool last = c == data_tiles(nb) - 1;
      const int marker = last ? s_mnum[k] : 0;
      const int nvalid = (int)min(max(nb - c * kTileBytes, 0LL),
                                  (long long)kTileBytes);
      if (k != held) {
        const int ff = load_and_count(words, s, c, seg_stride, nvalid, tid,
                                      w);
        before = scan_ff(ff, warp_ff[scans++ & 1], lane, warp, &tile_ff);
      }
      const long long p0 = s_excl[k];
      if (tid == 0) {
        if (c == 0 && s % spi == 0) bounds[s / spi] = p0;
        if (last && s == n_seg - 1) bounds[n_seg / spi] = p0 + s_agg[k];
      }
      // The stuffed tile in shared memory, byte i at sh + i, where sh is
      // the output's 16-byte phase: byte i goes to out + p0 + i.
      const int sh = (int)(reinterpret_cast<uintptr_t>(out + p0) & 15);
      int q = sh + b0 + before;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (b0 + 4 * i + j < nvalid) {
            const uint8_t byte = (uint8_t)(w[i] >> (24 - 8 * j));
            buf[q++] = byte;
            if (byte == 0xFF) buf[q++] = 0;
          }
        }
      }
      if (tid == 0 && marker) {
        buf[sh + nvalid + tile_ff] = 0xFF;
        buf[sh + nvalid + tile_ff + 1] = (uint8_t)marker;
      }
      __syncthreads();

      // 16-byte stores where a whole aligned 16 bytes is the tile's, bytes
      // at the unaligned head and tail (their neighbours are other tiles').
      const int len = (int)s_agg[k];
      uint8_t* dst = out + p0 - sh;
      for (int m = tid; 16 * m < sh + len; m += kThreads) {
        const int lo = 16 * m, hi = lo + 16;
        if (lo >= sh && hi <= sh + len) {
          *reinterpret_cast<uint4*>(dst + lo) =
              *reinterpret_cast<const uint4*>(buf + lo);
        } else {
          for (int i = max(lo, sh); i < min(hi, sh + len); ++i)
            dst[i] = buf[i];
        }
      }
      __syncthreads();                       // buf is free again
    }
  }
}

// The persistent grid: as many blocks as are resident on the device at
// once (cached per device), at most one a chunk.
int launch(const int32_t* seg_words, const int32_t* seg_bits,
           const int32_t* mnum, uint8_t* out, int64_t* bounds,
           unsigned long long* scratch, long long n_seg, long long seg_stride,
           long long spi, cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  if (spi <= 0 || n_seg % spi || seg_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long chunks = (seg_stride + kTileWords - 1) / kTileWords;
  const long long f = chunks > 0 ? chunks : 1;
  const long long n_tiles = n_seg * f;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(kScratchHead + n_tiles) * sizeof(long long),
      stream);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  const int e = jt::resident_blocks(stuff_lookback_kernel, kThreads, 0,
                                    &resident);
  if (e) return e;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  stuff_lookback_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(seg_words), seg_bits, mnum,
      out, reinterpret_cast<long long*>(bounds), scratch, n_seg, seg_stride,
      f, spi);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: segments in images of segs_per_image each (the marker table numbered
// within each image), bounds [n_seg / segs_per_image + 1].
extern "C" int jt_stuff_segments(const int32_t* seg_words,
                                 const int32_t* seg_bits,
                                 const int32_t* mnum, uint8_t* out,
                                 int64_t* bounds, unsigned long long* scratch,
                                 long long n_seg, long long seg_stride,
                                 long long segs_per_image,
                                 cudaStream_t stream) {
  return launch(seg_words, seg_bits, mnum, out, bounds, scratch, n_seg,
                seg_stride, segs_per_image, stream);
}

// K5: one chain of one image (restart 0: a single segment), bounds [2].
extern "C" int jt_stuff_chunks(const int32_t* seg_words,
                               const int32_t* seg_bits,
                               const int32_t* mnum, uint8_t* out,
                               int64_t* bounds, unsigned long long* scratch,
                               long long n_seg, long long seg_stride,
                               cudaStream_t stream) {
  return launch(seg_words, seg_bits, mnum, out, bounds, scratch, n_seg,
                seg_stride, n_seg, stream);
}
