// Segment-merge kernel: MCU bitstreams -> one bitstream per restart segment,
// with the last byte of each segment 1-padded (ITU-T T.81 F.1.2.3), and each
// segment's bit count.
//
// Replaces jpegtpu/kernels/entropy_pack.py:_seg_merge_v3_kernel (called
// from seg_merge_mcu). The TPU kernel advances up to 32 segments together
// through a register window that it flushes in 1024-word frames, because its
// grid runs in order, after XLA glue has scanned the MCU lengths. Here no
// glue runs: the kernel takes the MCU words, their lengths and the real MCU
// count nm; MCUs nm .. n_seg*mps - 1 are zero-length pads of a ragged last
// segment. It scans the lengths itself and writes every output word of a
// segment, 0 .. ceil(seg_bits / 32) - 1, exactly once with a plain store
// (the last one 1-padded past the data, then zero); words past them are
// never written, so the output needs no zero fill.
//
// - A tile is a run of MCUs in one thread block. A segment of up to
//   kMaxTile MCUs is never split: a tile holds whole segments, about
//   kTargetMcus MCUs of them, and needs nothing from another tile. A longer
//   segment (restart 0, long intervals) is cut into tiles of kSplitMcus,
//   and each takes its bit offset in the segment, its carry, from the tiles
//   before it by a decoupled look-back (lookback.cuh; a tile that starts a
//   segment is its own inclusive prefix, so no look-back crosses a segment
//   start). The split tiles are taken by ticket (atomicAdd), so a tile only
//   waits on tiles that running blocks hold; whole-segment tiles go by
//   blockIdx. The grid is persistent.
// - The block scans its tile's lengths in shared memory. Output word q of a
//   segment belongs to the tile that holds its first bit, 32q: a thread per
//   word finds that MCU by a binary search on the tile's offsets and
//   funnel-shifts its words into the output word, then the next MCUs'
//   while the word is not full and the segment has MCUs left. Those MCUs
//   may lie past the tile (the word that straddles two tiles); their
//   lengths and words are read-only inputs, so no tile waits for another's
//   output. Neighbouring threads take neighbouring words, so loads and
//   stores coalesce. Bits of an MCU's last word past its length, and its
//   words past them, are never read.
// - A segment of 2^31 bits or more gets seg_bits -1, which the wrapper
//   reads where the worst case could reach it.
//
// Scratch (split segments only): kScratchHead + the tile count int64 words
// from the wrapper (the ticket counter in word 0, then a status word a
// tile), zeroed by the launcher with cudaMemsetAsync on the launch's
// stream; the pointer may be null when no segment is split.
//
// Bound: bytes, the valid MCU words and lengths read once, the valid
// segment words and seg_bits written once. On an H100 at 3840x2160 the
// kernel takes about 8x that bound (PERF.md): a tile's scan, each word's
// nine-step search and the look-back are latency that about five words a
// thread do not hide. Two words a thread with their searches interleaved
// spilled registers and was slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 512;       // = entropy_pack.SEG_MERGE_WHOLE
constexpr int kTargetMcus = 128;    // MCUs of a whole-segment tile, about
constexpr int kSplitMcus = 256;     // = entropy_pack.SEG_MERGE_TILE
constexpr long long kScratchHead = 16;  // = entropy_pack.SEG_MERGE_SCRATCH_HEAD
// Rows wider than this could give a tile 2^31 bits: refused.
constexpr long long kMaxRowWords = (1LL << 31) / (32 * kMaxTile);
static_assert(kMaxTile <= kThreads && kSplitMcus <= kMaxTile &&
                  kWarps <= 32,
              "one MCU of a tile a thread; one warp scans the warps' sums");

// Block-wide exclusive scan of x (two __syncthreads); the sum in *total.
// wtot holds kWarps + 1 values.
template <typename T>
__device__ __forceinline__ T block_scan(T x, T* wtot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wtot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T v = lane < kWarps ? wtot[lane] : 0;
    T w = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) wtot[lane] = w - v;
    if (lane == 31) wtot[kWarps] = w;
  }
  __syncthreads();
  *total = wtot[kWarps];
  return wtot[warp] + inc - x;
}

// The last index i in [lo, hi] with off[i] <= v (off is non-decreasing,
// off[lo] <= v and hi - lo < 512): nine fixed steps, no branch.
__device__ __forceinline__ int last_at_most(const int* off, int lo, int hi,
                                            int v) {
  int i = lo;
#pragma unroll
  for (int step = 256; step; step >>= 1) {
    const int j = min(i + step, hi);
    i = off[j] <= v ? j : i;
  }
  return i;
}

// Bit positions inside a tile are tile-relative int32: a tile holds at most
// kMaxTile MCUs of rows narrower than kMaxRowWords.
__global__ void __launch_bounds__(kThreads, 2)
seg_merge_mcu_kernel(const uint32_t* __restrict__ mwords,
                     const int32_t* __restrict__ mlens,
                     uint32_t* __restrict__ out, int32_t* __restrict__ seg_bits,
                     unsigned long long* __restrict__ scratch, long long nm,
                     long long n_seg, long long mps, int mcu_words,
                     long long seg_words, long long spt, long long tps,
                     long long n_tiles) {
  __shared__ int s_len[kMaxTile];
  __shared__ int s_off[kMaxTile + 1];      // tile-relative, s_off[n] = sum
  __shared__ int s_wpre[kThreads];         // each segment's first word
  __shared__ int s_wtot[2][kWarps + 1];    // the two scans' buffers
  __shared__ long long s_tile, s_carry;
  const bool split = spt == 0;
  unsigned long long* status = scratch + kScratchHead;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long k = blockIdx.x;; k += gridDim.x) {
    if (split) {
      if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ULL);
      __syncthreads();
    }
    const long long t = split ? s_tile : k;
    if (t >= n_tiles) break;
    // The tile: whole segments s0 .. s0 + np - 1, or part c of segment s0.
    const long long s0 = split ? t / tps : t * spt;
    const long long c = split ? t - s0 * tps : 0;
    const int np = split ? 1 : (int)min(spt, n_seg - s0);
    const int per = (int)min(mps, (long long)kMaxTile);   // MCUs a segment
    const long long first = s0 * mps + c * kSplitMcus;    // its first MCU
    const int n = split ? (int)min((long long)kSplitMcus, mps - c * kSplitMcus)
                        : np * per;

    // 1. The lengths and their tile-relative offsets.
    const long long gi = first + tid;
    const int len = tid < n && gi < nm ? mlens[gi] : 0;
    int sum;
    const int ex = block_scan(len, s_wtot[0], &sum);
    if (tid < n) {
      s_len[tid] = len;
      s_off[tid] = ex;
    }
    if (tid == 0) s_off[n] = sum;

    // 2. A split tile's carry: the bits of its segment before it.
    if (split && warp == 0) {
      long long carry = 0;
      if (c == 0) {
        if (lane == 0) jt::publish(&status[t], jt::kInclusive | sum);
      } else {
        if (lane == 0) jt::publish(&status[t], jt::kAggregate | sum);
        carry = jt::look_back(status, t, lane);
        if (lane == 0)
          jt::publish(&status[t], jt::kInclusive | (carry + sum));
      }
      if (lane == 0) s_carry = carry;
    }
    __syncthreads();

    // 3. The words each segment of the tile owns (those whose first bit it
    // holds, below seg_words), and the bit counts of the segments it ends.
    // A split tile's first word starts `lead` bits into it.
    const long long carry = split ? s_carry : 0;
    const long long q_lo = (carry + 31) >> 5;             // 0 when whole
    const int lead = (int)(32 * q_lo - carry);
    int nw = 0;
    if (tid < np) {
      const long long bits = split ? carry + sum
                                   : s_off[(tid + 1) * per] - s_off[tid * per];
      nw = (int)max(min((bits + 31) >> 5, seg_words) - q_lo, 0LL);
      if (!split || c == tps - 1)
        seg_bits[s0 + tid] = bits < (1LL << 31) ? (int32_t)bits : -1;
    }
    int n_words;
    const int pre = block_scan(nw, s_wtot[1], &n_words);
    if (tid < np) s_wpre[tid] = pre;
    __syncthreads();

    // 4. Each word from the MCU that holds its first bit and those after.
    for (int f = tid; f < n_words; f += kThreads) {
      const int p = np == 1 ? 0 : last_at_most(s_wpre, 0, np - 1, f);
      const int qi = f - s_wpre[p];                       // word in the tile
      const long long seg = s0 + p;
      const long long seg_end = (seg + 1) * mps;          // its MCUs' end
      // The word's first bit, tile-relative, and the MCU that holds it.
      const int lo = p * per;
      int pos = 32 * qi + (split ? lead : s_off[lo]);
      const int i = last_at_most(s_off, lo, split ? n - 1 : lo + per - 1,
                                 pos);
      int o = s_off[i], mlen = s_len[i];
      long long m = first + i;
      uint32_t acc = 0;
      int filled = 0;
      for (;;) {
        const int avail = o + mlen - pos;
        if (avail > 0) {
          const int take = min(avail, 32 - filled);
          const int b = pos - o;                          // bit in MCU m
          const uint32_t* row = mwords + m * mcu_words + (b >> 5);
          const int sh = b & 31;
          const uint32_t hi = row[0];
          const uint32_t lo_w = sh + take > 32 ? row[1] : 0u;
          acc |= (__funnelshift_l(lo_w, hi, sh) >> (32 - take))
                 << (32 - filled - take);
          filled += take;
          pos += take;
          if (filled == 32) break;
        }
        o += mlen;
        if (++m >= seg_end) break;                        // segment ends
        const long long li = m - first;
        mlen = li < n ? s_len[li] : (m < nm ? mlens[m] : 0);
      }
      if (filled < 32) {              // 1-pad the segment's last byte
        const int padb = (8 - (filled & 7)) & 7;
        acc |= ((1u << padb) - 1u) << (32 - filled - padb);
      }
      out[seg * seg_words + q_lo + qi] = acc;
    }
    __syncthreads();                  // shared memory free for the next tile
  }
}

}  // namespace

// MCU streams [nm, mcu_words] (bits past each length ignored, never read
// past its valid words) and lengths [nm] -> n_seg segments of mps MCUs (MCU
// nm and up are zero-length pads; nm <= n_seg * mps) in rows of seg_words
// words, and seg_bits [n_seg]. scratch: kScratchHead + n_seg *
// ceil(mps / kSplitMcus) int64 words when mps > kMaxTile, else unused (may
// be null).
extern "C" int jt_seg_merge_mcu(const int32_t* mwords, const int32_t* mlens,
                                int32_t* out, int32_t* seg_bits,
                                unsigned long long* scratch, long long nm,
                                long long n_seg, long long mps, int mcu_words,
                                long long seg_words, cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  if (mps <= 0 || nm < 0 || nm > n_seg * mps || mcu_words <= 0 ||
      mcu_words >= kMaxRowWords || seg_words < 0)
    return (int)cudaErrorInvalidValue;
  const bool split = mps > kMaxTile;
  const long long spt = split ? 0 : kTargetMcus / mps > 1 ? kTargetMcus / mps
                                                          : 1;
  const long long tps = split ? (mps + kSplitMcus - 1) / kSplitMcus : 1;
  const long long n_tiles = split ? n_seg * tps : (n_seg + spt - 1) / spt;
  cudaError_t err;
  if (split) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(scratch, 0,
                          (size_t)(kScratchHead + n_tiles) * sizeof(long long),
                          stream);
    if (err != cudaSuccess) return (int)err;
  }
  int resident = 0;
  const int e = jt::resident_blocks(seg_merge_mcu_kernel, kThreads, 0,
                                    &resident);
  if (e) return e;
  const long long grid = n_tiles < resident ? n_tiles : resident;
  seg_merge_mcu_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(mwords), mlens,
      reinterpret_cast<uint32_t*>(out), seg_bits, scratch, nm, n_seg, mps,
      mcu_words, seg_words, spt, tps, n_tiles);
  return (int)cudaGetLastError();
}
