// Segment-merge kernel body: rows of bitstreams -> one bitstream per
// segment of consecutive rows, and each segment's bit count. Four
// instances, by three compile-time options:
//
// - kPad: 1-pad each segment's last byte (ITU-T T.81 F.1.2.3).
// - kZeroTail: write every word of each output row, the words past the
//   segment's data as zeros, so the output needs no fill; without it the
//   words past ceil(seg_bits / 32) are never written.
// - kSplit: the rows of a tile of a split segment (it also gives each
//   instance a symbol of its own).
//
// - jt_seg_merge_mcu (K3; replaces jpegtpu/kernels/entropy_pack.py:
//   _seg_merge_v3_kernel, called from seg_merge_mcu): MCU streams into
//   restart segments; kPad, no tail.
// - jt_seg_merge_v1 (K10; replaces jpegtpu/kernels/entropy_oracles.py:
//   _seg_merge_kernel, called from seg_merge): 56-word block streams into
//   restart segments; kPad and kZeroTail.
// - jt_seg_merge_window (K9; replaces jpegtpu/kernels/entropy_oracles.py:
//   _seg_merge_window_kernel, called from seg_merge_v2 after mcu_merge):
//   K8's MCU streams into restart segments; kPad and kZeroTail, like K10,
//   but split tiles of kSplitMcus rows (an MCU row holds g blocks' words).
// - jt_mcu_merge (K8; replaces jpegtpu/kernels/entropy_oracles.py:
//   _mcu_merge_kernel, called from mcu_merge): 56-word block streams into
//   MCUs of g blocks, a "segment" each; kZeroTail, no pad. A row that
//   truncates (a budget-sized mcu_words) drops the words past it while the
//   length stays the full sum.
//
// The TPU kernels advance segments through a register window flushed in
// 1024-word frames after XLA glue has scanned the lengths (K3, K9), append a
// segment's blocks one by one into a zeroed VMEM accumulator (K10), or
// place the g blocks of 256 MCUs by lane gathers into zeroed chunks (K8):
// their grids run in order on one core. Here no glue runs: the kernel
// takes the rows, their lengths and the real row count nm; rows nm ..
// n_seg*mps - 1 are zero-length pads of a ragged last segment. It scans
// the lengths itself and writes every output word once, with a plain
// store: no atomics, no read of the output.
//
// - A tile is a run of rows in one thread block. A segment of up to
//   kMaxTile rows is not split: a tile holds whole segments, about
//   kTargetMcus rows of them (with the zero tail up to kMaxTile, so that a
//   tile's scan is paid for the most stores), and needs nothing from
//   another tile. A longer segment (restart 0, long intervals, K10's
//   1,440-block rows at 4K), and with the zero tail a segment whose output
//   row is wider than kTailWords (K9's 76,800-word rows at 4K: one block
//   would write 300 KB while the tail tiles spread it over the grid; such
//   a segment of up to kMaxTile rows is one data tile), is cut into tiles
//   of kSplit rows, and each takes its bit offset in the segment, its
//   carry, from the tiles before it by a decoupled look-back
//   (lookback.cuh; a tile that starts a segment is its own inclusive
//   prefix, so no look-back crosses a segment start). The split tiles are
//   taken by ticket (atomicAdd), so a tile only waits on tiles that running
//   blocks hold; whole-segment tiles go by blockIdx. The grid is
//   persistent.
// - The block scans its tile's lengths in shared memory. Output word q of a
//   segment belongs to the tile that holds its first bit, 32q: a thread per
//   word finds that row by a binary search on the tile's offsets and
//   funnel-shifts its words into the output word, then the next rows'
//   while the word is not full and the segment has rows left. Those rows
//   may lie past the tile (the word that straddles two tiles); their
//   lengths and words are read-only inputs, so no tile waits for another's
//   output. Neighbouring threads take neighbouring words, so loads and
//   stores coalesce. Bits of a row's last word past its length, and its
//   words past them, are never read.
// - kZeroTail, whole-segment tiles: the tile's segments are consecutive
//   output rows, so it writes the one range [s0 * seg_words, (s0 + np) *
//   seg_words): first its zeros, consecutive threads on consecutive 16-byte
//   quads (single words in the quad where a segment's data ends), then its
//   data words by the search above, so the stores are out before the data
//   words' dependent loads.
// - kZeroTail, split segments: after every data tile come tail tiles in
//   ticket order, kTailWords words of a segment's row each. A tail tile
//   waits on its segment's last data tile's inclusive status (the
//   segment's bit count) and zeroes its share of [ceil(seg_bits / 32),
//   seg_words) in 16-byte stores. It waits only on a tile of an earlier
//   ticket, which a running block holds, as in the look-back, so it
//   cannot deadlock; no tile waits on it, so it has no status word.
// - A segment that outgrows its row keeps its true bit count and loses the
//   words past the row. A segment of 2^31 bits or more gets seg_bits -1,
//   which the wrapper reads where the worst case could reach it.
//
// Scratch (split segments only): kScratchHead + the data tile count int64
// words from the wrapper (the ticket counter in word 0, then a status word
// a data tile), zeroed by the launcher with cudaMemsetAsync on the launch's
// stream; the pointer may be null when no segment is split.
//
// Bound: bytes. K3: the valid row words and lengths read once, the valid
// segment words and seg_bits written once; on an H100 at 3840x2160 the
// kernel takes about 8x that bound (PERF.md): a tile's scan, each word's
// nine-step search and the look-back are latency that about five words a
// thread do not hide. Two words a thread with their searches interleaved
// spilled registers and was slower. K8, K9 and K10: the same reads, and the
// whole output rows written (zeros included), which dominate; there each
// tile's scan and its data words' searches and loads are latency between
// the bursts of stores, so the card writes the rows at about half the
// rate of a plain fill of the same output (PERF.md, merge_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 512;       // = entropy_pack.SEG_MERGE_WHOLE
constexpr int kTargetMcus = 128;    // = entropy_pack.SEG_MERGE_TARGET
constexpr int kSplitMcus = 256;     // = entropy_pack.SEG_MERGE_TILE
constexpr int kZeroSplit = 512;     // = entropy_pack.SEG_MERGE_ZERO_TILE
constexpr long long kScratchHead = 16;  // = entropy_pack.SEG_MERGE_SCRATCH_HEAD
constexpr long long kTailWords = 16384;  // = entropy_pack.SEG_MERGE_TAIL
// Rows wider than this could give a tile 2^31 bits: refused.
constexpr long long kMaxRowWords = (1LL << 31) / (32 * kMaxTile);
static_assert(kMaxTile < kThreads && kWarps <= 32,
              "one row of a tile a thread; one warp scans the warps' sums");

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

// The segment word whose first bit is tile-relative bit pos: from the row
// in [lo, hi] of the tile that holds it and the rows after it, up to
// seg_end (the segment's end; rows past the tile's n are read from mlens).
// 1-padded past the segment's last bit when kPad.
template <bool kPad>
__device__ __forceinline__ uint32_t segment_word(
    const uint32_t* __restrict__ mwords, const int32_t* __restrict__ mlens,
    const int* s_off, const int* s_len, int lo, int hi, int pos,
    long long first, int n, long long nm, long long seg_end, int mcu_words) {
  const int i = last_at_most(s_off, lo, hi, pos);
  int o = s_off[i], mlen = s_len[i];
  long long m = first + i;
  uint32_t acc = 0;
  int filled = 0;
  for (;;) {
    const int avail = o + mlen - pos;
    if (avail > 0) {
      const int take = min(avail, 32 - filled);
      const int b = pos - o;                              // bit in row m
      const uint32_t* row = mwords + m * mcu_words + (b >> 5);
      const int sh = b & 31;
      const uint32_t hi_w = row[0];
      const uint32_t lo_w = sh + take > 32 ? row[1] : 0u;
      acc |= (__funnelshift_l(lo_w, hi_w, sh) >> (32 - take))
             << (32 - filled - take);
      filled += take;
      pos += take;
      if (filled == 32) break;
    }
    o += mlen;
    if (++m >= seg_end) break;                            // segment ends
    const long long li = m - first;
    mlen = li < n ? s_len[li] : (m < nm ? mlens[m] : 0);
  }
  if (kPad && filled < 32) {          // 1-pad the segment's last byte
    const int padb = (8 - (filled & 7)) & 7;
    acc |= ((1u << padb) - 1u) << (32 - filled - padb);
  }
  return acc;
}

// Bit positions inside a tile are tile-relative int32: a tile holds at most
// kMaxTile rows narrower than kMaxRowWords. Tickets n_tiles .. n_tiles +
// n_seg * tails - 1 are tail tiles (kZeroTail, split segments only).
template <bool kPad, bool kZeroTail, int kSplit>
__global__ void __launch_bounds__(kThreads, 2)
seg_merge_mcu_kernel(const uint32_t* __restrict__ mwords,
                     const int32_t* __restrict__ mlens,
                     uint32_t* __restrict__ out, int32_t* __restrict__ seg_bits,
                     unsigned long long* __restrict__ scratch, long long nm,
                     long long n_seg, long long mps, int mcu_words,
                     long long seg_words, long long spt, long long tps,
                     long long n_tiles, long long tails) {
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
    if constexpr (kZeroTail) {
      if (split && t >= n_tiles) {
        // A tail tile: share j of segment s's row, past its data.
        const long long u = t - n_tiles;
        if (u >= n_seg * tails) break;
        const long long s = u / tails, j = u - s * tails;
        if (tid == 0) {
          const unsigned long long* st = &status[s * tps + tps - 1];
          unsigned long long v;
          while (((v = jt::observe(st)) >> 62) != 2) {
          }
          s_carry = (long long)(v & jt::kValue);
        }
        __syncthreads();
        // Words [lo, hi) of the row: up to 3 alone to a 16-byte boundary,
        // then 16-byte stores (rows are whole quads, 16-byte aligned).
        const long long lo = max((s_carry + 31) >> 5, j * kTailWords);
        const long long hi = min((j + 1) * kTailWords, seg_words);
        const long long a = min((lo + 3) & ~3LL, hi);
        uint32_t* row = out + s * seg_words;
        if (tid < a - lo) row[lo + tid] = 0u;
        uint4* row4 = reinterpret_cast<uint4*>(row);
        for (long long q4 = (a >> 2) + tid; q4 < (hi >> 2); q4 += kThreads)
          row4[q4] = make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();              // s_tile and s_carry free again
        continue;
      }
    }
    if (t >= n_tiles) break;
    // The tile: whole segments s0 .. s0 + np - 1, or part c of segment s0.
    const long long s0 = split ? t / tps : t * spt;
    const long long c = split ? t - s0 * tps : 0;
    const int np = split ? 1 : (int)min(spt, n_seg - s0);
    const int per = (int)min(mps, (long long)kMaxTile);   // rows a segment
    // A segment split for its row's width alone is one tile.
    const long long rows_t = kZeroTail && mps <= kMaxTile ? mps : kSplit;
    const long long first = s0 * mps + c * rows_t;        // its first row
    const int n = split ? (int)min(rows_t, mps - c * rows_t)
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
    if (kZeroTail && !split && tid == 0) s_wpre[np] = n_words;
    __syncthreads();

    if (kZeroTail && !split) {
      // 4'. The tile's rows [s0 * seg_words, (s0 + np) * seg_words) hold
      // its segments' words and zeros past them: the zeros first, their
      // stores issued before the data words' loads. Thread tid takes quad
      // qq of row p (words 4qq .. 4qq + 3), kThreads quads further a
      // round: a 16-byte store past the data, single words in the quad
      // where the data ends.
      const int sw4 = (int)max(seg_words >> 2, 1LL);      // quads a row
      const int step_p = kThreads / sw4, step_q = kThreads - step_p * sw4;
      int p = tid / sw4, qq = tid - p * sw4;
      uint32_t* dst = out + s0 * seg_words;
      uint4* dst4 = reinterpret_cast<uint4*>(dst);
      for (long long f = tid; f < np * (seg_words >> 2); f += kThreads) {
        const int nwp = s_wpre[p + 1] - s_wpre[p];
        if (4 * qq >= nwp)
          dst4[f] = make_uint4(0u, 0u, 0u, 0u);
        else
          for (int w = nwp; w < 4 * qq + 4; ++w) dst[4 * f - 4 * qq + w] = 0u;
        p += step_p;
        qq += step_q;
        if (qq >= sw4) {
          qq -= sw4;
          ++p;
        }
      }
    }

    // 4. Each word from the row that holds its first bit and those after.
    for (int f = tid; f < n_words; f += kThreads) {
      const int p = np == 1 ? 0 : last_at_most(s_wpre, 0, np - 1, f);
      const int qi = f - s_wpre[p];                       // word in the tile
      const long long seg = s0 + p;
      const int lo = p * per;
      out[seg * seg_words + q_lo + qi] = segment_word<kPad>(
          mwords, mlens, s_off, s_len, lo, split ? n - 1 : lo + per - 1,
          32 * qi + (split ? lead : s_off[lo]), first, n, nm,
          (seg + 1) * mps, mcu_words);
    }
    __syncthreads();                  // shared memory free for the next tile
  }
}

// The launch of one instance: rows [nm, mcu_words] (bits past each length
// ignored, never read past its valid words) and lengths [nm] -> n_seg
// segments of mps rows (row nm and up are zero-length pads; nm <= n_seg *
// mps) in rows of seg_words words, and seg_bits [n_seg]. scratch:
// kScratchHead + a word a data tile where segments are split (mps >
// kMaxTile: ceil(mps / kSplit) tiles a segment; with the zero tail also
// seg_words > kTailWords: one), else unused (may be null). With the zero
// tail, seg_words must be a multiple of 4 and out 16-byte aligned.
template <bool kPad, bool kZeroTail, int kSplit>
int launch(const int32_t* mwords, const int32_t* mlens, int32_t* out,
           int32_t* seg_bits, unsigned long long* scratch, long long nm,
           long long n_seg, long long mps, int mcu_words, long long seg_words,
           cudaStream_t stream) {
  if (n_seg <= 0) return 0;
  if (mps <= 0 || nm < 0 || nm > n_seg * mps || mcu_words <= 0 ||
      mcu_words >= kMaxRowWords || seg_words < 0 ||
      (kZeroTail && (seg_words >= (1LL << 31) || seg_words % 4)))
    return (int)cudaErrorInvalidValue;
  if (kZeroTail && reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  static_assert(kSplit > 0 && kSplit <= kMaxTile, "a split tile's rows");
  const bool split = mps > kMaxTile || (kZeroTail && seg_words > kTailWords);
  // Whole rows (the zero tail) are mostly stores: fill a tile's kMaxTile
  // rows, so its scan and searches are paid once for the most stores.
  const long long target = kZeroTail ? kMaxTile : kTargetMcus;
  const long long spt = split ? 0 : target / mps > 1 ? target / mps : 1;
  // A segment of up to kMaxTile rows split for its row's width (the zero
  // tail) is one data tile, so its data takes no look-back.
  const long long tps = split && mps > kMaxTile ? (mps + kSplit - 1) / kSplit
                                                : 1;
  const long long n_tiles = split ? n_seg * tps : (n_seg + spt - 1) / spt;
  const long long tails =
      kZeroTail && split ? (seg_words + kTailWords - 1) / kTailWords : 0;
  cudaError_t err;
  if (split) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(scratch, 0,
                          (size_t)(kScratchHead + n_tiles) * sizeof(long long),
                          stream);
    if (err != cudaSuccess) return (int)err;
  }
  int resident = 0;
  const int e = jt::resident_blocks(
      seg_merge_mcu_kernel<kPad, kZeroTail, kSplit>, kThreads, 0, &resident);
  if (e) return e;
  const long long total = n_tiles + n_seg * tails;
  const long long grid = total < resident ? total : resident;
  seg_merge_mcu_kernel<kPad, kZeroTail, kSplit>
      <<<(unsigned)grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(mwords), mlens,
      reinterpret_cast<uint32_t*>(out), seg_bits, scratch, nm, n_seg, mps,
      mcu_words, seg_words, spt, tps, n_tiles, tails);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: MCU streams [nm, mcu_words] and lengths [nm] -> n_seg segments of mps
// MCUs, 1-padded, in rows of seg_words words (words past ceil(seg_bits /
// 32) not written), and seg_bits [n_seg].
extern "C" int jt_seg_merge_mcu(const int32_t* mwords, const int32_t* mlens,
                                int32_t* out, int32_t* seg_bits,
                                unsigned long long* scratch, long long nm,
                                long long n_seg, long long mps, int mcu_words,
                                long long seg_words, cudaStream_t stream) {
  return launch<true, false, kSplitMcus>(mwords, mlens, out, seg_bits,
                                          scratch, nm, n_seg, mps, mcu_words,
                                          seg_words, stream);
}

// K10: block streams [n_seg * bps, block_words] and lengths -> n_seg
// segments of bps blocks, 1-padded, in whole rows of seg_words words (zero
// past the data), and seg_bits [n_seg].
extern "C" int jt_seg_merge_v1(const int32_t* words, const int32_t* lens,
                               int32_t* out, int32_t* seg_bits,
                               unsigned long long* scratch, long long n_seg,
                               long long bps, int block_words,
                               long long seg_words, cudaStream_t stream) {
  return launch<true, true, kZeroSplit>(words, lens, out, seg_bits, scratch,
                                        n_seg * bps, n_seg, bps, block_words,
                                        seg_words, stream);
}

// K8: block streams [n_mcu * g, block_words] and lengths -> n_mcu MCU
// streams of g blocks, unpadded, in whole rows of mcu_words words (zero
// past the data; words past the row dropped), and their true lengths
// [n_mcu].
extern "C" int jt_mcu_merge(const int32_t* words, const int32_t* lens,
                            int32_t* mwords, int32_t* mlens,
                            unsigned long long* scratch, long long n_mcu,
                            long long g, int block_words, long long mcu_words,
                            cudaStream_t stream) {
  return launch<false, true, kZeroSplit>(words, lens, mwords, mlens,
                                         scratch, n_mcu * g, n_mcu, g,
                                         block_words, mcu_words, stream);
}

// K9: MCU streams [n_seg * mps, mcu_words] and lengths -> n_seg segments of
// mps MCUs, 1-padded, in whole rows of seg_words words (zero past the
// data), and seg_bits [n_seg].
extern "C" int jt_seg_merge_window(const int32_t* mwords,
                                   const int32_t* mlens, int32_t* out,
                                   int32_t* seg_bits,
                                   unsigned long long* scratch,
                                   long long n_seg, long long mps,
                                   int mcu_words, long long seg_words,
                                   cudaStream_t stream) {
  return launch<true, true, kSplitMcus>(mwords, mlens, out, seg_bits,
                                        scratch, n_seg * mps, n_seg, mps,
                                        mcu_words, seg_words, stream);
}
