// The default route's whole chain in one host call: K1 (jt_pixel, or K12
// jt_pixel_dc with the DC plane), K2 (jt_block_pack_mcu_segments), K3
// (jt_seg_merge_mcu) and K4 (jt_stuff_segments) or K5 (jt_stuff_chunks),
// enqueued in that order on one stream, each through its own launcher with
// the arguments its Python wrapper would pass. No kernel of its own: it
// replaces no TPU kernel, and exists because on the H100 the host's
// per-call Python and five ctypes launches took longer than the device's
// 0.23 ms of work at 4K 4:2:0, so the host set the pace
// (jpegtpu_torch/kernels/chain.py, PERF.md).
//
// The plan (ChainPlan, built once per shape and tables by chain.py) holds
// every pointer and size that does not change between calls; a call brings
// the image, two buffers, the bounds and where to report what it launched.
// Intermediates live where the kernel after next no longer needs them, so
// a call holds no more memory than the per-kernel path's largest moment:
//
//   work  K1's coefficients [n_mcu, g * 64] (and its DC plane at dc_at),
//         then, once K2 has read them, K3's segments [n_seg, seg_words],
//         seg_bits at seg_bits_at, K3's scratch at merge_scratch_at (-1:
//         none) and K4 / K5's scratch at stuff_scratch_at
//   out   K2's MCU streams [n_mcu, mcu_words] and lengths at mlens_at,
//         then, once K3 has read them, the scan
//
// Every field is 8 bytes wide, so ctypes lays out its mirror (chain.py's
// ChainArgs) as the compiler does; the names and their order are checked
// against that mirror on the CPU (tests/test_torch_plan.py).

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {
int jt_pixel(const uint8_t* img, const float* lum, const float* chroma,
             const float* bias, int32_t* out, long long n_mcu, long long nrx,
             long long row_bytes, long long h, long long my, int mh, int mw,
             int groups, cudaStream_t stream);
int jt_pixel_dc(const uint8_t* img, const float* lum, const float* chroma,
                const float* bias, int32_t* out, int32_t* dc, long long n_mcu,
                long long nrx, long long row_bytes, long long h, long long my,
                int mh, int mw, int groups, cudaStream_t stream);
int jt_block_pack_mcu_segments(
    const int32_t* coeffs, const int32_t* dc, long long dc_mcu_stride,
    long long dc_block_step, const int32_t* dc_codes, const int32_t* dc_lens,
    const int32_t* ac_codes, const int32_t* ac_lens, int32_t* mwords,
    int32_t* mlens, long long n_mcu, int g, int n_luma, long long restart,
    int mcu_words, cudaStream_t stream);
int jt_seg_merge_mcu(const int32_t* mwords, const int32_t* mlens,
                     int32_t* out, int32_t* seg_bits,
                     unsigned long long* scratch, long long nm,
                     long long n_seg, long long mps, int mcu_words,
                     long long seg_words, cudaStream_t stream);
int jt_stuff_segments(const int32_t* seg_words, const int32_t* seg_bits,
                      const int32_t* mnum, uint8_t* out, int64_t* bounds,
                      unsigned long long* scratch, long long n_seg,
                      long long seg_stride, long long segs_per_image,
                      cudaStream_t stream);
int jt_stuff_chunks(const int32_t* seg_words, const int32_t* seg_bits,
                    const int32_t* mnum, uint8_t* out, int64_t* bounds,
                    unsigned long long* scratch, long long n_seg,
                    long long seg_stride, cudaStream_t stream);
}

struct ChainPlan {
  // The tables: the operator's factors and bias, the Huffman LUTs, the RST
  // marker table.
  const float* lum;
  const float* chroma;
  const float* bias;
  const int32_t* dc_codes;
  const int32_t* dc_lens;
  const int32_t* ac_codes;
  const int32_t* ac_lens;
  const int32_t* mnum;
  // K1 / K12: the tall view [n * h, W, 3], my MCU rows of nrx an image.
  long long n_mcu;
  long long nrx;
  long long row_bytes;
  long long h;
  long long my;
  long long mh;
  long long mw;
  long long groups;
  long long with_dc;
  // K2: the DC of block b of MCU m at src[m * dc_stride + b * dc_step].
  long long dc_stride;
  long long dc_step;
  long long g;
  long long n_luma;
  long long restart;
  long long mcu_words;
  // K3.
  long long n_seg;
  long long mps;
  long long seg_words;
  // K4 (segments an image), or K5 where chunks is 1.
  long long spi;
  long long chunks;
  // Byte offsets in work and out.
  long long dc_at;
  long long seg_bits_at;
  long long merge_scratch_at;
  long long stuff_scratch_at;
  long long mlens_at;
};

// Enqueues the chain on stream; 0 or the first launcher's CUDA error (the
// launchers after it are not called). launched (host memory, zeroed by the
// caller) gets 1 in the entry of each launcher called that returned 0:
// [0] jt_pixel, [1] jt_pixel_dc, [2] jt_block_pack_mcu_segments,
// [3] jt_seg_merge_mcu, [4] jt_stuff_segments, [5] jt_stuff_chunks
// (chain.py's CHAINED), so that each kernel's launch count is what ran.
extern "C" int jt_encode_chain(const ChainPlan* p, const uint8_t* img,
                               uint8_t* work, uint8_t* out, int64_t* bounds,
                               long long* launched, cudaStream_t stream) {
  int32_t* coeffs = reinterpret_cast<int32_t*>(work);
  int32_t* dc = nullptr;
  int err;
  if (p->with_dc) {
    dc = reinterpret_cast<int32_t*>(work + p->dc_at);
    err = jt_pixel_dc(img, p->lum, p->chroma, p->bias, coeffs, dc, p->n_mcu,
                      p->nrx, p->row_bytes, p->h, p->my, (int)p->mh,
                      (int)p->mw, (int)p->groups, stream);
    if (err) return err;
    launched[1] = 1;
  } else {
    err = jt_pixel(img, p->lum, p->chroma, p->bias, coeffs, p->n_mcu, p->nrx,
                   p->row_bytes, p->h, p->my, (int)p->mh, (int)p->mw,
                   (int)p->groups, stream);
    if (err) return err;
    launched[0] = 1;
  }

  int32_t* mwords = reinterpret_cast<int32_t*>(out);
  int32_t* mlens = reinterpret_cast<int32_t*>(out + p->mlens_at);
  err = jt_block_pack_mcu_segments(
      coeffs, dc ? dc : coeffs, p->dc_stride, p->dc_step, p->dc_codes,
      p->dc_lens, p->ac_codes, p->ac_lens, mwords, mlens, p->n_mcu, (int)p->g,
      (int)p->n_luma, p->restart, (int)p->mcu_words, stream);
  if (err) return err;
  launched[2] = 1;

  int32_t* seg = reinterpret_cast<int32_t*>(work);
  int32_t* seg_bits = reinterpret_cast<int32_t*>(work + p->seg_bits_at);
  unsigned long long* merge_scratch =
      p->merge_scratch_at < 0
          ? nullptr
          : reinterpret_cast<unsigned long long*>(work + p->merge_scratch_at);
  err = jt_seg_merge_mcu(mwords, mlens, seg, seg_bits, merge_scratch,
                         p->n_mcu, p->n_seg, p->mps, (int)p->mcu_words,
                         p->seg_words, stream);
  if (err) return err;
  launched[3] = 1;

  unsigned long long* stuff_scratch =
      reinterpret_cast<unsigned long long*>(work + p->stuff_scratch_at);
  if (p->chunks) {
    err = jt_stuff_chunks(seg, seg_bits, p->mnum, out, bounds, stuff_scratch,
                          p->n_seg, p->seg_words, stream);
    if (err) return err;
    launched[5] = 1;
  } else {
    err = jt_stuff_segments(seg, seg_bits, p->mnum, out, bounds,
                            stuff_scratch, p->n_seg, p->seg_words, p->spi,
                            stream);
    if (err) return err;
    launched[4] = 1;
  }
  return 0;
}
