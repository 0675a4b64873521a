// The size of a persistent grid, shared by the launchers of K1 and K12-K14
// (pixel_mma.cu, pixel_dma.cu), K2 (block_pack.cu), K3 (seg_merge.cu) and
// K4/K5 (stuff.cu): as many blocks of a kernel as are resident on the
// current device at once.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace jt {

// The blocks of `kernel`, threads a block and smem bytes of dynamic shared
// memory each, that fit on the current device at once, into *blocks. A
// kernel that takes more than the default 48 KB of dynamic shared memory is
// opted in to it here (such a kernel launches at one size). Set up on the
// first call for each device, kernel and size and kept, so a launch after
// the first makes no query. 0 or the CUDA error; a kernel that does not fit
// at all gives cudaErrorInvalidConfiguration.
inline int resident_blocks(const void* kernel, int threads, size_t smem,
                           int* blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  static Entry cache[256];
  static int n_cache = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i) {
    const Entry& c = cache[i];
    if (c.kernel == kernel && c.dev == dev && c.smem == smem) {
      *blocks = c.blocks;
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  if ((smem > 48 * 1024 &&
       (e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)) != cudaSuccess) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (n_cache < (int)(sizeof(cache) / sizeof(cache[0])))
    cache[n_cache++] = Entry{kernel, dev, smem, sms * per_sm};
  *blocks = sms * per_sm;
  return 0;
}

template <typename Kernel>
inline int resident_blocks(Kernel* kernel, int threads, size_t smem,
                           int* blocks) {
  return resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem,
                         blocks);
}

}  // namespace jt
