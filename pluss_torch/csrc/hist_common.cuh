// Shared-memory, warp-aggregated [NBINS] histogram epilogue of the event
// kernels (event_hist.cu, masked_hist.cu).
//
// Each block keeps its own shared-memory bins.  Lanes of a warp that land
// in the same bin elect one leader (__match_any_sync), which adds the
// group's size: a warp full of equal short reuses costs one shared atomic,
// not 32.  At the end each block adds its nonzero bins to the int64 output
// with one global atomic per bin.  Integer atomics make the result exact
// and independent of order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pluss {

constexpr int kNBins = 49;       // pluss_torch.config.NBINS
constexpr int kHistThreads = 256;
constexpr int kHistBlocksPerSM = 8;  // 8 x 256 threads fill an SM's 2048

// Histogram slot of a reuse: bits - clz(reuse) for reuse >= 1, the
// JAX package's 1 + floor(log2(reuse)) at the reuse's own width.
template <typename P>
__device__ __forceinline__ int log2_slot(P reuse);

template <>
__device__ __forceinline__ int log2_slot<int32_t>(int32_t reuse) {
  return 32 - __clz(reuse);
}

template <>
__device__ __forceinline__ int log2_slot<int64_t>(int64_t reuse) {
  return 64 - __clzll(reuse);
}

__device__ __forceinline__ void hist_init(unsigned int* s_hist) {
  for (int b = threadIdx.x; b < kNBins; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();
}

// Every lane of the warp must call this (full-mask vote); bin < 0 or
// bin >= kNBins adds nothing.
__device__ __forceinline__ void hist_add(unsigned int* s_hist, int bin) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int lane = threadIdx.x & 31;
  if (bin >= 0 && bin < kNBins && lane == __ffs(peers) - 1) {
    atomicAdd(&s_hist[bin], static_cast<unsigned int>(__popc(peers)));
  }
}

__device__ __forceinline__ void hist_flush(const unsigned int* s_hist,
                                           unsigned long long* out) {
  __syncthreads();
  for (int b = threadIdx.x; b < kNBins; b += blockDim.x) {
    const unsigned int c = s_hist[b];
    if (c) atomicAdd(&out[b], static_cast<unsigned long long>(c));
  }
}

// Blocks of a grid-stride pass over `need_blocks` blocks of work spread
// over `rows` grid rows: enough to fill the card, no more than the work.
inline cudaError_t hist_grid_x(long long need_blocks, long long rows,
                               unsigned* grid_x) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long want = static_cast<long long>(sms) * kHistBlocksPerSM / rows;
  if (want < 1) want = 1;
  *grid_x = static_cast<unsigned>(need_blocks < want ? need_blocks : want);
  return cudaSuccess;
}

}  // namespace pluss
