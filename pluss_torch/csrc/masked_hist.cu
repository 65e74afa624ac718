// Masked event histogram of a classified event stream.
//
// Replaces the TPU kernel pluss/ops/pallas_events.py:_hist_kernel (built
// by _masked_hist_fn, wrapped by fused_event_histogram), which the JAX
// trace replay runs on every segmented batch through
// reuse.event_histogram (pluss/trace.py:747, pluss/ops/reuse.py:323).
//
// What it computes, over n entries of window_events' outputs:
//   evt = is_evt && !share
//   bin = evt ? bits - clz(max(reuse, 1)) : 0   (bits = reuse's width)
//   wgt = include_cold ? (evt || cold) : evt
//   out[bin] += wgt   for bin < NBINS; a bin at or above NBINS weighs
//                     nothing (the one-hot form's rule), it is not clamped.
// out is int64 [NBINS]; it is bit-identical to the plain torch version
// (pluss_torch/ops/event_hist.py:masked_histogram_plain).
//
// Design.  The TPU kernel needs int32 evt/wgt masks and the stream padded
// to 8192-entry blocks for its (8, 128) tiles, and int64 reuse goes to XLA
// instead.  Here the kernel reads window_events' outputs as they are (the
// reuse in its own width, int32 or int64, and three bool masks), masks the
// ragged tail itself, and folds the weight rule in: the wrapper makes no
// mask, padding or copy.  One grid-stride pass; each block bins into
// shared memory with warp-aggregated atomics and flushes with one integer
// atomic per bin (hist_common.cuh): exact in any order.  Trace reuses
// crowd into a few bins, which is where the warp aggregation pays.
//
// Bound.  Each entry is read once: reuse (4 or 8 B) + three masks (3 B),
// plus the 49 x 8 B output.  At the trace path's 2^24-entry batch that is
// ~117 MB (int32 reuse), ~35 us at the H100's 3.35 TB/s: bound by bytes.
//
// Bound to Python with ctypes (pluss_torch/ops/event_hist.py): the C entry
// points take raw device pointers and the CUDA stream, launch on that
// stream, never synchronize, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_common.cuh"

namespace {

using pluss::kHistThreads;
using pluss::kNBins;

template <typename R>
__global__ void __launch_bounds__(kHistThreads)
masked_hist(const R* __restrict__ reuse, const uint8_t* __restrict__ is_evt,
            const uint8_t* __restrict__ share,
            const uint8_t* __restrict__ cold, int include_cold, int64_t n,
            unsigned long long* __restrict__ out) {
  __shared__ unsigned int s_hist[kNBins];
  pluss::hist_init(s_hist);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // `base` is uniform across the block: every lane reaches hist_add's
  // full-mask vote the same number of times
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    int bin = -1;  // -1: weighs nothing
    if (i < n) {
      const bool evt = is_evt[i] && !share[i];
      if (evt) {
        const R r = reuse[i];
        bin = pluss::log2_slot<R>(r > 0 ? r : R(1));
      } else if (include_cold && cold[i]) {
        bin = 0;
      }
    }
    pluss::hist_add(s_hist, bin);
  }
  pluss::hist_flush(s_hist, out);
}

template <typename R>
int launch(const void* reuse, const void* is_evt, const void* share,
           const void* cold, int include_cold, long long n, void* out,
           void* stream) {
  if (n <= 0) return 0;  // nothing to count
  unsigned gx = 0;
  const cudaError_t err =
      pluss::hist_grid_x((n + kHistThreads - 1) / kHistThreads, 1, &gx);
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_hist<R><<<gx, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const R*>(reuse), static_cast<const uint8_t*>(is_evt),
      static_cast<const uint8_t*>(share), static_cast<const uint8_t*>(cold),
      include_cold, n, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pluss_masked_hist_i32(const void* reuse, const void* is_evt,
                                     const void* share, const void* cold,
                                     int include_cold, long long n, void* out,
                                     void* stream) {
  return launch<int32_t>(reuse, is_evt, share, cold, include_cold, n, out,
                         stream);
}

extern "C" int pluss_masked_hist_i64(const void* reuse, const void* is_evt,
                                     const void* share, const void* cold,
                                     int include_cold, long long n, void* out,
                                     void* stream) {
  return launch<int64_t>(reuse, is_evt, share, cold, include_cold, n, out,
                         stream);
}
