// Carried-event histogram of ghost-merged, (line, pos)-sorted windows.
//
// Replaces the TPU kernel pluss/ops/pallas_events.py:_kernel (built by
// _event_hist_fn, wrapped by event_histogram_fused), which the JAX engine
// calls once per sort window per simulated thread (engine._sort_window).
//
// What it computes, per row t of a [T, L] batch (one simulated thread's
// window each): an entry is real when valid and pos >= win_start[t].  A
// real entry whose left neighbour has the same line is
//   - an event with reuse = pos - prev_pos when prev_pos >= 0, or
//   - cold when prev_pos < 0 (the line's ghost says "never touched").
// Events with span > 0 && reuse > span/2 are share events and are left out;
// the others land in slot 1 + floor(log2(max(reuse, 1))).  Cold entries land
// in slot 0.  out[t, :NBINS] (int64) receives the counts.
//
// Design.  The TPU kernel walks 8192-entry blocks of one row in a sequential
// grid, with the shifted neighbour arrays precomputed on the host and the
// row padded to a block multiple.  Here one launch covers all T rows
// (blockIdx.y = row); each CUDA thread reads its entry and its left
// neighbour directly (the neighbour is the previous thread's entry, so the
// second read hits L1) and masks the ragged tail itself.  Each block keeps a
// shared-memory histogram fed by warp-aggregated atomics and flushes it
// with one integer atomicAdd per bin (hist_common.cuh).  Integer atomics
// make the result exact and independent of order: it is bit-identical to
// the plain torch version (pluss_torch/ops/event_hist.py:
// event_histogram_plain).
//
// Bound.  The kernel reads each entry once: key (4 B) + pos (4 or 8 B) +
// span (4 B) + valid (1 B) = 13 or 17 B, and does ~20 integer operations.
// At the main path's shape (mvt-4000: T = 4 rows of ~10.45M entries) that
// is ~546 MB, or ~0.16 ms at the H100's 3.35 TB/s: it is bound by bytes.
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
using pluss::log2_slot;

template <typename P>
__global__ void __launch_bounds__(kHistThreads)
carried_event_hist(const int32_t* __restrict__ key,
                   const P* __restrict__ pos,
                   const int32_t* __restrict__ span,
                   const uint8_t* __restrict__ valid,
                   const P* __restrict__ win_start,
                   int64_t L,
                   unsigned long long* __restrict__ out) {
  __shared__ unsigned int s_hist[kNBins];
  pluss::hist_init(s_hist);

  const int t = blockIdx.y;
  const int64_t row = static_cast<int64_t>(t) * L;
  const P ws = win_start[t];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // `base` is uniform across the block, so every lane of a warp runs the
  // same number of iterations and the full-mask warp vote is legal.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < L; base += stride) {
    const int64_t i = base + threadIdx.x;
    int bin = -1;  // -1: contributes nothing
    if (i > 0 && i < L) {  // entry 0 has no left neighbour
      const int64_t j = row + i;
      const P p = pos[j];
      if (valid[j] && p >= ws && key[j] == key[j - 1]) {
        const P prev = pos[j - 1];
        if (prev < 0) {
          bin = 0;
        } else {
          const P reuse = p - prev;
          const int32_t sp = span[j];
          if (!(sp > 0 && reuse > static_cast<P>(sp / 2))) {
            bin = log2_slot<P>(reuse > 0 ? reuse : P(1));
          }
        }
      }
    }
    pluss::hist_add(s_hist, bin);
  }
  pluss::hist_flush(s_hist, out + static_cast<int64_t>(t) * kNBins);
}

template <typename P>
int launch(const void* key, const void* pos, const void* span,
           const void* valid, const void* win_start, long long T,
           long long L, void* out, void* stream) {
  if (T <= 0 || L <= 0) return 0;  // nothing to count
  if (T > 65535) return static_cast<int>(cudaErrorInvalidValue);
  unsigned gx = 0;
  const cudaError_t err =
      pluss::hist_grid_x((L + kHistThreads - 1) / kHistThreads, T, &gx);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(gx, static_cast<unsigned>(T));
  carried_event_hist<P><<<grid, kHistThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const P*>(pos),
      static_cast<const int32_t*>(span), static_cast<const uint8_t*>(valid),
      static_cast<const P*>(win_start), L,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pluss_event_hist_i32(const void* key, const void* pos,
                                    const void* span, const void* valid,
                                    const void* win_start, long long T,
                                    long long L, void* out, void* stream) {
  return launch<int32_t>(key, pos, span, valid, win_start, T, L, out, stream);
}

extern "C" int pluss_event_hist_i64(const void* key, const void* pos,
                                    const void* span, const void* valid,
                                    const void* win_start, long long T,
                                    long long L, void* out, void* stream) {
  return launch<int64_t>(key, pos, span, valid, win_start, T, L, out, stream);
}
