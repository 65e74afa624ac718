// Masked event histogram of a classified event stream.
//
// Replaces the TPU kernel pluss/ops/pallas_events.py:263 (_hist_kernel,
// built by _masked_hist_fn at :316/:320, wrapped by fused_event_histogram
// at :347), which the JAX trace replay runs on every segmented batch
// through reuse.event_histogram (pluss/trace.py:747, pluss/ops/reuse.py:323).
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
// Bound.  Each entry is read once: reuse (4 or 8 B) + three bool masks
// (3 B), plus the 49 x 8 B output.  At the trace path's 2^24-entry batch
// that is ~117 MB with int32 reuse, 35 us at the H100's 3.35 TB/s: the
// kernel is bound by bytes, so its design is about keeping loads wide and
// many in flight, and keeping the binning off the memory pipe's way.
//
// Design.
// - Runs of 16.  Each thread takes 16 consecutive entries per grid-stride
//   step: every mask is one 16-B vector load, the reuse four (int32) or
//   eight (int64) 16-B loads, all issued before any branch (the reuse is
//   read whether or not the entry is an event; the bound counts it
//   anyway).  The next step's loads are issued before this step is
//   binned, so two steps are in flight per thread.
// - Alignment.  The wrapper picks a scalar head of h < 16 entries after
//   which as many of the four arrays as possible sit on 16-B boundaries
//   (ops/event_hist.py:masked_vector_plan) and says which ones do (`vec`);
//   an array that does not is read with scalar loads in the same loop.
//   The head and the ragged tail (< 16 entries) are binned one entry per
//   thread.  So any legal contiguous view is taken as it is.
// - Privatised bins.  Thread t keeps its own uint32 counter of each bin in
//   dynamic shared memory, laid out [NBINS][256] so that thread t always
//   hits bank t % 32: the hot loop has no atomic, no vote and no bank
//   conflict, and a run of equal bins (the trace's reuses crowd into a few)
//   costs nothing extra.  49 x 256 x 4 = 50,176 B per block, above the
//   static 48 KB, so the launch sets the dynamic-shared-memory attribute.
// - Merge.  Each warp sums the 256 copies of its bins (uint64), and adds a
//   nonzero bin to the int64 output with one global atomic: exact in any
//   order.  The entry point zeroes the output with one cudaMemsetAsync on
//   the launch's stream.
// - Grid.  One resident wave (SMs x blocks per SM from the occupancy
//   query), no more blocks than the work needs.
//
// The per-thread counters cannot wrap: a thread takes at most
// ceil(n / (blocks x 256)) runs of 16, far below 2^32 for any n a tensor
// can hold.
//
// Bound to Python with ctypes (pluss_torch/ops/event_hist.py): the C entry
// points take raw device pointers, the head and alignment plan, and the
// CUDA stream, launch on that stream, never synchronize, and return the
// first CUDA error.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hist_common.cuh"

namespace {

using pluss::kNBins;

constexpr int kThreads = 256;
constexpr int kRun = 16;  // entries per thread per step
constexpr int kSmemBytes = kNBins * kThreads * 4;
constexpr int kMaxDevices = 64;

// bits of `vec`: the arrays read with 16-B vector loads after the head
constexpr int kVecEvt = 1, kVecShare = 2, kVecCold = 4, kVecReuse = 8;

// 16 bytes of a mask from p: one vector load when p is 16-B aligned
__device__ __forceinline__ uint4 load_mask(const uint8_t* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = static_cast<uint32_t>(__ldg(p + 4 * q))
           | static_cast<uint32_t>(__ldg(p + 4 * q + 1)) << 8
           | static_cast<uint32_t>(__ldg(p + 4 * q + 2)) << 16
           | static_cast<uint32_t>(__ldg(p + 4 * q + 3)) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word_of(uint4 m, int q) {
  return q == 0 ? m.x : q == 1 ? m.y : q == 2 ? m.z : m.w;
}

// byte j (0..15) of a 16-byte mask, as a truth value
__device__ __forceinline__ bool byte_of(uint4 m, int j) {
  return (word_of(m, j >> 2) >> (8 * (j & 3))) & 0xffu;
}

template <typename R>
struct Run {
  R reuse[kRun];
  uint4 evt, share, cold;
};

template <typename R>
__device__ __forceinline__ void load_run(Run<R>& r, const R* reuse,
                                         const uint8_t* is_evt,
                                         const uint8_t* share,
                                         const uint8_t* cold, int64_t i,
                                         int vec) {
  if (vec & kVecReuse) {
    constexpr int kPer = 16 / sizeof(R);  // entries per 16-B load
    using V = typename std::conditional<sizeof(R) == 4, int4, longlong2>::type;
    const V* p = reinterpret_cast<const V*>(reuse + i);
#pragma unroll
    for (int q = 0; q < kRun / kPer; ++q) {
      const V v = __ldg(p + q);
      if constexpr (sizeof(R) == 4) {
        r.reuse[4 * q] = v.x;
        r.reuse[4 * q + 1] = v.y;
        r.reuse[4 * q + 2] = v.z;
        r.reuse[4 * q + 3] = v.w;
      } else {
        r.reuse[2 * q] = v.x;
        r.reuse[2 * q + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) r.reuse[j] = reuse[i + j];
  }
  r.evt = load_mask(is_evt + i, vec & kVecEvt);
  r.share = load_mask(share + i, vec & kVecShare);
  r.cold = load_mask(cold + i, vec & kVecCold);
}

// Bin one entry into this thread's counters (column `mine` of the
// [NBINS][kThreads] layout).
template <typename R>
__device__ __forceinline__ void count(unsigned* mine, R reuse, bool is_evt,
                                      bool share, bool cold,
                                      int include_cold) {
  const bool evt = is_evt && !share;
  const int bin = evt ? pluss::log2_slot<R>(reuse > 0 ? reuse : R(1)) : 0;
  if ((evt || (include_cold && cold)) && bin < kNBins) {
    mine[bin * kThreads] += 1u;
  }
}

template <typename R>
__device__ __forceinline__ void count_run(unsigned* mine, const Run<R>& r,
                                          int include_cold) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    count<R>(mine, r.reuse[j], byte_of(r.evt, j), byte_of(r.share, j),
             byte_of(r.cold, j), include_cold);
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
masked_hist(const R* __restrict__ reuse, const uint8_t* __restrict__ is_evt,
            const uint8_t* __restrict__ share,
            const uint8_t* __restrict__ cold, int include_cold, int64_t n,
            int64_t head, int vec, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned s_cnt[];  // [kNBins][kThreads]
  unsigned* mine = s_cnt + threadIdx.x;
  // a thread's column is its own until the merge: no barrier needed here
#pragma unroll
  for (int b = 0; b < kNBins; ++b) mine[b * kThreads] = 0u;

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t runs = (n - head) / kRun;
  const int64_t body_end = head + runs * kRun;

  // the scalar head [0, head) and the ragged tail [body_end, n)
  const int64_t n_edge = head + (n - body_end);
  for (int64_t e = tid; e < n_edge; e += stride) {
    const int64_t i = e < head ? e : body_end + (e - head);
    count<R>(mine, reuse[i], __ldg(is_evt + i), __ldg(share + i),
             __ldg(cold + i), include_cold);
  }

  // the body: runs of 16, the next run's loads in flight while this one
  // is binned
  int64_t r = tid;
  Run<R> cur;
  if (r < runs) {
    load_run<R>(cur, reuse, is_evt, share, cold, head + r * kRun, vec);
  }
  for (; r < runs; r += stride) {
    Run<R> nxt;
    const int64_t rn = r + stride;
    if (rn < runs) {
      load_run<R>(nxt, reuse, is_evt, share, cold, head + rn * kRun, vec);
    }
    count_run<R>(mine, cur, include_cold);
    cur = nxt;
  }

  // merge: warp w sums bins w, w + 8, ... over the block's 256 copies
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < kNBins; b += kThreads / 32) {
    unsigned long long c = 0;
#pragma unroll
    for (int t = lane; t < kThreads; t += 32) c += s_cnt[b * kThreads + t];
#pragma unroll
    for (int d = 16; d; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
    if (lane == 0 && c) atomicAdd(&out[b], c);
  }
}

// Blocks of one resident wave on the current device: set the kernel's
// shared-memory attribute and ask the occupancy calculator, once per
// device and reuse width.
template <typename R>
cudaError_t wave_blocks(int* blocks) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(masked_hist<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_hist<R>, kThreads, kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename R>
int launch(const void* reuse, const void* is_evt, const void* share,
           const void* cold, int include_cold, long long n, long long head,
           int vec, void* out, void* stream) {
  if (n <= 0 || head < 0 || head > n || head >= kRun
      || (reinterpret_cast<uintptr_t>(reuse) % sizeof(R))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const R* r = static_cast<const R*>(reuse) + head;
  const uint8_t* e = static_cast<const uint8_t*>(is_evt) + head;
  const uint8_t* s = static_cast<const uint8_t*>(share) + head;
  const uint8_t* c = static_cast<const uint8_t*>(cold) + head;
  // a vector flag the pointers do not honour would fault: refuse it
  if (((vec & kVecReuse) && !aligned16(r)) || ((vec & kVecEvt) && !aligned16(e))
      || ((vec & kVecShare) && !aligned16(s))
      || ((vec & kVecCold) && !aligned16(c))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, kNBins * sizeof(unsigned long long), st);
  int wave = 0;
  if (err == cudaSuccess) err = wave_blocks<R>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long runs = (n - head) / kRun;
  const long long edge = n - runs * kRun;  // head + tail entries
  const long long work = runs > edge ? runs : edge;
  const long long need = (work + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
  masked_hist<R><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const R*>(reuse), static_cast<const uint8_t*>(is_evt),
      static_cast<const uint8_t*>(share), static_cast<const uint8_t*>(cold),
      include_cold, n, head, vec, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pluss_masked_hist_i32(const void* reuse, const void* is_evt,
                                     const void* share, const void* cold,
                                     int include_cold, long long n,
                                     long long head, int vec, void* out,
                                     void* stream) {
  return launch<int32_t>(reuse, is_evt, share, cold, include_cold, n, head,
                         vec, out, stream);
}

extern "C" int pluss_masked_hist_i64(const void* reuse, const void* is_evt,
                                     const void* share, const void* cold,
                                     int include_cold, long long n,
                                     long long head, int vec, void* out,
                                     void* stream) {
  return launch<int64_t>(reuse, is_evt, share, cold, include_cold, n, head,
                         vec, out, stream);
}
