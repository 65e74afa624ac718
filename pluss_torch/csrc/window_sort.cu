// The sort window's (line, pos) order as one keys-only radix sort of a
// packed 64-bit key: pack, sort, unpack.
//
// Replaces no TPU kernel.  The JAX package sorts a window with XLA's
// lax.sort; the port sorted it with torch.sort, int64 positions in two
// stable full-width passes carrying int64 indices and four gathers after
// them (pluss_torch/ops/reuse.py:sort_columns), about 5x the bytes the
// order needs.
//
// The key of an entry of row r (pluss_torch/ops/window_sort.py:KeyLayout
// sets the field widths from the plan, on the host), high bits to low:
//
//   row | line - line_lo | rel | code
//
//  - line - line_lo: the entry's cache line against the window's first
//    covered line; an invalid entry takes the field's all-ones value, past
//    every covered line, so it sorts last in its row;
//  - rel: 0 for a ghost (one per covered line, carrying the line's last
//    position before the window), pos - win_start[r] + 1 for a real entry;
//  - code: the entry's share-span code.  Positions are unique in a row, so
//    the code never decides the order; it rides in the key so the sort
//    needs no values.
//
// With the row in the top bits, one sort of the flat [R * N] buffer keeps
// every row in its own N entries.  The order is the (line, pos) order of
// sort_columns on every valid entry, the ghost first in each line.
//
//  - window_sort_pack / window_sort_ghosts: each block of the window (a
//    ref's [R, n] (line, pos, code, valid) columns; a covered line range's
//    ghosts, which need no input) writes its columns of the key buffer.
//  - pluss_window_sort: cub::DeviceRadixSort::SortKeys over bits
//    [0, end_bit) on a DoubleBuffer: end_bit / 8 passes of 16 B an entry
//    (a read and a write of the key) where the width needs them, and no
//    gather.
//  - window_sort_unpack: reads each sorted key once and writes the four
//    columns the window's consumers read (key_s int32, pos_s, span_s
//    int32, valid_s); a ghost's pos is the carried last_pos of its line,
//    read here, before the window's tails rewrite it.  An invalid entry
//    gets the fixed fill (LINE_SENTINEL, -1, 0, false): its consumers read
//    only valid_s of it.
//
// The kernels share the prefix window_sort_, by which the profile finds
// them among the card's operations (pluss_torch/profile.py:PORT_KERNELS).
//
// Bound.  Pack reads 14 or 10 B a real entry (line, pos, code, valid) and
// writes 8 B an entry; the sort reads the keys once for its digit counts
// and moves 16 B an entry a pass of 8 bits; unpack reads 8 B and writes 17
// or 13.  At cholesky-2000's largest window ([4, 64,460,012], int64
// positions, a 47-bit key: 6 passes) that is ~38.9 GB, ~11.6 ms at the
// H100's 3.35 TB/s; the card takes ~18.4 ms.
//
// Bound to Python with ctypes (pluss_torch/ops/window_sort.py): the C entry
// points take raw device pointers and the CUDA stream, launch on that
// stream, never synchronize, and return the first CUDA error.  The sort's
// alternate buffer and temporary storage come from the caller (PyTorch's
// caching allocator).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 8 x 256 threads fill an SM's 2048
constexpr int32_t kLineSentinel = INT32_MAX;  // ops/reuse.py:LINE_SENTINEL

// The key's fields; field for field ops/window_sort.py:_Layout.
struct Layout {
  long long line_lo;    // the window's first covered line
  long long line_ones;  // the line field's all-ones value: invalid
  long long rel_mask;   // the rel field's all-ones value
  long long code_mask;  // the code field's all-ones value
  long long s_rel, s_line, s_row;  // each field's lowest bit
};

// Blocks along a row: enough to fill the card, at most one an entry.
cudaError_t grid_of(long long n, long long rows, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (rows > 65535) return cudaErrorInvalidValue;
  long long want = static_cast<long long>(sms) * kBlocksPerSM / rows;
  const long long need = (n + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  *grid = dim3(static_cast<unsigned>(need < want ? need : want),
               static_cast<unsigned>(rows));
  return cudaSuccess;
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
window_sort_pack(const int32_t* __restrict__ line,
                 const P* __restrict__ pos, const uint8_t* __restrict__ code,
                 const uint8_t* __restrict__ valid, long long n,
                 const P* __restrict__ win_start, Layout L,
                 u64* __restrict__ key, long long N, long long off) {
  const long long r = blockIdx.y;
  const u64 top = static_cast<u64>(r) << L.s_row;
  const long long w0 = static_cast<long long>(win_start[r]) - 1;
  const long long in = r * n;
  u64* out = key + r * N + off;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long j = in + i;
    u64 k;
    if (valid[j]) {
      k = static_cast<u64>(line[j] - L.line_lo) << L.s_line |
          static_cast<u64>(static_cast<long long>(pos[j]) - w0) << L.s_rel |
          code[j];
    } else {
      k = static_cast<u64>(L.line_ones) << L.s_line;
    }
    out[i] = top | k;
  }
}

__global__ void __launch_bounds__(kThreads)
window_sort_ghosts(long long c, long long field0, Layout L,
                   u64* __restrict__ key, long long N, long long off) {
  const long long r = blockIdx.y;
  const u64 top = static_cast<u64>(r) << L.s_row;
  u64* out = key + r * N + off;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < c; i += stride) {
    out[i] = top | static_cast<u64>(field0 + i) << L.s_line;
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
window_sort_unpack(const u64* __restrict__ key, long long N,
                   const P* __restrict__ win_start,
                   const P* __restrict__ last_pos, long long lp_stride,
                   const int32_t* __restrict__ spans, Layout L,
                   int32_t* __restrict__ key_s, P* __restrict__ pos_s,
                   int32_t* __restrict__ span_s,
                   uint8_t* __restrict__ valid_s) {
  const long long r = blockIdx.y;
  const long long w0 = static_cast<long long>(win_start[r]) - 1;
  const P* lp = last_pos + r * lp_stride;
  const long long base = r * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < N; i += stride) {
    const long long j = base + i;
    const u64 k = key[j];
    const long long field = static_cast<long long>(k >> L.s_line) &
                            L.line_ones;
    if (field == L.line_ones) {
      key_s[j] = kLineSentinel;
      pos_s[j] = P(-1);
      span_s[j] = 0;
      valid_s[j] = 0;
    } else {
      const long long ln = L.line_lo + field;
      const long long rel = static_cast<long long>(k >> L.s_rel) & L.rel_mask;
      key_s[j] = static_cast<int32_t>(ln);
      pos_s[j] = rel ? static_cast<P>(w0 + rel) : lp[ln];
      span_s[j] = spans[static_cast<long long>(k) & L.code_mask];
      valid_s[j] = 1;
    }
  }
}

template <typename P>
int pack_launch(const void* line, const void* pos, const void* code,
                const void* valid, long long R, long long n,
                const void* win_start, const void* layout, void* key,
                long long N, long long off, void* stream) {
  if (R <= 0 || n <= 0) return 0;
  dim3 grid;
  const cudaError_t err = grid_of(n, R, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_sort_pack<P><<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(line), static_cast<const P*>(pos),
      static_cast<const uint8_t*>(code), static_cast<const uint8_t*>(valid),
      n, static_cast<const P*>(win_start),
      *static_cast<const Layout*>(layout), static_cast<u64*>(key), N, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int unpack_launch(const void* key, long long R, long long N,
                  const void* win_start, const void* last_pos,
                  long long lp_stride, const void* spans, const void* layout,
                  void* key_s, void* pos_s, void* span_s, void* valid_s,
                  void* stream) {
  if (R <= 0 || N <= 0) return 0;
  dim3 grid;
  const cudaError_t err = grid_of(N, R, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_sort_unpack<P><<<grid, kThreads, 0, s>>>(
      static_cast<const u64*>(key), N, static_cast<const P*>(win_start),
      static_cast<const P*>(last_pos), lp_stride,
      static_cast<const int32_t*>(spans), *static_cast<const Layout*>(layout),
      static_cast<int32_t*>(key_s), static_cast<P*>(pos_s),
      static_cast<int32_t*>(span_s), static_cast<uint8_t*>(valid_s));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pluss_window_pack_i32(const void* line, const void* pos,
                                     const void* code, const void* valid,
                                     long long R, long long n,
                                     const void* win_start,
                                     const void* layout, void* key,
                                     long long N, long long off,
                                     void* stream) {
  return pack_launch<int32_t>(line, pos, code, valid, R, n, win_start,
                              layout, key, N, off, stream);
}

extern "C" int pluss_window_pack_i64(const void* line, const void* pos,
                                     const void* code, const void* valid,
                                     long long R, long long n,
                                     const void* win_start,
                                     const void* layout, void* key,
                                     long long N, long long off,
                                     void* stream) {
  return pack_launch<int64_t>(line, pos, code, valid, R, n, win_start,
                              layout, key, N, off, stream);
}

extern "C" int pluss_window_pack_ghosts(long long R, long long c,
                                        long long field0, const void* layout,
                                        void* key, long long N, long long off,
                                        void* stream) {
  if (R <= 0 || c <= 0) return 0;
  dim3 grid;
  const cudaError_t err = grid_of(c, R, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  window_sort_ghosts<<<grid, kThreads, 0, s>>>(
      c, field0, *static_cast<const Layout*>(layout), static_cast<u64*>(key),
      N, off);
  return static_cast<int>(cudaGetLastError());
}

// Temporary storage bytes of a sort of n keys over bits [0, end_bit): a
// host-side query, nothing is launched.
extern "C" int pluss_window_sort_bytes(long long n, int end_bit,
                                       unsigned long long* bytes) {
  if (n <= 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cub::DoubleBuffer<u64> keys(nullptr, nullptr);
  size_t b = 0;
  const cudaError_t err = cub::DeviceRadixSort::SortKeys(
      nullptr, b, keys, static_cast<int>(n), 0, end_bit);
  *bytes = b;
  return static_cast<int>(err);
}

// Sorts keys[0, n) over bits [0, end_bit), with alt as the other half of
// the double buffer; *selector is 0 when the sorted keys are in keys, 1
// when they are in alt (set on the host, without waiting for the card).
extern "C" int pluss_window_sort(void* keys, void* alt, long long n,
                                 int end_bit, void* temp,
                                 unsigned long long temp_bytes, void* stream,
                                 int* selector) {
  if (n <= 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cub::DoubleBuffer<u64> db(static_cast<u64*>(keys), static_cast<u64*>(alt));
  size_t b = temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortKeys(
      temp, b, db, static_cast<int>(n), 0, end_bit,
      static_cast<cudaStream_t>(stream));
  *selector = db.selector;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pluss_window_unpack_i32(const void* key, long long R,
                                       long long N, const void* win_start,
                                       const void* last_pos,
                                       long long lp_stride, const void* spans,
                                       const void* layout, void* key_s,
                                       void* pos_s, void* span_s,
                                       void* valid_s, void* stream) {
  return unpack_launch<int32_t>(key, R, N, win_start, last_pos, lp_stride,
                                spans, layout, key_s, pos_s, span_s, valid_s,
                                stream);
}

extern "C" int pluss_window_unpack_i64(const void* key, long long R,
                                       long long N, const void* win_start,
                                       const void* last_pos,
                                       long long lp_stride, const void* spans,
                                       const void* layout, void* key_s,
                                       void* pos_s, void* span_s,
                                       void* valid_s, void* stream) {
  return unpack_launch<int64_t>(key, R, N, win_start, last_pos, lp_stride,
                                spans, layout, key_s, pos_s, span_s, valid_s,
                                stream);
}
