// d24v wire decode: (payload u8, wm u8) -> int32[nb * 1024] line ids.
//
// Replaces the TPU kernel pluss/ops/pallas_decode.py:_kernel (built by
// _decode_call, wrapped by decode_d24v), which the JAX trace replay runs
// on every streamed batch under wire="d24v" (pluss/trace.py:1339-1343).
// Bit-identical to pluss/ops/wirecodec.py:decode_d24v and to the plain
// torch version (pluss_torch/ops/wirecodec.py:decode_d24v_plain).
//
// What it computes.  Block b of 1024 ids has k = wm[b] & 7 nibbles per
// value and is raw when wm[b] & 0x80.  Its payload starts at word
// start[b] = sum_{b' < b} k[b'] * 128 (a block is k * 512 bytes, so every
// block starts on a 32-bit word).  Value r sits at bit r*4k of the block:
// a funnel shift of two consecutive little-endian words, masked to 4k
// bits.  Raw blocks hold the ids.  Delta blocks hold zigzag deltas; the id
// is the running sum of the deltas from the batch head, where a raw block
// resets the chain to its own last id.
//
// Design.  The Pallas kernel walks the blocks in a sequential grid and
// carries the last id in an SMEM cell.  Blocks of a CUDA grid run in no
// order, so the carry becomes a scan over the (few) blocks:
//   1. starts: one CTA scans k * 128 over the nb blocks (exclusive sum);
//   2. unpack: one CTA per block unpacks its 1024 values (4 per thread),
//      applies the zigzag inverse and a block-local inclusive scan (warp
//      shuffles), writes the block-local ids, and leaves the block's
//      carry value: its last raw id, or its delta sum;
//   3. carry: one CTA runs the segmented scan over the nb carry values
//      (reset at raw blocks), giving each block's base = last id of the
//      block before it;
//   4. rebase: delta blocks add their base.
// Every sum is in uint32 (wrapping mod 2^32 like the JAX decoder's int32
// sums; signed overflow would be undefined behaviour) and reinterpreted as
// int32 at the store.  Word indices clamp to the last payload word, so no
// read leaves the payload whatever wm says (the JAX gathers clamp too).
//
// Bound.  The work moves the used payload (<= 3 B/id), wm (1 B per 1024
// ids) and writes 4 B/id, plus pass 4's read and write of the delta
// blocks (8 B/id more, counted in PERF.md as the design's overhead, not in
// the bound).  At the trace path's 2^24-id batch: <= 117 MB, ~35 us at the
// H100's 3.35 TB/s — bound by bytes.
//
// Bound to Python with ctypes (pluss_torch/ops/decode.py): the C entry
// point takes raw device pointers, a scratch buffer and the CUDA stream,
// launches the four kernels on that stream, never synchronizes, and
// returns the first cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;        // ids per wire block (wirecodec.BLOCK)
constexpr int kRawMode = 0x80;      // wirecodec.RAW_MODE
constexpr int kWordsPerNibble = kBlock / 8;  // 128 u32 words per nibble width
constexpr int kUnpackThreads = 256; // 4 ids per thread
constexpr int kScanThreads = 1024;

// Segmented scan element: `reset` blocks start a new chain at `v`;
// others add `v` to the chain.  combine(a, b) applies a, then b.
struct Seg {
  uint32_t v;
  uint32_t reset;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{b.reset ? b.v : a.v + b.v, a.reset | b.reset};
}

__device__ __forceinline__ Seg shfl_up(Seg s, int d) {
  return Seg{__shfl_up_sync(0xffffffffu, s.v, d),
             __shfl_up_sync(0xffffffffu, s.reset, d)};
}

// Exclusive segmented scan of one CTA over n elements, each thread owning
// a contiguous run of them.  load(i) gives element i; the result for i
// (the combination of elements 0..i-1, identity {0, 0}) goes to out[i].
template <typename Load>
__device__ void cta_exclusive_scan(int n, Load load, uint32_t* out) {
  __shared__ Seg s_warp[kScanThreads / 32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  Seg agg{0u, 0u};
  for (int i = lo; i < hi; ++i) agg = combine(agg, load(i));
  // inclusive scan of the thread aggregates: within the warp, then
  // across the warps' totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg inc = agg;
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up = shfl_up(inc, d);
    if (lane >= d) inc = combine(up, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg w = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const Seg up = shfl_up(w, d);
      if (lane >= d) w = combine(up, w);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  // exclusive prefix of this thread = warps before it, then lanes before it
  Seg run = warp ? s_warp[warp - 1] : Seg{0u, 0u};
  const Seg lane_prev = shfl_up(inc, 1);
  if (lane) run = combine(run, lane_prev);
  for (int i = lo; i < hi; ++i) {
    out[i] = run.v;
    run = combine(run, load(i));
  }
}

// Pass 1: start word of every block.
__global__ void __launch_bounds__(kScanThreads)
d24v_starts(const uint8_t* __restrict__ wm, int nb,
            uint32_t* __restrict__ start) {
  cta_exclusive_scan(
      nb,
      [&](int i) {
        return Seg{static_cast<uint32_t>(wm[i] & 7) * kWordsPerNibble, 0u};
      },
      start);
}

// Pass 2: unpack one block per CTA into block-local ids.
__global__ void __launch_bounds__(kUnpackThreads)
d24v_unpack(const uint32_t* __restrict__ words, int64_t n_words,
            const uint8_t* __restrict__ wm,
            const uint32_t* __restrict__ start,
            uint32_t* __restrict__ out, uint32_t* __restrict__ carry) {
  __shared__ uint32_t s_warp[kUnpackThreads / 32];
  const int b = blockIdx.x;
  const uint32_t m = wm[b];
  const uint32_t k = m & 7u;
  const bool raw = (m & kRawMode) != 0;
  const uint32_t mask = (1u << (4u * k)) - 1u;
  const int64_t w0 = start[b];
  const int64_t last = n_words - 1;
  const int r0 = threadIdx.x * 4;

  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k == 0) {
      v[j] = 0u;  // zero-width block: nothing to read
    } else {
      const uint32_t bit = static_cast<uint32_t>(r0 + j) * 4u * k;
      const int64_t w = w0 + (bit >> 5);
      const uint32_t lo = words[w < last ? w : last];
      const uint32_t hi = words[w + 1 < last ? w + 1 : last];
      v[j] = __funnelshift_r(lo, hi, bit & 31u) & mask;
    }
  }

  uint32_t* dst = out + static_cast<int64_t>(b) * kBlock + r0;
  if (raw) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    if (threadIdx.x == kUnpackThreads - 1) carry[b] = v[3];
    return;  // uniform across the CTA: no barrier below is skipped by some
  }
  // zigzag inverse, then the block-local inclusive scan
  uint32_t s[4];
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc += (v[j] >> 1) ^ (0u - (v[j] & 1u));
    s[j] = acc;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = acc;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  uint32_t before = inc - acc;  // lanes before this one in the warp
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(before + s[0], before + s[1], before + s[2], before + s[3]);
  if (threadIdx.x == kUnpackThreads - 1) carry[b] = before + s[3];
}

// Pass 3: base of every block = last id of the block before it.
__global__ void __launch_bounds__(kScanThreads)
d24v_carry(const uint8_t* __restrict__ wm, const uint32_t* __restrict__ carry,
           int nb, uint32_t* __restrict__ base) {
  cta_exclusive_scan(
      nb,
      [&](int i) {
        return Seg{carry[i], static_cast<uint32_t>((wm[i] & kRawMode) != 0)};
      },
      base);
}

// Pass 4: delta blocks add their base.
__global__ void __launch_bounds__(kUnpackThreads)
d24v_rebase(const uint8_t* __restrict__ wm, const uint32_t* __restrict__ base,
            uint32_t* __restrict__ out) {
  const int b = blockIdx.x;
  if (wm[b] & kRawMode) return;
  const uint32_t c = base[b];
  uint4* p = reinterpret_cast<uint4*>(out + static_cast<int64_t>(b) * kBlock
                                      + threadIdx.x * 4);
  uint4 q = *p;
  q.x += c;
  q.y += c;
  q.z += c;
  q.w += c;
  *p = q;
}

}  // namespace

// payload: n_words little-endian u32 words (the uint8 payload, 4-aligned);
// wm: nb bytes; out: nb * 1024 int32; scratch: 3 * nb uint32.
extern "C" int pluss_d24v_decode(const void* payload, long long n_words,
                                 const void* wm, long long nb, void* out,
                                 void* scratch, void* stream) {
  if (nb <= 0) return 0;
  // start words stay below 2^32 up to 2^22 blocks (6 * 128 words each)
  if (n_words <= 0 || nb > (1LL << 22)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(nb);
  uint32_t* start = static_cast<uint32_t*>(scratch);
  uint32_t* carry = start + nb;
  uint32_t* base = carry + nb;
  const uint8_t* w = static_cast<const uint8_t*>(wm);
  uint32_t* o = static_cast<uint32_t*>(out);
  d24v_starts<<<1, kScanThreads, 0, s>>>(w, n, start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  d24v_unpack<<<n, kUnpackThreads, 0, s>>>(
      static_cast<const uint32_t*>(payload), n_words, w, start, o, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  d24v_carry<<<1, kScanThreads, 0, s>>>(w, carry, n, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  d24v_rebase<<<n, kUnpackThreads, 0, s>>>(w, base, o);
  return static_cast<int>(cudaGetLastError());
}
