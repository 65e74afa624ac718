// d24v wire decode: (payload u8, wm u8) -> int32[nb * 1024] line ids.
//
// Replaces the TPU kernel pluss/ops/pallas_decode.py:130 (_kernel, built
// by _decode_call at :182/:186, wrapped by decode_d24v at :205), which the
// JAX trace replay runs on every streamed batch under wire="d24v"
// (pluss/trace.py:1339-1343).  Bit-identical to
// pluss/ops/wirecodec.py:decode_d24v and to the plain torch version
// (pluss_torch/ops/wirecodec.py:decode_d24v_plain).
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
// Bound.  The work reads the used payload (<= 3 B/id for the widths the
// encoder writes) and wm (1 B per 1024 ids) once and writes 4 B/id.  At
// the trace path's 2^24-id batch that is <= 117 MB, ~35 us at the H100's
// 3.35 TB/s: bound by bytes.  Both carries across blocks (a block's start
// word and the delta chain's running id) are scans; the design folds them
// into the one pass over the bytes, so what is left between the kernel
// and its bound is the latency of resolving them tile after tile.
//
// Design: one launch, a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).
// - Tiles.  A CTA of 8 warps takes a tile of 8 wire blocks (8192 ids), one
//   warp per block.  The tile index comes from an atomicAdd on a counter
//   in the scratch, not from blockIdx: tiles are handed out in the order
//   CTAs start, so a CTA that waits on a predecessor never waits on one
//   that is not running.  40 registers a thread: 6 CTAs per SM.
// - Start words.  A tile's start word is the sum of k * 128 over the
//   blocks before it, which wm alone gives.  The CTA walks back 256
//   predecessors per round, each thread taking one: a predecessor whose
//   inclusive start is already published gives it and ends the walk,
//   any other gives its own sum from its 8 wm bytes.  So the walk waits on
//   no other CTA; the published starts only cut it short.  The tile then
//   publishes its own inclusive start.
// - Staging.  The tile's payload is contiguous: its words [start, start +
//   sum) plus one guard word go to shared memory with 16-B cp.async copies
//   (scalar copies where the payload pointer is not 16-B aligned or a
//   copy would pass the last payload word).  Every staged word is read
//   clamped to the last payload word, so no read leaves the payload
//   whatever wm says, as the plain version's clamped gathers.
// - Pass 1.  Each warp gives its block's element of the segmented scan: a
//   raw block resets the chain to its last id (one value read), a delta
//   block adds the sum of its zigzag-decoded deltas (lane l unpacks ids
//   128j + 4l + q, j < 8, q < 4, from shared memory with the funnel shift
//   and keeps its eight chunk sums).
// - Carry.  The tile's element (its blocks' elements combined) is
//   published at once with a flag state (invalid / aggregate / inclusive
//   prefix, packed with the value into one 64-bit word, so a flag is never
//   seen without its value); an aggregate that holds a reset is already an
//   inclusive prefix.  The CTA then walks back 256 predecessors per round,
//   warp w over 32 of them, waiting on each until it is published, and
//   stops at the latest inclusive prefix or reset; a warp whose tiles lie
//   past that point stops waiting.  Meanwhile the delta warps scan their
//   chunk sums (eight interleaved warp-shuffle scans).  A tile whose first
//   block is raw reads nothing from before it and skips the walk.
// - Pass 2, one write.  Each warp unpacks its block again from shared
//   memory; delta blocks add their base (the last id before the block) and
//   run the prefix in registers; every id is stored once with coalesced
//   16-B stores.  Keeping no value live across the walk is what holds the
//   kernel at 40 registers.
// Every sum is in uint32 (wrapping mod 2^32 like the JAX decoder's int32
// sums; signed overflow would be undefined behaviour) and reinterpreted as
// int32 at the store.
//
// Scratch (zeroed by one cudaMemsetAsync on the launch's stream): the tile
// counter (16 B), then the start-word and carry flags, one 64-bit word per
// tile each: 16 + 16 * ceil(nb / 8) bytes (ops/decode.py:scratch_bytes).
//
// Bound to Python with ctypes (pluss_torch/ops/decode.py): the C entry
// point takes raw device pointers, the scratch and the CUDA stream, makes
// one memset and one launch on that stream, never synchronizes, and
// returns the first CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;        // ids per wire block (wirecodec.BLOCK)
constexpr int kRawMode = 0x80;      // wirecodec.RAW_MODE
constexpr int kWordsPerNibble = kBlock / 8;  // 128 u32 words per nibble width
constexpr int kTileBlocks = 8;      // wire blocks per tile (decode.TILE_BLOCKS)
constexpr int kWarps = kTileBlocks;          // one warp per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kBlock / 128;        // 4 ids per lane per chunk
constexpr int kCtasPerSm = 6;       // register budget: 6 x 256 threads
constexpr int kMaxNibbles = 7;      // wm & 7
// the tile's widest payload plus the guard word, padded to 16 B
constexpr int kStageWords = kTileBlocks * kMaxNibbles * kWordsPerNibble + 4;
constexpr long long kScratchHead = 16;       // the tile counter, padded
constexpr long long kMaxBlocks = 1LL << 22;  // start words stay below 2^32

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInvalid = 0, kAggregate = 1, kPrefix = 2;
constexpr int kStatusShift = 40;

// Segmented scan element: `reset` elements start a new chain at `v`;
// others add `v` to the chain.  combine(a, b) applies a, then b.
struct Seg {
  uint32_t v;
  uint32_t reset;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{b.reset ? b.v : a.v + b.v, a.reset | b.reset};
}

// status (bits 40-41) | reset (bit 32) | value (bits 0-31): one word, so a
// reader that sees a status sees its value
__device__ __forceinline__ unsigned long long pack(Seg s, uint32_t status) {
  return static_cast<unsigned long long>(status) << kStatusShift
         | static_cast<unsigned long long>(s.reset) << 32 | s.v;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* smem,
                                           const uint32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Value r of a staged block of k nibbles per value: a funnel shift of two
// consecutive words, masked to 4k bits (0 for a zero-width block, which
// reads nothing).
__device__ __forceinline__ uint32_t value_at(const uint32_t* src, uint32_t k,
                                             uint32_t mask, int r) {
  if (k == 0) return 0u;
  const uint32_t bit = static_cast<uint32_t>(r) * 4u * k;
  const uint32_t w = bit >> 5;
  return __funnelshift_r(src[w], src[w + 1], bit & 31u) & mask;
}

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

__device__ __forceinline__ uint32_t status_of(unsigned long long f) {
  return static_cast<uint32_t>(f >> kStatusShift);
}

__device__ __forceinline__ Seg seg_of(unsigned long long f) {
  return Seg{static_cast<uint32_t>(f), static_cast<uint32_t>(f >> 32) & 1u};
}

// Combine a warp's 32 elements, lane i + 1 holding the tile before lane
// i's, from its latest lane up to the first lane that `stops` (that lane
// included); the result is in every lane.
__device__ __forceinline__ Seg warp_window(Seg s, bool stops) {
  const int lane = threadIdx.x & 31;
  const unsigned stop = __ballot_sync(kFull, stops);
  if (stop && lane > __ffs(stop) - 1) s = Seg{0u, 0u};
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o{__shfl_down_sync(kFull, s.v, d),
                __shfl_down_sync(kFull, s.reset, d)};
    if (lane + d < 32) s = combine(o, s);  // lane i + d: earlier tiles
  }
  return Seg{__shfl_sync(kFull, s.v, 0), __shfl_sync(kFull, s.reset, 0)};
}

// Start word of tile t: the sum of k * 128 over the blocks before it.  The
// whole CTA walks back kThreads tiles per round, thread i over tile
// p - i: a predecessor whose inclusive start is published gives it, any
// other gives its own sum from its 8 wm bytes.  Nothing is waited on: the
// published starts only cut the walk short at the latest one.  Uniform
// across the CTA.
__device__ uint32_t start_walk(const unsigned long long* flags,
                               const uint8_t* wm, int t, int* s_first,
                               uint32_t* s_part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t excl = 0u;
  for (int p = t - 1; p >= 0; p -= kThreads) {
    const int q = p - static_cast<int>(threadIdx.x);
    uint32_t v = 0u;
    bool published = false;
    if (q >= 0) {
      const unsigned long long f = load_flag(flags + q);
      published = status_of(f) == kPrefix;
      if (published) {
        v = static_cast<uint32_t>(f);
      } else {
        const uint8_t* m = wm + static_cast<int64_t>(q) * kTileBlocks;
#pragma unroll
        for (int j = 0; j < kTileBlocks; ++j) v += __ldg(m + j) & 7u;
        v *= kWordsPerNibble;
      }
    }
    const unsigned found = __ballot_sync(kFull, published);
    if (lane == 0) s_first[warp] = found ? __ffs(found) - 1 : 32;
    __syncthreads();
    int stop = kThreads;  // thread of the latest published start
    for (int w = 0; w < kWarps; ++w) {
      if (s_first[w] < 32) {
        stop = 32 * w + s_first[w];
        break;
      }
    }
    uint32_t x = static_cast<int>(threadIdx.x) <= stop ? v : 0u;
#pragma unroll
    for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
    if (lane == 0) s_part[warp] = x;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) excl += s_part[w];
    __syncthreads();  // s_first and s_part are written again
    if (stop < kThreads) break;
  }
  return excl;
}

// Exclusive carry of tile t (t >= 1): the combination of the published
// elements of the tiles before it, up to the latest inclusive prefix or
// reset.  The whole CTA walks back kThreads tiles per round, warp w over
// tiles p - 32w - 31 .. p - 32w, each lane waiting until its tile is
// published; a warp stops waiting once a later warp's window has met a
// prefix or reset (its tiles are then not needed).  Uniform across the
// CTA.
__device__ Seg carry_walk(const unsigned long long* flags, int t,
                          int* s_stop, Seg* s_win) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg excl{0u, 0u};
  for (int p = t - 1;; p -= kThreads) {
    if (threadIdx.x == 0) *s_stop = kWarps;
    __syncthreads();
    const int q = p - static_cast<int>(threadIdx.x);
    unsigned long long f = pack(Seg{0u, 0u}, kPrefix);  // before tile 0
    if (q >= 0) {
      f = load_flag(flags + q);
      while (status_of(f) == kInvalid
             && *static_cast<volatile int*>(s_stop) > warp) {
        f = load_flag(flags + q);
      }
    }
    const Seg s = seg_of(f);
    const bool stops = status_of(f) == kPrefix || s.reset;
    const Seg win = warp_window(s, stops);
    const bool window_stops = __any_sync(kFull, stops);
    if (lane == 0) {
      s_win[warp] = win;
      if (window_stops) atomicMin(s_stop, warp);
    }
    __syncthreads();
    const int last = *s_stop;  // the latest warp whose window stops
    Seg round{0u, 0u};
    for (int w = last < kWarps ? last : kWarps - 1; w >= 0; --w) {
      round = combine(round, s_win[w]);
    }
    excl = combine(round, excl);
    __syncthreads();  // s_stop and s_win are written again
    if (last < kWarps) return excl;
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
d24v_decode(const uint32_t* __restrict__ words, int64_t n_words, int vec,
            const uint8_t* __restrict__ wm, int nb,
            uint32_t* __restrict__ out, unsigned* __restrict__ tile_counter,
            unsigned long long* __restrict__ start_flags,
            unsigned long long* __restrict__ carry_flags) {
  __shared__ __align__(16) uint32_t s_words[kStageWords];
  __shared__ uint32_t s_off[kTileBlocks];  // block start, tile-relative
  __shared__ Seg s_seg[kTileBlocks];       // block's scan element
  __shared__ int s_tile;
  __shared__ uint32_t s_total;
  __shared__ int s_first[kWarps], s_stop;  // walk-back scratch
  __shared__ uint32_t s_part[kWarps];
  __shared__ Seg s_win[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(tile_counter, 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  const int b0 = tile * kTileBlocks;
  const int nblk = min(kTileBlocks, nb - b0);

  // 1. start words: block offsets in the tile from its wm bytes, the
  //    tile's start by the walk back; publish the tile's inclusive start
  if (warp == 0) {
    const uint32_t w =
        lane < nblk ? (wm[b0 + lane] & 7u) * kWordsPerNibble : 0u;
    uint32_t inc = w;
#pragma unroll
    for (int d = 1; d < kTileBlocks; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += up;
    }
    if (lane < kTileBlocks) s_off[lane] = inc - w;
    if (lane == kTileBlocks - 1) s_total = inc;
  }
  __syncthreads();
  const uint32_t start = start_walk(start_flags, wm, tile, s_first, s_part);
  const uint32_t total = s_total;
  if (threadIdx.x == 0) {
    store_flag(start_flags + tile, pack(Seg{start + total, 0u}, kPrefix));
  }

  // 2. stage words [start, start + total] of the payload, each clamped to
  //    the last payload word
  const int64_t last = n_words - 1;
  for (uint32_t i = 4 * threadIdx.x; i < total; i += 4 * kThreads) {
    const int64_t g = static_cast<int64_t>(start) + i;
    if (vec && g + 3 <= last) {
      cp_async16(s_words + i, words + g);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) s_words[i + q] = words[min(g + q, last)];
    }
  }
  if (threadIdx.x == 0) {
    s_words[total] = words[min(static_cast<int64_t>(start) + total, last)];
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. pass 1, each block's scan element: a raw block's last id (one
  //    value), or a delta block's sum (lane l's chunk sums kept for pass 2)
  uint32_t k = 0u, mask = 0u;
  bool raw = false;
  const uint32_t* src = s_words;
  uint32_t sum[kChunks];
  if (warp < nblk) {
    const uint32_t m = wm[b0 + warp];
    k = m & 7u;
    raw = (m & kRawMode) != 0;
    mask = (1u << (4u * k)) - 1u;
    src = s_words + s_off[warp];
    Seg seg;
    if (raw) {
      seg = Seg{value_at(src, k, mask, kBlock - 1), 1u};
    } else {
      uint32_t total_d = 0u;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        sum[j] = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sum[j] += unzigzag(value_at(src, k, mask, 128 * j + 4 * lane + q));
        }
        total_d += sum[j];
      }
#pragma unroll
      for (int d = 16; d; d >>= 1) total_d += __shfl_xor_sync(kFull, total_d, d);
      seg = Seg{total_d, 0u};
    }
    if (lane == 0) s_seg[warp] = seg;
  }
  __syncthreads();

  // 4. carry: publish the tile's element at once (already an inclusive
  //    prefix for tile 0 or when it holds a reset); each delta warp scans
  //    its chunk sums (eight interleaved warp scans) into each lane's
  //    exclusive prefix within the block; then the walk back, unless the
  //    tile's first block is raw and so reads nothing from before it
  Seg agg{0u, 0u};
  for (int i = 0; i < nblk; ++i) agg = combine(agg, s_seg[i]);
  const bool inclusive = tile == 0 || agg.reset;
  if (threadIdx.x == 0) {
    store_flag(carry_flags + tile,
               pack(agg, inclusive ? kPrefix : kAggregate));
  }
  uint32_t pre[kChunks];
  if (warp < nblk && !raw) {
    uint32_t inc[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) inc[j] = sum[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const uint32_t up = __shfl_up_sync(kFull, inc[j], d);
        if (lane >= d) inc[j] += up;
      }
    }
    uint32_t run = 0u;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      pre[j] = run + inc[j] - sum[j];
      run += __shfl_sync(kFull, inc[j], 31);
    }
  }
  Seg excl{0u, 0u};
  if (tile > 0 && !s_seg[0].reset) {
    excl = carry_walk(carry_flags, tile, &s_stop, s_win);
    if (threadIdx.x == 0 && !inclusive) {
      store_flag(carry_flags + tile, pack(combine(excl, agg), kPrefix));
    }
  }

  // 5. pass 2: unpack again from shared memory; delta blocks add their
  //    base (the last id before the block) and run the prefix in
  //    registers; one coalesced 16-B store per 4 ids
  if (warp < nblk) {
    Seg run = excl;
    for (int i = 0; i < warp; ++i) run = combine(run, s_seg[i]);
    const uint32_t base = raw ? 0u : run.v;
    uint4* dst = reinterpret_cast<uint4*>(
        out + static_cast<int64_t>(b0 + warp) * kBlock) + lane;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      uint32_t x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = value_at(src, k, mask, 128 * j + 4 * lane + q);
      }
      if (!raw) {
        uint32_t acc = base + pre[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc += unzigzag(x[q]);
          x[q] = acc;
        }
      }
      dst[32 * j] = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

}  // namespace

// payload: n_words little-endian u32 words (the uint8 payload, 4-aligned);
// wm: nb bytes; out: nb * 1024 int32; scratch: scratch_bytes >= 16 + 16 *
// ceil(nb / 8), 16-B aligned.
extern "C" int pluss_d24v_decode(const void* payload, long long n_words,
                                 const void* wm, long long nb, void* out,
                                 void* scratch, long long scratch_bytes,
                                 void* stream) {
  if (nb <= 0) return 0;
  const long long tiles = (nb + kTileBlocks - 1) / kTileBlocks;
  const long long need = kScratchHead + 2 * 8 * tiles;
  if (n_words <= 0 || nb > kMaxBlocks || scratch_bytes < need
      || (reinterpret_cast<uintptr_t>(payload) & 3u)
      || (reinterpret_cast<uintptr_t>(scratch) & 15u)
      || (reinterpret_cast<uintptr_t>(out) & 15u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, need, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* counter = static_cast<unsigned*>(scratch);
  auto* start_flags = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + kScratchHead);
  const int vec = (reinterpret_cast<uintptr_t>(payload) & 15u) == 0;
  d24v_decode<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(payload), n_words, vec,
      static_cast<const uint8_t*>(wm), static_cast<int>(nb),
      static_cast<uint32_t*>(out), counter, start_flags, start_flags + tiles);
  return static_cast<int>(cudaGetLastError());
}
