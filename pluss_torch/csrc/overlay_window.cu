// One interleave-overlay window of one overlaid array, for a batch of
// simulated-thread rows, in one launch.
//
// Replaces no TPU kernel.  The JAX package's overlay window
// (pluss/overlay.py:device_window) is jnp inside a scan that XLA fuses;
// the port ran the same algebra as ~350 eager torch operators a window
// (pluss_torch/overlay.py:device_window_plain), each a launch of its own,
// which left the card idle while the host launched them.  This kernel is
// that algebra in one pass, bit for bit (the card tests compare every
// output tensor element for element).
//
// What it computes, for row b (simulated thread tids[b], nest base nb[b])
// and the overlaid array's n_lines array-local lines, which sit at
// line_base in the row of the carried table last_pos (read before any
// write of this window, rewritten in place):
//
//  - Part A, a thread per line, on every line that is not a collision line
//    of this window: the S template's head event, reuse first0 + dpos -
//    carried, cold when carried < 0, share when s_span > 0 && reuse >
//    s_span / 2; the tail last0 + dpos written back.  A collision line
//    gets reuse 0, share false, and no event here.
//  - Part B, a warp per collision line (W x CS x R a row): the line's SL x
//    lpe arrivals of S, each against max(D's closed-form predecessor, its
//    own S predecessor, the carried value); the gap substitution (ADD dsucc
//    - q, and with a D predecessor SUB dsucc - dpred); the line's D-head
//    event and its head-broken substitution; the tail max(dlast, qlast).
//  - hist[b] = static - sum over W runs of (prefix[lo + CS*R] - prefix[lo])
//    + the binned S heads, ADD events and SUB events (weight -1).  Each
//    block bins into shared memory (warp-aggregated, hist_common.cuh) and
//    adds its nonzero bins into the int64 output with integer atomics:
//    exact in any order.  The entry point zeroes the output first, with
//    one cudaMemsetAsync on the launch's stream.
//  - plus / minus: the plain version's (reuse, share) rows, the same
//    entries at the same places: plus = [arrival ADD (SL*SL*K) | gap ADD
//    (SL*SL*K) | D head (W*CS*R) | S heads (n_lines)], minus = [gap SUB
//    (SL*SL*K) | head-broken SUB (W*CS*R)], an arrival (s, m, k) at
//    (s*SL + m)*K + k.  Every entry is written.
//
// Each line is owned by one thread (part A) or one warp's lane 0 (part
// B): the owner alone reads its carried value and writes its tail, so the
// reads and the writes of one launch cannot race.  All arithmetic is
// int64 whatever the width of last_pos; divisions whose dividend can be
// negative round toward minus infinity, as torch's floor division does.
//
// Bound.  Bytes: each row reads and writes its slice of the carried
// table (n_lines x 4 or 8 B, twice), reads first0 and last0 (n_lines x 16
// B, shared by the rows) and writes the plus and minus rows (9 B an
// entry).  At syrk-1024's window (4 rows, 131,072 lines, 16,384 arrivals a
// row) that is ~12.7 MB, ~3.8 us at the H100's 3.35 TB/s; the integer
// work (a few dozen int64 operations an arrival, two floor divisions) is
// far below the card's rate.  The design keeps it to one pass and one
// launch: no intermediate reaches device memory.
//
// Bound to Python with ctypes (pluss_torch/ops/overlay_window.py): the C
// entry points take the geometry by pointer, raw device pointers and the
// CUDA stream, launch on that stream, never synchronize, and return the
// first CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "hist_common.cuh"

namespace {

using pluss::kHistThreads;
using pluss::kNBins;

constexpr int kWarps = kHistThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The window's geometry; field for field ops/overlay_window.py:_Geom.
struct Geom {
  long long T, CS;        // simulated threads, chunk size
  long long R, lpe, J;    // lines a row, elements a line, D's middle trip
  long long SL, W, K;     // window slots (W * CS), rounds, S's inner trip
  long long n_lines;      // the array's lines
  long long line_base;    // its first line in a row of the carried table
  long long row_len;      // lines a row of the carried table
  long long w;            // the window
  long long dpos;         // (w - w0) * pos_shift
  long long d_s0, d_sj, d_sk, d_off, d_span;
  long long s_s0, s_su, s_sk, s_off, s_span;
  long long a_blocks;     // blocks of part A a row (set by the launcher)
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ops/reuse.py:share_mask: span > 0 && reuse > span // 2
__device__ __forceinline__ bool share_of(long long reuse, long long span) {
  return span > 0 && reuse > floor_div(span, 2);
}

// Slot of a no-share event: frexp(max(reuse, 1))'s exponent, or -1 (no
// weight) at or past NBINS, as bin_histogram leaves such bins out.
__device__ __forceinline__ int slot_of(long long reuse) {
  const int s = 64 - __clzll(reuse > 1 ? reuse : 1LL);
  return s < kNBins ? s : -1;
}

// Whether array-local line l is one of thread t's collision lines in
// this window: its row's chunk is ((w*W + r)*T + t) for some r < W.
__device__ __forceinline__ bool is_collision(const Geom& g, long long t,
                                             long long l) {
  const long long grp = l / g.R / g.CS - t;
  if (grp < 0 || grp % g.T) return false;
  const long long r = grp / g.T - g.w * g.W;
  return r >= 0 && r < g.W;
}

// Part A: the S template's heads and tails on the non-collision lines.
template <typename P>
__device__ void heads(const Geom& g, long long t, long long nb, P* row,
                      const int64_t* __restrict__ first0,
                      const int64_t* __restrict__ last0, int64_t* sh_r,
                      uint8_t* sh_s, unsigned* s_add) {
  const long long dpos = g.dpos + nb;
  const long long stride = g.a_blocks * blockDim.x;
  // `base` is uniform across the block: every lane of a warp runs the
  // same iterations, as hist_add's full-mask vote needs
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < g.n_lines; base += stride) {
    const long long l = base + threadIdx.x;
    int bin = -1;
    if (l < g.n_lines) {
      long long reuse = 0;
      bool share = false;
      if (!is_collision(g, t, l)) {
        const long long c = row[l];
        if (c >= 0) {
          reuse = first0[l] + dpos - c;
          share = share_of(reuse, g.s_span);
          bin = share ? -1 : slot_of(reuse);
        } else {
          bin = 0;
        }
        row[l] = static_cast<P>(last0[l] + dpos);
      }
      sh_r[l] = reuse;
      sh_s[l] = share;
    }
    pluss::hist_add(s_add, bin);
  }
}

// Part B: a warp per collision line, a lane per arrival.
template <typename P>
__device__ void arrivals(const Geom& g, long long t, long long nb, P* row,
                         int64_t* plus_r, uint8_t* plus_s, int64_t* minus_r,
                         uint8_t* minus_s, unsigned* s_add, unsigned* s_sub) {
  const int lane = threadIdx.x & 31;
  const long long CSR = g.CS * g.R;
  const long long NA = g.SL * g.SL * g.K;
  const long long WC = g.W * CSR;
  const long long n_arr = g.SL * g.lpe;
  const long long warps =
      static_cast<long long>(gridDim.x - g.a_blocks) * kWarps;
  // the window's first and last parallel iteration (rank), every line's
  // first and last arrival
  const long long rank0 = g.w * g.W * g.CS;
  const long long rankz =
      (g.w * g.W + (g.SL - 1) / g.CS) * g.CS + (g.SL - 1) % g.CS;
  // Every operand below is >= 0 unless marked: plain division is floor.
  for (long long cl =
           static_cast<long long>(blockIdx.x - g.a_blocks) * kWarps +
           threadIdx.x / 32;
       cl < WC; cl += warps) {
    const long long r = cl / CSR, off = cl % CSR;
    const long long row_start = ((g.w * g.W + r) * g.T + t) * g.CS;
    const long long u = row_start + off / g.R;   // the line's row
    const long long m = r * g.CS + off / g.R;    // its row slot
    const long long l = row_start * g.R + off;   // array-local line
    const long long k0 = (off % g.R) * g.lpe;    // its first S inner index
    long long cc = 0;
    if (lane == 0) cc = row[l];
    cc = __shfl_sync(kFull, cc, 0);
    const long long rank_d = u / (g.T * g.CS) * g.CS + u % g.CS;
    const long long c_l = rank_d * g.d_s0 + g.d_off + nb;
    const long long dfirst = c_l + k0 * g.d_sk;
    const long long qrow = u * g.s_su + g.s_off + nb;
    for (long long a0 = 0; a0 < n_arr; a0 += 32) {
      const long long a = a0 + lane;
      int b_add = -1, b_gap = -1, b_sub = -1;
      if (a < n_arr) {
        const long long s = a / g.lpe, o = a % g.lpe, k = k0 + o;
        const long long rank = (g.w * g.W + s / g.CS) * g.CS + s % g.CS;
        const long long q = rank * g.s_s0 + qrow + k * g.s_sk;
        // D's closed-form predecessor and successor (qp can be < 0)
        const long long qp = q - c_l;
        const bool has_dpred = qp >= k0 * g.d_sk;
        long long jq = floor_div(qp - k0 * g.d_sk, g.d_sj);
        jq = jq < 0 ? 0 : (jq > g.J - 1 ? g.J - 1 : jq);
        long long kq = floor_div(qp - jq * g.d_sj, g.d_sk);
        if (kq > k0 + g.lpe - 1) kq = k0 + g.lpe - 1;
        const long long dpred =
            has_dpred ? c_l + jq * g.d_sj + kq * g.d_sk : -1;
        const bool k_wrap = kq >= k0 + g.lpe - 1;
        const long long jn = k_wrap ? jq + 1 : jq;
        const long long kn = k_wrap ? k0 : kq + 1;
        const bool has_dsucc = has_dpred ? jn < g.J : true;
        const long long dsucc =
            has_dpred ? c_l + jn * g.d_sj + kn * g.d_sk : dfirst;
        // the arrival's own S neighbours on the line
        const bool has_aprev = o > 0 || s > 0;
        const long long aprev =
            !has_aprev ? -1
                       : (o > 0 ? q - g.s_sk
                                : q - g.s_s0 + (g.lpe - 1) * g.s_sk);
        const bool has_anext = o < g.lpe - 1 || s < g.SL - 1;
        const long long anext =
            !has_anext ? -1
                       : (o < g.lpe - 1 ? q + g.s_sk
                                        : q + g.s_s0 - (g.lpe - 1) * g.s_sk);
        // the arrival's event against max(dpred, aprev, carried)
        long long pred = dpred > aprev ? dpred : aprev;
        pred = pred > cc ? pred : cc;
        const bool a_cold = pred < 0;
        const long long a_reuse = a_cold ? 0 : q - pred;
        const bool a_share = !a_cold && share_of(a_reuse, g.s_span);
        // the gap substitution, once a broken D gap: its last arrival
        const bool last_in_gap = has_dsucc && (!has_anext || anext > dsucc);
        const long long g_reuse = last_in_gap ? dsucc - q : 0;
        const bool g_share = last_in_gap && share_of(g_reuse, g.d_span);
        const bool sub_gap = last_in_gap && has_dpred;
        const long long s_reuse = sub_gap ? dsucc - dpred : 0;
        const bool s_share = sub_gap && share_of(s_reuse, g.d_span);
        const long long i = (s * g.SL + m) * g.K + k;
        plus_r[i] = a_reuse;
        plus_s[i] = a_share;
        plus_r[NA + i] = g_reuse;
        plus_s[NA + i] = g_share;
        minus_r[i] = s_reuse;
        minus_s[i] = s_share;
        b_add = a_cold ? 0 : (a_share ? -1 : slot_of(a_reuse));
        b_gap = last_in_gap && !g_share ? slot_of(g_reuse) : -1;
        b_sub = sub_gap && !s_share ? slot_of(s_reuse) : -1;
      }
      pluss::hist_add(s_add, b_add);
      pluss::hist_add(s_add, b_gap);
      pluss::hist_add(s_sub, b_sub);
    }
    // the line's D-head event and its head-broken substitution, and its
    // tail, by the owner (lane 0)
    int b_head = -1, b_broken = -1;
    if (lane == 0) {
      const long long dlast =
          c_l + (g.J - 1) * g.d_sj + (k0 + g.lpe - 1) * g.d_sk;
      const long long qfirst = rank0 * g.s_s0 + qrow + k0 * g.s_sk;
      const long long qlast =
          rankz * g.s_s0 + qrow + (k0 + g.lpe - 1) * g.s_sk;
      const bool dh_cold = cc < 0;
      const long long dh_reuse = dh_cold ? 0 : dfirst - cc;
      const bool dh_share = !dh_cold && share_of(dh_reuse, g.d_span);
      const bool broken = qfirst < dfirst;
      const bool hb_cold = broken && dh_cold;
      const bool hb_evt = broken && !dh_cold;
      plus_r[2 * NA + cl] = dh_reuse;
      plus_s[2 * NA + cl] = dh_share;
      minus_r[NA + cl] = hb_evt ? dh_reuse : 0;
      minus_s[NA + cl] = hb_evt && dh_share;
      b_head = dh_cold ? 0 : (dh_share ? -1 : slot_of(dh_reuse));
      b_broken = hb_cold ? 0 : (hb_evt && !dh_share ? slot_of(dh_reuse)
                                                    : -1);
      row[l] = static_cast<P>(dlast > qlast ? dlast : qlast);
    }
    pluss::hist_add(s_add, b_head);
    pluss::hist_add(s_sub, b_broken);
  }
}

template <typename P>
__global__ void __launch_bounds__(kHistThreads)
overlay_window(const Geom g, const int64_t* __restrict__ tids,
               const int64_t* __restrict__ nbs, P* __restrict__ last_pos,
               const int64_t* __restrict__ static_hist,
               const int64_t* __restrict__ prefix,
               const int64_t* __restrict__ first0,
               const int64_t* __restrict__ last0, int64_t* __restrict__ plus_r,
               uint8_t* __restrict__ plus_s, int64_t* __restrict__ minus_r,
               uint8_t* __restrict__ minus_s,
               unsigned long long* __restrict__ hist) {
  __shared__ unsigned int s_add[kNBins];
  __shared__ unsigned int s_sub[kNBins];
  for (int i = threadIdx.x; i < kNBins; i += blockDim.x) {
    s_add[i] = 0;
    s_sub[i] = 0;
  }
  __syncthreads();

  const long long b = blockIdx.y;
  const long long t = tids[b], nb = nbs[b];
  const long long CSR = g.CS * g.R;
  const long long NA = g.SL * g.SL * g.K;
  const long long WC = g.W * CSR;
  const long long n_plus = 2 * NA + WC + g.n_lines, n_minus = NA + WC;
  P* row = last_pos + b * g.row_len + g.line_base;
  int64_t* pr = plus_r + b * n_plus;
  uint8_t* ps = plus_s + b * n_plus;
  unsigned long long* out = hist + b * kNBins;

  if (blockIdx.x < g.a_blocks) {
    if (blockIdx.x == 0 && threadIdx.x < kNBins) {
      // the static histograms less S's per-line part on the W runs
      const int bin = threadIdx.x;
      long long v = static_hist[bin];
      for (long long r = 0; r < g.W; ++r) {
        const long long lo = ((g.w * g.W + r) * g.T + t) * g.CS * g.R;
        v -= prefix[(lo + CSR) * kNBins + bin] - prefix[lo * kNBins + bin];
      }
      if (v) atomicAdd(&out[bin], static_cast<unsigned long long>(v));
    }
    heads<P>(g, t, nb, row, first0, last0, pr + 2 * NA + WC,
             ps + 2 * NA + WC, s_add);
  } else {
    arrivals<P>(g, t, nb, row, pr, ps, minus_r + b * n_minus,
                minus_s + b * n_minus, s_add, s_sub);
  }

  __syncthreads();
  for (int i = threadIdx.x; i < kNBins; i += blockDim.x) {
    const long long c = static_cast<long long>(s_add[i]) -
                        static_cast<long long>(s_sub[i]);
    if (c) atomicAdd(&out[i], static_cast<unsigned long long>(c));
  }
}

template <typename P>
int launch(const Geom* geom, long long Tb, const void* tids, const void* nb,
           void* last_pos, const void* static_hist, const void* prefix,
           const void* first0, const void* last0, void* plus_r,
           void* plus_s, void* minus_r, void* minus_s, void* hist,
           void* stream) {
  if (Tb <= 0) return 0;
  if (Tb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Geom g = *geom;
  if (g.n_lines <= 0 || g.T <= 0 || g.CS <= 0 || g.R <= 0 || g.lpe <= 0 ||
      g.J <= 0 || g.SL <= 0 || g.W <= 0 || g.K <= 0 || g.d_sj <= 0 ||
      g.d_sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, static_cast<size_t>(Tb) * kNBins * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned a_blocks = 0;
  err = pluss::hist_grid_x((g.n_lines + kHistThreads - 1) / kHistThreads, Tb,
                           &a_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  g.a_blocks = a_blocks;
  long long b_blocks = (g.W * g.CS * g.R + kWarps - 1) / kWarps;
  if (b_blocks > (1LL << 20)) b_blocks = 1LL << 20;  // warps stride on
  const dim3 grid(static_cast<unsigned>(a_blocks + b_blocks),
                  static_cast<unsigned>(Tb));
  overlay_window<P><<<grid, kHistThreads, 0, s>>>(
      g, static_cast<const int64_t*>(tids), static_cast<const int64_t*>(nb),
      static_cast<P*>(last_pos), static_cast<const int64_t*>(static_hist),
      static_cast<const int64_t*>(prefix), static_cast<const int64_t*>(first0),
      static_cast<const int64_t*>(last0), static_cast<int64_t*>(plus_r),
      static_cast<uint8_t*>(plus_s), static_cast<int64_t*>(minus_r),
      static_cast<uint8_t*>(minus_s),
      static_cast<unsigned long long*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PLUSS_OVERLAY_ENTRY(name, P)                                        \
  extern "C" int name(const void* geom, long long Tb, const void* tids,     \
                      const void* nb, void* last_pos,                       \
                      const void* static_hist, const void* prefix,          \
                      const void* first0, const void* last0, void* plus_r,  \
                      void* plus_s, void* minus_r, void* minus_s,           \
                      void* hist, void* stream) {                           \
    return launch<P>(static_cast<const Geom*>(geom), Tb, tids, nb,          \
                     last_pos, static_hist, prefix, first0, last0, plus_r,  \
                     plus_s, minus_r, minus_s, hist, stream);               \
  }

PLUSS_OVERLAY_ENTRY(pluss_overlay_window_i32, int32_t)
PLUSS_OVERLAY_ENTRY(pluss_overlay_window_i64, int64_t)
