// Window template of the host plan (host code, not a kernel).
//
// engine._build_template analyses the first clean window of a rectangular
// nest once, at plan time: each cache line's accesses inside the window, in
// position order, give the window's local reuse histogram, its in-window
// share reuses, and each line's first access (head) and last access (tail).
// Every access of the window has a position of its own, so one pass over
// the positions in ascending order, with a table of each line's first and
// last position, gives all of it with no sort: the PLUSS reference's
// last-access-table walk, over a single window.
//
// 1. Enumerate: every template reference's accesses over the window's
//    rounds, with engine.py's affine arithmetic (the line is floor
//    division, numpy's //), into a buffer indexed by position; slots of
//    sort-path references stay holes.  A slot written twice is an error,
//    and so is a position or a line outside the window's ranges.
// 2. Walk: the slots in ascending order against the per-line table.
// 3. Emit: heads and tails in ascending line order; share reuses distinct
//    and ascending with their counts.
//
// The buffer is one tile of positions at a time, small enough for the
// core's cache: each reference's accesses come in program order, so their
// positions ascend, and a cursor per reference fills the tile up to its end
// before the walk takes it.  A position below the tile (one out of order)
// falls outside it and is an error too.
//
// The window's parallel iterations split into segments, one thread each:
// a parallel iteration's positions lie in a range of their own, so each
// segment walks its own positions with a table of its own, and the merge
// walks the segments in order per line, adding the reuse from one
// segment's last access to the next one's first, which the segment took
// as a head.  The result is the single walk's whatever the split.
//
// Built with the host compiler by pluss_torch/ops/build.py and called
// through ctypes (pluss_torch/native.py: template_builder), which releases
// the interpreter lock.  The result lives in a handle: the caller reads its
// sizes, allocates the arrays, copies them out and frees the handle.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr uint16_t kHole = 0xFFFF;
constexpr int64_t kTile = 1 << 16;  // positions per tile
constexpr int kMaxDepth = 64;
constexpr int kBins = 64;           // bit lengths of an int64 reuse
constexpr int kErr = 256;

int64_t floor_div(int64_t a, int64_t b) {  // b > 0, as numpy's //
  return a / b - static_cast<int64_t>((a % b != 0) & (a < 0));
}

// Counts of the distinct share reuses.  A window has few distinct values,
// often one, so the last one's count is kept at hand (a map's values stay
// where they are as it grows).
class ShareCounts {
 public:
  ShareCounts() = default;
  ShareCounts(const ShareCounts&) = delete;
  ShareCounts& operator=(const ShareCounts&) = delete;

  void add(int64_t v, int64_t count = 1) {
    if (!last_ || v != last_v_) {
      last_ = &counts_[v];
      last_v_ = v;
    }
    *last_ += count;
  }

  void add_all(const ShareCounts& o) {
    for (const auto& e : o.counts_) add(e.first, e.second);
  }

  void emit(std::vector<int64_t>* vals, std::vector<int64_t>* cnts) const {
    std::vector<std::pair<int64_t, int64_t>> kv(counts_.begin(),
                                                counts_.end());
    std::sort(kv.begin(), kv.end());
    for (const auto& e : kv) {
      vals->push_back(e.first);
      cnts->push_back(e.second);
    }
  }

 private:
  std::unordered_map<int64_t, int64_t> counts_;
  int64_t* last_ = nullptr;
  int64_t last_v_ = 0;
};

// The window's shape and the line arithmetic shared by every reference.
struct Window {
  const int64_t* owned;  // [W] chunk ids of the window's rounds
  int64_t W, r0, cs, sched_start, sched_step, ds, cls;
  int shift;             // log2(cls) when cls is a power of two, else -1
  int64_t pos_lo, n_pos, line_lo, n_lines;
  const int64_t* half;   // per reference: share iff reuse > half

  int64_t line_of(int64_t addr, int64_t line_base) const {
    const int64_t a = addr * ds;
    return line_base + (shift >= 0 ? a >> shift : floor_div(a, cls));
  }
};

// A template reference: its levels as depth rows of (trip, pos_stride,
// addr_coef, start, step) in `lv` (row 0 is the parallel loop, driven by
// the chunk schedule), and the box of its positions inside one parallel
// iteration, relative to the iteration's start.
struct Ref {
  uint16_t id;
  int64_t depth, offset, addr_base, line_base;
  const int64_t* lv;
  bool empty;              // a level of no trips: no accesses
  int64_t inner_lo, inner_hi;
};

// One reference walked in program order over parallel iterations
// [q, q_end) (q = r * cs + p: round r, chunk slot p), then levels
// 1..depth-1 as an odometer.
struct Cursor {
  const Ref* ref;
  int64_t q, q_end;
  int64_t idx[kMaxDepth] = {};
  int64_t pos = 0, addr = 0;  // of the next access
  bool done = false;

  void begin_iteration(const Window& w) {
    const int64_t r = q / w.cs, p = q % w.cs;
    const int64_t* lv = ref->lv;
    const int64_t rank = (w.r0 + r) * w.cs + p;
    const int64_t g = w.owned[r] * w.cs + p;
    pos = rank * lv[1] + ref->offset;
    addr = ref->addr_base + lv[2] * (w.sched_start + g * w.sched_step);
    for (int64_t l = 1; l < ref->depth; ++l) {
      addr += lv[5 * l + 2] * lv[5 * l + 3];
      idx[l] = 0;
    }
  }

  void start(const Window& w) {
    done = ref->empty || q >= q_end;
    if (!done) begin_iteration(w);
  }

  void next_iteration(const Window& w) {
    done = ++q >= q_end;
    if (!done) begin_iteration(w);
  }
};

// Per line of a segment: the slot of its last access so far (-1 before
// the first) and the references of its first and last access.
struct LineState {
  int32_t last;
  uint16_t first_ref, last_ref;
};

// The walk of parallel iterations [q_begin, q_end), over positions
// [lo, hi] (slots, relative to the window's pos_lo).
struct Segment {
  int64_t q_begin, q_end, lo, hi;
  std::vector<LineState> table;
  std::vector<int32_t> first;
  int64_t hist[kBins] = {};
  ShareCounts share;
  int64_t entries = 0;
  char err[kErr] = {};
};

struct Tile {
  int64_t lo;        // first slot of the tile
  int64_t n;         // its slots
  uint32_t* line;    // [kTile] line - line_lo
  uint16_t* ref;     // [kTile] reference, or kHole
  Segment* seg;
};

// Store `n` accesses of `c` at positions c.pos, c.pos + dp, ... and
// addresses c.addr, c.addr + da, ...; false (with the message set) on an
// error.
bool put_run(Tile* t, const Window& w, const Cursor& c, int64_t n,
             int64_t dp, int64_t da) {
  const Ref& f = *c.ref;
  int64_t p = c.pos, a = c.addr;
  for (int64_t k = 0; k < n; ++k, p += dp, a += da) {
    const int64_t line = w.line_of(a, f.line_base);
    const uint64_t slot = static_cast<uint64_t>(p - w.pos_lo - t->lo);
    const uint64_t li = static_cast<uint64_t>(line - w.line_lo);
    if (slot >= static_cast<uint64_t>(t->n) ||
        li >= static_cast<uint64_t>(w.n_lines) || t->ref[slot] != kHole) {
      char* err = t->seg->err;
      if (slot >= static_cast<uint64_t>(t->n))
        snprintf(err, kErr,
                 "position %lld of reference %d falls outside the tile "
                 "[%lld, %lld): out of order or outside the window",
                 static_cast<long long>(p), f.id,
                 static_cast<long long>(w.pos_lo + t->lo),
                 static_cast<long long>(w.pos_lo + t->lo + t->n));
      else if (li >= static_cast<uint64_t>(w.n_lines))
        snprintf(err, kErr,
                 "line %lld of reference %d falls outside the window's "
                 "lines [%lld, %lld)",
                 static_cast<long long>(line), f.id,
                 static_cast<long long>(w.line_lo),
                 static_cast<long long>(w.line_lo + w.n_lines));
      else
        snprintf(err, kErr,
                 "position %lld written twice (references %d and %d): two "
                 "accesses of the window share a position",
                 static_cast<long long>(p), t->ref[slot], f.id);
      return false;
    }
    t->ref[slot] = f.id;
    t->line[slot] = static_cast<uint32_t>(li);
  }
  t->seg->entries += n;
  return true;
}

// Store every access of `c` below position `end` into the tile.
bool advance(Cursor* c, const Window& w, Tile* t, int64_t end) {
  const Ref& f = *c->ref;
  while (!c->done && c->pos < end) {
    if (f.depth == 1) {
      if (!put_run(t, w, *c, 1, 0, 0)) return false;
      c->next_iteration(w);
      continue;
    }
    const int64_t d = f.depth - 1;
    const int64_t* in = f.lv + 5 * d;
    const int64_t trip = in[0], dp = in[1], da = in[2] * in[4];
    const int64_t left = trip - c->idx[d];
    // the run up to the tile's end; a stride that does not ascend takes
    // the whole run, and put_run reports it
    const int64_t n = dp > 0 ? std::min(left, (end - c->pos + dp - 1) / dp)
                             : left;
    if (!put_run(t, w, *c, n, dp, da)) return false;
    c->idx[d] += n;
    c->pos += n * dp;
    c->addr += n * da;
    if (c->idx[d] < trip) continue;
    // the innermost level is done: carry into the outer ones
    c->idx[d] = 0;
    c->pos -= trip * dp;
    c->addr -= trip * da;
    int64_t l = d - 1;
    for (; l >= 1; --l) {
      const int64_t* v = f.lv + 5 * l;
      if (++c->idx[l] < v[0]) {
        c->pos += v[1];
        c->addr += v[2] * v[4];
        break;
      }
      c->pos -= v[1] * (v[0] - 1);
      c->addr -= v[2] * v[4] * (v[0] - 1);
      c->idx[l] = 0;
    }
    if (l < 1) c->next_iteration(w);
  }
  return true;
}

// Walk one segment; false (with seg->err set) on an error.
bool walk(Segment* seg, const Window& w, const std::vector<Ref>& refs) {
  std::vector<Cursor> cur(refs.size());
  for (size_t i = 0; i < refs.size(); ++i) {
    cur[i].ref = &refs[i];
    cur[i].q = seg->q_begin;
    cur[i].q_end = seg->q_end;
    cur[i].start(w);
  }
  seg->table.assign(w.n_lines, LineState{-1, 0, 0});
  seg->first.resize(w.n_lines);
  std::vector<uint32_t> tline(kTile);
  std::vector<uint16_t> tref(kTile);
  Tile t{0, 0, tline.data(), tref.data(), seg};
  LineState* table = seg->table.data();
  int32_t* first = seg->first.data();
  for (int64_t lo = seg->lo; lo <= seg->hi; lo += kTile) {
    t.lo = lo;
    t.n = std::min<int64_t>(kTile, seg->hi + 1 - lo);
    std::fill_n(tref.data(), t.n, kHole);
    for (Cursor& c : cur)
      if (!advance(&c, w, &t, w.pos_lo + lo + t.n)) return false;
    for (int64_t k = 0; k < t.n; ++k) {
      const uint16_t r = tref[k];
      if (r == kHole) continue;
      const int32_t s = static_cast<int32_t>(lo + k);
      const uint32_t li = tline[k];
      LineState& e = table[li];
      if (e.last < 0) {
        first[li] = s;
        e.first_ref = r;
      } else {
        const int64_t reuse = s - e.last;
        if (reuse > w.half[r])  // ops/reuse.share_mask
          seg->share.add(reuse);
        else  // the bit length: frexp's exponent
          ++seg->hist[64 - __builtin_clzll(reuse)];
      }
      e.last = s;
      e.last_ref = r;
    }
  }
  for (const Cursor& c : cur)
    if (!c.done) {
      snprintf(seg->err, kErr,
               "reference %d has accesses past the window's positions "
               "[%lld, %lld)", c.ref->id, static_cast<long long>(w.pos_lo),
               static_cast<long long>(w.pos_lo + w.n_pos));
      return false;
    }
  return true;
}

struct Template {
  int64_t entries = 0, threads = 1;
  std::vector<int64_t> local_hist;
  std::vector<int64_t> share_vals, share_cnts;
  std::vector<int32_t> head_line, head_span, head_dline, hs_idx;
  std::vector<int32_t> tail_line, tail_dline;
  std::vector<int64_t> head_pos, tail_pos;
};

Template* build(int64_t n_refs, const long long* meta,
                const long long* levels, const int* span, const int* dline,
                const long long* owned, int64_t W, int64_t r0, int64_t cs,
                int64_t ds, int64_t cls, int64_t sched_start,
                int64_t sched_step, int64_t nbins, int64_t threads,
                char* err) {
  std::vector<int64_t> half(n_refs);
  for (int64_t i = 0; i < n_refs; ++i)
    half[i] = span[i] > 0 ? span[i] / 2 : INT64_MAX;
  Window w{reinterpret_cast<const int64_t*>(owned), W, r0, cs, sched_start,
           sched_step, ds, cls, -1, 0, 0, 0, 0, half.data()};
  if ((cls & (cls - 1)) == 0)
    for (w.shift = 0; (1LL << w.shift) < cls; ++w.shift) {
    }
  const int64_t Q = W * cs;  // parallel iterations of the window
  int64_t g_lo = 0, g_hi = 0;
  for (int64_t r = 0; r < W; ++r) {
    g_lo = r ? std::min(g_lo, w.owned[r] * cs) : w.owned[r] * cs;
    g_hi = r ? std::max(g_hi, w.owned[r] * cs + cs - 1)
             : w.owned[r] * cs + cs - 1;
  }
  // the references, and the boxes of their positions and lines: each term
  // is affine in one index, so its extremes lie at the index's ends, and
  // the line is monotone in the address
  std::vector<Ref> refs(n_refs);
  const int64_t* lv = reinterpret_cast<const int64_t*>(levels);
  int64_t entries = 0, line_lo = INT64_MAX, line_hi = INT64_MIN;
  int64_t pos_lo = INT64_MAX, pos_hi = INT64_MIN;
  auto rank_box = [&](const Ref& f, int64_t q0, int64_t q1, int64_t* lo,
                      int64_t* hi) {
    const int64_t a = (r0 * cs + q0) * f.lv[1], b = (r0 * cs + q1) * f.lv[1];
    *lo = std::min(*lo, std::min(a, b) + f.offset + f.inner_lo);
    *hi = std::max(*hi, std::max(a, b) + f.offset + f.inner_hi);
  };
  for (int64_t i = 0; i < n_refs; ++i) {
    Ref& f = refs[i];
    f.id = static_cast<uint16_t>(i);
    f.depth = meta[4 * i];
    f.offset = meta[4 * i + 1];
    f.addr_base = meta[4 * i + 2];
    f.line_base = meta[4 * i + 3];
    f.lv = lv;
    if (f.depth < 1 || f.depth > kMaxDepth) {
      snprintf(err, kErr, "reference %lld has %lld levels (1 to %d)",
               static_cast<long long>(i), static_cast<long long>(f.depth),
               kMaxDepth);
      return nullptr;
    }
    lv += 5 * f.depth;
    f.empty = Q <= 0;
    f.inner_lo = f.inner_hi = 0;
    int64_t count = 1;
    const int64_t c0[2] = {f.lv[2] * (sched_start + g_lo * sched_step),
                           f.lv[2] * (sched_start + g_hi * sched_step)};
    int64_t a_lo = f.addr_base + std::min(c0[0], c0[1]);
    int64_t a_hi = f.addr_base + std::max(c0[0], c0[1]);
    for (int64_t l = 1; l < f.depth; ++l) {
      const int64_t* v = f.lv + 5 * l;
      if (v[0] <= 0) f.empty = true;
      const int64_t e = (v[0] - 1) * v[1];
      f.inner_lo += std::min<int64_t>(0, e);
      f.inner_hi += std::max<int64_t>(0, e);
      const int64_t x = v[2] * v[3], y = v[2] * (v[3] + (v[0] - 1) * v[4]);
      a_lo += std::min(x, y);
      a_hi += std::max(x, y);
      count *= v[0];
    }
    if (f.empty) continue;
    entries += Q * count;
    rank_box(f, 0, Q - 1, &pos_lo, &pos_hi);
    line_lo = std::min(line_lo, f.line_base + floor_div(a_lo * ds, cls));
    line_hi = std::max(line_hi, f.line_base + floor_div(a_hi * ds, cls));
  }
  if (pos_lo > pos_hi) pos_lo = 0, pos_hi = -1, line_lo = 0, line_hi = -1;
  if (pos_hi - pos_lo >= INT32_MAX || line_lo < INT32_MIN ||
      line_hi > INT32_MAX) {
    snprintf(err, kErr,
             "the window's positions [%lld, %lld] or lines [%lld, %lld] "
             "fall outside int32",
             static_cast<long long>(pos_lo), static_cast<long long>(pos_hi),
             static_cast<long long>(line_lo),
             static_cast<long long>(line_hi));
    return nullptr;
  }
  w.pos_lo = pos_lo;
  w.n_pos = pos_hi - pos_lo + 1;
  w.line_lo = line_lo;
  w.n_lines = line_hi - line_lo + 1;

  // segments of whole parallel iterations, one per thread, each with a
  // table of the window's lines: no more than the entries would fill
  const int64_t n_seg = std::max<int64_t>(
      1, std::min({threads, Q,
                   entries / std::max<int64_t>(1, w.n_lines)}));
  std::vector<Segment> seg(n_seg);
  for (int64_t s = 0; s < n_seg; ++s) {
    Segment& g = seg[s];
    g.q_begin = Q * s / n_seg;
    g.q_end = Q * (s + 1) / n_seg;
    g.lo = INT64_MAX;
    g.hi = INT64_MIN;
    for (const Ref& f : refs)
      if (!f.empty) rank_box(f, g.q_begin, g.q_end - 1, &g.lo, &g.hi);
    if (g.lo > g.hi) g.lo = pos_lo, g.hi = pos_lo - 1;  // no accesses
    g.lo -= pos_lo;
    g.hi -= pos_lo;
    if (s && g.lo <= seg[s - 1].hi) {
      snprintf(err, kErr,
               "parallel iterations %lld and %lld share positions",
               static_cast<long long>(g.q_begin - 1),
               static_cast<long long>(g.q_begin));
      return nullptr;
    }
  }

  std::vector<char> ok(n_seg, 0);
  auto run = [&](int64_t s) {
    try {
      ok[s] = walk(&seg[s], w, refs);
    } catch (const std::exception& e) {
      snprintf(seg[s].err, kErr, "segment %lld: %s",
               static_cast<long long>(s), e.what());
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int64_t s = 1; s < n_seg; ++s) pool.emplace_back(run, s);
  } catch (...) {  // joinable threads must not be destroyed
    for (std::thread& th : pool) th.join();
    throw;
  }
  run(0);
  for (std::thread& th : pool) th.join();
  for (int64_t s = 0; s < n_seg; ++s)
    if (!ok[s]) {
      snprintf(err, kErr, "%s", seg[s].err);
      return nullptr;
    }

  // the merge: per line, the segments in order
  std::unique_ptr<Template> out(new Template);
  out->threads = n_seg;
  std::vector<int64_t> hist(kBins, 0);
  ShareCounts share;
  for (const Segment& g : seg) {
    out->entries += g.entries;
    for (int b = 0; b < kBins; ++b) hist[b] += g.hist[b];
    share.add_all(g.share);
  }
  for (int64_t li = 0; li < w.n_lines; ++li) {
    int32_t last = -1, head = 0;
    uint16_t head_ref = 0, tail_ref = 0;
    for (const Segment& g : seg) {
      const LineState& e = g.table[li];
      if (e.last < 0) continue;
      if (last < 0) {
        head = g.first[li];
        head_ref = e.first_ref;
      } else {
        const int64_t reuse = g.first[li] - last;
        if (reuse > half[e.first_ref])
          share.add(reuse);
        else
          ++hist[64 - __builtin_clzll(reuse)];
      }
      last = e.last;
      tail_ref = e.last_ref;
    }
    if (last < 0) continue;
    if (span[head_ref] > 0)
      out->hs_idx.push_back(static_cast<int32_t>(out->head_line.size()));
    const int32_t line = static_cast<int32_t>(line_lo + li);
    out->head_line.push_back(line);
    out->head_pos.push_back(pos_lo + head);
    out->head_span.push_back(span[head_ref]);
    out->head_dline.push_back(dline[head_ref]);
    out->tail_line.push_back(line);
    out->tail_pos.push_back(pos_lo + last);
    out->tail_dline.push_back(dline[tail_ref]);
  }
  for (int b = nbins; b < kBins; ++b)
    if (hist[b]) {
      snprintf(err, kErr, "a reuse falls past the histogram's %lld slots",
               static_cast<long long>(nbins));
      return nullptr;
    }
  hist.resize(nbins);
  out->local_hist = std::move(hist);
  share.emit(&out->share_vals, &out->share_cnts);
  return out.release();
}

}  // namespace

// Builds the window template.  Reference i is described by
// meta[4i..4i+3] = (depth, offset, addr_base, line_base), its levels by
// depth rows of (trip, pos_stride, addr_coef, start, step) in `levels`
// (all references' rows one after another), its share span by span[i] and
// its line shift per unit by dline[i].  `owned` holds the W chunk ids of
// the window's rounds for its thread, r0 the window's first round.  Up to
// `threads` threads walk it.  On success returns the handle and writes
// (entries, heads, distinct share reuses, heads with a span, threads that
// walked) to sizes; on an error returns null with the message in err (at
// least 256 bytes).
extern "C" void* pluss_torch_window_template(
    long long n_refs, const long long* meta, const long long* levels,
    const int* span, const int* dline, const long long* owned, long long W,
    long long r0, long long cs, long long ds, long long cls,
    long long sched_start, long long sched_step, long long nbins,
    long long threads, long long* sizes, char* err) {
  if (n_refs < 0 || n_refs >= kHole || W < 0 || cs < 0 || ds <= 0 ||
      cls <= 0 || nbins < 1 || nbins > kBins || threads < 1) {
    snprintf(err, kErr,
             "bad arguments: %lld references (below %d), W %lld, chunk %lld, "
             "ds %lld, cls %lld, nbins %lld (1 to %d), threads %lld",
             n_refs, kHole, W, cs, ds, cls, nbins, kBins, threads);
    return nullptr;
  }
  Template* t = nullptr;
  try {
    t = build(n_refs, meta, levels, span, dline, owned, W, r0, cs, ds, cls,
              sched_start, sched_step, nbins, threads, err);
  } catch (const std::exception& e) {
    snprintf(err, kErr, "%s", e.what());
    return nullptr;
  }
  if (t) {
    sizes[0] = t->entries;
    sizes[1] = static_cast<long long>(t->head_line.size());
    sizes[2] = static_cast<long long>(t->share_vals.size());
    sizes[3] = static_cast<long long>(t->hs_idx.size());
    sizes[4] = t->threads;
  }
  return t;
}

// Copies the template into the caller's arrays, sized from `sizes`:
// local_hist [nbins], share_vals and share_cnts [S], the head and tail
// arrays [H], hs_idx [Hs].
extern "C" void pluss_torch_window_template_emit(
    void* handle, long long* local_hist, long long* share_vals,
    long long* share_cnts, int* head_line, long long* head_pos,
    int* head_span, int* head_dline, int* hs_idx, int* tail_line,
    long long* tail_pos, int* tail_dline) {
  const Template* t = static_cast<const Template*>(handle);
  auto copy = [](auto* dst, const auto& v) {
    if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
  };
  copy(local_hist, t->local_hist);
  copy(share_vals, t->share_vals);
  copy(share_cnts, t->share_cnts);
  copy(head_line, t->head_line);
  copy(head_pos, t->head_pos);
  copy(head_span, t->head_span);
  copy(head_dline, t->head_dline);
  copy(hs_idx, t->hs_idx);
  copy(tail_line, t->tail_line);
  copy(tail_pos, t->tail_pos);
  copy(tail_dline, t->tail_dline);
}

extern "C" void pluss_torch_window_template_free(void* handle) {
  delete static_cast<Template*>(handle);
}
