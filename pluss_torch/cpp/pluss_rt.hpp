// pluss native runtime: spec-interpreting sampler walk + CRI statistics + AET.
//
// The host sibling of the port's engine (pluss_torch/engine.py), which runs on
// the card: an independent sampler to hold the card's results against.  Where
// the reference ships *generated* per-workload state machines (the reference's
// c_lib/test/sampler/gemm-t4-pluss-pro-model-ri-omp.cpp:37-333) over a
// hand-written runtime header (c_lib/test/runtime/pluss_utils.h), this runtime
// interprets the same declarative loop-nest spec the engine consumes
// (pluss_torch/spec.py), marshalled as a flat token stream
// (pluss_torch/native.py spec_tokens).  Statistics semantics (log2 binning,
// share classification, NBD dilation, racetrack split, AET sweep) match the
// reference bit-for-bit in f64; the NBD pmf uses std::lgamma instead of GSL
// (pluss_utils.h:1002), same parameterization.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <unordered_map>
#include <vector>

namespace pluss {

using Histogram = std::map<long long, double>;  // ordered: print parity is free

// ---- declarative spec (token-marshalled tree) ------------------------------
// token stream grammar (int64 tokens):
//   nest_count, then nest_count LOOP trees, preorder:
//     LOOP  := 0, trip, start, step, n_body, body...
//     TRI   := 2, trip, start, step, bound_a, bound_b, start_coef,
//              bound_level, n_body, body...
//     REF   := 1, array_idx, addr_base, share_span(-1 = no share test),
//              n_terms, (depth, coef) * n_terms
struct Ref {
  int array = 0;
  long long addr_base = 0;
  long long share_span = -1;  // -1: never classified as shared
  std::vector<std::pair<int, long long>> terms;  // (loop depth, coefficient)
};

struct Node;  // LOOP or REF
struct Loop {
  long long trip = 0, start = 0, step = 1;
  // triangular bound (spec.Loop.bound_coef): effective trip = a + b*k at
  // effective trip = bound_a + bound_b * (index of the referenced level)
  // when `bounded` — bound_level 0 is the parallel index k; > 0 names an
  // enclosing inner level (the quad contract: that level has start=0,
  // step=1, so its index equals its value in `iv`).  First value =
  // start + start_coef*k
  bool bounded = false;
  long long bound_a = 0, bound_b = 0, start_coef = 0;
  int bound_level = 0;
  std::vector<Node> body;
};
struct Node {
  bool is_ref = false;
  Ref ref;
  std::shared_ptr<Loop> loop;
};

struct Spec {
  std::vector<Loop> nests;
  std::vector<long long> array_lines;  // cache lines per array
};

Spec parse_spec(const long long* tokens, long long n_tokens,
                const long long* array_elems, int n_arrays, int ds, int cls);

// ---- sampler ---------------------------------------------------------------
struct Config {
  int thread_num = 4, chunk_size = 4, ds = 8, cls = 64;
  long long cache_kb = 2560;
};

struct SampleResult {
  std::vector<Histogram> noshare;              // per tid; key -1 = cold
  std::vector<Histogram> share;                // per tid; raw (unbinned) keys
  long long total_count = 0;                   // "max iteration traversed"
};

// Interpret the spec for every simulated thread (OpenMP fan-out when built
// with -fopenmp; threads are disjoint by construction, SURVEY.md §2).
SampleResult run_sampler(const Spec& spec, const Config& cfg);

// ---- statistics (reference-parity, pluss_utils.h:664-1208) -----------------
long long highest_power_of_two(long long x);            // :665-679
void histogram_update(Histogram& h, long long reuse, double cnt,
                      bool in_log_format = true);       // :680-689
// NBD dilation: appends (key, pmf) pairs; point mass past the cutoff. :987-1009
void cri_nbd(int thread_cnt, long long n,
             std::vector<std::pair<long long, double>>& out);
void cri_noshare_distribute(const std::vector<Histogram>& noshare,
                            Histogram& ri, int thread_cnt);       // :1010-1039
void cri_racetrack(const std::vector<Histogram>& share, Histogram& ri,
                   int thread_cnt, int share_ratio);              // :1040-1131
Histogram cri_distribute(const SampleResult& r, const Config& cfg); // :1204-1208

// ---- dynamic trace replay --------------------------------------------------
// The reference's disabled trace-driven API (pluss_access: line masking,
// global clock, last-access map — c_lib/test/runtime/pluss.cpp:126-160,
// CACHE_MASK at :13), live here.  Single-clock: feeds aet_mrc directly,
// no CRI dilation (the trace path bypasses the CRI model).
Histogram replay_trace(const long long* addrs, long long n, int cls);

// ---- AET -> MRC (pluss_utils.h:758-804, 851-913) ---------------------------
constexpr double kMrcDedupEps = 1e-5;  // pluss_utils.h:863,899
std::vector<double> aet_mrc(const Histogram& ri, const Config& cfg);
void write_mrc(const std::vector<double>& mrc, const char* path);

}  // namespace pluss
