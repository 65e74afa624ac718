// Standalone acc|speed|mrc|trace binary of the native runtime (pluss_cpp),
// mirroring the reference's C++ mains (c_lib/test/sampler/…omp.cpp:334-362):
// banner + %0.6f seconds, three sorted histogram dumps, "max iteration
// traversed".  The GEMM spec is built here with the same declarative tree the
// port's models marshal (pluss_torch/models/gemm.py); any other registry spec
// comes in through --spec.
#include <chrono>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "pluss_rt.hpp"

using pluss::Histogram;

namespace {

pluss::Spec gemm_spec(long long n, int ds, int cls) {
  using pluss::Loop;
  using pluss::Node;
  using pluss::Ref;
  long long span = (n + 1) * n + 1;  // share threshold (…omp.cpp:202)
  auto cref = [&](void) {
    Node nd;
    nd.is_ref = true;
    nd.ref = Ref{0, 0, -1, {{0, n}, {1, 1}}};
    return nd;
  };
  Node a0;
  a0.is_ref = true;
  a0.ref = Ref{1, 0, -1, {{0, n}, {2, 1}}};
  Node b0;
  b0.is_ref = true;
  b0.ref = Ref{2, 0, span, {{2, n}, {1, 1}}};
  auto inner = std::make_shared<Loop>();
  inner->trip = n;
  inner->body = {a0, b0, cref(), cref()};
  Node inner_n;
  inner_n.loop = inner;
  auto mid = std::make_shared<Loop>();
  mid->trip = n;
  mid->body = {cref(), cref(), inner_n};
  Node mid_n;
  mid_n.loop = mid;
  Loop nest;
  nest.trip = n;
  nest.body = {mid_n};
  pluss::Spec spec;
  spec.nests = {nest};
  for (int a = 0; a < 3; ++a)
    spec.array_lines.push_back((n * n * ds + cls - 1) / cls);
  return spec;
}

// on-disk spec format of pluss_torch/native.py write_spec_file: little-endian
// int64 [magic, n_arrays, elems..., n_tokens, tokens...] in the pluss_rt token
// grammar — a native block for every registry model, not only the hardwired
// GEMM.
constexpr long long kSpecMagic = 0x53554C50;  // "PLUS"

pluss::Spec load_spec_file(const char* path, const pluss::Config& cfg) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) throw std::runtime_error(std::string("cannot open ") + path);
  std::vector<long long> words;
  long long w;
  while (std::fread(&w, sizeof(w), 1, f) == 1) words.push_back(w);
  std::fclose(f);
  if (words.size() < 3 || words[0] != kSpecMagic)
    throw std::runtime_error("bad spec file (magic mismatch)");
  // subtraction-sided bounds: "3 + n_arrays" would signed-overflow for a
  // corrupt count near LLONG_MAX and bypass the check
  long long n_arrays = words[1];
  if (n_arrays < 0 || n_arrays > (long long)words.size() - 3)
    throw std::runtime_error("truncated spec file (arrays)");
  long long n_tokens = words[2 + n_arrays];
  if (n_tokens < 0 ||
      n_tokens != (long long)words.size() - 3 - n_arrays)
    throw std::runtime_error("truncated spec file (tokens)");
  return pluss::parse_spec(words.data() + 3 + n_arrays, n_tokens,
                           words.data() + 2, (int)n_arrays, cfg.ds, cfg.cls);
}

void print_hist(const char* title, const Histogram& h) {
  std::printf("%s\n", title);
  double sum = 0.0;
  for (auto& [k, v] : h) sum += v;
  for (auto& [k, v] : h)
    std::printf("%lld,%g,%g\n", k, v, sum != 0.0 ? v / sum : 0.0);
}

Histogram merge_noshare(const std::vector<Histogram>& per_thread) {
  Histogram out;
  for (auto& h : per_thread)
    for (auto& [k, v] : h) out[k] += v;
  return out;
}

// -- timing & measurement parity (reference L4, pluss.cpp:45-124) -----------
// timer_start flushes a cache-sized buffer so each timed rep starts with a
// cold data cache (pluss.cpp:71-94, POLYBENCH_CACHE_SIZE_KB default 2560);
// under -DPLUSS_CYCLE_ACCURATE_TIMER the wall clock is replaced by the TSC
// cycle counter (pluss.cpp:57-69,98-124).

#ifndef POLYBENCH_CACHE_SIZE_KB
#define POLYBENCH_CACHE_SIZE_KB 2560
#endif

void flush_cache() {
  const long long cs = POLYBENCH_CACHE_SIZE_KB * 1024LL / sizeof(double);
  static std::vector<double> buf(cs, 0.0);
  double tmp = 0.0;
  for (long long i = 0; i < cs; ++i) tmp += buf[i];
  // the sum must stay observable or the flush loop is dead code
  volatile double sink = tmp;
  (void)sink;
}

#ifdef PLUSS_CYCLE_ACCURATE_TIMER
unsigned long long now_cycles() {
#if defined(__x86_64__)
  unsigned hi, lo;
  __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
  return ((unsigned long long)hi << 32) | lo;
#else
  return (unsigned long long)std::chrono::steady_clock::now()
      .time_since_epoch()
      .count();
#endif
}
#endif

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Timer {
  double t0 = 0.0;
#ifdef PLUSS_CYCLE_ACCURATE_TIMER
  unsigned long long c0 = 0;
#endif
  void start() {
    flush_cache();  // pluss_timer_start flushes, then reads the clock
#ifdef PLUSS_CYCLE_ACCURATE_TIMER
    c0 = now_cycles();
#endif
    t0 = now_s();
  }
  double stop() {
    double dt = now_s() - t0;
#ifdef PLUSS_CYCLE_ACCURATE_TIMER
    std::fprintf(stderr, "cycles: %llu\n", now_cycles() - c0);
#endif
    return dt;
  }
};

}  // namespace

int main(int argc, char** argv) {
  std::string mode = argc > 1 ? argv[1] : "acc";
  pluss::Config cfg;
  pluss::Spec spec;
  long long n = 128;
  int argi = 3;  // first positional after mode+n (mrc path etc.)
  if (argc > 3 && std::strcmp(argv[2], "--spec") == 0) {
    // any registry model, serialized by native.write_spec_file
    try {
      spec = load_spec_file(argv[3], cfg);
    } catch (const std::exception& e) {
      std::fprintf(stderr, "%s\n", e.what());
      return 1;
    }
    argi = 4;
  } else if (argc > 2 && std::strcmp(argv[2], "--spec") == 0) {
    std::fprintf(stderr, "usage: %s %s --spec <spec-file>\n", argv[0],
                 mode.c_str());
    return 2;
  } else {
    n = argc > 2 ? std::atoll(argv[2]) : 128;
    spec = gemm_spec(n, cfg.ds, cfg.cls);
  }

  if (mode == "acc") {
    Timer t;
    t.start();
    pluss::SampleResult res = pluss::run_sampler(spec, cfg);
    Histogram ri = pluss::cri_distribute(res, cfg);
    std::printf("NATIVE C++: %0.6f\n", t.stop());
    print_hist("Start to dump noshare private reuse time",
               merge_noshare(res.noshare));
    print_hist("Start to dump share private reuse time",
               merge_noshare(res.share));
    print_hist("Start to dump reuse time", ri);
    std::printf("max iteration traversed\n%lld\n\n", res.total_count);
  } else if (mode == "speed") {
    for (int rep = 0; rep < 3; ++rep) {
      Timer t;
      t.start();
      pluss::SampleResult res = pluss::run_sampler(spec, cfg);
      Histogram ri = pluss::cri_distribute(res, cfg);
      (void)ri;
      std::printf("NATIVE C++: %0.6f\n", t.stop());
      if (res.total_count == 0) return 1;
    }
    std::printf("\n");
  } else if (mode == "mrc") {
    // native twin of `python -m pluss_torch.cli mrc` (the dormant titular
    // capability of the reference, live here)
    const char* path = argc > argi ? argv[argi] : "mrc.csv";
    pluss::SampleResult res = pluss::run_sampler(spec, cfg);
    std::vector<double> mrc = pluss::aet_mrc(pluss::cri_distribute(res, cfg), cfg);
    pluss::write_mrc(mrc, path);
    std::printf("wrote MRC over %zu cache sizes to %s\n", mrc.size(), path);
  } else if (mode == "trace") {
    // native twin of `python -m pluss_torch.cli trace`: replay a packed-u64
    // address file (the reference's disabled pluss_access path, live)
    const char* path = argc > 2 ? argv[2] : nullptr;
    if (!path) {
      std::fprintf(stderr, "usage: %s trace <u64-file> [mrc_path]\n", argv[0]);
      return 2;
    }
    std::FILE* f = std::fopen(path, "rb");
    if (!f) {
      std::fprintf(stderr, "cannot open %s\n", path);
      return 1;
    }
    std::vector<long long> addrs;
    long long a;
    while (std::fread(&a, sizeof(a), 1, f) == 1) addrs.push_back(a);
    std::fclose(f);
    Timer t;
    t.start();
    Histogram h = pluss::replay_trace(addrs.data(),
                                      (long long)addrs.size(), cfg.cls);
    std::printf("NATIVE TRACE: %0.6f\n", t.stop());
    print_hist("Start to dump reuse time", h);
    std::printf("max iteration traversed\n%lld\n\n", (long long)addrs.size());
    if (argc > 3) pluss::write_mrc(pluss::aet_mrc(h, cfg), argv[3]);
  } else {
    std::fprintf(stderr,
                 "usage: %s {acc|speed|mrc|trace} [n|file] [mrc_path]\n",
                 argv[0]);
    return 2;
  }
  return 0;
}
