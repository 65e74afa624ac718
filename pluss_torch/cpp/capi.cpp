// C ABI of the native runtime for ctypes (pluss_torch/native.py): plain C
// symbols, no PyTorch headers.  A handle owns one run's results; getters copy
// histograms into caller arrays.  The trace feed's line mapper lives in its
// own library (pluss_torch/csrc/map_lines.cpp) and is not linked here.
#include <cstring>
#include <memory>
#include <new>

#include "pluss_rt.hpp"

namespace {

struct Handle {
  pluss::SampleResult res;
  pluss::Histogram ri;
  std::vector<double> mrc;
  pluss::Config cfg;
};

long long copy_hist(const pluss::Histogram& h, long long* keys, double* vals,
                    long long cap) {
  long long n = 0;
  for (auto& [k, v] : h) {
    if (n < cap) {
      keys[n] = k;
      vals[n] = v;
    }
    ++n;
  }
  return n;  // required size; > cap means truncated
}

}  // namespace

extern "C" {

// Run sampler + CRI distribute.  Returns nullptr on malformed specs.
void* pluss_run(const long long* tokens, long long n_tokens,
                const long long* array_elems, int n_arrays, int thread_num,
                int chunk_size, int ds, int cls, long long cache_kb) {
  try {
    auto h = std::make_unique<Handle>();
    h->cfg = {thread_num, chunk_size, ds, cls, cache_kb};
    pluss::Spec spec =
        pluss::parse_spec(tokens, n_tokens, array_elems, n_arrays, ds, cls);
    h->res = pluss::run_sampler(spec, h->cfg);
    h->ri = pluss::cri_distribute(h->res, h->cfg);
    return h.release();
  } catch (...) {
    return nullptr;
  }
}

long long pluss_total_count(void* hp) {
  return static_cast<Handle*>(hp)->res.total_count;
}

long long pluss_get_noshare(void* hp, int tid, long long* keys, double* vals,
                            long long cap) {
  auto* h = static_cast<Handle*>(hp);
  if (tid < 0 || tid >= static_cast<int>(h->res.noshare.size())) return -1;
  return copy_hist(h->res.noshare[tid], keys, vals, cap);
}

long long pluss_get_share(void* hp, int tid, long long* keys, double* vals,
                          long long cap) {
  auto* h = static_cast<Handle*>(hp);
  if (tid < 0 || tid >= static_cast<int>(h->res.share.size())) return -1;
  return copy_hist(h->res.share[tid], keys, vals, cap);
}

long long pluss_get_ri(void* hp, long long* keys, double* vals, long long cap) {
  return copy_hist(static_cast<Handle*>(hp)->ri, keys, vals, cap);
}

long long pluss_get_mrc(void* hp, double* out, long long cap) {
  auto* h = static_cast<Handle*>(hp);
  if (h->mrc.empty()) h->mrc = pluss::aet_mrc(h->ri, h->cfg);
  long long n = static_cast<long long>(h->mrc.size());
  if (out)
    std::memcpy(out, h->mrc.data(),
                sizeof(double) * static_cast<size_t>(std::min(n, cap)));
  return n;
}

// Dynamic trace replay: the handle's ri/mrc getters serve the result; the
// sampler-specific getters see empty per-thread histograms.
void* pluss_replay(const long long* addrs, long long n, int cls,
                   long long cache_kb) {
  try {
    auto h = std::make_unique<Handle>();
    h->cfg = {1, 1, 8, cls, cache_kb};
    h->ri = pluss::replay_trace(addrs, n, cls);
    h->res.total_count = n;
    return h.release();
  } catch (...) {
    return nullptr;
  }
}

void pluss_destroy(void* hp) { delete static_cast<Handle*>(hp); }

}  // extern "C"
