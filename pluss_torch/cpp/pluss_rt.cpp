#include "pluss_rt.hpp"

#include <cassert>
#include <cmath>
#include <cstdio>
#include <stdexcept>

namespace pluss {

// ---- spec parsing ----------------------------------------------------------

namespace {

Node parse_node(const long long* t, long long n, long long& i);

Loop parse_loop(const long long* t, long long n, long long& i) {
  if (i + 5 > n || (t[i] != 0 && t[i] != 2))
    throw std::runtime_error("spec: expected LOOP");
  Loop lp;
  bool tri = t[i] == 2;  // triangular: token carries the (a, b) bound
  lp.trip = t[i + 1];
  lp.start = t[i + 2];
  lp.step = t[i + 3];
  long long n_body;
  if (tri) {
    if (i + 9 > n) throw std::runtime_error("spec: truncated TRI LOOP");
    lp.bounded = true;
    lp.bound_a = t[i + 4];
    lp.bound_b = t[i + 5];
    lp.start_coef = t[i + 6];
    lp.bound_level = static_cast<int>(t[i + 7]);
    n_body = t[i + 8];
    i += 9;
  } else {
    n_body = t[i + 4];
    i += 5;
  }
  for (long long b = 0; b < n_body; ++b) lp.body.push_back(parse_node(t, n, i));
  return lp;
}

Node parse_node(const long long* t, long long n, long long& i) {
  Node node;
  if (i >= n) throw std::runtime_error("spec: truncated");
  if (t[i] == 0 || t[i] == 2) {
    node.loop = std::make_shared<Loop>(parse_loop(t, n, i));
  } else if (t[i] == 1) {
    if (i + 5 > n) throw std::runtime_error("spec: truncated REF");
    node.is_ref = true;
    node.ref.array = static_cast<int>(t[i + 1]);
    node.ref.addr_base = t[i + 2];
    node.ref.share_span = t[i + 3];
    long long n_terms = t[i + 4];
    i += 5;
    for (long long k = 0; k < n_terms; ++k) {
      node.ref.terms.emplace_back(static_cast<int>(t[i]), t[i + 1]);
      i += 2;
    }
  } else {
    throw std::runtime_error("spec: bad token");
  }
  return node;
}

}  // namespace

Spec parse_spec(const long long* tokens, long long n_tokens,
                const long long* array_elems, int n_arrays, int ds, int cls) {
  Spec spec;
  long long i = 0;
  if (n_tokens < 1) throw std::runtime_error("spec: empty");
  long long n_nests = tokens[i++];
  for (long long k = 0; k < n_nests; ++k)
    spec.nests.push_back(parse_loop(tokens, n_tokens, i));
  for (int a = 0; a < n_arrays; ++a)
    spec.array_lines.push_back((array_elems[a] * ds + cls - 1) / cls);
  return spec;
}

// ---- sampler walk ----------------------------------------------------------

namespace {

struct ThreadState {
  // per-array last-access-time tables (the reference's LAT_A/B/C hashmaps,
  // gemm_sampler.rs:70-72) keyed by cache-line id
  std::vector<std::unordered_map<long long, long long>> lat;
  long long clock = 0;
  Histogram noshare, share;
  const Config* cfg;
};

void walk(const Node& node, std::vector<long long>& iv, ThreadState& st,
          long long k0) {
  if (node.is_ref) {
    const Ref& r = node.ref;
    long long addr = r.addr_base;
    for (auto& [d, c] : r.terms) addr += c * iv[d];
    long long line = addr * st.cfg->ds / st.cfg->cls;
    auto& lat = st.lat[r.array];
    auto it = lat.find(line);
    if (it != lat.end()) {
      long long reuse = st.clock - it->second;
      // share iff distance_to(reuse,0) > distance_to(reuse,span)
      // (gemm_sampler.rs:199) == 2*reuse > span for non-negative ints
      if (r.share_span >= 0 && 2 * reuse > r.share_span) {
        st.share[reuse] += 1.0;  // raw, unbinned (pluss_utils.h:928-937, Q6)
      } else {
        histogram_update(st.noshare, reuse, 1.0);
      }
      it->second = st.clock;
    } else {
      lat.emplace(line, st.clock);
    }
    st.clock += 1;
    return;
  }
  const Loop& lp = *node.loop;
  // triangular inner loops run a + b*idx iterations, idx = the parallel
  // index k0 (bound_level 0) or an inner level's index (quad contract:
  // index == value there, so iv[] serves directly); values start at
  // start + start_coef*k0
  long long bref = lp.bound_level == 0 ? k0 : iv[lp.bound_level];
  long long trip = lp.bounded ? lp.bound_a + lp.bound_b * bref : lp.trip;
  long long start = lp.start + lp.start_coef * k0;
  iv.push_back(0);
  for (long long k = 0; k < trip; ++k) {
    iv.back() = start + k * lp.step;
    for (const Node& b : lp.body) walk(b, iv, st, k0);
  }
  iv.pop_back();
}

void run_thread(const Spec& spec, const Config& cfg, int tid, ThreadState& st) {
  st.cfg = &cfg;
  st.lat.resize(spec.array_lines.size());
  for (const Loop& nest : spec.nests) {
    // static round-robin chunking of the parallel (outermost) dim
    // (pluss_utils.h:410-425): chunk cid -> thread cid % T
    long long n_chunks = (nest.trip + cfg.chunk_size - 1) / cfg.chunk_size;
    for (long long cid = tid; cid < n_chunks; cid += cfg.thread_num) {
      long long b = cid * cfg.chunk_size;
      long long e = std::min(b + cfg.chunk_size, nest.trip);
      std::vector<long long> iv;
      iv.push_back(0);
      for (long long k = b; k < e; ++k) {
        iv[0] = nest.start + k * nest.step;
        for (const Node& body : nest.body) walk(body, iv, st, k);
      }
    }
  }
  // end-of-run cold flush: every still-resident line becomes one cold miss,
  // recorded as weight = table size on key -1 (gemm_sampler.rs:48-53)
  for (auto& lat : st.lat) st.noshare[-1] += static_cast<double>(lat.size());
}

}  // namespace

SampleResult run_sampler(const Spec& spec, const Config& cfg) {
  int T = cfg.thread_num;
  std::vector<ThreadState> states(T);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int tid = 0; tid < T; ++tid) run_thread(spec, cfg, tid, states[tid]);
  SampleResult res;
  for (int tid = 0; tid < T; ++tid) {
    res.total_count += states[tid].clock;
    res.noshare.push_back(std::move(states[tid].noshare));
    res.share.push_back(std::move(states[tid].share));
  }
  return res;
}

// ---- statistics ------------------------------------------------------------

long long highest_power_of_two(long long x) {
  long long r = 1;
  while (r * 2 <= x) r *= 2;
  return r;
}

void histogram_update(Histogram& h, long long reuse, double cnt,
                      bool in_log_format) {
  if (reuse > 0 && in_log_format) reuse = highest_power_of_two(reuse);
  h[reuse] += cnt;
}

namespace {

// NegativeBinomial(r, p) pmf at k, GSL parameterization
// (gsl_ran_negative_binomial_pdf(k, p, n), pluss_utils.h:1002)
double nbd_pmf(long long k, double r, double p) {
  return std::exp(std::lgamma(k + r) - std::lgamma(k + 1.0) - std::lgamma(r) +
                  r * std::log(p) + k * std::log1p(-p));
}

constexpr double kNbdCutoffCoef = 4000.0;  // pluss_utils.h:993
constexpr double kNbdMassCut = 0.9999;     // pluss_utils.h:1001-1008

}  // namespace

void cri_nbd(int thread_cnt, long long n,
             std::vector<std::pair<long long, double>>& out) {
  if (static_cast<double>(n) >=
      kNbdCutoffCoef * (thread_cnt - 1) / thread_cnt) {
    out.emplace_back(static_cast<long long>(thread_cnt) * n, 1.0);
    return;
  }
  double p = 1.0 / thread_cnt, mass = 0.0;
  for (long long k = 0;; ++k) {
    double pk = nbd_pmf(k, static_cast<double>(n), p);
    out.emplace_back(n + k, pk);
    mass += pk;
    if (mass > kNbdMassCut) return;  // crossing term included
  }
}

void cri_noshare_distribute(const std::vector<Histogram>& noshare,
                            Histogram& ri, int thread_cnt) {
  Histogram merged;
  for (const auto& h : noshare)
    for (auto& [k, v] : h) merged[k] += v;
  for (auto& [k, v] : merged) {
    if (k < 0) {
      histogram_update(ri, k, v);
    } else if (thread_cnt > 1) {
      std::vector<std::pair<long long, double>> dist;
      cri_nbd(thread_cnt, k, dist);
      for (auto& [kk, pk] : dist) histogram_update(ri, kk, v * pk);
    } else {
      histogram_update(ri, k, v);
    }
  }
}

void cri_racetrack(const std::vector<Histogram>& share, Histogram& ri,
                   int thread_cnt, int share_ratio) {
  Histogram merged;
  for (const auto& h : share)
    for (auto& [k, v] : h) merged[k] += v;
  double n = static_cast<double>(share_ratio);
  for (auto& [r, c] : merged) {
    if (thread_cnt <= 1) {
      histogram_update(ri, r, c);
      continue;
    }
    std::vector<std::pair<long long, double>> dist;
    cri_nbd(thread_cnt, r, dist);
    for (auto& [rik, pv] : dist) {
      double cnt = c * pv;
      // log2 bin split with the residual OVERWRITING the last computed bin
      // (pluss_utils.h:1076-1093; the overwrite is load-bearing for parity)
      double ri_f = static_cast<double>(rik), prob_sum = 0.0;
      std::map<int, double> probs;
      int i = 1;
      while (std::pow(2.0, i) <= ri_f) {
        probs[i] = std::pow(1.0 - std::pow(2.0, i - 1) / ri_f, n) -
                   std::pow(1.0 - std::pow(2.0, i) / ri_f, n);
        prob_sum += probs[i];
        ++i;
        if (prob_sum == 1.0) break;
      }
      if (prob_sum != 1.0) probs[i - 1] = 1.0 - prob_sum;
      for (auto& [b, bp] : probs)
        histogram_update(
            ri, static_cast<long long>(std::pow(2.0, b - 1)), bp * cnt);
    }
  }
}

Histogram cri_distribute(const SampleResult& r, const Config& cfg) {
  Histogram ri;
  cri_noshare_distribute(r.noshare, ri, cfg.thread_num);
  cri_racetrack(r.share, ri, cfg.thread_num, cfg.thread_num - 1);
  return ri;
}

// ---- dynamic trace replay (pluss.cpp:126-160 semantics) --------------------
Histogram replay_trace(const long long* addrs, long long n, int cls) {
  int shift = 0;
  while ((1LL << shift) < cls) ++shift;
  std::unordered_map<long long, long long> lat;
  Histogram h;
  for (long long clock = 0; clock < n; ++clock) {
    long long line = addrs[clock] >> shift;
    auto it = lat.find(line);
    if (it != lat.end()) {
      histogram_update(h, clock - it->second, 1.0);
      it->second = clock;
    } else {
      histogram_update(h, -1, 1.0);
      lat.emplace(line, clock);
    }
  }
  return h;
}

// ---- AET -> MRC ------------------------------------------------------------

std::vector<double> aet_mrc(const Histogram& ri, const Config& cfg) {
  // P(reuse > t) built by descending-key accumulation seeded with the cold
  // count; P[0] forced to 1 (pluss_utils.h:761-781)
  if (ri.empty()) return {1.0};
  long long max_rt = ri.rbegin()->first;
  if (max_rt < 0) return {1.0};
  double total = 0.0;
  for (auto& [k, v] : ri) total += v;
  std::map<long long, double> P;
  auto cold = ri.find(-1);
  double acc = cold != ri.end() ? cold->second : 0.0;
  for (auto it = ri.rbegin(); it != ri.rend(); ++it) {
    if (it->first == -1) continue;
    P[it->first] = acc / total;
    acc += it->second;
  }
  P[0] = 1.0;
  long long c_max =
      std::min(max_rt, cfg.cache_kb * 1024 / 8);  // pluss_utils.h:785
  std::vector<double> mrc;
  mrc.reserve(c_max + 1);
  // serial sweep exactly as the reference does it (pluss_utils.h:783-802):
  // prev_t advances only on exact P keys; between keys the step value P[prev_t]
  // accumulates.  The MRC_pred guard there is vestigial (always taken, see
  // AET_PRED_EPS in pluss_torch/config.py), so every c gets an entry.
  long long t = 0, prev_t = 0;
  double sum_P = 0.0;
  for (long long c = 0; c <= c_max; ++c) {
    while (sum_P < static_cast<double>(c) && t <= max_rt) {
      auto it = P.find(t);
      if (it != P.end()) {
        sum_P += it->second;
        prev_t = t;
      } else {
        sum_P += P[prev_t];
      }
      ++t;
    }
    mrc.push_back(P[prev_t]);
  }
  return mrc;
}

void write_mrc(const std::vector<double>& mrc, const char* path) {
  // run-collapsing dedup printer, eps 1e-5 (pluss_utils.h:885-913)
  FILE* f = std::fopen(path, "w");
  if (!f) throw std::runtime_error("cannot open mrc output file");
  std::fprintf(f, "miss ratio\n");
  size_t i1 = 0, n = mrc.size();
  while (i1 < n) {
    size_t i2 = i1;
    while (i2 + 1 < n && mrc[i1] - mrc[i2 + 1] < kMrcDedupEps) ++i2;
    std::fprintf(f, "%zu, %g\n", i1, mrc[i1]);
    if (i1 != i2) std::fprintf(f, "%zu, %g\n", i2, mrc[i2]);
    i1 = i2 + 1;
  }
  std::fclose(f);
}

}  // namespace pluss
