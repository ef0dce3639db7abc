// Prefix CTC beam search with optional n-gram LM shallow fusion: the host
// beam of onebit_asr_tpu_torch, in C++.
//
// Own copy of the JAX package's native/beam.cpp, the exact algorithm of
// decode/beam.py (the corrected Hannun rules) and decode/lm.py
// (stupid-backoff n-gram LM) behind a C ABI; the Python modules stay the
// plain version (`prefer_native=False`).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libonebit_beam.so beam.cpp
// (native/__init__.py builds it into onebit_asr_tpu_torch/_build/ at first
// use and binds it with ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float NEG_INF = -std::numeric_limits<float>::infinity();
constexpr float LOG_BACKOFF = -0.916290731874155f;  // log(0.4)
constexpr float UNIGRAM_FLOOR = -20.0f;

inline float logsumexp2(float a, float b) {
  if (a == NEG_INF) return b;
  if (b == NEG_INF) return a;
  float m = a > b ? a : b;
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

// ---------------------------------------------------------------------- LM

struct NGramLM {
  int order = 0;
  long long total = 0;
  // key: n tokens packed into a byte string
  std::unordered_map<std::string, long long> counts;

  static std::string key(const int32_t* toks, int n) {
    return std::string(reinterpret_cast<const char*>(toks),
                       sizeof(int32_t) * n);
  }

  long long count(const int32_t* toks, int n) const {
    auto it = counts.find(key(toks, n));
    return it == counts.end() ? 0 : it->second;
  }

  // log P(c | context) with stupid backoff (decode/lm.py semantics)
  float score(const std::vector<int32_t>& context, int32_t c) const {
    int ctx_len = std::min<int>(context.size(), order - 1);
    std::vector<int32_t> buf(ctx_len + 1);
    for (int i = 0; i < ctx_len; ++i)
      buf[i] = context[context.size() - ctx_len + i];
    float penalty = 0.0f;
    while (true) {
      buf[ctx_len] = c;
      long long num = count(buf.data() + 0, ctx_len + 1);
      if (num) {
        long long den =
            ctx_len ? count(buf.data(), ctx_len) : total;
        if (den) return penalty + std::log((double)num / (double)den);
      }
      if (!ctx_len) return penalty + UNIGRAM_FLOOR;
      buf.erase(buf.begin());
      --ctx_len;
      penalty += LOG_BACKOFF;
    }
  }
};

// -------------------------------------------------------------------- beam

struct Beam {
  std::vector<int32_t> prefix;
  float p_b;   // log prob of ending in blank
  float p_nb;  // log prob of ending in non-blank
};

struct Slot {
  float p_b = NEG_INF;
  float p_nb = NEG_INF;
  int prefix_idx = -1;  // index into the arena of prefixes
};

}  // namespace

extern "C" {

void* onebit_lm_create(const int64_t* keys, const int64_t* vals, int64_t n,
                       int32_t order, int64_t total) {
  // keys: [n, order+1] rows of (ngram_len, tok_0..tok_{order-1}) — the
  // layout decode/lm.py's .npz serialization uses.
  auto* lm = new NGramLM();
  lm->order = order;
  lm->total = total;
  lm->counts.reserve(n * 2);
  std::vector<int32_t> buf(order);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* row = keys + i * (order + 1);
    int len = (int)row[0];
    for (int j = 0; j < len; ++j) buf[j] = (int32_t)row[1 + j];
    lm->counts[NGramLM::key(buf.data(), len)] = vals[i];
  }
  return lm;
}

void onebit_lm_free(void* lm) { delete static_cast<NGramLM*>(lm); }

// Returns the decoded length (<= max_out). log_probs: [T, V] row-major.
int32_t onebit_ctc_beam_search(const float* log_probs, int32_t T, int32_t V,
                               int32_t blank_id, int32_t beam_size,
                               int32_t top_k, void* lm_handle,
                               float lm_weight, float length_bonus,
                               int32_t* out_ids, int32_t max_out) {
  const NGramLM* lm = static_cast<const NGramLM*>(lm_handle);
  bool fuse = lm != nullptr && lm_weight != 0.0f;

  std::vector<Beam> beams;
  beams.push_back({{}, 0.0f, NEG_INF});

  std::vector<int32_t> cand;
  cand.reserve(V);
  std::vector<int32_t> idx(V);

  for (int32_t t = 0; t < T; ++t) {
    const float* lp = log_probs + (size_t)t * V;

    // top-k candidate ids by lp (same candidate SET as np.argpartition)
    cand.clear();
    if (top_k > 0 && top_k < V) {
      for (int32_t i = 0; i < V; ++i) idx[i] = i;
      std::nth_element(idx.begin(), idx.begin() + (V - top_k), idx.end(),
                       [&](int32_t a, int32_t b) { return lp[a] < lp[b]; });
      cand.assign(idx.begin() + (V - top_k), idx.end());
    } else {
      for (int32_t i = 0; i < V; ++i) cand.push_back(i);
    }
    float lp_blank = lp[blank_id];

    // new beams keyed by prefix bytes
    std::unordered_map<std::string, Slot> next;
    next.reserve(beams.size() * (cand.size() + 1) * 2);
    std::vector<std::vector<int32_t>> arena;
    arena.reserve(beams.size() * (cand.size() + 1));

    auto slot = [&](std::vector<int32_t>&& prefix) -> Slot& {
      std::string k = NGramLM::key(prefix.data(), prefix.size());
      auto it = next.find(k);
      if (it == next.end()) {
        arena.push_back(std::move(prefix));
        Slot s;
        s.prefix_idx = (int)arena.size() - 1;
        it = next.emplace(std::move(k), s).first;
      }
      return it->second;
    };

    for (const Beam& bm : beams) {
      float total = logsumexp2(bm.p_b, bm.p_nb);
      {
        Slot& s = slot(std::vector<int32_t>(bm.prefix));
        s.p_b = logsumexp2(s.p_b, total + lp_blank);
      }
      int32_t last = bm.prefix.empty() ? -1 : bm.prefix.back();
      for (int32_t c : cand) {
        if (c == blank_id) continue;
        float lp_c = lp[c];
        float bonus = length_bonus;
        if (fuse) bonus += lm_weight * lm->score(bm.prefix, c);
        if (c == last) {
          // collapsed repeat stays on the prefix (from p_nb);
          // post-blank emission extends it (from p_b)
          Slot& s = slot(std::vector<int32_t>(bm.prefix));
          s.p_nb = logsumexp2(s.p_nb, bm.p_nb + lp_c);
          std::vector<int32_t> ext(bm.prefix);
          ext.push_back(c);
          Slot& se = slot(std::move(ext));
          se.p_nb = logsumexp2(se.p_nb, bm.p_b + lp_c + bonus);
        } else {
          std::vector<int32_t> ext(bm.prefix);
          ext.push_back(c);
          Slot& se = slot(std::move(ext));
          se.p_nb = logsumexp2(se.p_nb, total + lp_c + bonus);
        }
      }
    }

    // prune to beam_size by total mass
    std::vector<const std::pair<const std::string, Slot>*> items;
    items.reserve(next.size());
    for (const auto& kv : next) items.push_back(&kv);
    auto score = [](const Slot& s) { return logsumexp2(s.p_b, s.p_nb); };
    int keep = std::min<int>(beam_size, items.size());
    std::partial_sort(items.begin(), items.begin() + keep, items.end(),
                      [&](auto* a, auto* b) {
                        return score(a->second) > score(b->second);
                      });
    beams.clear();
    for (int i = 0; i < keep; ++i) {
      const Slot& s = items[i]->second;
      beams.push_back({arena[s.prefix_idx], s.p_b, s.p_nb});
    }
  }

  const Beam* best = &beams[0];
  float best_score = logsumexp2(best->p_b, best->p_nb);
  for (const Beam& bm : beams) {
    float sc = logsumexp2(bm.p_b, bm.p_nb);
    if (sc > best_score) {
      best = &bm;
      best_score = sc;
    }
  }
  int32_t n = std::min<int32_t>(best->prefix.size(), max_out);
  std::memcpy(out_ids, best->prefix.data(), sizeof(int32_t) * n);
  return n;
}

}  // extern "C"
