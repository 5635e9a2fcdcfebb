// Native text-processing engine: batch MurmurHash3 and VW-format parsing.
//
// The PyTorch port's copy of the JAX package's native/textproc.cpp (the
// same source, byte for byte below this header): Vowpal Wabbit's native
// parser+hasher behind VowpalWabbitNative.learnFromString and
// VowpalWabbitMurmurWithPrefix.scala:80.  Python drives these through
// ctypes with concatenated-buffer + offsets calling conventions (no
// per-string FFI crossings), multithreaded over line ranges.  It is host
// code, built with g++ at first use (synapseml_tpu_torch/native).
//
// Semantics mirror synapseml_tpu_torch/models/online/generic.py:
// parse_vw_line exactly — including Python float() strictness (full-token
// parse or the value falls back to 1.0 / the label to "absent").

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

// MurmurHash3 x86_32 (public domain, Austin Appleby)
uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const int nblocks = static_cast<int>(len / 4);
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    memcpy(&k1, data + 4 * i, 4);
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8; [[fallthrough]];
    case 1: k1 ^= tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= static_cast<uint32_t>(len);
  h1 ^= h1 >> 16; h1 *= 0x85ebca6b; h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35; h1 ^= h1 >> 16;
  return h1;
}

// Python float(tok) semantics (not raw strtod): no hex literals, single
// underscores allowed strictly between digits, full-token consumption,
// inf/infinity/nan accepted.  (Known residual divergence: non-ASCII
// Unicode digits, which Python accepts — not worth a Unicode tables dep.)
bool parse_full_double(const char* s, size_t n, double* out) {
  if (n == 0) return false;
  std::string norm;
  norm.reserve(n);
  size_t i = 0;
  if (s[0] == '+' || s[0] == '-') { norm.push_back(s[0]); i = 1; }
  // reject hex floats (strtod accepts them, Python float() does not)
  if (i + 1 < n && s[i] == '0' && (s[i + 1] == 'x' || s[i + 1] == 'X'))
    return false;
  for (size_t j = i; j < n; j++) {
    char c = s[j];
    if (c == '_') {
      // Python: a single underscore strictly between two digits
      if (j == 0 || j + 1 >= n ||
          !isdigit(static_cast<unsigned char>(s[j - 1])) ||
          !isdigit(static_cast<unsigned char>(s[j + 1])))
        return false;
      continue;  // strip
    }
    if (c == '(' || c == ')' || isspace(static_cast<unsigned char>(c)))
      return false;  // Python rejects nan(...) forms and inner spaces
    norm.push_back(c);
  }
  if (norm.empty() ||
      (norm.size() == 1 && (norm[0] == '+' || norm[0] == '-')))
    return false;
  char* end = nullptr;
  double v = strtod(norm.c_str(), &end);
  if (end != norm.c_str() + norm.size()) return false;
  *out = v;
  return true;
}

struct Tok { const char* p; size_t n; };

// Python str.split() whitespace: Unicode White_Space plus the 0x1c-0x1f
// separators.  Returns the byte length of the space char at p (0 = not
// whitespace).  Invalid UTF-8 bytes are treated as non-space.
size_t py_space_len(const char* p, const char* e) {
  unsigned char c0 = static_cast<unsigned char>(p[0]);
  if (c0 < 0x80) {
    return ((c0 >= 9 && c0 <= 13) || (c0 >= 28 && c0 <= 31) || c0 == ' ')
        ? 1 : 0;
  }
  if ((c0 == 0xC2) && p + 1 < e) {
    unsigned char c1 = static_cast<unsigned char>(p[1]);
    return (c1 == 0x85 || c1 == 0xA0) ? 2 : 0;   // NEL, NBSP
  }
  if (c0 == 0xE1 && p + 2 < e &&
      static_cast<unsigned char>(p[1]) == 0x9A &&
      static_cast<unsigned char>(p[2]) == 0x80)
    return 3;                                     // U+1680 ogham
  if (c0 == 0xE2 && p + 2 < e) {
    unsigned char c1 = static_cast<unsigned char>(p[1]);
    unsigned char c2 = static_cast<unsigned char>(p[2]);
    if (c1 == 0x80 &&
        ((c2 >= 0x80 && c2 <= 0x8A) ||            // U+2000-200A
         c2 == 0xA8 || c2 == 0xA9 ||              // U+2028/2029
         c2 == 0xAF))                             // U+202F
      return 3;
    if (c1 == 0x81 && c2 == 0x9F) return 3;       // U+205F
  }
  if (c0 == 0xE3 && p + 2 < e &&
      static_cast<unsigned char>(p[1]) == 0x80 &&
      static_cast<unsigned char>(p[2]) == 0x80)
    return 3;                                     // U+3000 ideographic
  return 0;
}

void split_ws(const char* s, const char* e, std::vector<Tok>& out) {
  out.clear();
  const char* p = s;
  while (p < e) {
    size_t sp;
    while (p < e && (sp = py_space_len(p, e)) > 0) p += sp;
    const char* t = p;
    while (p < e && py_space_len(p, e) == 0) p++;
    if (p > t) out.push_back({t, static_cast<size_t>(p - t)});
  }
}

// One parsed feature emit.
struct Emit { uint32_t idx; float val; };

// Parse one VW line; fills feats, label/importance/has_label.
void parse_line(const char* s, const char* e, uint32_t seed, uint32_t dim_mask,
                std::vector<Tok>& scratch, std::string& namebuf,
                std::vector<Emit>& feats, float* label, float* importance,
                uint8_t* has_label) {
  *label = 0.0f; *importance = 1.0f; *has_label = 0;
  const char* bar = static_cast<const char*>(memchr(s, '|', e - s));
  const char* head_end = bar ? bar : e;
  split_ws(s, head_end, scratch);
  if (!scratch.empty()) {
    double v;
    if (parse_full_double(scratch[0].p, scratch[0].n, &v)) {
      *label = static_cast<float>(v);
      *has_label = 1;
      if (scratch.size() > 1 &&
          parse_full_double(scratch[1].p, scratch[1].n, &v)) {
        *importance = static_cast<float>(v);
      }
    }
  }
  if (!bar) return;
  const char* seg = bar + 1;
  while (seg <= e) {
    const char* seg_end =
        static_cast<const char*>(memchr(seg, '|', e - seg));
    if (!seg_end) seg_end = e;
    split_ws(seg, seg_end, scratch);
    size_t first = 0;
    double ns_weight = 1.0;
    const char* ns_p = nullptr;
    size_t ns_n = 0;
    if (!scratch.empty() && seg < seg_end &&
        *seg != ' ' && *seg != '\t') {  // Python: seg[:1] not in (" ", "\t")
      // namespace token attached to the '|'
      const Tok& t = scratch[0];
      const char* colon =
          static_cast<const char*>(memchr(t.p, ':', t.n));
      if (colon) {
        ns_p = t.p; ns_n = colon - t.p;
        double w;
        if (colon + 1 < t.p + t.n &&
            parse_full_double(colon + 1, t.p + t.n - colon - 1, &w)) {
          ns_weight = w;
        }
      } else {
        ns_p = t.p; ns_n = t.n;
      }
      first = 1;
    }
    for (size_t i = first; i < scratch.size(); i++) {
      const Tok& t = scratch[i];
      const char* colon =
          static_cast<const char*>(memchr(t.p, ':', t.n));
      const char* name_p = t.p;
      size_t name_n = colon ? static_cast<size_t>(colon - t.p) : t.n;
      double value = 1.0;
      if (colon && colon + 1 < t.p + t.n) {
        double v;
        if (parse_full_double(colon + 1, t.p + t.n - colon - 1, &v))
          value = v;
      }
      namebuf.assign(ns_p, ns_n);
      namebuf.append(name_p, name_n);
      uint32_t h = murmur3_32(
          reinterpret_cast<const uint8_t*>(namebuf.data()),
          namebuf.size(), seed);
      feats.push_back({h & dim_mask,
                       static_cast<float>(value * ns_weight)});
    }
    if (seg_end == e) break;
    seg = seg_end + 1;
  }
}

void run_threads(int64_t n, int n_threads,
                 const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 4;
  }
  if (n_threads > n) n_threads = static_cast<int>(n > 0 ? n : 1);
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Batch murmur3: n strings as a concatenated buffer + n+1 offsets.
void sml_murmur3_batch(const char* buf, const int64_t* offsets, int64_t n,
                       uint32_t seed, uint32_t* out, int n_threads) {
  run_threads(n, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      out[i] = murmur3_32(
          reinterpret_cast<const uint8_t*>(buf + offsets[i]),
          static_cast<size_t>(offsets[i + 1] - offsets[i]), seed);
    }
  });
}

// Pass 1: per-line feature counts (for exact output allocation).
void sml_vw_count(const char* buf, const int64_t* offsets, int64_t n_lines,
                  uint32_t seed, int64_t* out_counts, int n_threads) {
  run_threads(n_lines, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<Tok> scratch;
    std::string namebuf;
    std::vector<Emit> feats;
    float lab, imp;
    uint8_t has;
    for (int64_t i = lo; i < hi; i++) {
      feats.clear();
      parse_line(buf + offsets[i], buf + offsets[i + 1], seed, 0xFFFFFFFFu,
                 scratch, namebuf, feats, &lab, &imp, &has);
      out_counts[i] = static_cast<int64_t>(feats.size());
    }
  });
}

// Pass 2: parse + hash, writing each line's features at starts[i].
// out_idx already reduced modulo 2^num_bits via dim_mask.
void sml_vw_parse(const char* buf, const int64_t* offsets, int64_t n_lines,
                  uint32_t seed, int num_bits, const int64_t* starts,
                  int32_t* out_row, int32_t* out_idx, float* out_val,
                  float* out_label, float* out_weight, uint8_t* out_has_label,
                  int n_threads) {
  uint32_t dim_mask = (num_bits >= 32)
      ? 0xFFFFFFFFu : ((1u << num_bits) - 1u);
  run_threads(n_lines, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<Tok> scratch;
    std::string namebuf;
    std::vector<Emit> feats;
    for (int64_t i = lo; i < hi; i++) {
      feats.clear();
      float lab, imp;
      uint8_t has;
      parse_line(buf + offsets[i], buf + offsets[i + 1], seed, dim_mask,
                 scratch, namebuf, feats, &lab, &imp, &has);
      out_label[i] = has ? lab : 0.0f;
      out_weight[i] = has ? imp : 0.0f;  // unlabeled lines: predict-only
      out_has_label[i] = has;
      int64_t w = starts[i];
      for (const Emit& f : feats) {
        out_row[w] = static_cast<int32_t>(i);
        out_idx[w] = static_cast<int32_t>(f.idx);
        out_val[w] = f.val;
        w++;
      }
    }
  });
}

// COO → dense accumulate: out[row, idx] += val.  Rows arrive sorted (the
// parser writes in line order) so thread ranges split on row boundaries.
void sml_coo_densify(const int32_t* rows, const int32_t* idxs,
                     const float* vals, int64_t nnz, float* out,
                     int64_t dim, int n_threads) {
  run_threads(nnz, n_threads, [&](int64_t lo, int64_t hi) {
    // snap range starts forward to a row boundary to avoid write races
    while (lo > 0 && lo < nnz && rows[lo] == rows[lo - 1]) lo++;
    while (hi < nnz && rows[hi] == rows[hi - 1]) hi++;
    for (int64_t i = lo; i < hi; i++) {
      out[static_cast<int64_t>(rows[i]) * dim + idxs[i]] += vals[i];
    }
  });
}

}  // extern "C"
