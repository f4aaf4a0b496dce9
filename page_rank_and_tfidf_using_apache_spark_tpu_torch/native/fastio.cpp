// Native host-side ingest kernels, bound via ctypes (utils/native.py).
//
// Reference counterpart: the JVM/native machinery Spark puts under its ingest
// path (SURVEY.md §2 native-code note).  The rebuild's device-side native
// layer is XLA; this file is the host-side native layer covering the two
// ingest loops SURVEY.md §7 flags as Python bottlenecks at scale:
//
//   1. SNAP edge-list parse (soc-LiveJournal1: 69M edges of text) — the
//      reference's `sc.textFile(edges).map(parse)` (SURVEY.md A2).
//   2. Tokenize + FNV-1a-hash (Wikipedia-scale streaming TF-IDF ingest) —
//      the reference's `flatMap(tokenize)` (SURVEY.md A7).
//
// Both must produce BIT-IDENTICAL output to the numpy fallbacks in
// io/graph.py and io/text.py; tests/test_native.py pins them equal.  Any
// input the numpy path would reject (non-integer edge tokens, odd token
// count) makes these return -1 so the caller falls back and surfaces the
// same Python-side error.
//
// Tokenizer semantics (must track io/text.py tokenize()): split on
// non-[A-Za-z0-9] bytes, optional ASCII lowercasing, drop tokens shorter
// than min_token_len.  Multi-byte UTF-8 sequences are all >= 0x80 so they
// act as separators in both implementations — with exactly two exceptions
// when lowercasing: the only Unicode codepoints whose Python str.lower()
// maps into ASCII are U+212A KELVIN SIGN (-> 'k', token continues) and
// U+0130 LATIN CAPITAL I WITH DOT (-> 'i' + combining U+0307, which ends
// the token after the 'i').  Both are handled below so Turkish/scientific
// text tokenizes identically on the fast path and the numpy fallback.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SNAP edge-list parsing
// ---------------------------------------------------------------------------

namespace {

inline bool is_ws(uint8_t c) {
  // Python str.split()/lstrip() whitespace, restricted to ASCII.
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

inline bool is_line_ws(uint8_t c) { return c == ' ' || c == '\t' || c == '\v' || c == '\f'; }

// Parse integer tokens from SNAP text.  When src/dst are non-null, fill
// them; always return the number of (src, dst) pairs, or -1 on any token
// the numpy path would reject (non-integer token, odd token count).
int64_t parse_edges_impl(const uint8_t* buf, int64_t n, int64_t* src,
                         int64_t* dst) {
  int64_t count = 0;  // integer tokens seen
  int64_t i = 0;
  while (i < n) {
    // Start of a line: skip leading blanks, then check for '#' comment.
    int64_t j = i;
    while (j < n && is_line_ws(buf[j])) j++;
    if (j < n && buf[j] == '#') {
      while (j < n && buf[j] != '\n') j++;
      i = j + 1;
      continue;
    }
    // Parse tokens until end of line.
    while (j < n && buf[j] != '\n') {
      if (is_ws(buf[j])) {
        j++;
        continue;
      }
      bool neg = false;
      if (buf[j] == '-') {
        neg = true;
        j++;
      }
      if (j >= n || buf[j] < '0' || buf[j] > '9') return -1;
      int64_t v = 0;
      while (j < n && buf[j] >= '0' && buf[j] <= '9') {
        int digit = buf[j] - '0';
        // int64 overflow: numpy's parse raises here, so bail to the
        // fallback instead of wrapping silently.
        if (v > (INT64_MAX - digit) / 10) return -1;
        v = v * 10 + digit;
        j++;
      }
      if (j < n && !is_ws(buf[j])) return -1;  // e.g. "12abc"
      if (neg) v = -v;
      if (src != nullptr) {
        if (count % 2 == 0) {
          src[count / 2] = v;
        } else {
          dst[count / 2] = v;
        }
      }
      count++;
    }
    i = j + 1;
  }
  if (count % 2 != 0) return -1;
  return count / 2;
}

}  // namespace

int64_t parse_edges_count(const uint8_t* buf, int64_t n) {
  return parse_edges_impl(buf, n, nullptr, nullptr);
}

int64_t parse_edges_fill(const uint8_t* buf, int64_t n, int64_t* src,
                         int64_t* dst) {
  return parse_edges_impl(buf, n, src, dst);
}

// ---------------------------------------------------------------------------
// Tokenize + FNV-1a hash
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

inline bool is_alnum(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9');
}

inline uint8_t to_lower(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? c + ('a' - 'A') : c;
}

inline uint64_t fnv1a(const uint8_t* p, int64_t len, uint64_t h = kFnvOffset) {
  for (int64_t i = 0; i < len; i++) h = (h ^ p[i]) * kFnvPrime;
  return h;
}

struct TokenSpan {
  int64_t start;  // into the per-doc lowered scratch buffer
  int64_t len;
};

// Unicode whose Python str.lower() introduces ASCII (see header comment).
// Returns the lowered ASCII byte and consumed length, or 0 if p[i] does not
// start such a sequence.  `ends_token` is set for U+0130, whose lowercase
// trailing combining mark (U+0307) terminates the token in the regex path.
inline uint8_t special_lower(const uint8_t* p, int64_t len, int64_t i,
                             int64_t* consumed, bool* ends_token) {
  if (p[i] == 0xC4 && i + 1 < len && p[i + 1] == 0xB0) {  // U+0130
    *consumed = 2;
    *ends_token = true;
    return 'i';
  }
  if (p[i] == 0xE2 && i + 2 < len && p[i + 1] == 0x84 &&
      p[i + 2] == 0xAA) {  // U+212A KELVIN SIGN
    *consumed = 3;
    *ends_token = false;
    return 'k';
  }
  return 0;
}

// Tokenize one document (bytes [p, p+len)) into `scratch` + `spans`.
void tokenize_doc(const uint8_t* p, int64_t len, bool lowercase,
                  int64_t min_token_len, std::string* scratch,
                  std::vector<TokenSpan>* spans) {
  scratch->clear();
  spans->clear();
  int64_t i = 0;
  int64_t tok_start = -1;  // offset into scratch, -1 = not inside a token
  auto end_token = [&]() {
    if (tok_start >= 0) {
      int64_t tlen = static_cast<int64_t>(scratch->size()) - tok_start;
      if (tlen >= min_token_len) {
        spans->push_back(TokenSpan{tok_start, tlen});
      } else {
        scratch->resize(tok_start);
      }
      tok_start = -1;
    }
  };
  while (i < len) {
    int64_t consumed;
    bool ends_token;
    uint8_t lowered;
    if (is_alnum(p[i])) {
      if (tok_start < 0) tok_start = static_cast<int64_t>(scratch->size());
      scratch->push_back(
          static_cast<char>(lowercase ? to_lower(p[i]) : p[i]));
      i++;
    } else if (lowercase &&
               (lowered = special_lower(p, len, i, &consumed, &ends_token))) {
      if (tok_start < 0) tok_start = static_cast<int64_t>(scratch->size());
      scratch->push_back(static_cast<char>(lowered));
      if (ends_token) end_token();
      i += consumed;
    } else {
      end_token();
      i++;
    }
  }
  end_token();
}

// Number of emitted terms for m unigrams with n-grams up to `ngram`
// (matches io/text.py add_ngrams: unigrams, then 2-grams, ... n-grams).
inline int64_t term_count(int64_t m, int64_t ngram) {
  int64_t total = m;
  for (int64_t k = 2; k <= ngram; k++) {
    if (m - k + 1 > 0) total += m - k + 1;
  }
  return total;
}

}  // namespace

// Count total emitted terms across all docs.  `blob` is the concatenation
// of the docs' UTF-8 bytes; `doc_lens[d]` is doc d's byte length.
int64_t tokenize_hash_count(const uint8_t* blob, int64_t blob_len,
                            const int64_t* doc_lens, int64_t n_docs,
                            int64_t ngram, int64_t lowercase,
                            int64_t min_token_len) {
  (void)blob_len;
  std::string scratch;
  std::vector<TokenSpan> spans;
  int64_t total = 0;
  int64_t off = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    tokenize_doc(blob + off, doc_lens[d], lowercase != 0, min_token_len,
                 &scratch, &spans);
    total += term_count(static_cast<int64_t>(spans.size()), ngram);
    off += doc_lens[d];
  }
  return total;
}

// Fill doc_ids/term_ids (int32 [total]) and doc_lengths (int32 [n_docs]).
// Emission order per doc matches add_ngrams: all unigrams in text order,
// then all 2-grams, then 3-grams, ...  n-gram hashes cover the bytes of
// the space-joined lowered tokens, identically to hashing the joined
// Python string.  Returns total terms written, or -1 on overflow vs the
// caller-allocated capacity implied by tokenize_hash_count.
int64_t tokenize_hash_fill(const uint8_t* blob, int64_t blob_len,
                           const int64_t* doc_lens, int64_t n_docs,
                           int64_t ngram, int64_t lowercase,
                           int64_t min_token_len, int64_t vocab_bits,
                           int32_t* doc_ids, int32_t* term_ids,
                           int32_t* doc_lengths) {
  (void)blob_len;
  const uint64_t mask = (vocab_bits >= 64)
                            ? ~0ULL
                            : ((1ULL << vocab_bits) - 1ULL);
  std::string scratch;
  std::vector<TokenSpan> spans;
  int64_t out = 0;
  int64_t off = 0;
  for (int64_t d = 0; d < n_docs; d++) {
    tokenize_doc(blob + off, doc_lens[d], lowercase != 0, min_token_len,
                 &scratch, &spans);
    const uint8_t* sp = reinterpret_cast<const uint8_t*>(scratch.data());
    const int64_t m = static_cast<int64_t>(spans.size());
    doc_lengths[d] = static_cast<int32_t>(term_count(m, ngram));
    // Unigrams.
    for (int64_t t = 0; t < m; t++) {
      uint64_t h = fnv1a(sp + spans[t].start, spans[t].len);
      doc_ids[out] = static_cast<int32_t>(d);
      term_ids[out] = static_cast<int32_t>(h & mask);
      out++;
    }
    // k-grams, k = 2..ngram: hash tok[i] ' ' tok[i+1] ' ' ... tok[i+k-1].
    for (int64_t k = 2; k <= ngram; k++) {
      for (int64_t t = 0; t + k <= m; t++) {
        uint64_t h = kFnvOffset;
        for (int64_t g = 0; g < k; g++) {
          if (g > 0) h = (h ^ static_cast<uint8_t>(' ')) * kFnvPrime;
          h = fnv1a(sp + spans[t + g].start, spans[t + g].len, h);
        }
        doc_ids[out] = static_cast<int32_t>(d);
        term_ids[out] = static_cast<int32_t>(h & mask);
        out++;
      }
    }
    off += doc_lens[d];
  }
  return out;
}

// ---------------------------------------------------------------------------
// Graph build: (dst, src) radix sort + dedup
// ---------------------------------------------------------------------------

// The graph-builder's hot step (io/graph.py from_edges): order compacted
// edges by (dst major, src minor) and drop duplicates — the reference's
// `distinct()` + the dst-sorted layout every SpMV impl relies on.  numpy's
// lexsort is a comparison sort; at soc-LiveJournal1 scale (69M edges,
// SURVEY.md §6 config 3) an LSD radix sort over the packed (dst<<32)|src
// key is several times faster.  Requires compacted ids < 2^31 (guaranteed
// by from_edges before calling).  Sorts in place; returns the deduped edge
// count, or -1 on invalid input (id out of range).
int64_t sort_dedup_edges(int64_t* src, int64_t* dst, int64_t e, int64_t dedup) {
  if (e <= 0) return e < 0 ? -1 : 0;
  constexpr int64_t kMaxId = (int64_t{1} << 31) - 1;
  std::vector<uint64_t> keys(static_cast<size_t>(e));
  for (int64_t i = 0; i < e; i++) {
    if (src[i] < 0 || src[i] > kMaxId || dst[i] < 0 || dst[i] > kMaxId) return -1;
    keys[static_cast<size_t>(i)] =
        (static_cast<uint64_t>(dst[i]) << 32) | static_cast<uint64_t>(src[i]);
  }
  // LSD radix, 16-bit digits, 4 passes.
  std::vector<uint64_t> tmp(static_cast<size_t>(e));
  std::vector<int64_t> counts(1 << 16);
  uint64_t* cur = keys.data();
  uint64_t* alt = tmp.data();
  for (int pass = 0; pass < 4; pass++) {
    const int shift = pass * 16;
    std::memset(counts.data(), 0, counts.size() * sizeof(int64_t));
    for (int64_t i = 0; i < e; i++) counts[(cur[i] >> shift) & 0xFFFF]++;
    if (counts[0] == e) continue;  // digit constant (common for high bits)
    int64_t total = 0;
    for (int64_t& c : counts) {
      int64_t was = c;
      c = total;
      total += was;
    }
    for (int64_t i = 0; i < e; i++) alt[counts[(cur[i] >> shift) & 0xFFFF]++] = cur[i];
    std::swap(cur, alt);
  }
  int64_t out = 0;
  for (int64_t i = 0; i < e; i++) {
    if (dedup && out > 0 && cur[i] == cur[out - 1]) continue;
    cur[out++] = cur[i];
  }
  for (int64_t i = 0; i < out; i++) {
    dst[i] = static_cast<int64_t>(cur[i] >> 32);
    src[i] = static_cast<int64_t>(cur[i] & 0xFFFFFFFFu);
  }
  return out;
}

}  // extern "C"
