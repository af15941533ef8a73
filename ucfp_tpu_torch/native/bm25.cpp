// Native BM25 engine: postings, corpus stats, and scoring in C++.
//
// The reference's BM25 is native (FST term dict + roaring postings in
// redb, scored in Rust — src/index/embedded/bm25.rs). This is the
// equivalent host engine: per-tenant corpora with interned terms and
// contiguous postings vectors, clear-then-reindex upserts, and BM25+
// scoring
//   idf = ln((N - n + 0.5) / (n + 0.5) + 1)
//   score += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
// with k1 = 1.2, b = 0.75 (bm25.rs:79-80,551). Accumulation runs in
// double in query-term order, matching the Python engine bit for bit so
// either backend produces identical rankings.
//
// Layout: terms are interned to dense uint32 ids once; each term's
// postings are a flat vector<pair<doc, tf>> (clear-then-reindex keeps
// them duplicate-free). Contiguous postings make the scoring loop a
// linear sweep instead of a node-chasing hash-map walk, and inserts are
// amortized push_backs instead of per-posting heap allocations.
//
// C ABI. Term blobs: [u32 n] then n x { u16 len, bytes, u32 tf }.
// ucfp_bm25_upsert_text additionally accepts raw ASCII text and runs
// tokenize (lowercase + split on non-alphanumeric, the Python
// tokenizer's exact semantics for ASCII input) in native code; callers
// must route non-ASCII text through the blob path, where Python owns
// the Unicode lowercase/isalnum semantics.
// Search results are written into caller-provided arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kK1 = 1.2;
constexpr double kB = 0.75;

using Postings = std::vector<std::pair<uint64_t, uint32_t>>;  // (doc, tf)

struct Corpus {
  std::unordered_map<std::string, uint32_t> term_ids;  // term -> dense id
  std::vector<Postings> postings;                      // by term id
  std::vector<std::string> id_terms;                   // id -> term (reclaim)
  std::vector<uint32_t> free_ids;                      // reusable term ids
  std::unordered_map<uint64_t, uint32_t> doc_lens;
  std::unordered_map<uint64_t, std::vector<uint32_t>> doc_terms;  // doc -> ids
  uint64_t total_doc_len = 0;
  uint64_t live_terms = 0;  // term ids with non-empty postings
};

uint32_t intern(Corpus* c, const char* ptr, size_t len) {
  std::string term(ptr, len);
  auto it = c->term_ids.find(term);
  if (it != c->term_ids.end()) return it->second;
  // reuse a reclaimed id when one is free: without reclamation the
  // term table grows with every distinct token EVER seen (vocabulary
  // churn — UUIDs, timestamps — would grow RSS without bound)
  uint32_t id;
  if (!c->free_ids.empty()) {
    id = c->free_ids.back();
    c->free_ids.pop_back();
    c->id_terms[id] = term;
  } else {
    id = (uint32_t)c->postings.size();
    c->postings.emplace_back();
    c->id_terms.push_back(term);
  }
  c->term_ids.emplace(std::move(term), id);
  return id;
}

// a term whose last posting vanished is dead: drop its intern entry and
// recycle the id (no doc references a term with empty postings)
void reclaim_term(Corpus* c, uint32_t tid) {
  c->term_ids.erase(c->id_terms[tid]);
  std::string().swap(c->id_terms[tid]);
  Postings().swap(c->postings[tid]);  // release capacity too
  c->free_ids.push_back(tid);
}

// -1 when the term was never seen.
long term_id(const Corpus* c, const char* ptr, size_t len) {
  auto it = c->term_ids.find(std::string(ptr, len));
  return it == c->term_ids.end() ? -1 : (long)it->second;
}

void add_posting(Corpus* c, uint32_t tid, uint64_t doc, uint32_t tf) {
  Postings& p = c->postings[tid];
  if (p.empty()) c->live_terms++;
  p.emplace_back(doc, tf);
}

struct TermRef {
  const char* ptr;
  uint16_t len;
  uint32_t tf;
};

// Parse a term blob; returns false on truncation.
bool parse_blob(const uint8_t* blob, uint32_t blob_len,
                std::vector<TermRef>* out) {
  if (blob_len < 4) return false;
  uint32_t n;
  std::memcpy(&n, blob, 4);
  uint32_t off = 4;
  // each entry needs >= 6 bytes, so a count beyond blob_len/6 is
  // malformed; clamping also keeps a hostile count from turning
  // reserve() into a multi-GB allocation before the loop rejects it
  out->reserve(std::min<uint32_t>(n, blob_len / 6 + 1));
  for (uint32_t i = 0; i < n; i++) {
    if (off + 2 > blob_len) return false;
    uint16_t len;
    std::memcpy(&len, blob + off, 2);
    off += 2;
    if (off + len + 4 > blob_len) return false;
    TermRef t{reinterpret_cast<const char*>(blob + off), len, 0};
    off += len;
    std::memcpy(&t.tf, blob + off, 4);
    off += 4;
    out->push_back(t);
  }
  return true;
}

}  // namespace

extern "C" {

void* ucfp_bm25_new() { return new Corpus(); }

void ucfp_bm25_free(void* h) { delete static_cast<Corpus*>(h); }

void ucfp_bm25_clear(void* h, uint64_t doc) {
  Corpus* c = static_cast<Corpus*>(h);
  auto it = c->doc_terms.find(doc);
  if (it == c->doc_terms.end()) return;
  for (uint32_t tid : it->second) {
    Postings& p = c->postings[tid];
    for (size_t i = 0; i < p.size(); i++) {
      if (p[i].first == doc) {
        p[i] = p.back();
        p.pop_back();
        break;  // clear-then-reindex keeps lists duplicate-free
      }
    }
    if (p.empty()) {
      c->live_terms--;
      reclaim_term(c, tid);
    }
  }
  c->total_doc_len -= c->doc_lens[doc];
  c->doc_lens.erase(doc);
  c->doc_terms.erase(it);
}

// terms blob: unique terms with tf counts; doc_len = total token count.
int ucfp_bm25_upsert(void* h, uint64_t doc, const uint8_t* blob,
                     uint32_t blob_len, uint32_t doc_len) {
  Corpus* c = static_cast<Corpus*>(h);
  ucfp_bm25_clear(h, doc);
  std::vector<TermRef> terms;
  if (!parse_blob(blob, blob_len, &terms)) return -1;
  if (terms.empty()) return 0;
  auto& dt = c->doc_terms[doc];
  dt.reserve(terms.size());
  for (const auto& t : terms) {
    uint32_t tid = intern(c, t.ptr, t.len);
    add_posting(c, tid, doc, t.tf);
    dt.push_back(tid);
  }
  c->doc_lens[doc] = doc_len;
  c->total_doc_len += doc_len;
  return 0;
}

// Tokenize ASCII text natively and upsert. Returns the token count, or
// -1 when the text contains a non-ASCII byte (caller must fall back to
// the Python tokenizer + blob path — Unicode semantics live there).
// Empty token stream degrades to a plain clear, like the Python engine.
long ucfp_bm25_upsert_text(void* h, uint64_t doc, const uint8_t* text,
                           uint32_t text_len) {
  for (uint32_t i = 0; i < text_len; i++) {
    if (text[i] >= 0x80) return -1;
  }
  Corpus* c = static_cast<Corpus*>(h);
  ucfp_bm25_clear(h, doc);

  // lowercase + split on non-alphanumeric; count via sort + run-length
  // over dense term ids (cheaper than a per-doc hash map).
  std::vector<uint32_t> ids;
  std::string tok;
  uint32_t n_tokens = 0;
  for (uint32_t i = 0; i <= text_len; i++) {
    char ch = i < text_len ? (char)text[i] : ' ';
    if (ch >= 'A' && ch <= 'Z') ch = (char)(ch - 'A' + 'a');
    const bool alnum =
        (ch >= 'a' && ch <= 'z') || (ch >= '0' && ch <= '9');
    if (alnum) {
      tok.push_back(ch);
    } else if (!tok.empty()) {
      if (tok.size() <= 65535) {  // same cap as the blob's u16 length
        ids.push_back(intern(c, tok.data(), tok.size()));
        n_tokens++;
      }
      tok.clear();
    }
  }
  if (ids.empty()) return 0;
  std::sort(ids.begin(), ids.end());
  auto& dt = c->doc_terms[doc];
  for (size_t i = 0; i < ids.size();) {
    size_t j = i;
    while (j < ids.size() && ids[j] == ids[i]) j++;
    add_posting(c, ids[i], doc, (uint32_t)(j - i));
    dt.push_back(ids[i]);
    i = j;
  }
  c->doc_lens[doc] = n_tokens;
  c->total_doc_len += n_tokens;
  return (long)n_tokens;
}

uint64_t ucfp_bm25_doc_count(void* h) {
  return static_cast<Corpus*>(h)->doc_lens.size();
}

uint64_t ucfp_bm25_total_doc_len(void* h) {
  return static_cast<Corpus*>(h)->total_doc_len;
}

uint64_t ucfp_bm25_term_count(void* h) {
  return static_cast<Corpus*>(h)->live_terms;
}

// df of one term (for SimHash-IDF corpus stats).
uint64_t ucfp_bm25_df(void* h, const char* term, uint16_t len) {
  Corpus* c = static_cast<Corpus*>(h);
  long tid = term_id(c, term, len);
  return tid < 0 ? 0 : c->postings[tid].size();
}

// tf of (term, doc) and the doc's length — for explain recomputation.
uint32_t ucfp_bm25_tf(void* h, const char* term, uint16_t len, uint64_t doc) {
  Corpus* c = static_cast<Corpus*>(h);
  long tid = term_id(c, term, len);
  if (tid < 0) return 0;
  for (const auto& [d, tf] : c->postings[tid]) {
    if (d == doc) return tf;
  }
  return 0;
}

uint32_t ucfp_bm25_doc_len(void* h, uint64_t doc) {
  Corpus* c = static_cast<Corpus*>(h);
  auto it = c->doc_lens.find(doc);
  return it == c->doc_lens.end() ? 0 : it->second;
}

// Score unique query terms (blob tf fields ignored) and write the top-k
// (doc, score) pairs, ranked by (-score, doc). Returns hit count (<= k),
// or -1 on a malformed blob.
long ucfp_bm25_search(void* h, const uint8_t* blob, uint32_t blob_len,
                      uint32_t k, uint64_t* out_docs, double* out_scores) {
  Corpus* c = static_cast<Corpus*>(h);
  if (c->doc_lens.empty() || k == 0) return 0;
  std::vector<TermRef> terms;
  if (!parse_blob(blob, blob_len, &terms)) return -1;
  const double n_docs = static_cast<double>(c->doc_lens.size());
  const double avgdl = static_cast<double>(c->total_doc_len) / n_docs;

  std::unordered_map<uint64_t, double> scores;
  for (const auto& t : terms) {
    long tid = term_id(c, t.ptr, t.len);
    if (tid < 0 || c->postings[tid].empty()) continue;
    const Postings& plist = c->postings[tid];
    const double n_t = static_cast<double>(plist.size());
    const double idf = std::log((n_docs - n_t + 0.5) / (n_t + 0.5) + 1.0);
    for (const auto& [doc, tf] : plist) {
      const double dl = static_cast<double>(c->doc_lens[doc]);
      const double denom = tf + kK1 * (1.0 - kB + kB * dl / avgdl);
      scores[doc] += idf * (tf * (kK1 + 1.0)) / denom;
    }
  }
  std::vector<std::pair<uint64_t, double>> ranked(scores.begin(), scores.end());
  const size_t kk = std::min<size_t>(k, ranked.size());
  std::partial_sort(
      ranked.begin(), ranked.begin() + kk, ranked.end(),
      [](const auto& a, const auto& b) {
        if (a.second != b.second) return a.second > b.second;
        return a.first < b.first;
      });
  for (size_t i = 0; i < kk; i++) {
    out_docs[i] = ranked[i].first;
    out_scores[i] = ranked[i].second;
  }
  return static_cast<long>(kk);
}

}  // extern "C"
