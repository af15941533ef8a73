// Native text-signature hot path: ASCII UAX#29 word tokenizer,
// k-shingle XXH3 hashing, and the MinHash mix+min reduction.
//
// Why: the reference's own headline bench fingerprints a 5.6 KiB text
// doc per iteration (the upstream benches/end_to_end.rs:24-42) and
// its REPORT claims sub-millisecond text fingerprints (REPORT.md:41).
// The Python pipeline measured 5.3 ms/doc on that workload: the regex
// engine's UAX#29 split (1.8 ms), the per-char strip loop (0.8 ms) and
// the numpy [S,128] mix+min with its multi-MB temporaries (2.1 ms).
// This module replaces the tokenize->shingle->hash->minhash chain with
// one streaming pass for ASCII inputs (the overwhelming common case);
// non-ASCII documents keep the full Unicode path in modality/text.py.
//
// EXACTNESS CONTRACT: the token stream must be byte-identical to
// modality.text.tokenize_words (the `regex` module's (?w)\b
// word segmentation), and signatures byte-identical to
// ops/textsig.minhash_signature. tests/test_torch_text.py holds
// both equalities; tests/goldens pin the wire bytes.
//
// UAX#29 word-boundary rules restricted to ASCII (no Extend/Format/ZWJ
// /Hebrew/Katakana/RI below U+0080), as implemented by the `regex`
// engine (probed + fuzz-pinned):
//   classes  ALetter  a-z A-Z
//            Numeric  0-9
//            ExtendNumLet  _
//            MidLetter     :          (joins letter . letter)
//            MidNumLet     .          (letters and digits)
//            Single_Quote  '          (letters via WB6/7, digits via
//                                      WB11/12, and WB5a below)
//            MidNum        , ;        (joins digit . digit)
//   WB5/8/9/10/13a/13b: [a-z0-9_] runs never break internally.
//   WB6/7:   letter  [:.']  letter   -> no break (one mid char only).
//   WB11/12: digit   [,;.'] digit    -> no break.
//   WB5a (the standard's French-elision customization, which the
//   `regex` engine applies): apostrophe binds FORWARD onto a vowel —
//   ' x vowel starts/extends a token ("l'objectif", "'a" -> ["'a"],
//   "'z" -> ["z"]; vowels are exactly aeiouAEIOU, probed).
// A token is a maximal such span containing at least one word char
// (the \w filter in tokenize_words); every token contains one by
// construction except a WB5a quote, which is always followed by one.
//
// XXH3 comes from the xxHash 0.8.3 header beside this file (xxhash.h,
// BSD-2-Clause), inlined; equality with the Python `xxhash` module is
// asserted in tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>

#define XXH_INLINE_ALL
#include "xxhash.h"

namespace {

inline bool is_letter(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }
inline bool is_word(uint8_t c) {
  return is_letter(c) || is_digit(c) || c == '_';
}
inline bool is_vowel(uint8_t c) {
  switch (c) {
    case 'a': case 'e': case 'i': case 'o': case 'u':
    case 'A': case 'E': case 'I': case 'O': case 'U':
      return true;
    default:
      return false;
  }
}
inline bool mid_letter_join(uint8_t c) {
  return c == ':' || c == '.' || c == '\'';
}
inline bool mid_num_join(uint8_t c) {
  return c == ',' || c == ';' || c == '.' || c == '\'';
}

// Scan one token starting at text[i] (caller guarantees is_word(text[i])
// or a WB5a apostrophe-vowel). Returns the end offset (exclusive).
inline int64_t scan_token(const uint8_t* text, int64_t len, int64_t i) {
  if (text[i] == '\'') ++i;  // WB5a: leading quote, vowel follows
  while (i < len) {
    uint8_t c = text[i];
    if (is_word(c)) {
      ++i;
      continue;
    }
    // candidate mid join: one mid char with matching classes both sides
    if (i + 1 < len) {
      uint8_t prev = text[i - 1], next = text[i + 1];
      if (is_letter(prev) && is_letter(next) && mid_letter_join(c)) {
        i += 2;
        continue;
      }
      if (is_digit(prev) && is_digit(next) && mid_num_join(c)) {
        i += 2;
        continue;
      }
    }
    break;
  }
  return i;
}

// Stafford mix13 (the splitmix64 output mix) — must match
// ops/textsig._mix64_arr bit for bit.
inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Tokenize ASCII text into [start, end) span pairs. Returns the token
// count, -1 if a non-ASCII byte is found (caller must fall back to the
// Unicode path), or -2 if cap (in spans, i.e. pairs) is exceeded.
int64_t ucfp_text_tokens(const uint8_t* text, int64_t len,
                         int64_t* spans, int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < len;) {
    uint8_t c = text[i];
    if (c >= 0x80) return -1;
    bool starts = is_word(c) ||
                  (c == '\'' && i + 1 < len && is_vowel(text[i + 1]));
    if (!starts) {
      ++i;
      continue;
    }
    int64_t end = scan_token(text, len, i);
    // the span may still hold non-ASCII further in? no: scan_token only
    // consumes ASCII word/mid chars, so verify nothing — but bytes
    // AFTER the token are checked by the outer loop as i advances.
    if (n >= cap) return -2;
    spans[2 * n] = i;
    spans[2 * n + 1] = end;
    ++n;
    i = end;
  }
  return n;
}

// out[j] = min over s of mix64(base[s] ^ keys[j]). out must be
// pre-sized to h; it is fully overwritten. Exactly the numpy
// _mix64_arr(base[:,None]^keys[None,:]).min(axis=0) reduction, single
// pass, no temporaries.
void ucfp_minhash_mix_min(const uint64_t* base, int64_t s,
                          const uint64_t* keys, int32_t h, uint64_t* out) {
  for (int32_t j = 0; j < h; ++j) out[j] = UINT64_MAX;
  for (int64_t i = 0; i < s; ++i) {
    uint64_t b = base[i];
    for (int32_t j = 0; j < h; ++j) {
      uint64_t v = mix64(b ^ keys[j]);
      if (v < out[j]) out[j] = v;
    }
  }
}

// Fused hot path: tokenize (ASCII UAX#29) -> k-shingle (tokens joined
// by single spaces; fewer than k tokens yields ONE shingle of all
// tokens, matching modality/text.shingles_of) -> XXH3-64 per shingle
// -> streaming MinHash mix+min into out_sig[h].
// Returns the shingle count (0 = no tokens; caller raises the same
// "no tokens" error as the Python path), or -1 on a non-ASCII byte
// (caller falls back; out_sig contents are then unspecified).
int64_t ucfp_text_minhash_sig(const uint8_t* text, int64_t len, int32_t k,
                              const uint64_t* keys, int32_t h,
                              uint64_t* out_sig) {
  for (int32_t j = 0; j < h; ++j) out_sig[j] = UINT64_MAX;

  // token spans, inline ring of the last k (shingles need a window)
  // — but "fewer than k tokens -> one shingle of all" needs the FULL
  // token list when short, so collect spans first (<= len/1 pairs;
  // tokens are non-overlapping so <= (len+1)/2 of them).
  // A 5.6 KiB doc has ~1.1 k tokens: a small stack-ish buffer suffices,
  // heap-allocate defensively for big docs.
  std::string scratch;
  scratch.reserve(256);
  // tokens are non-overlapping and at least one char wide with at
  // least one separator between them, so (len+1)/2 bounds the count
  const int64_t max_tokens = len / 2 + 1;
  int64_t* spans = new int64_t[2 * (size_t)max_tokens];
  int64_t t = ucfp_text_tokens(text, len, spans, max_tokens);
  if (t < 0) {
    delete[] spans;
    return -1;  // non-ASCII (cap can't hit: max_tokens >= any count)
  }
  if (t == 0) {
    delete[] spans;
    return 0;
  }

  const int64_t nsh = t < k ? 1 : t - k + 1;
  const int64_t width = t < k ? t : k;
  for (int64_t s0 = 0; s0 < nsh; ++s0) {
    scratch.clear();
    for (int64_t j = 0; j < width; ++j) {
      if (j) scratch.push_back(' ');
      const int64_t a = spans[2 * (s0 + j)], b = spans[2 * (s0 + j) + 1];
      scratch.append(reinterpret_cast<const char*>(text) + a, (size_t)(b - a));
    }
    const uint64_t base = XXH3_64bits(scratch.data(), scratch.size());
    for (int32_t j = 0; j < h; ++j) {
      const uint64_t v = mix64(base ^ keys[j]);
      if (v < out_sig[j]) out_sig[j] = v;
    }
  }
  delete[] spans;
  return nsh;
}

// TF-weighted 64-bit SimHash over the ASCII tokenizer's token stream.
// Byte-identical to ops/textsig.simhash64(terms, tf-weights): summing
// +/-tf per UNIQUE term equals summing +/-1 per OCCURRENCE, and the
// Python float accumulation is exact for integral weights, so int64
// accumulators match it bit for bit. Returns 1 ok (*out set), 0 no
// tokens, -1 non-ASCII byte (caller falls back).
int ucfp_text_simhash64_tf(const uint8_t* text, int64_t len, uint64_t* out) {
  int64_t acc[64] = {0};
  bool any = false;
  for (int64_t i = 0; i < len;) {
    uint8_t c = text[i];
    if (c >= 0x80) return -1;
    bool starts = is_word(c) ||
                  (c == '\'' && i + 1 < len && is_vowel(text[i + 1]));
    if (!starts) {
      ++i;
      continue;
    }
    const int64_t end = scan_token(text, len, i);
    const uint64_t h = XXH3_64bits(text + i, (size_t)(end - i));
    for (int b = 0; b < 64; ++b) acc[b] += ((h >> b) & 1) ? 1 : -1;
    any = true;
    i = end;
  }
  if (!any) return 0;
  uint64_t sig = 0;
  for (int b = 0; b < 64; ++b)
    if (acc[b] > 0) sig |= (uint64_t)1 << b;
  *out = sig;
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TLSH 128/1 (Oliver et al. 2013, published algorithm): the Python
// implementation in ops/textsig.py is the semantic source of truth —
// this is a byte-identical port (fuzz-pinned) of its per-byte loop,
// which costs ~6.5 ms/doc in CPython. The Pearson permutation table is
// passed in from Python so the published constant lives in ONE place.
// ---------------------------------------------------------------------------

namespace {

inline uint8_t b_mapping(const uint8_t* p, uint8_t salt, uint8_t i,
                         uint8_t j, uint8_t k) {
  uint8_t t = p[salt];
  t = p[t ^ i];
  t = p[t ^ j];
  return p[t ^ k];
}

// Logarithmic length bucket (TLSH l_capturing). Double math mirrors
// Python's math.log / float division exactly (same libm, no FMA:
// builds use -ffp-contract=off).
inline int l_capturing(int64_t length) {
  if (length <= 0) return 0;
  double x;
  if (length <= 656) {
    x = std::log((double)length) / std::log(1.5);
  } else if (length <= 3199) {
    x = std::log((double)length) / std::log(1.3) - 8.72777;
  } else {
    x = std::log((double)length) / std::log(1.1) - 62.5472;
  }
  int v = (int)x;  // trunc, like Python int()
  if (v < 0) v = 0;
  if (v > 255) v = 255;
  return v;
}

inline uint8_t swap_nibbles(uint8_t b) {
  return (uint8_t)(((b & 0x0F) << 4) | ((b & 0xF0) >> 4));
}

}  // namespace

extern "C" {

// TLSH 128-bucket / 1-byte-checksum digest. Writes 70 lowercase hex
// chars (NOT NUL-terminated) to out. Returns 0 ok, -1 input shorter
// than min_len, -2 insufficient variation (q3 == 0).
int ucfp_tlsh_128_1(const uint8_t* data, int64_t n, int64_t min_len,
                    const uint8_t* pearson, char* out) {
  if (n < min_len) return -1;
  uint32_t buckets[256];
  std::memset(buckets, 0, sizeof(buckets));
  uint8_t checksum = 0;
  for (int64_t i = 4; i < n; ++i) {
    const uint8_t b0 = data[i], b1 = data[i - 1], b2 = data[i - 2],
                  b3 = data[i - 3], b4 = data[i - 4];
    checksum = b_mapping(pearson, 0, b0, b1, checksum);
    ++buckets[b_mapping(pearson, 2, b0, b1, b2)];
    ++buckets[b_mapping(pearson, 3, b0, b1, b3)];
    ++buckets[b_mapping(pearson, 5, b0, b2, b3)];
    ++buckets[b_mapping(pearson, 7, b0, b2, b4)];
    ++buckets[b_mapping(pearson, 11, b0, b1, b4)];
    ++buckets[b_mapping(pearson, 13, b0, b3, b4)];
  }
  // quartiles over the first 128 buckets
  uint32_t sorted_b[128];
  std::memcpy(sorted_b, buckets, sizeof(sorted_b));
  std::sort(sorted_b, sorted_b + 128);
  const uint32_t q1 = sorted_b[31], q2 = sorted_b[63], q3 = sorted_b[95];
  if (q3 == 0) return -2;
  const int lvalue = l_capturing(n);
  const uint32_t q1ratio = (uint32_t)(((uint64_t)q1 * 100 / q3) % 16);
  const uint32_t q2ratio = (uint32_t)(((uint64_t)q2 * 100 / q3) % 16);
  uint8_t digest[35];
  digest[0] = swap_nibbles(checksum);
  digest[1] = swap_nibbles((uint8_t)lvalue);
  digest[2] = swap_nibbles((uint8_t)((q1ratio << 4) | q2ratio));
  for (int i = 0; i < 32; ++i) {
    uint8_t sextet = 0;
    for (int j = 0; j < 4; ++j) {
      const uint32_t k = buckets[(31 - i) * 4 + j];
      uint8_t code;
      if (k <= q1) code = 0;
      else if (k <= q2) code = 1;
      else if (k <= q3) code = 2;
      else code = 3;
      sextet |= (uint8_t)(code << (j * 2));
    }
    digest[3 + i] = sextet;
  }
  static const char* hexd = "0123456789abcdef";
  for (int i = 0; i < 35; ++i) {
    out[2 * i] = hexd[digest[i] >> 4];
    out[2 * i + 1] = hexd[digest[i] & 0x0F];
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full-Unicode UAX#29 word segmentation (UTF-8 input).
//
// The ASCII scanner above covers pure-ASCII documents; this section
// extends the native path to EVERY input, replacing the `regex`
// engine's (?w)\b split (~1.8 ms on a 5.6 KiB doc) for the non-ASCII
// pipeline. The per-codepoint Word_Break classes, Extended_Pictographic
// and \w flags, and the engine's apostrophe vowel-bind set come from
// wb_table.h, GENERATED from the regex engine itself
// (scripts/gen_wb_table.py) so the two paths share one property source.
//
// Rule machine (probed against regex 2026.7.19; every rule below is
// pinned by the differential fuzz in tests/test_torch_text.py):
//   WB3   CR x LF                      (raw adjacency)
//   WB3a  (Newline|CR|LF) ÷
//   WB3b  ÷ (Newline|CR|LF)
//   WB3c  ZWJ x ExtPict                (raw adjacency)
//   WB3d  WSegSpace x WSegSpace        (raw adjacency)
//   WB4   X (Extend|Format|ZWJ)* -> X  (base-skipping below)
//   WB5-13b per UAX#29 over base classes with lookahead WB6/7b/12
//   WB15/16 as the engine implements them: a base char that is a
//         Regional_Indicator whose RAW consecutive-RI run has ODD
//         length suppresses the break to ANY next char (newlines
//         excepted via WB3a/3b) — probed: "🇫a" holds, "🇫🇷a" breaks,
//         an Extend between RIs restarts the raw run count.
//   WB5a-style elision tailoring: a base char U+0027/U+2019 binds onto
//         exactly the 41 vowel-bind codepoints ("'a" holds, "'z"
//         breaks; the set is probed into the table, not assumed).
// A token is a maximal no-break span containing >= 1 \w char.
// ---------------------------------------------------------------------------

#include "wb_table.h"

namespace {

constexpr uint8_t kNoBase = 0xFF;

inline bool u8_is_ahl(uint8_t c) {
  return c == wbtab::kALetter || c == wbtab::kHebrewLetter;
}
inline bool u8_is_mid_letterish(uint8_t c) {
  return c == wbtab::kMidLetter || c == wbtab::kMidNumLet ||
         c == wbtab::kSingleQuote;
}
inline bool u8_is_mid_numish(uint8_t c) {
  return c == wbtab::kMidNum || c == wbtab::kMidNumLet ||
         c == wbtab::kSingleQuote;
}
inline bool u8_is_efz(uint8_t c) {
  return c == wbtab::kExtend || c == wbtab::kFormat || c == wbtab::kZWJ;
}
inline bool u8_is_newline(uint8_t c) {
  return c == wbtab::kCR || c == wbtab::kLF || c == wbtab::kNewline;
}

// Decode one codepoint at t[i]; advances i. Returns 0xFFFFFFFF on a
// malformed sequence (callers bail out to the Python fallback — input
// normally arrives from Python str.encode('utf-8') and is valid).
inline uint32_t u8_next(const uint8_t* t, int64_t len, int64_t& i) {
  const uint8_t b0 = t[i];
  if (b0 < 0x80) {
    ++i;
    return b0;
  }
  int n;
  uint32_t cp;
  if ((b0 & 0xE0) == 0xC0) {
    n = 1;
    cp = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    n = 2;
    cp = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    n = 3;
    cp = b0 & 0x07;
  } else {
    return 0xFFFFFFFFu;
  }
  if (i + n >= len) return 0xFFFFFFFFu;  // missing continuation bytes
  for (int j = 1; j <= n; ++j) {
    const uint8_t b = t[i + j];
    if ((b & 0xC0) != 0x80) return 0xFFFFFFFFu;
    cp = (cp << 6) | (b & 0x3F);
  }
  // reject overlong encodings, surrogates, and out-of-range values —
  // CPython's str.encode never emits them, but the sanitizer harness
  // feeds raw garbage and the refusal contract (-1 -> regex fallback)
  // must hold for any byte stream
  if (n == 1 && cp < 0x80) return 0xFFFFFFFFu;
  if (n == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
    return 0xFFFFFFFFu;
  if (n == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return 0xFFFFFFFFu;
  i += n + 1;
  return cp;
}

// Class of the codepoint immediately after byte offset j — the
// engine's WB6/7b/12 lookahead is RAW (a Format/Extend char between
// the mid and the following letter DEFEATS the rule: probed,
// "ë’‌X" breaks at ë÷’ where spec-style skipping would hold).
// kNoBase at end of text / malformed tail.
inline uint8_t u8_lookahead_raw(const uint8_t* t, int64_t len, int64_t j) {
  if (j >= len) return kNoBase;
  const uint32_t cp = u8_next(t, len, j);
  if (cp == 0xFFFFFFFFu) return kNoBase;
  return wbtab::lookup(cp) & wbtab::kClassMask;
}

struct U8SegState {
  // raw previous codepoint
  uint32_t prev_cp = 0;
  uint8_t prev_cls = kNoBase;
  // WB4 base chain: last non-EFZ codepoint, plus the RAW class of the
  // char immediately before it (the engine's WB7/7c/11 left element is
  // raw-adjacent to the mid, NOT base-skipped: probed, "bf‌:Z"
  // breaks at :÷Z while "n't" holds)
  uint32_t base_cp = 0;
  uint8_t base_cls = kNoBase;
  uint8_t pre_base_raw_cls = kNoBase;
  // raw consecutive-RI run length ending at the base char
  int base_ri_run = 0;
  // raw RI run ending at the previous raw char (feeds base_ri_run)
  int raw_ri_run = 0;
};

// Decide the boundary BEFORE the codepoint `cp` (byte offset `after`
// pointing just past cp). st describes everything to the left.
inline bool u8_is_break(const U8SegState& st, uint32_t cp, uint8_t props,
                        const uint8_t* t, int64_t len, int64_t after) {
  const uint8_t nc = props & wbtab::kClassMask;
  const uint8_t pc = st.prev_cls;  // caller never asks at sot
  // WB3
  if (pc == wbtab::kCR && nc == wbtab::kLF) return false;
  // WB3a / WB3b
  if (u8_is_newline(pc)) return true;
  if (u8_is_newline(nc)) return true;
  // WB3c (raw)
  if (pc == wbtab::kZWJ && (props & wbtab::kExtPict)) return false;
  // WB3d (raw)
  if (pc == wbtab::kWSegSpace && nc == wbtab::kWSegSpace) return false;
  // WB4
  if (u8_is_efz(nc)) return false;
  const uint8_t bc = st.base_cls;
  // sot-leading Extend/Format/ZWJ attach to the first non-EFZ char
  // whatever it is (probed: "‌c" and "̈!" are single segments)
  if (bc == kNoBase) return false;
  const uint8_t pb = st.pre_base_raw_cls;
  // WB5
  if (u8_is_ahl(bc) && u8_is_ahl(nc)) return false;
  // WB6 (raw lookahead)
  if (u8_is_ahl(bc) && u8_is_mid_letterish(nc) &&
      u8_is_ahl(u8_lookahead_raw(t, len, after)))
    return false;
  // WB7 (raw left element)
  if (pb != kNoBase && u8_is_ahl(pb) && u8_is_mid_letterish(bc) &&
      u8_is_ahl(nc))
    return false;
  // WB7a
  if (bc == wbtab::kHebrewLetter && nc == wbtab::kSingleQuote) return false;
  // WB7b (raw lookahead)
  if (bc == wbtab::kHebrewLetter && nc == wbtab::kDoubleQuote &&
      u8_lookahead_raw(t, len, after) == wbtab::kHebrewLetter)
    return false;
  // WB7c (raw left element)
  if (pb == wbtab::kHebrewLetter && bc == wbtab::kDoubleQuote &&
      nc == wbtab::kHebrewLetter)
    return false;
  // WB8/9/10
  if (bc == wbtab::kNumeric && nc == wbtab::kNumeric) return false;
  if (u8_is_ahl(bc) && nc == wbtab::kNumeric) return false;
  if (bc == wbtab::kNumeric && u8_is_ahl(nc)) return false;
  // WB11 (raw left element)
  if (pb == wbtab::kNumeric && u8_is_mid_numish(bc) && nc == wbtab::kNumeric)
    return false;
  // WB12 (raw lookahead)
  if (bc == wbtab::kNumeric && u8_is_mid_numish(nc) &&
      u8_lookahead_raw(t, len, after) == wbtab::kNumeric)
    return false;
  // WB13
  if (bc == wbtab::kKatakana && nc == wbtab::kKatakana) return false;
  // WB13a
  if ((u8_is_ahl(bc) || bc == wbtab::kNumeric || bc == wbtab::kKatakana ||
       bc == wbtab::kExtendNumLet) &&
      nc == wbtab::kExtendNumLet)
    return false;
  // WB13b
  if (bc == wbtab::kExtendNumLet &&
      (u8_is_ahl(nc) || nc == wbtab::kNumeric || nc == wbtab::kKatakana))
    return false;
  // engine WB15/16: odd raw-RI run at the base suppresses the break
  if (bc == wbtab::kRegionalIndicator && (st.base_ri_run & 1)) return false;
  // elision tailoring: apostrophe base binds onto a vowel-bind char
  if ((st.base_cp == 0x27 || st.base_cp == 0x2019) &&
      (props & wbtab::kVBind))
    return false;
  return true;
}

inline void u8_advance(U8SegState& st, uint32_t cp, uint8_t props) {
  const uint8_t cls = props & wbtab::kClassMask;
  st.raw_ri_run =
      (cls == wbtab::kRegionalIndicator) ? st.raw_ri_run + 1 : 0;
  if (!u8_is_efz(cls)) {
    st.pre_base_raw_cls = st.prev_cls;
    st.base_cls = cls;
    st.base_cp = cp;
    st.base_ri_run = st.raw_ri_run;
  }
  st.prev_cls = cls;
  st.prev_cp = cp;
}

}  // namespace

extern "C" {

// Tokenize UTF-8 text into [start, end) BYTE-span pairs (full-Unicode
// UAX#29 word segmentation + the \w keep-filter). Returns the token
// count, -1 on a malformed UTF-8 sequence (caller falls back to the
// regex path), or -2 if cap (in span pairs) is exceeded.
int64_t ucfp_text_tokens_u8(const uint8_t* text, int64_t len,
                            int64_t* spans, int64_t cap) {
  int64_t n = 0;
  U8SegState st;
  int64_t seg_start = 0;
  bool seg_word = false;
  int64_t i = 0;
  bool first = true;
  while (i < len) {
    const int64_t at = i;
    const uint32_t cp = u8_next(text, len, i);
    if (cp == 0xFFFFFFFFu) return -1;
    const uint8_t props = wbtab::lookup(cp);
    if (!first && u8_is_break(st, cp, props, text, len, i)) {
      if (seg_word) {
        if (n >= cap) return -2;
        spans[2 * n] = seg_start;
        spans[2 * n + 1] = at;
        ++n;
      }
      seg_start = at;
      seg_word = false;
    }
    first = false;
    if (props & wbtab::kWordFlag) seg_word = true;
    u8_advance(st, cp, props);
  }
  if (!first && seg_word) {
    if (n >= cap) return -2;
    spans[2 * n] = seg_start;
    spans[2 * n + 1] = len;
    ++n;
  }
  return n;
}

// Fused full-Unicode minhash: UAX#29 tokenize -> k-shingle (tokens
// joined by single spaces; fewer than k tokens yields ONE shingle) ->
// XXH3-64 -> streaming mix+min into out_sig[h]. Returns the shingle
// count (0 = no tokens), -1 on malformed UTF-8 (caller falls back).
// Byte-identical to the Python pipeline by the same argument as the
// ASCII path: tokens are byte ranges of the SAME UTF-8 encoding the
// Python path hashes, and the join separator is ASCII space.
int64_t ucfp_text_minhash_sig_u8(const uint8_t* text, int64_t len,
                                 int32_t k, const uint64_t* keys, int32_t h,
                                 uint64_t* out_sig) {
  for (int32_t j = 0; j < h; ++j) out_sig[j] = UINT64_MAX;
  // adjacent 1-byte tokens cannot touch (two ASCII word chars never
  // break), so len/2+1 span pairs bound the count (see tokens_u8 cap
  // note in ops/textsig.py)
  const int64_t max_tokens = len / 2 + 1;
  int64_t* spans = new int64_t[2 * (size_t)max_tokens];
  const int64_t t = ucfp_text_tokens_u8(text, len, spans, max_tokens);
  if (t < 0) {
    delete[] spans;
    return -1;
  }
  if (t == 0) {
    delete[] spans;
    return 0;
  }
  std::string scratch;
  scratch.reserve(256);
  const int64_t nsh = t < k ? 1 : t - k + 1;
  const int64_t width = t < k ? t : k;
  for (int64_t s0 = 0; s0 < nsh; ++s0) {
    scratch.clear();
    for (int64_t j = 0; j < width; ++j) {
      if (j) scratch.push_back(' ');
      const int64_t a = spans[2 * (s0 + j)], b = spans[2 * (s0 + j) + 1];
      scratch.append(reinterpret_cast<const char*>(text) + a,
                     (size_t)(b - a));
    }
    const uint64_t base = XXH3_64bits(scratch.data(), scratch.size());
    for (int32_t j = 0; j < h; ++j) {
      const uint64_t v = mix64(base ^ keys[j]);
      if (v < out_sig[j]) out_sig[j] = v;
    }
  }
  delete[] spans;
  return nsh;
}

// Fused full-Unicode TF SimHash (same +/-1-per-occurrence equivalence
// as the ASCII variant). Returns 1 ok, 0 no tokens, -1 malformed UTF-8.
int ucfp_text_simhash64_tf_u8(const uint8_t* text, int64_t len,
                              uint64_t* out) {
  const int64_t max_tokens = len / 2 + 1;
  int64_t* spans = new int64_t[2 * (size_t)max_tokens];
  const int64_t t = ucfp_text_tokens_u8(text, len, spans, max_tokens);
  if (t < 0) {
    delete[] spans;
    return -1;
  }
  if (t == 0) {
    delete[] spans;
    return 0;
  }
  int64_t acc[64] = {0};
  for (int64_t i = 0; i < t; ++i) {
    const int64_t a = spans[2 * i], b = spans[2 * i + 1];
    const uint64_t hh = XXH3_64bits(text + a, (size_t)(b - a));
    for (int bbit = 0; bbit < 64; ++bbit)
      acc[bbit] += ((hh >> bbit) & 1) ? 1 : -1;
  }
  delete[] spans;
  uint64_t sig = 0;
  for (int bbit = 0; bbit < 64; ++bbit)
    if (acc[bbit] > 0) sig |= (uint64_t)1 << bbit;
  *out = sig;
  return 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Extended grapheme clusters (the regex engine's \X): UAX#29 GB1-GB999
// over the generated kGcbPages table. Probed against regex 2026.7.19 —
// unlike the word scanner, \X shows NO deviations from the spec (no
// sot-Extend attachment: a leading combining mark is its own cluster).
// ---------------------------------------------------------------------------

namespace {

struct GcbState {
  uint8_t prev_cls = 0xFF;           // raw class of previous char
  bool prev_extpict_zwj = false;     // ExtPict Extend* ZWJ just ended
  bool extpict_chain = false;        // ExtPict Extend* still open
  int ri_run = 0;                    // raw consecutive-RI run
};

inline bool gcb_is_break(const GcbState& st, uint8_t props) {
  using namespace wbtab;
  const uint8_t nc = props & kGcbClassMask;
  const uint8_t pc = st.prev_cls;
  if (pc == kGcbCR && nc == kGcbLF) return false;               // GB3
  if (pc == kGcbControl || pc == kGcbCR || pc == kGcbLF) return true;
  if (nc == kGcbControl || nc == kGcbCR || nc == kGcbLF) return true;
  if (pc == kGcbL &&
      (nc == kGcbL || nc == kGcbV || nc == kGcbLV || nc == kGcbLVT))
    return false;                                               // GB6
  if ((pc == kGcbLV || pc == kGcbV) && (nc == kGcbV || nc == kGcbT))
    return false;                                               // GB7
  if ((pc == kGcbLVT || pc == kGcbT) && nc == kGcbT) return false;  // GB8
  if (nc == kGcbExtend || nc == kGcbZWJ) return false;          // GB9
  if (nc == kGcbSpacingMark) return false;                      // GB9a
  if (pc == kGcbPrepend) return false;                          // GB9b
  if (pc == kGcbZWJ && st.prev_extpict_zwj && (props & kGcbExtPict))
    return false;                                               // GB11
  if (pc == kGcbRegionalIndicator && nc == kGcbRegionalIndicator &&
      (st.ri_run & 1))
    return false;                                               // GB12/13
  return true;
}

inline void gcb_advance(GcbState& st, uint8_t props) {
  using namespace wbtab;
  const uint8_t cls = props & kGcbClassMask;
  st.ri_run = (cls == kGcbRegionalIndicator) ? st.ri_run + 1 : 0;
  if (props & kGcbExtPict) {
    st.extpict_chain = true;
    st.prev_extpict_zwj = false;
  } else if (cls == kGcbExtend && st.extpict_chain) {
    // chain stays open across Extend*
    st.prev_extpict_zwj = false;
  } else if (cls == kGcbZWJ && st.extpict_chain) {
    st.prev_extpict_zwj = true;
    st.extpict_chain = false;
  } else {
    st.extpict_chain = false;
    st.prev_extpict_zwj = false;
  }
  st.prev_cls = cls;
}

}  // namespace

extern "C" {

// Segment UTF-8 text into extended grapheme clusters as [start, end)
// BYTE-span pairs. skip_spaces != 0 drops clusters whose chars ALL
// have the isspace flag (the grapheme tokenizer's keep-filter,
// matching Python str.isspace on the cluster). Returns the cluster
// count, -1 on malformed UTF-8, -2 if cap (span pairs) is exceeded.
int64_t ucfp_text_graphemes_u8(const uint8_t* text, int64_t len,
                               int skip_spaces, int64_t* spans,
                               int64_t cap) {
  int64_t n = 0;
  GcbState st;
  int64_t seg_start = 0;
  bool seg_nonspace = false;
  bool first = true;
  int64_t i = 0;
  while (i < len) {
    const int64_t at = i;
    const uint32_t cp = u8_next(text, len, i);
    if (cp == 0xFFFFFFFFu) return -1;
    const uint8_t props = wbtab::gcb_lookup(cp);
    if (!first && gcb_is_break(st, props)) {
      if (seg_nonspace || !skip_spaces) {
        if (n >= cap) return -2;
        spans[2 * n] = seg_start;
        spans[2 * n + 1] = at;
        ++n;
      }
      seg_start = at;
      seg_nonspace = false;
    }
    first = false;
    if (!(props & wbtab::kGcbSpace)) seg_nonspace = true;
    gcb_advance(st, props);
  }
  if (!first && (seg_nonspace || !skip_spaces)) {
    if (n >= cap) return -2;
    spans[2 * n] = seg_start;
    spans[2 * n + 1] = len;
    ++n;
  }
  return n;
}

// Fused grapheme-tokenized minhash (tokenizer="grapheme"): cluster ->
// k-shingle (space-joined) -> XXH3 -> mix+min. Same return contract as
// ucfp_text_minhash_sig_u8. Clusters that are entirely whitespace are
// dropped first (the tokenize() keep-filter).
int64_t ucfp_text_minhash_sig_gr(const uint8_t* text, int64_t len,
                                 int32_t k, const uint64_t* keys,
                                 int32_t h, uint64_t* out_sig) {
  for (int32_t j = 0; j < h; ++j) out_sig[j] = UINT64_MAX;
  // every cluster is >= 1 byte: len span pairs always suffice
  const int64_t max_tokens = len > 0 ? len : 1;
  int64_t* spans = new int64_t[2 * (size_t)max_tokens];
  const int64_t t =
      ucfp_text_graphemes_u8(text, len, 1, spans, max_tokens);
  if (t < 0) {
    delete[] spans;
    return -1;
  }
  if (t == 0) {
    delete[] spans;
    return 0;
  }
  std::string scratch;
  scratch.reserve(256);
  const int64_t nsh = t < k ? 1 : t - k + 1;
  const int64_t width = t < k ? t : k;
  for (int64_t s0 = 0; s0 < nsh; ++s0) {
    scratch.clear();
    for (int64_t j = 0; j < width; ++j) {
      if (j) scratch.push_back(' ');
      const int64_t a = spans[2 * (s0 + j)], b = spans[2 * (s0 + j) + 1];
      scratch.append(reinterpret_cast<const char*>(text) + a,
                     (size_t)(b - a));
    }
    const uint64_t base = XXH3_64bits(scratch.data(), scratch.size());
    for (int32_t j = 0; j < h; ++j) {
      const uint64_t v = mix64(base ^ keys[j]);
      if (v < out_sig[j]) out_sig[j] = v;
    }
  }
  delete[] spans;
  return nsh;
}

}  // extern "C"
