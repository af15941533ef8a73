"""Text modality pipeline: canonicalize -> tokenize -> shingle -> signature.

A copy of ucfp_tpu/modality/text.py (host code). It differs in its
imports and in one argument: the semantic path takes the `device` that a
local transformers model (models/hf_local.py) runs on.

Rebuilds the reference's text modality surface (src/modality/text.rs):
  * fingerprint_minhash      "minhash-h128"      1032-byte signature
  * fingerprint_simhash_tf   "simhash-b64-tf"    8 bytes
  * fingerprint_simhash_idf  "simhash-b64-idf"   8 bytes
  * fingerprint_lsh          "minhash-lsh-h128"  minhash bytes, re-tagged
  * fingerprint_tlsh         "tlsh-128-1"        70-char hex STRING bytes
  * fingerprint_semantic     "embedding-local" / "embedding-openai" /
                             "embedding-voyage" / "embedding-cohere"
  * StreamingMinHashSession  buffered push/finalize (text.rs:655-730)
  * inspect_text             stage extractor (text.rs:877-967)
  * html/markdown/pdf preprocess passes (text.rs:764-798)

Canonicalizer knobs mirror txtfp's (normalization nfc/nfkc/none, simple
case fold, strip bidi controls, strip format chars, optional confusable
mapping; defaults NFKC + fold + strip, reference manifest
algorithms_manifest.rs:240-268).

The signature math lives in ops.textsig (see its header for the
documented schemes and the host-vs-device rationale).
"""

from __future__ import annotations

import os.path
import re
import unicodedata
from dataclasses import dataclass, replace

import numpy as np

from ..core import Modality, ModalityError, Record, UnsupportedError
from ..ops import textsig
from .confighash import config_hash64

DEFAULT_K = 5
DEFAULT_H = 128

ALGORITHM_MINHASH_128 = "minhash-h128"
ALGORITHM_SIMHASH_TF = "simhash-b64-tf"
ALGORITHM_SIMHASH_IDF = "simhash-b64-idf"
ALGORITHM_LSH = "minhash-lsh-h128"
ALGORITHM_TLSH = "tlsh-128-1"
ALGORITHM_SEMANTIC_LOCAL = "embedding-local"
ALGORITHM_SEMANTIC_OPENAI = "embedding-openai"
ALGORITHM_SEMANTIC_VOYAGE = "embedding-voyage"
ALGORITHM_SEMANTIC_COHERE = "embedding-cohere"


# ---------------------------------------------------------------------------
# Canonicalization
# ---------------------------------------------------------------------------

_BIDI_CONTROLS = {
    "‎",  # LRM
    "‏",  # RLM
    "؜",  # ALM
    "‪",  # LRE
    "‫",  # RLE
    "‬",  # PDF
    "‭",  # LRO
    "‮",  # RLO
    "⁦",  # LRI
    "⁧",  # RLI
    "⁨",  # FSI
    "⁩",  # PDI
}

class _CfDeleteTable(dict):
    """Memoizing str.translate table that deletes Cf (format) chars.

    str.translate consults the mapping per character; on a miss,
    __missing__ classifies the codepoint ONCE with unicodedata (the
    exact test the old per-char loop ran) and caches None (delete) or
    the codepoint itself (keep) — so steady-state translation is
    C-speed dict hits instead of a Python loop per character."""

    def __missing__(self, cp: int):
        val = None if unicodedata.category(chr(cp)) == "Cf" else cp
        self[cp] = val
        return val


_CF_DELETE_TABLE = _CfDeleteTable()
# strip_bidi without strip_format: delete exactly the 12 bidi controls
_BIDI_DELETE_TABLE = {ord(c): None for c in _BIDI_CONTROLS}

# Small built-in confusable map (UTS#39-inspired subset: common Cyrillic /
# Greek homoglyphs of Latin letters). Off by default like the reference.
_CONFUSABLES = str.maketrans(
    {
        "а": "a", "е": "e", "о": "o", "р": "p", "с": "c", "х": "x", "у": "y",
        "і": "i", "ѕ": "s", "ԁ": "d", "ɡ": "g", "α": "a", "β": "b", "ο": "o",
        "ρ": "p", "τ": "t", "υ": "u", "ν": "v",
    }
)


@dataclass(frozen=True)
class TextOpts:
    """Per-request tunables (reference TextOpts, text.rs:116-147)."""

    k: int = DEFAULT_K
    h: int = DEFAULT_H
    tokenizer: str = "word"  # word | grapheme | char
    normalization: str = "nfkc"  # nfc | nfkc | none
    case_fold: bool = True
    strip_bidi: bool = True
    strip_format: bool = True
    apply_confusable: bool = False
    preprocess: str | None = None  # html | markdown | pdf


def canonicalize(text: str, opts: TextOpts) -> str:
    # the reference canonicalizer accepts nfc/nfkc/nfd/nfkd/none
    # (dto.rs:405-408)
    if opts.normalization not in ("nfc", "nfkc", "nfd", "nfkd", "none"):
        raise ModalityError(f"unknown normalization {opts.normalization!r}")
    if text.isascii():
        # every stage below is the identity on ASCII except case folding
        # (all four normalization forms fix ASCII; no bidi controls, no
        # Cf characters, no confusable-map keys exist below U+0080) —
        # and the per-char strip loop costs ~0.8 ms on a 5.6 KiB doc
        return text.casefold() if opts.case_fold else text
    if opts.normalization != "none":
        text = unicodedata.normalize(opts.normalization.upper(), text)
    if opts.case_fold:
        text = text.casefold()
    # deletion set: (bidi controls if strip_bidi) ∪ (Cf if strip_format)
    # — every bidi control IS Cf, so strip_format subsumes strip_bidi.
    # str.translate with the memoizing table replaces the ~0.8 ms/5.6KiB
    # per-char category loop; identical semantics (same unicodedata
    # category test, property-tested in test_textsig_native.py).
    # presence prefilter: str.translate(dict) pays a per-char dict hit
    # (~0.32 ms on a 5.6 KiB doc) even when nothing is deleted; a
    # compiled \p{Cf} search costs ~0.04 ms, and the regex engine's Cf
    # set is IDENTICAL to unicodedata's (property-pinned both ways in
    # test_textsig_native.py), so a no-match skip is semantics-free —
    # when a match exists, the exact unicodedata-backed table still
    # does the deletion.
    if opts.strip_format:
        if _CF_SEARCH_RE.search(text) is not None:
            text = text.translate(_CF_DELETE_TABLE)
    elif opts.strip_bidi:
        if _BIDI_SEARCH_RE.search(text) is not None:
            text = text.translate(_BIDI_DELETE_TABLE)
    if opts.apply_confusable:
        text = text.translate(_CONFUSABLES)
    return text


# ---------------------------------------------------------------------------
# Tokenizers (word + grapheme = real UAX#29 via the `regex` engine; char)
#
# The reference's txtfp uses UAX#29 word segmentation and extended
# grapheme clusters (text.rs:30-33). `regex`'s (?w) flag implements the
# UAX#29 default word-boundary rules (WB1-WB999: apostrophes stay inside
# words via MidLetter, "1,234.5" holds together via MidNum, hyphens
# break) and \X implements extended grapheme clusters (combining marks,
# regional-indicator flags, emoji ZWJ/modifier sequences). TOKENIZER_SPEC
# is baked into every config_hash so records cut with the pre-UAX#29
# round-2 tokenizers refuse comparison instead of silently mismatching.
# ---------------------------------------------------------------------------

import regex as _regex

TOKENIZER_SPEC = "uax29-v1"

_WORD_BOUNDARY_RE = _regex.compile(r"(?w)\b")
_HAS_WORD_CHAR_RE = _regex.compile(r"\w", _regex.UNICODE)
_GRAPHEME_RE = _regex.compile(r"\X")
# canonicalize prefilters (bound at call time; canonicalize is defined
# above this import but never called before module init completes)
_CF_SEARCH_RE = _regex.compile(r"\p{Cf}")
_BIDI_SEARCH_RE = _regex.compile("[" + "".join(sorted(_BIDI_CONTROLS)) + "]")


def tokenize_words(text: str) -> list[str]:
    """UAX#29 default word segmentation, keeping only segments that
    contain a word character (letters/marks/digits/underscore) — the
    token stream the reference's WordTokenizer produces.

    ASCII inputs take the native ASCII scanner; everything else takes
    the native full-Unicode scanner (wb_table.h is GENERATED from the
    regex engine's own property tables, and the rule machine is
    differential-fuzzed against (?w)\b — byte-equality pinned in
    tests/test_textsig_native.py). The regex engine remains the
    semantic source of truth and the fallback."""
    if text.isascii():
        toks = textsig.tokenize_ascii_fast(text)
    else:
        toks = textsig.tokenize_u8_fast(text)
    if toks is not None:
        return toks
    return [
        seg
        for seg in _WORD_BOUNDARY_RE.split(text)
        if seg and _HAS_WORD_CHAR_RE.search(seg)
    ]


def tokenize_graphemes(text: str) -> list[str]:
    """UAX#29 extended grapheme clusters (combining sequences, flags,
    emoji ZWJ/modifier sequences stay single tokens).

    regex's \\X stays the list-materializing path (its C findall beats
    a ctypes span walk at ~5k clusters/doc); the native GB scanner
    (byte-identical, fuzz-pinned) serves the FUSED grapheme minhash in
    fingerprint_minhash, where no token list is built at all."""
    return _GRAPHEME_RE.findall(text)


def _is_han(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0xF900 <= cp <= 0xFAFF
        or 0x20000 <= cp <= 0x2A6DF
    )


def _is_kana(ch: str) -> bool:
    cp = ord(ch)
    return 0x3040 <= cp <= 0x30FF or 0x31F0 <= cp <= 0x31FF


def _is_hangul(ch: str) -> bool:
    cp = ord(ch)
    return 0xAC00 <= cp <= 0xD7AF or 0x1100 <= cp <= 0x11FF


# -- pluggable CJK dictionary segmentation ----------------------------------
#
# The reference's txtfp segments Japanese/Korean with Lindera/KoDic
# morphological dictionaries (src/modality/text.rs:30-33) — multi-MB
# artifacts not vendorable here. Out of the box the BUNDLED curated
# frequency lexicon (data/cjk_lexicon/ of this package, ~2.5k high-frequency
# zh/ja/ko words) drives min-cost Viterbi segmentation of CJK runs
# (longest-match falls out of the cost structure: covering a run with
# fewer, longer dictionary words is cheaper); spans no lexicon word
# covers degrade to the dictionary-free scheme (Han bigrams + whole
# kana/hangul runs — a bigram postings index retrieves any dictionary
# segmentation of the same text). UCFP_CJK_DICT mirrors the
# UCFP_MODEL_DIR pattern: point it at a directory of lexicon files
# (*.txt / *.tsv, one `word[<TAB>cost]` per line, '#' comments) to
# replace the bundled lexicon with real morphological data; set it to
# "none" (or empty) to disable dictionaries entirely and keep the pure
# bigram scheme. The active dictionary's content hash is folded into
# config_hash (see _opts_config_hash), so records cut with different
# lexicons refuse comparison instead of silently mismatching.

_UNKNOWN_CHAR_COST = 2.0  # per char not covered by any lexicon word
_DEFAULT_WORD_COST = 1.0  # per lexicon word without an explicit cost

_cjk_dict_cache: dict = {}


def _load_cjk_dict(dict_dir: str):
    """Parse every *.txt / *.tsv lexicon under dict_dir. Returns
    (words: {str: cost}, max_word_len, spec: 'dict-<hash16>'), cached
    per directory path for the process lifetime."""
    cached = _cjk_dict_cache.get(dict_dir)
    if cached is not None:
        return cached
    import hashlib
    import os

    words: dict[str, float] = {}
    try:
        names = sorted(
            f for f in os.listdir(dict_dir)
            if f.endswith((".txt", ".tsv"))
        )
    except OSError as e:
        raise ModalityError(f"UCFP_CJK_DICT unreadable: {e}") from e
    for name in names:
        with open(os.path.join(dict_dir, name), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                w = parts[0]
                if not w:
                    continue
                try:
                    cost = float(parts[1]) if len(parts) > 1 \
                        else _DEFAULT_WORD_COST
                except ValueError as e:
                    raise ModalityError(
                        f"bad cost in {name}: {line!r}"
                    ) from e
                words[w] = cost
    if not words:
        raise ModalityError(f"UCFP_CJK_DICT has no lexicon entries: {dict_dir}")
    h = hashlib.sha256()
    for w in sorted(words):
        h.update(f"{w}\t{words[w]}\n".encode())
    out = (words, max(len(w) for w in words),
           f"dict-{h.hexdigest()[:16]}")
    _cjk_dict_cache[dict_dir] = out
    return out


_BUNDLED_CJK_DICT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "cjk_lexicon",
)


def _active_cjk_dict():
    """The (words, maxlen, spec) for the active lexicon, or None.

    UCFP_CJK_DICT=<dir> mounts a user dictionary; unset uses the
    bundled frequency lexicon; "none"/"" disables dictionaries (pure
    Han-bigram scheme, the pre-round-5 default)."""
    import os

    d = os.environ.get("UCFP_CJK_DICT")
    if d is None:
        return _load_cjk_dict(_BUNDLED_CJK_DICT)
    if not d or d.lower() == "none":
        return None
    return _load_cjk_dict(d)


def cjk_dict_spec() -> str:
    """Config-hash component for the active CJK lexicon ('' when
    dictionaries are disabled via UCFP_CJK_DICT=none) — mounting or
    changing a lexicon (bundled included) re-versions every cjk-token
    fingerprint, like UCFP_MODEL_DIR does for encoder fingerprints."""
    active = _active_cjk_dict()
    return active[2] if active else ""


def _dictfree_span(span: str) -> list[str]:
    """The dictionary-free scheme for one contiguous CJK span: Han
    sub-runs emit character bigrams (singles stay single), kana and
    hangul sub-runs emit whole script runs."""
    out: list[str] = []
    i = 0
    n = len(span)
    while i < n:
        ch = span[i]
        if _is_han(ch):
            j = i
            while j < n and _is_han(span[j]):
                j += 1
            run = span[i:j]
            if len(run) == 1:
                out.append(run)
            else:
                out.extend(run[k : k + 2] for k in range(len(run) - 1))
        else:
            pred = _is_kana if _is_kana(ch) else _is_hangul
            j = i
            while j < n and pred(span[j]):
                j += 1
            out.append(span[i:j])
        i = j
    return out


def _viterbi_segment(run: str, words: dict, maxlen: int) -> list[str]:
    """Min-cost segmentation of a CJK run: lexicon words cost their
    dictionary cost, uncovered chars cost _UNKNOWN_CHAR_COST each — so
    known words (the longer the better) dominate. Spans no lexicon word
    covers degrade to the dictionary-free scheme (_dictfree_span: Han
    bigrams + whole kana/hangul runs), NOT to single-char tokens — a
    small curated lexicon leaves most proper nouns uncovered, and
    bigrams keep those spans retrievable the same way the no-dict
    configuration indexes them."""
    n = len(run)
    inf = float("inf")
    best = [inf] * (n + 1)
    back = [0] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        bi = best[i]
        if bi == inf:
            continue
        # unknown single char (always available: keeps dp connected)
        c1 = bi + words.get(run[i], _UNKNOWN_CHAR_COST)
        if c1 < best[i + 1]:
            best[i + 1], back[i + 1] = c1, i
        for ln in range(2, min(maxlen, n - i) + 1):
            cost = words.get(run[i : i + ln])
            if cost is not None and bi + cost < best[i + ln]:
                best[i + ln], back[i + ln] = bi + cost, i
    toks: list[str] = []
    j = n
    while j > 0:
        i = back[j]
        toks.append(run[i:j])
        j = i
    toks.reverse()
    # merge consecutive UNKNOWN singles (the fallback path above) into
    # spans and re-emit them dictionary-free
    out: list[str] = []
    span = ""
    for t in toks:
        if len(t) == 1 and t not in words:
            span += t
            continue
        if span:
            out.extend(_dictfree_span(span))
            span = ""
        out.append(t)
    if span:
        out.extend(_dictfree_span(span))
    return out


def _is_cjk(ch: str) -> bool:
    return _is_han(ch) or _is_kana(ch) or _is_hangul(ch)


def tokenize_cjk(text: str) -> list[str]:
    """Script-aware CJK tokenization. With UCFP_CJK_DICT mounted, every
    contiguous CJK run (Han + kana + hangul together — real morphology
    crosses script boundaries, e.g. kanji+okurigana verbs) is segmented
    by min-cost Viterbi over the user lexicon. Without a dictionary
    (the default; documented divergence from the reference's
    Lindera/KoDic morphology): Han runs emit character BIGRAMS (the
    standard dictionary-free CJK indexing scheme — a bigram postings
    index retrieves any dictionary segmentation of the same text), kana
    and hangul runs emit whole script runs, everything else goes
    through the word tokenizer."""
    active = _active_cjk_dict()
    out: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if active is not None and _is_cjk(ch):
            j = i
            while j < n and _is_cjk(text[j]):
                j += 1
            words, maxlen, _spec = active
            out.extend(_viterbi_segment(text[i:j], words, maxlen))
            i = j
        elif _is_han(ch):
            j = i
            while j < n and _is_han(text[j]):
                j += 1
            run = text[i:j]
            if len(run) == 1:
                out.append(run)
            else:
                out.extend(run[k : k + 2] for k in range(len(run) - 1))
            i = j
        elif _is_kana(ch) or _is_hangul(ch):
            pred = _is_kana if _is_kana(ch) else _is_hangul
            j = i
            while j < n and pred(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
        else:
            j = i
            while j < n and not (_is_han(text[j]) or _is_kana(text[j])
                                 or _is_hangul(text[j])):
                j += 1
            out.extend(tokenize_words(text[i:j]))
            i = j
    return out


def tokenize(text: str, kind: str) -> list[str]:
    if kind == "word":
        return tokenize_words(text)
    if kind == "grapheme":
        return [g for g in tokenize_graphemes(text) if not g.isspace()]
    if kind == "char":
        return [c for c in text if not c.isspace()]
    if kind == "cjk":
        return tokenize_cjk(text)
    raise ModalityError(f"unknown tokenizer {kind!r}")


def shingles_of(tokens: list[str], k: int) -> list[str]:
    """k-token windows joined by single space; short inputs yield one
    shingle of all tokens."""
    if not tokens:
        return []
    if len(tokens) < k:
        return [" ".join(tokens)]
    return [" ".join(tokens[i : i + k]) for i in range(len(tokens) - k + 1)]


def _opts_config_hash(algorithm: str, opts: TextOpts) -> int:
    tok_spec = f"{opts.tokenizer}:{TOKENIZER_SPEC}"
    if opts.tokenizer == "cjk":
        # the lexicon changes the token stream, so its content hash
        # versions the fingerprint; '' (no dict) keeps existing
        # Han-bigram hashes stable
        dict_spec = cjk_dict_spec()
        if dict_spec:
            tok_spec = f"{tok_spec}:{dict_spec}"
    return config_hash64(
        algorithm,
        k=opts.k,
        h=opts.h,
        # spec-versioned: a tokenizer behavior change (e.g. the round-3
        # UAX#29 upgrade) must version every fingerprint it can affect
        tokenizer=tok_spec,
        normalization=opts.normalization,
        case_fold=opts.case_fold,
        strip_bidi=opts.strip_bidi,
        strip_format=opts.strip_format,
        apply_confusable=opts.apply_confusable,
        preprocess=opts.preprocess,
    )


def _prepare(text: str, opts: TextOpts) -> str:
    if opts.preprocess == "html":
        text = html_to_text(text)
    elif opts.preprocess == "markdown":
        text = markdown_to_text(text)
    elif opts.preprocess == "pdf":
        raise ModalityError("pdf preprocess takes raw bytes; use pdf_to_text")
    elif opts.preprocess is not None:
        raise ModalityError(f"unknown preprocess {opts.preprocess!r}")
    return canonicalize(text, opts)


# ---------------------------------------------------------------------------
# Fingerprint functions
# ---------------------------------------------------------------------------


def terms_of(text: str, opts: TextOpts | None = None) -> list[str]:
    """Canonicalized token list — the corpus-stats lookup key for the
    SimHash-IDF path."""
    opts = opts or TextOpts()
    return tokenize(_prepare(text, opts), opts.tokenizer)


def fingerprint_minhash(
    text: str, tenant_id: int, record_id: int, opts: TextOpts | None = None
) -> Record:
    opts = opts or TextOpts()
    canon = _prepare(text, opts)
    sig = None
    if opts.tokenizer == "word":
        # fused native path: tokenize -> shingle -> hash -> mix/min in
        # one C++ pass, no token/shingle materialization (5.3 ms ->
        # ~0.25 ms on the reference's 5.6 KiB bench doc; the _u8 variant
        # covers non-ASCII text with the wb_table.h full-Unicode UAX#29
        # scanner, 3.1 -> 0.25 ms). Byte-identical to the fallback below
        # (fuzz + goldens).
        fast = (textsig.text_minhash_fast(canon, opts.k, opts.h)
                if canon.isascii()
                else textsig.text_minhash_u8_fast(canon, opts.k, opts.h))
        if fast is not None:
            sig, nsh = fast
            if nsh == 0:
                raise ModalityError("no tokens after canonicalization")
    elif opts.tokenizer == "grapheme":
        fast = textsig.text_minhash_gr_fast(canon, opts.k, opts.h)
        if fast is not None:
            sig, nsh = fast
            if nsh == 0:
                raise ModalityError("no tokens after canonicalization")
    if sig is None:
        toks = tokenize(canon, opts.tokenizer)
        if not toks:
            raise ModalityError("no tokens after canonicalization")
        sh = shingles_of(toks, opts.k)
        sig = textsig.minhash_signature(sh, opts.h)
    algorithm = f"minhash-h{opts.h}" if opts.h != 128 else ALGORITHM_MINHASH_128
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.TEXT,
        algorithm=algorithm,
        fingerprint=textsig.serialize_minhash(sig),
        config_hash=_opts_config_hash(algorithm, opts),
        text=canon,
    )


def fingerprint_simhash(
    text: str,
    tenant_id: int,
    record_id: int,
    opts: TextOpts | None = None,
    idf: dict[str, float] | None = None,
) -> Record:
    """TF-weighted (idf=None) or TF-IDF-weighted 64-bit SimHash.

    The IDF variant falls back to pure TF when no corpus stats are
    available, matching REPORT.md 4.1.2's first-document behavior.
    """
    opts = opts or TextOpts()
    canon = _prepare(text, opts)
    h = None
    if not idf and opts.tokenizer == "word":
        # pure-TF weights (idf None, or the empty-corpus IDF fallback):
        # the fused native path hashes per token OCCURRENCE — identical
        # to the unique-term/tf form (textsig.cpp has the argument)
        fast = (textsig.text_simhash_tf_fast(canon) if canon.isascii()
                else textsig.text_simhash_tf_u8_fast(canon))
        if fast is not None:
            h, has_tokens = fast
            if not has_tokens:
                raise ModalityError("no tokens after canonicalization")
    if h is None:
        toks = tokenize(canon, opts.tokenizer)
        if not toks:
            raise ModalityError("no tokens after canonicalization")
        from collections import Counter

        tf = Counter(toks)
        terms = list(tf.keys())
        if idf:
            weights = [tf[t] * idf.get(t, 1.0) for t in terms]
        else:
            weights = [float(tf[t]) for t in terms]
        h = textsig.simhash64(terms, weights)
    algorithm = (ALGORITHM_SIMHASH_IDF if idf is not None
                 else ALGORITHM_SIMHASH_TF)
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.TEXT,
        algorithm=algorithm,
        fingerprint=h.to_bytes(8, "little"),
        config_hash=_opts_config_hash(algorithm, opts),
        text=canon,
    )


def fingerprint_lsh(
    text: str, tenant_id: int, record_id: int, opts: TextOpts | None = None
) -> Record:
    """MinHash record re-tagged for LSH bucket insertion (text.rs:437-446)."""
    rec = fingerprint_minhash(text, tenant_id, record_id, opts)
    return replace(rec, algorithm=ALGORITHM_LSH)


def fingerprint_tlsh(
    text: str, tenant_id: int, record_id: int, opts: TextOpts | None = None
) -> Record:
    opts = opts or TextOpts()
    canon = _prepare(text, opts)
    data = canon.encode("utf-8")
    try:
        digest = textsig.tlsh_128_1(data)
    except ValueError as e:
        raise ModalityError(str(e))
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.TEXT,
        algorithm=ALGORITHM_TLSH,
        # stored as the hex string's bytes, matching text.rs:478
        fingerprint=digest.encode("ascii"),
        config_hash=_opts_config_hash(ALGORITHM_TLSH, opts),
        text=canon,
    )


# -- semantic providers -------------------------------------------------------

from ..models import TEXT_MODEL_ID as SEMANTIC_LOCAL_MODEL_ID
from ..models.encoders import TEXT_DIM as SEMANTIC_DIM


def _local_embed(canon: str, device=None) -> tuple[np.ndarray, str]:
    """Local embedding + its model_id: a real transformers model when
    UCFP_MODEL_DIR/text holds weights (the reference's local ONNX
    MiniLM provider, text.rs:500-606), else the deterministic seeded
    stand-in from models.encoders."""
    from ..models import hf_local, text_hash_embed

    try:
        if hf_local.available("text"):
            return hf_local.text_embed(canon, device=device)
        toks = tokenize_words(canon)
        return text_hash_embed(toks), SEMANTIC_LOCAL_MODEL_ID
    except ValueError as e:
        raise ModalityError(str(e))


_PROVIDER_ALGOS = {
    "openai": ALGORITHM_SEMANTIC_OPENAI,
    "voyage": ALGORITHM_SEMANTIC_VOYAGE,
    "cohere": ALGORITHM_SEMANTIC_COHERE,
}


def fingerprint_semantic(
    text: str,
    tenant_id: int,
    record_id: int,
    provider: str = "local",
    opts: TextOpts | None = None,
    provider_key: str | None = None,
    model: str | None = None,
    device=None,
) -> Record:
    """Semantic embedding record: embedding slot + f32-LE fingerprint
    bytes. provider "local" runs the on-host encoder; openai / voyage /
    cohere call the hosted embedding APIs with the caller's key
    (reference: text.rs:500-606 — model_id/api_key required per arm,
    handlers.rs:440-510), wire codecs in modality/providers.py."""
    opts = opts or TextOpts()
    canon = _prepare(text, opts)
    if provider == "local":
        emb, model_id = _local_embed(canon, device)
        algorithm = ALGORITHM_SEMANTIC_LOCAL
    elif provider in _PROVIDER_ALGOS:
        from . import providers as prov

        if not provider_key:
            raise ModalityError(
                f"semantic-{provider} requires `api_key` "
                "(X-Provider-Key header or api_key param)"
            )
        want = model or prov.DEFAULT_MODEL[provider]
        emb, model_id = prov.embed(provider, canon, want, provider_key)
        algorithm = _PROVIDER_ALGOS[provider]
    else:
        raise ModalityError(f"unknown semantic provider {provider!r}")
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.TEXT,
        algorithm=algorithm,
        fingerprint=emb.astype("<f4").tobytes(),
        embedding=[float(x) for x in emb],
        model_id=model_id,
        config_hash=_opts_config_hash(algorithm, opts),
        text=canon,
    )


# ---------------------------------------------------------------------------
# Streaming session (buffered, like txtfp MinHashStreaming, text.rs:655-730)
# ---------------------------------------------------------------------------


class StreamingMinHashSession:
    """Push text chunks, finalize once into a MinHash record."""

    def __init__(self, tenant_id: int, record_id: int, opts: TextOpts | None = None):
        self.tenant_id = tenant_id
        self.record_id = record_id
        self.opts = opts or TextOpts()
        self._chunks: list[str] = []
        self._finalized = False

    def push(self, chunk: str) -> None:
        if self._finalized:
            raise ModalityError("session already finalized")
        self._chunks.append(chunk)

    def finalize(self) -> Record:
        if self._finalized:
            raise ModalityError("session already finalized")
        rec = fingerprint_minhash(
            "".join(self._chunks), self.tenant_id, self.record_id, self.opts
        )
        # only mark finalized on SUCCESS: a failed fingerprint (e.g.
        # whitespace-only buffer) must leave the session usable, not
        # poisoned behind a misleading "already finalized" error
        self._finalized = True
        return rec


# ---------------------------------------------------------------------------
# Preprocess passes (text.rs:764-798)
# ---------------------------------------------------------------------------


def html_to_text(html: str) -> str:
    from html.parser import HTMLParser

    class _Extract(HTMLParser):
        def __init__(self):
            super().__init__()
            self.parts: list[str] = []
            self._skip = 0

        def handle_starttag(self, tag, attrs):
            if tag in ("script", "style"):
                self._skip += 1

        def handle_endtag(self, tag):
            if tag in ("script", "style") and self._skip:
                self._skip -= 1

        def handle_data(self, data):
            if not self._skip:
                self.parts.append(data)

    p = _Extract()
    p.feed(html)
    return re.sub(r"\s+", " ", " ".join(p.parts)).strip()


_MD_PATTERNS = [
    (re.compile(r"```.*?```", re.DOTALL), " "),
    (re.compile(r"`([^`]*)`"), r"\1"),
    (re.compile(r"!\[([^\]]*)\]\([^)]*\)"), r"\1"),
    (re.compile(r"\[([^\]]*)\]\([^)]*\)"), r"\1"),
    (re.compile(r"^#{1,6}\s*", re.MULTILINE), ""),
    (re.compile(r"[*_~]{1,3}([^*_~]+)[*_~]{1,3}"), r"\1"),
    (re.compile(r"^>\s?", re.MULTILINE), ""),
    (re.compile(r"^[-+*]\s+", re.MULTILINE), ""),
    (re.compile(r"^\d+\.\s+", re.MULTILINE), ""),
]


def markdown_to_text(md: str) -> str:
    for pat, rep in _MD_PATTERNS:
        md = pat.sub(rep, md)
    return re.sub(r"\s+", " ", md).strip()


def pdf_to_text(data: bytes) -> str:
    """Minimal PDF text extraction: literal strings in Tj/TJ show operators
    across uncompressed content streams. Compressed streams (FlateDecode)
    are inflated with zlib. Not a full PDF renderer — enough for the
    text-bearing PDFs the reference's preprocess pass targets."""
    import zlib

    text_parts: list[str] = []
    for m in re.finditer(rb"stream\r?\n(.*?)endstream", data, re.DOTALL):
        blob = m.group(1)
        try:
            blob = zlib.decompress(blob)
        except zlib.error:
            pass
        for sm in re.finditer(rb"\(((?:[^()\\]|\\.)*)\)\s*T[jJ]", blob):
            raw = sm.group(1)
            s = re.sub(rb"\\([()\\])", rb"\1", raw)
            try:
                text_parts.append(s.decode("latin-1"))
            except UnicodeDecodeError:
                continue
    if not text_parts:
        raise ModalityError("pdf: no extractable text")
    return re.sub(r"\s+", " ", " ".join(text_parts)).strip()


# ---------------------------------------------------------------------------
# Inspect (stage extractor, text.rs:877-967)
# ---------------------------------------------------------------------------


def inspect_text(text: str, opts: TextOpts | None = None) -> dict:
    opts = opts or TextOpts()
    canon = _prepare(text, opts)
    toks = tokenize(canon, opts.tokenizer)
    sh = shingles_of(toks, opts.k)
    sig = textsig.minhash_signature(sh, opts.h)
    fp = textsig.serialize_minhash(sig)
    algorithm = f"minhash-h{opts.h}" if opts.h != 128 else ALGORITHM_MINHASH_128
    return {
        "algorithm": algorithm,
        "canonicalized": canon,
        "tokens": toks,
        "shingles": sh,
        "signature_u64": [int(x) for x in sig],
        "fingerprint_hex": fp.hex(),
        "fingerprint_bytes": len(fp),
        "config_hash": _opts_config_hash(algorithm, opts),
    }
