"""The port's text modality (modality/text.py, ops/textsig.py and the
native textsig.cpp) against ucfp_tpu on the same inputs.

  * all 18 text/* digests of tests/goldens/conformance.json through the
    port on the CPU (text/semantic/long too: the stand-in text encoder is
    host feature hashing, so it is exact);
  * canonicalize and the four tokenizers equal to the reference's;
  * the native and the Python paths of the port byte-equal;
  * SimHash-IDF with corpus statistics from the port's BM25 engine equal
    to the reference's with its own.

Tolerance: none; every comparison is byte or token equality.
"""

import json
import pathlib
import random

import pytest
from test_conformance import LONG_TEXT, PANGRAM, UNICODE_TEXT, d

from ucfp_tpu.modality import text as rtext
from ucfp_tpu_torch.modality import text as ttext
from ucfp_tpu_torch.ops import textsig

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "goldens" / "conformance.json").read_text()
)

UAX = ("don't e-mail rock 'n' roll 1,234.56 items can't-do "
       "naïve café-au-lait O'Brien's 3.14159")
EMOJI = ("family \U0001F468‍\U0001F469‍\U0001F467 flag "
         "\U0001F1FA\U0001F1F8 thumbs \U0001F44D\U0001F3FD done")
HTML = f"<html><body><p>{LONG_TEXT}</p></body></html>"


def _corpus(m):
    """text/* key -> record, built with module m (port or reference),
    the inputs of tests/test_conformance.build_corpus."""
    T = m.TextOpts
    return {
        "text/minhash/pangram": lambda: m.fingerprint_minhash(PANGRAM, 0, 1),
        "text/minhash/long": lambda: m.fingerprint_minhash(LONG_TEXT, 0, 1),
        "text/minhash/unicode": lambda: m.fingerprint_minhash(UNICODE_TEXT, 0, 1),
        "text/minhash/h64-k3": lambda: m.fingerprint_minhash(
            LONG_TEXT, 0, 1, T(h=64, k=3)),
        "text/minhash/grapheme": lambda: m.fingerprint_minhash(
            PANGRAM, 0, 1, T(tokenizer="grapheme")),
        "text/simhash-tf/long": lambda: m.fingerprint_simhash(LONG_TEXT, 0, 1),
        "text/simhash-idf/long": lambda: m.fingerprint_simhash(
            LONG_TEXT, 0, 1, idf={"quick": 2.0, "jump": 3.0}),
        "text/tlsh/long": lambda: m.fingerprint_tlsh(LONG_TEXT, 0, 1),
        "text/lsh/pangram": lambda: m.fingerprint_lsh(PANGRAM, 0, 1),
        "text/semantic/long": lambda: m.fingerprint_semantic(LONG_TEXT, 0, 1),
        "text/minhash/nfc-nofold": lambda: m.fingerprint_minhash(
            UNICODE_TEXT, 0, 1, T(normalization="nfc", case_fold=False)),
        "text/minhash/confusables": lambda: m.fingerprint_minhash(
            "сар fits like a cap", 0, 1, T(apply_confusable=True)),
        "text/minhash/cjk": lambda: m.fingerprint_minhash(
            "北京大学的计算机科学课程非常好", 0, 1, T(tokenizer="cjk", k=3)),
        "text/minhash/char-tok": lambda: m.fingerprint_minhash(
            PANGRAM, 0, 1, T(tokenizer="char")),
        "text/tlsh/pangram-x4": lambda: m.fingerprint_tlsh(PANGRAM * 4, 0, 1),
        "text/minhash/uax29": lambda: m.fingerprint_minhash(UAX, 0, 1, T(k=2)),
        "text/minhash/grapheme-emoji": lambda: m.fingerprint_minhash(
            EMOJI, 0, 1, T(tokenizer="grapheme", k=3)),
        "text/minhash/html-preprocess": lambda: m.fingerprint_minhash(
            HTML, 0, 1, T(preprocess="html")),
    }


KEYS = sorted(_corpus(ttext))


def _no_native(monkeypatch):
    monkeypatch.setattr(textsig, "_native_textsig", lambda: None)


def test_every_text_golden_is_covered():
    assert set(KEYS) == {k for k in GOLDEN if k.startswith("text/")}
    assert len(KEYS) == 18


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("key", KEYS)
def test_text_digest(key, path, monkeypatch):
    if path == "python":
        _no_native(monkeypatch)
    rec = _corpus(ttext)[key]()
    assert d(rec.fingerprint) == GOLDEN[key]
    ref = _corpus(rtext)[key]()
    assert (rec.algorithm, rec.config_hash, rec.text, rec.model_id,
            rec.embedding) == (ref.algorithm, ref.config_hash, ref.text,
                               ref.model_id, ref.embedding)


def _random_texts(seed: int, n: int = 60):
    rng = random.Random(seed)
    pieces = ["The", "quick", "Brown", "fox's", "e-mail", "1,234.5", "naïve",
              "Straße", "ﬁne", "Ｈｅｌｌｏ", "‮", "​", "Ḱ",
              "北京大学", "ひらがな", "한국어", "👍🏽", "сар", "_snake_", "l'objectif",
              "3.14", "—", "\t", "  ", "\n", "'a", "don't", "ABC.def"]
    return [" ".join(rng.choice(pieces) for _ in range(rng.randint(0, 30)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_canonicalize_and_tokenizers(seed):
    for text in _random_texts(seed):
        for opts in (dict(), dict(normalization="nfc", case_fold=False),
                     dict(normalization="none", strip_bidi=False,
                          strip_format=False, apply_confusable=True)):
            a = ttext.canonicalize(text, ttext.TextOpts(**opts))
            b = rtext.canonicalize(text, rtext.TextOpts(**opts))
            assert a == b
            for kind in ("word", "grapheme", "cjk", "char"):
                assert ttext.tokenize(a, kind) == rtext.tokenize(b, kind)


@pytest.mark.parametrize("seed", [2, 3])
def test_native_and_python_paths_byte_equal(seed, monkeypatch):
    texts = [t for t in _random_texts(seed, 40) if t.strip()]
    texts += [LONG_TEXT * 4, PANGRAM]

    def records():
        out = []
        for i, text in enumerate(texts):
            for fn, opts in ((ttext.fingerprint_minhash, {}),
                             (ttext.fingerprint_minhash, {"tokenizer": "grapheme", "k": 2}),
                             (ttext.fingerprint_simhash, {}),
                             (ttext.fingerprint_tlsh, {})):
                try:
                    out.append(fn(text, 0, i, ttext.TextOpts(**opts)).fingerprint)
                except Exception as e:  # noqa: BLE001 - errors must match too
                    out.append(type(e).__name__ + str(e))
        return out

    native = records()
    _no_native(monkeypatch)
    assert records() == native


def test_simhash_idf_with_corpus_stats(tmp_path):
    """SimHash-IDF weighted by the tenant's BM25 IDF, the port's backend
    against the reference's, on the same corpus."""
    from ucfp_tpu.index.embedded import EmbeddedBackend as RBackend
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend as TBackend

    docs = [" ".join(random.Random(i).choices(
        PANGRAM.split() + ["snake_case", "Zebra", "jugs"], k=20)) for i in range(30)]
    t = TBackend(str(tmp_path / "t"), device="cpu")
    r = RBackend(str(tmp_path / "r"))
    try:
        import asyncio

        asyncio.run(t.upsert([ttext.fingerprint_minhash(x, 0, i) for i, x in enumerate(docs)]))
        asyncio.run(r.upsert([rtext.fingerprint_minhash(x, 0, i) for i, x in enumerate(docs)]))
        for text in (LONG_TEXT, PANGRAM + " snake_case zebra", UNICODE_TEXT):
            terms = ttext.terms_of(text)
            assert terms == rtext.terms_of(text)
            idf_t = t.bm25_idf_map(0, terms)
            assert idf_t == r.bm25_idf_map(0, terms)
            a = ttext.fingerprint_simhash(text, 0, 1, idf=idf_t)
            b = rtext.fingerprint_simhash(text, 0, 1, idf=idf_t)
            assert a.fingerprint == b.fingerprint and a.algorithm == b.algorithm
    finally:
        t.close()
        r.close()


def test_streaming_minhash_session_equals_one_shot():
    sess = ttext.StreamingMinHashSession(0, 9)
    for i in range(0, len(LONG_TEXT), 23):
        sess.push(LONG_TEXT[i:i + 23])
    rec = sess.finalize()
    assert rec.fingerprint == rtext.fingerprint_minhash(LONG_TEXT, 0, 9).fingerprint
    with pytest.raises(Exception):
        sess.push("more")
