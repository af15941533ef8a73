"""The port's BM25 engines (index/bm25.py: the Python engine and the
native bm25.cpp) against the reference's Python Bm25Engine on the same
seeded corpora.

Tolerance: none. Scores are the same doubles (BM25+ accumulated in
query-term order in both engines), so they are compared with ==, and the
order (score descending, ties to the lower record id) must be equal.
"""

import random

import pytest

from ucfp_tpu.index.bm25 import Bm25Engine as RefEngine
from ucfp_tpu.index.bm25 import tokenize as ref_tokenize
from ucfp_tpu_torch.index.bm25 import Bm25Engine, NativeBm25Engine, make_engine, tokenize
from ucfp_tpu_torch.native import load_bm25

WORDS = ("apple banana cherry date elderberry fig grape honeydew kiwi lemon "
         "mango nectarine orange peach quince raspberry strawberry tomato "
         "Äpfel naïve café straße Καλημέρα 你好 snake_case x1 42").split()


def _port_engine(kind: str):
    if kind == "python":
        return Bm25Engine()
    lib = load_bm25()
    assert lib is not None, "the g++ toolchain builds native/bm25.cpp"
    return NativeBm25Engine(lib)


@pytest.fixture(params=["python", "native"])
def pair(request):
    return _port_engine(request.param), RefEngine()


def _fill(engines, seed: int, docs: int = 80, tenants=(0, 7)):
    rng = random.Random(seed)
    for t in tenants:
        for rid in range(docs):
            # skewed draw: early words are common, late ones rare
            k = rng.randint(1, 50)
            text = " ".join(WORDS[min(int(rng.paretovariate(1.2)) - 1,
                                      len(WORDS) - 1)] for _ in range(k))
            if rid % 11 == 3:
                text = text.upper()
            for e in engines:
                e.upsert_one(t, rid, text)


def _queries(seed: int, n: int = 30):
    rng = random.Random(seed)
    qs = [rng.sample(WORDS, rng.randint(1, 5)) for _ in range(n)]
    qs += [["apple apple"], ["APPLE", "apple"], ["zzz"], [], ["a-b", "c.d"],
           ["snake_case"], [w.upper() for w in WORDS[:6]]]
    return qs


def test_tokenizer_matches_reference():
    rng = random.Random(3)
    for _ in range(200):
        s = "".join(rng.choice(WORDS + [" ", "-", "_", ".", "'", "\t"])
                    for _ in range(rng.randint(0, 12)))
        assert tokenize(s) == ref_tokenize(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_bit_equal(pair, seed):
    port, ref = pair
    _fill((port, ref), seed)
    for t in (0, 7, 99):
        for q in _queries(seed + 10):
            for k in (1, 5, 40, 200):
                a = port.search(t, q, k)
                b = ref.search(t, q, k)
                assert a == b, (t, q, k)


@pytest.mark.parametrize("seed", [0, 4])
def test_updates_and_clears(pair, seed):
    port, ref = pair
    _fill((port, ref), seed, docs=40)
    rng = random.Random(seed)
    for step in range(60):
        rid = rng.randrange(50)
        op = rng.random()
        for e in (port, ref):
            if op < 0.3:
                e.clear_one(0, rid)
            elif op < 0.4:
                e.upsert_one(0, rid, None)
            else:
                e.upsert_one(0, rid, f"{WORDS[step % 9]} cherry {WORDS[rid % 20]}")
        q = rng.sample(WORDS[:12], 2)
        assert port.search(0, q, 20) == ref.search(0, q, 20)
    assert port.stats(0) == ref.stats(0)
    terms = sorted({w.lower() for w in WORDS[:15]})
    assert port.idf_map(0, terms) == ref.idf_map(0, terms)


def test_explain_bit_equal_and_capped(pair):
    port, ref = pair
    _fill((port, ref), 5)
    # a document with more than 16 distinct query terms: explain keeps 16
    many = [f"t{i}" for i in range(24)]
    for e in (port, ref):
        e.upsert_one(0, 1000, " ".join(many * 2))
    for q in _queries(6, 10) + [many]:
        a = port.search_explain(0, q, 10)
        b = ref.search_explain(0, q, 10)
        assert [(d, s) for d, s, _ in a] == [(d, s) for d, s, _ in b]
        for (_, _, ta), (_, _, tb) in zip(a, b):
            assert [(x.term, x.idf, x.tf, x.contribution) for x in ta] == \
                   [(x.term, x.idf, x.tf, x.contribution) for x in tb]
            assert len(ta) <= 16
    top = port.search_explain(0, many, 1)
    assert top[0][0] == 1000 and len(top[0][2]) == 16


def test_make_engine_picks_native_unless_asked():
    assert isinstance(make_engine(prefer_native=True), NativeBm25Engine)
    assert isinstance(make_engine(prefer_native=False), Bm25Engine)


def test_backend_engine_follows_env(tmp_path, monkeypatch):
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend

    for env, kind in (("python", Bm25Engine), ("native", NativeBm25Engine)):
        monkeypatch.setenv("UCFP_BM25", env)
        b = EmbeddedBackend(str(tmp_path / env), device="cpu")
        try:
            assert isinstance(b._bm25, kind)
        finally:
            b.close()
