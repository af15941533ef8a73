"""The port's audio records and audio index (ucfp_tpu_torch.modality.audio,
the audio side of ucfp_tpu_torch.index.embedded) against ucfp_tpu's on the
CPU.

Tolerance: bit-equal. Records (fingerprint bytes, config_hash) are
integers; knn_audio's scores are the same float64 ratios of integer vote
counts; knn_haitsma's scores are 1 - (the same float32 BER) in float64.
Hits compare as (record_id, score, source) tuples with ==.
"""

import asyncio
import json
import pathlib

import numpy as np
import pytest
import torch
from test_conformance import d, fixed_audio
from test_torch_index import Pair, hits, run

from ucfp_tpu.core import Record as JRecord
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu.modality import audio as jam
from ucfp_tpu_torch.core import Modality, Record
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.modality import audio as tam
from ucfp_tpu_torch.parallel import mesh as TM

CPU8 = [torch.device("cpu")] * 8
GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "goldens" / "conformance.json").read_text())
WANG, PANAKO, HAITSMA = tam.ALGORITHM_WANG, tam.ALGORITHM_PANAKO, tam.ALGORITHM_HAITSMA


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")


def _same_record(j, t):
    assert (t.tenant_id, t.record_id, t.modality.value, t.algorithm, t.fingerprint,
            t.config_hash) == (j.tenant_id, j.record_id, j.modality.value, j.algorithm,
                               j.fingerprint, j.config_hash)


def test_conformance_digests():
    """The 8 non-neural audio goldens (tests/test_conformance.py's corpus)."""
    x, short = fixed_audio(), fixed_audio(secs=1.0)
    got = {
        "audio/wang/8k": tam.fingerprint_wang(x, 8000, 0, 1, device="cpu"),
        "audio/wang/16k-resampled": tam.fingerprint_wang(np.repeat(x, 2), 16000, 0, 1,
                                                         device="cpu"),
        "audio/panako/8k": tam.fingerprint_panako(x, 8000, 0, 1, device="cpu"),
        "audio/haitsma/8k": tam.fingerprint_haitsma(x, 8000, 0, 1, device="cpu"),
        "audio/wang/1s": tam.fingerprint_wang(short, 8000, 0, 1, device="cpu"),
        "audio/haitsma/44k1-resampled": tam.fingerprint_haitsma(
            fixed_audio(secs=2.0, sr=44100), 44100, 0, 1, device="cpu"),
        "audio/wang/tuned": tam.fingerprint_wang(
            x, 8000, 0, 1, tam.WangConfig(fan_out=4, target_zone_t=32, target_zone_f=32,
                                          peaks_per_sec=15, min_anchor_mag_db=-40.0),
            device="cpu"),
        "audio/haitsma/tuned": tam.fingerprint_haitsma(
            x, 8000, 0, 1, tam.HaitsmaConfig(fmin=200.0, fmax=1800.0), device="cpu"),
    }
    assert {k: d(r.fingerprint) for k, r in got.items()} == {k: GOLDEN[k] for k in got}
    assert set(got) == {k for k in GOLDEN if k.startswith("audio/") and "neural" not in k}


@pytest.mark.parametrize("case", ["wang", "wang-lf", "wang-22k", "panako", "haitsma",
                                  "haitsma-fft", "haitsma-band"])
def test_records_and_config_hash_equal(case):
    x = fixed_audio(secs=2.0)
    if case.startswith("wang"):
        sr = 22050 if case == "wang-22k" else 8000
        clip = tam.dsp.resample_linear(x, 8000, sr) if sr != 8000 else x
        lf = case == "wang-lf"
        j = jam.fingerprint_wang(clip, sr, 3, 9, jam.WangConfig(local_floor=lf))
        t = tam.fingerprint_wang(clip, sr, 3, 9, tam.WangConfig(local_floor=lf),
                                 device="cpu")
    elif case == "panako":
        j = jam.fingerprint_panako(x, 8000, 3, 9, jam.PanakoConfig(fan_out=3))
        t = tam.fingerprint_panako(x, 8000, 3, 9, tam.PanakoConfig(fan_out=3), device="cpu")
    else:
        kw = {"haitsma-fft": {"fft": True}, "haitsma-band": {"fmin": 250.0, "fmax": 1500.0}
              }.get(case, {})
        j = jam.fingerprint_haitsma(x, 8000, 3, 9, jam.HaitsmaConfig(**kw))
        t = tam.fingerprint_haitsma(x, 8000, 3, 9, tam.HaitsmaConfig(**kw), device="cpu")
    _same_record(j, t)


@pytest.mark.parametrize("algorithm", ["wang", "panako", "haitsma"])
def test_fingerprint_audio_batch_equal(algorithm):
    """Mixed lengths (two groups), f32 and the s16 wire form."""
    rng = np.random.default_rng(4)
    x = fixed_audio(secs=1.5)
    clips = [x, x[::-1].copy(), (x * 0.5)[:8000], rng.normal(0, 0.2, 12000).astype(np.float32)]
    s16 = [np.round(c * 20000).astype(np.int16) for c in clips]
    for batch in (clips, s16):
        want = jam.fingerprint_audio_batch(algorithm, batch, 8000, 1, [5, 6, 7, 8])
        got = tam.fingerprint_audio_batch(algorithm, batch, 8000, 1, [5, 6, 7, 8],
                                          device="cpu")
        for j, t in zip(want, got):
            _same_record(j, t)


def test_watermark_detect_equal():
    x = fixed_audio(secs=5.0)
    cfg_j = jam.WatermarkConfig(key="tenant-secret")
    marked = jam.embed_watermark(x, 8000, 0xBEEF, cfg_j)
    for clip, key in ((marked, "tenant-secret"), (marked, "wrong"), (x, "tenant-secret")):
        a = jam.detect_watermark(clip, 8000, jam.WatermarkConfig(key=key))
        b = tam.detect_watermark(clip, 8000, tam.WatermarkConfig(key=key))
        assert (a.detected, a.payload, a.confidence) == (b.detected, b.payload, b.confidence)


def _audio_rows():
    """(algorithm, record_id, fingerprint) rows: 12 clips per algorithm
    (distinct tones and noise), plus their query excerpts."""
    rng = np.random.default_rng(12)
    rows, queries = [], {}
    t = np.arange(int(4.0 * 8000)) / 8000
    clips = []
    for i in range(12):
        f0, f1 = 300 + 97 * i, 900 + 131 * i
        x = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * f1 * t)
             * (np.sin(2 * np.pi * (0.3 + 0.1 * i) * t) > 0)
             + rng.normal(0, 0.05, t.size)).astype(np.float32)
        clips.append(x)
    for alg, fn in ((WANG, tam.fingerprint_wang), (PANAKO, tam.fingerprint_panako),
                    (HAITSMA, tam.fingerprint_haitsma)):
        base = {WANG: 100, PANAKO: 200, HAITSMA: 300}[alg]
        for i, x in enumerate(clips):
            rows.append((alg, base + i, fn(x, 8000, 0, base + i, device="cpu").fingerprint))
        queries[alg] = [fn(clips[i][8000 + 800 * i:24000], 8000, 0, 0,
                           device="cpu").fingerprint for i in (0, 5, 11)]
    return rows, queries


_ROWS = None


def rows_and_queries():
    global _ROWS
    if _ROWS is None:
        _ROWS = _audio_rows()
    return _ROWS


def _upsert(p: Pair, rows, per_record: bool = False):
    recs = [dict(tenant_id=0, record_id=rid, modality="audio", algorithm=alg,
                 fingerprint=fp) for alg, rid, fp in rows]
    if per_record:
        for r in recs:
            p.both("upsert", [r])
    else:
        p.both("upsert", recs)


def _check_audio(p: Pair, queries, ks=(1, 5, 20)):
    out = {}
    for alg, qs in queries.items():
        for k in ks:
            for q in qs:
                if alg == HAITSMA:
                    out[(alg, k, q)] = p.same("knn_haitsma", 0, q, k)
                else:
                    out[(alg, k, q)] = p.same("knn_audio", 0, alg, q, k)
    return out


@pytest.mark.parametrize("engine", ["native", "json"])
def test_knn_audio_and_haitsma_same_hits(tmp_path, engine):
    rows, queries = rows_and_queries()
    p = Pair(tmp_path, engine)
    try:
        _upsert(p, rows)
        res = _check_audio(p, queries)
        # each excerpt finds its clip at rank 1
        for alg, base in ((WANG, 100), (PANAKO, 200), (HAITSMA, 300)):
            for q, i in zip(queries[alg], (0, 5, 11)):
                assert res[(alg, 5, q)][0].record_id == base + i
        # the padded-stream and landmark paths agree on edge queries
        for q in (b"", b"\x01\x02\x03", b"\x00" * 4, rows[-1][2] * 3):
            p.same("knn_haitsma", 0, q, 3)
        for q in (b"", b"\x00" * 4, b"\x00" * 8, rows[0][2] * 2):
            p.same("knn_audio", 0, WANG, q, 3)
        p.same("knn_audio", 0, WANG, queries[WANG][0], 0)
        p.same("knn_audio", 1, WANG, queries[WANG][0], 3)  # empty tenant
    finally:
        p.close()


def test_updates_and_deletes_keep_the_indexes_equal(tmp_path):
    rows, queries = rows_and_queries()
    p = Pair(tmp_path, "native")
    try:
        _upsert(p, rows, per_record=True)
        # re-tag a haitsma record as wang (the stream leaves the cache) and
        # a wang record as haitsma, then a misaligned haitsma fingerprint
        swap = [dict(tenant_id=0, record_id=300, modality="audio", algorithm=WANG,
                     fingerprint=rows[0][2]),
                dict(tenant_id=0, record_id=101, modality="audio", algorithm=HAITSMA,
                     fingerprint=rows[-1][2]),
                dict(tenant_id=0, record_id=305, modality="audio", algorithm=HAITSMA,
                     fingerprint=b"\x01\x02\x03")]
        p.both("upsert", swap)
        p.both("delete", 0, [100, 211, 311, 999])
        _check_audio(p, queries, ks=(3, 12))
        assert p.t._haitsma[0].n == p.j._haitsma[0].n
    finally:
        p.close()


def test_reference_data_dir_reopens_with_audio(tmp_path):
    rows, queries = rows_and_queries()
    j = JBackend(str(tmp_path))
    run(j.upsert([JRecord(tenant_id=0, record_id=rid, modality=jam.Modality.AUDIO,
                          algorithm=alg, fingerprint=fp) for alg, rid, fp in rows]))
    run(j.delete(0, [102, 303]))
    j.close()
    j = JBackend(str(tmp_path))
    t = EmbeddedBackend(str(tmp_path), device="cpu")
    try:
        for alg, qs in queries.items():
            for q in qs:
                if alg == HAITSMA:
                    assert hits(run(j.knn_haitsma(0, q, 7))) == hits(run(t.knn_haitsma(0, q, 7)))
                else:
                    assert hits(run(j.knn_audio(0, alg, q, 7))) == \
                        hits(run(t.knn_audio(0, alg, q, 7)))
        assert j.list_records(0, 0, 100) == t.list_records(0, 0, 100)
    finally:
        j.close()
        t.close()


def test_sharded_haitsma_equals_unsharded(tmp_path):
    rows, queries = rows_and_queries()
    recs = [Record(tenant_id=0, record_id=rid, modality=Modality.AUDIO, algorithm=alg,
                   fingerprint=fp) for alg, rid, fp in rows]
    plain = EmbeddedBackend(str(tmp_path / "a"), device="cpu")
    mesh = EmbeddedBackend(str(tmp_path / "b"), device="cpu",
                           mesh=TM.data_mesh(8, devices=CPU8))
    try:
        for b in (plain, mesh):
            run(b.upsert(recs))
            run(b.delete(0, [304]))
        for q in queries[HAITSMA]:
            for k in (1, 4, 50):
                assert hits(run(plain.knn_haitsma(0, q, k))) == \
                    hits(run(mesh.knn_haitsma(0, q, k)))
        data, lens = mesh._device_haitsma(mesh._haitsma[0])
        assert len(data.shards) == 8 and len(lens.shards) == 8
    finally:
        plain.close()
        mesh.close()


def test_fingerprints_queries_batch_equal_singles(tmp_path):
    rows, queries = rows_and_queries()
    b = EmbeddedBackend(str(tmp_path), device="cpu")
    try:
        run(b.upsert([Record(tenant_id=0, record_id=rid, modality=Modality.AUDIO,
                             algorithm=alg, fingerprint=fp) for alg, rid, fp in rows]))
        singles = [hits(run(b.knn_haitsma(0, q, 4))) for q in queries[HAITSMA]]

        async def together():
            return await asyncio.gather(*(b.knn_haitsma(0, q, 4) for q in queries[HAITSMA]))

        assert [hits(r) for r in run(together())] == singles
    finally:
        b.close()
