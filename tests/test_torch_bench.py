"""ucfp_tpu_torch.bench (python -m ucfp_tpu_torch.bench) on the CPU at tiny
sizes: every ported bench function returns a finite positive number, main's
two output lines parse (the last one at most 1.5 KB, with the headline, the
device and the 10M x 64 keys), the reference's knobs act as they do there,
a key that raises ends the run, and with no card and no --device the bench
exits non-zero. The numbers themselves mean nothing on the CPU; the card's
are in PERF.md.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ucfp_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ROWS = 1 << 15  # one 32,768-row tile: the smallest catalog the fused scans take

TINY = {
    "bench_phash": {"batch": 2, "iters": 2},
    "bench_multihash": {"batch": 2, "iters": 2},
    "bench_query_p50": {"n": 4096, "iters": 2},
    "bench_hamming_10m": {"n": 4096, "iters": 2},
    "bench_cosine_int8_10m": {"n": 4096, "iters": 2},
    "bench_hamming_10m_fused": {"n": ROWS, "iters": 2},
    "bench_cosine_int8_10m_hybrid": {"n": ROWS, "iters": 2},
    "bench_cosine_int8_10m_mxu": {"n": ROWS, "iters": 2},
    "bench_cosine_int8_10m_fused": {"n": ROWS, "iters": 2},
    "bench_cosine_int8_10m_768": {"n_rows": ROWS, "d": 64, "iters": 2, "rounds": 1,
                                  "recall_q": 4, "recall_chunk": 2, "shards": 1,
                                  "qbatch": 4},
    "bench_audio_xrt": {"secs": 1.0, "iters": 2},
    "bench_audio_match": {"n_records": 1000, "per": 10, "queries": 3},
    "bench_text_minhash": {"n": 3},
}
AUDIO_KEYS = {"audio_wang_xrt", "audio_panako_xrt", "audio_haitsma_xrt",
              "audio_haitsma_fft_xrt", "audio_match_p50_ms_1m_landmarks"}
TEXT_KEYS = {"text_minhash_docs_per_sec", "text_minhash_ms_per_doc_5k6",
             "text_minhash_unicode_ms_per_doc_5k6"}
X64_KEYS = {
    "query_hamming_fused_p50_ms_10m_x64bit", "query_cosine_int8_hybrid_p50_ms_10m_x64",
    "query_cosine_int8_mxu_p50_ms_10m_x64", "query_cosine_int8_fused_p50_ms_10m_x64",
    "query_hamming_p50_ms_10m_x64bit", "query_cosine_int8_p50_ms_10m_x64",
}


def _positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.fixture
def knobs(monkeypatch):
    """The bench's knobs unset, and every bench function at its TINY size
    (over the arguments the run passes it)."""
    for name in ("UCFP_BENCH_ONLY", "UCFP_BENCH_FULL", "UCFP_BENCH_BUDGET_S"):
        monkeypatch.delenv(name, raising=False)
    for name, tiny in TINY.items():
        fn = getattr(bench, name)
        monkeypatch.setattr(bench, name, lambda dev, fn=fn, tiny=tiny, **kw: fn(
            dev, **{**kw, **tiny}))
    return monkeypatch


def _main(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("name", sorted(set(TINY) - {"bench_cosine_int8_10m_768",
                                                     "bench_text_minhash"}))
def test_bench_function_returns_a_finite_number(name):
    assert _positive(getattr(bench, name)(CPU, **TINY[name]))


@pytest.mark.parametrize("algorithm", ["wang", "panako", "haitsma", "haitsma_fft"])
def test_audio_xrt_each_algorithm(algorithm):
    assert _positive(bench.bench_audio_xrt(CPU, algorithm, **TINY["bench_audio_xrt"]))


def test_main_prints_the_x768_line_then_a_short_last_line(knobs, capsys):
    knobs.setenv("UCFP_BENCH_FULL", "1")
    lines = _main(capsys)
    assert len(lines) == 2
    x768 = json.loads(lines[0])["10m_x768"]
    for key in ("query_cosine_int8_p50_ms_10m_x768",
                "query_cosine_int8_batch32_ms_per_query_10m_x768",
                "query_cosine_int4_p50_ms_10m_x768",
                "query_cosine_int4_batch32_ms_per_query_10m_x768",
                "query_cosine_int4_batch64_ms_per_query_10m_x768",
                "query_cosine_int2_p50_ms_10m_x768",
                "query_cosine_int2_batch2_ms_per_query_10m_x768",
                "query_cosine_sketch_p50_ms_10m_x768", "sketch_fast_p50_ms_10m_x768",
                "query_sharded_per_shard_exact_p50_ms", "query_sharded_per_shard_p50_ms",
                "query_sharded_per_shard_int4_p50_ms",
                "query_sharded_per_shard_int2_p50_ms",
                "query_sharded_per_shard_int4_batch32_ms_per_query",
                "query_sharded_per_shard_int4_batch64_ms_per_query"):
        assert _positive(x768[key]), key
    for key in ("int4", "int4_batch", "int2", "int2_batch", "sketch"):
        assert 0.0 <= x768[f"{key}_recall10_random_10m_x768"] <= 1.0
        assert x768[f"{key}_recall10_ci95"] >= 0.0
    assert 0.0 <= x768["sketch_fast_recall10_random"] <= 1.0
    assert {f"sketch_top1_planted_cos{c}" for c in ("99", "7", "5")} <= set(x768)
    assert x768["sharded_rows_per_shard"] == ROWS
    assert not any(k.startswith(("query_v5e8", "query_sharded_merge")) for k in x768)

    assert len(lines[-1].encode()) <= bench.LAST_LINE_MAX
    last = json.loads(lines[-1])
    assert last["metric"] == "phash images/sec/chip" and _positive(last["value"])
    assert last["unit"] == "images/s"
    assert last["device"] == {"type": "cpu", "card": "cpu"}
    extra = last["extra"]
    assert set(extra) == X64_KEYS | AUDIO_KEYS | TEXT_KEYS | {
        "multihash_images_per_sec", "query_cosine_p50_ms_1m_x64"}
    assert all(_positive(v) for v in extra.values())


def test_default_keys_and_the_only_knob(knobs, capsys):
    knobs.setenv("UCFP_BENCH_ONLY", "mxu,fused_p50")
    lines = _main(capsys)
    assert len(lines) == 1  # no 10M x 768 key ran
    last = json.loads(lines[0])
    assert last["value"] == "skipped: not in UCFP_BENCH_ONLY"
    # the default list holds no exact comparison key
    assert set(last["extra"]) == {"query_cosine_int8_mxu_p50_ms_10m_x64",
                                  "query_cosine_int8_fused_p50_ms_10m_x64",
                                  "query_hamming_fused_p50_ms_10m_x64bit"}


def test_budget_skips_are_printed_as_skipped_never_as_numbers(knobs, capsys):
    knobs.setenv("UCFP_BENCH_BUDGET_S", "0")
    lines = _main(capsys)
    x768 = json.loads(lines[0])["10m_x768"]
    last = json.loads(lines[-1])
    assert _positive(last["value"])  # the headline runs before the budget
    skipped = {**x768, **last["extra"]}
    assert len(skipped) == 12
    assert all(v == "skipped: bench budget exhausted" for v in skipped.values())


def test_a_key_that_raises_ends_the_run(knobs, capsys):
    def broken(dev, **kw):
        raise RuntimeError("kernel launch failed")

    knobs.setenv("UCFP_BENCH_ONLY", "mxu")
    knobs.setattr(bench, "bench_cosine_int8_10m_mxu", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""  # no result line


def test_no_card_and_no_device_exits_nonzero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", "ucfp_tpu_torch.bench"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""


def test_text_minhash_key():
    """The text key (the reference's _text_minhash): three finite positive
    numbers, docs/s the inverse of ms/doc."""
    out = bench.bench_text_minhash(CPU, **TINY["bench_text_minhash"])
    assert set(out) == TEXT_KEYS and all(_positive(v) for v in out.values())
    assert abs(out["text_minhash_docs_per_sec"]
               * out["text_minhash_ms_per_doc_5k6"] - 1000.0) < 1.0
