"""Machine-readable algorithms catalog for GET /v1/algorithms.

Drives the playground UI exactly like the reference's manifest
(src/server/algorithms_manifest.rs): every algorithm lists its tunables
(name/label/help/kind/min/max/step/enum_values/default) and presets.
Defaults mirror the reference's ground-truth values: text k 1-16 / h
16-1024, image preprocess {50 MiB, 8192, 32}, Wang {10, 63, 64, 30, -50},
Panako {5, 96, 96, 30, -50}, Haitsma {300 Hz, 2000 Hz, "312 B/sec"}.

Copied from ucfp_tpu/server/manifest.py; only its imports differ.
"""

from __future__ import annotations


def _tunable(name, label, help, kind, default, min=None, max=None, step=None,
             enum_values=None):
    t = {"name": name, "label": label, "help": help, "kind": kind,
         "default": default}
    if min is not None:
        t["min"] = min
    if max is not None:
        t["max"] = max
    if step is not None:
        t["step"] = step
    if enum_values is not None:
        t["enum_values"] = enum_values
    return t


def _text_common():
    return [
        _tunable("tokenizer", "Tokenizer", "word | grapheme | char | cjk", "enum",
                 "word", enum_values=["word", "grapheme", "char", "cjk"]),
        _tunable("preprocess", "Preprocess", "optional html/markdown strip",
                 "enum", None, enum_values=[None, "html", "markdown"]),
        _tunable("canon_normalization", "Normalization", "Unicode normalization",
                 "enum", "nfkc", enum_values=["nfc", "nfkc", "none"]),
        _tunable("canon_case_fold", "Case fold", "simple case folding", "bool", True),
        _tunable("canon_strip_bidi", "Strip bidi", "drop bidi controls", "bool", True),
        _tunable("canon_strip_format", "Strip format", "drop Cf chars", "bool", True),
        _tunable("canon_confusable", "Confusables", "UTS#39-style homoglyph map",
                 "bool", False),
    ]


def build_manifest() -> dict:
    wang_tunables = [
        _tunable("fan_out", "Fan-out", "targets per anchor", "int", 10, 1, 32, 1),
        _tunable("target_zone_t", "Zone Δt", "max frames ahead", "int", 63, 1, 256, 1),
        _tunable("target_zone_f", "Zone Δf", "max bin distance", "int", 64, 1, 256, 1),
        _tunable("peaks_per_sec", "Peaks/sec", "per-second peak cap", "int",
                 30, 1, 120, 1),
        _tunable("min_anchor_mag_db", "Floor (dB)", "magnitude floor vs max",
                 "float", -50.0, -120.0, 0.0, 1.0),
        _tunable("local_floor", "Per-slab floor",
                 "floor relative to each second's max (robust to loud "
                 "unrelated passages)", "bool", False),
    ]
    return {
        "format_version": 1,
        "text": {
            "algorithms": [
                {
                    "id": "minhash",
                    "algorithm": "minhash-h128",
                    "label": "MinHash",
                    "tunables": [
                        _tunable("k", "Shingle width", "tokens per shingle",
                                 "int", 5, 1, 16, 1),
                        _tunable("h", "Hash count", "signature slots", "int",
                                 128, 16, 1024, 16),
                        *_text_common(),
                    ],
                    "presets": {
                        "balanced": {"k": 5, "h": 128},
                        "high-recall": {"k": 3, "h": 256},
                        "fast": {"k": 7, "h": 64},
                    },
                },
                {"id": "simhash-tf", "algorithm": "simhash-b64-tf",
                 "label": "SimHash (TF)", "tunables": _text_common()},
                {"id": "simhash-idf", "algorithm": "simhash-b64-idf",
                 "label": "SimHash (TF-IDF)", "tunables": _text_common()},
                {"id": "lsh", "algorithm": "minhash-lsh-h128",
                 "label": "Banded LSH",
                 "tunables": [
                     *_text_common(),
                 ]},
                {"id": "tlsh", "algorithm": "tlsh-128-1", "label": "TLSH",
                 "tunables": _text_common(),
                 "notes": "requires >= 50 input bytes"},
                {"id": "semantic", "algorithm": "embedding-local",
                 "label": "Semantic embedding",
                 "tunables": [
                     _tunable("provider", "Provider",
                              "local | openai | voyage | cohere", "enum",
                              "local",
                              enum_values=["local", "openai", "voyage", "cohere"]),
                 ]},
            ],
        },
        "image": {
            "preprocess": [
                _tunable("max_input_bytes", "Max bytes", "reject larger uploads",
                         "int", 50 * 1024 * 1024, 1024, 512 * 1024 * 1024, 1024),
                _tunable("max_dimension", "Max dimension",
                         "downscale longest edge above this", "int",
                         8192, 64, 16384, 1),
                _tunable("min_dimension", "Min dimension",
                         "reject smaller inputs", "int", 32, 1, 1024, 1),
            ],
            "algorithms": [
                {"id": "multi", "algorithm": "imgfprint-multi-v1",
                 "label": "Multi-hash bundle",
                 "tunables": [
                     _tunable("phash_weight", "pHash weight", "", "float",
                              0.4, 0.0, 1.0, 0.05),
                     _tunable("dhash_weight", "dHash weight", "", "float",
                              0.3, 0.0, 1.0, 0.05),
                     _tunable("ahash_weight", "aHash weight", "", "float",
                              0.1, 0.0, 1.0, 0.05),
                     _tunable("global_weight", "Histogram weight", "", "float",
                              0.1, 0.0, 1.0, 0.05),
                     _tunable("block_weight", "Block weight", "", "float",
                              0.1, 0.0, 1.0, 0.05),
                     _tunable("block_distance_threshold", "Block threshold",
                              "Hamming match threshold", "int", 12, 0, 64, 1),
                 ]},
                {"id": "phash", "algorithm": "imgfprint-phash-v1",
                 "label": "Perceptual hash (DCT)", "tunables": []},
                {"id": "dhash", "algorithm": "imgfprint-dhash-v1",
                 "label": "Difference hash", "tunables": []},
                {"id": "ahash", "algorithm": "imgfprint-ahash-v1",
                 "label": "Average hash", "tunables": []},
                {"id": "semantic", "algorithm": "embedding-image-local",
                 "label": "Semantic embedding (CLIP-class)", "tunables": []},
            ],
        },
        "audio": {
            "algorithms": [
                {"id": "wang", "algorithm": "audiofp-wang-v1",
                 "label": "Wang landmarks", "tunables": wang_tunables},
                {"id": "panako", "algorithm": "audiofp-panako-v1",
                 "label": "Panako triplets (tempo-invariant ±5%)",
                 "tunables": [
                     _tunable("fan_out", "Fan-out", "targets per anchor",
                              "int", 5, 1, 32, 1),
                     _tunable("target_zone_t", "Zone Δt", "max frames ahead",
                              "int", 96, 1, 256, 1),
                     _tunable("target_zone_f", "Zone Δf", "max bin distance",
                              "int", 96, 1, 256, 1),
                     _tunable("peaks_per_sec", "Peaks/sec", "", "int",
                              30, 1, 120, 1),
                     _tunable("min_anchor_mag_db", "Floor (dB)", "", "float",
                              -50.0, -120.0, 0.0, 1.0),
                 ]},
                {"id": "haitsma", "algorithm": "audiofp-haitsma-v1",
                 "label": "Haitsma robust hash (312 B/sec)",
                 "tunables": [
                     _tunable("fmin", "Min freq (Hz)", "", "float",
                              300.0, 50.0, 2000.0, 10.0),
                     _tunable("fmax", "Max freq (Hz)", "", "float",
                              2000.0, 500.0, 2500.0, 10.0),
                     _tunable("fft", "Integer FFT", "ucfp-int-fft-v1 "
                              "staged spectrogram (different exactness "
                              "spec; forks config_hash)", "bool", False),
                 ]},
                {"id": "neural", "algorithm": "audiofp-neural-v1",
                 "label": "Neural log-mel embedding", "tunables": []},
                {"id": "watermark", "algorithm": "audiofp-watermark-v1",
                 "label": "Watermark detection",
                 "tunables": [
                     _tunable("threshold", "Threshold", "detection threshold",
                              "float", 0.5, 0.0, 1.0, 0.01),
                 ]},
            ],
        },
    }
