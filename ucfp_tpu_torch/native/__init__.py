"""Native (C++) host components: the WAL engine, the batch image
decoder, the text-signature hot path and the BM25 engine.

The sources are copies of ucfp_tpu/native/walstore.cpp, imgbatch.cpp,
textsig.cpp (with its generated wb_table.h) and bm25.cpp; textsig.cpp
includes the xxHash 0.8.3 header shipped beside it (xxhash.h,
BSD-2-Clause), so the native text code builds from the package's own
sources. The loaders mirror ucfp_tpu/native/__init__.py but build into
the port's ignored `_build/` directory (see ucfp_tpu_torch/_build.py).
Each returns None when the toolchain is unavailable, and the caller keeps
its pure-Python path, which gives the same bytes and scores.
"""

from __future__ import annotations

import ctypes
import functools

from .._build import build_host


@functools.lru_cache(maxsize=1)
def load_imgbatch():
    """Load (building if needed) the native batch-image decoder, or None."""
    out = build_host("imgbatch.cpp", "libucfpimgbatch.so")
    if out is None:
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    # body rides as c_char_p: ctypes passes the bytes object's internal
    # pointer without a copy
    lib.ucfp_imgbatch_probe.restype = ctypes.c_int
    lib.ucfp_imgbatch_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ucfp_imgbatch_fill.restype = ctypes.c_int
    lib.ucfp_imgbatch_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ucfp_imgbatch_resize.restype = ctypes.c_int
    lib.ucfp_imgbatch_resize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


@functools.lru_cache(maxsize=1)
def load_walstore():
    """Load (building if needed) the native WAL library, or None."""
    out = build_host("walstore.cpp", "libucfpwal.so")
    if out is None:
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    lib.ucfp_wal_open.restype = ctypes.c_void_p
    lib.ucfp_wal_open.argtypes = [ctypes.c_char_p]
    lib.ucfp_wal_append.restype = ctypes.c_int
    lib.ucfp_wal_append.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32
    ]
    lib.ucfp_wal_append_many.restype = ctypes.c_int
    lib.ucfp_wal_append_many.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
    ]
    lib.ucfp_wal_commit.restype = ctypes.c_int
    lib.ucfp_wal_commit.argtypes = [ctypes.c_void_p]
    lib.ucfp_wal_close.restype = ctypes.c_int
    lib.ucfp_wal_close.argtypes = [ctypes.c_void_p]
    lib.ucfp_wal_replace.restype = ctypes.c_int
    lib.ucfp_wal_replace.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                          ctypes.c_uint32)
    lib._replay_cb_type = CB
    lib.ucfp_wal_replay.restype = ctypes.c_long
    lib.ucfp_wal_replay.argtypes = [ctypes.c_char_p, CB, ctypes.c_void_p]
    lib.ucfp_wal_append_fixed.restype = ctypes.c_int
    lib.ucfp_wal_append_fixed.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint64,
    ]
    lib.ucfp_wal_replay_concat.restype = ctypes.c_long
    lib.ucfp_wal_replay_concat.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
    ]
    lib.ucfp_wal_buf_free.restype = None
    lib.ucfp_wal_buf_free.argtypes = [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=1)
def load_bm25():
    """Load (building if needed) the native BM25 engine, or None (callers
    keep the Python engine)."""
    out = build_host("bm25.cpp", "libucfpbm25.so")
    if out is None:
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    lib.ucfp_bm25_new.restype = ctypes.c_void_p
    lib.ucfp_bm25_free.argtypes = [ctypes.c_void_p]
    lib.ucfp_bm25_clear.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ucfp_bm25_upsert.restype = ctypes.c_int
    lib.ucfp_bm25_upsert.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.ucfp_bm25_upsert_text.restype = ctypes.c_long
    lib.ucfp_bm25_upsert_text.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
    ]
    for fn in ("ucfp_bm25_doc_count", "ucfp_bm25_total_doc_len",
               "ucfp_bm25_term_count"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ucfp_bm25_df.restype = ctypes.c_uint64
    lib.ucfp_bm25_df.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16]
    lib.ucfp_bm25_tf.restype = ctypes.c_uint32
    lib.ucfp_bm25_tf.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint64
    ]
    lib.ucfp_bm25_doc_len.restype = ctypes.c_uint32
    lib.ucfp_bm25_doc_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ucfp_bm25_search.restype = ctypes.c_long
    lib.ucfp_bm25_search.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


@functools.lru_cache(maxsize=1)
def load_textsig():
    """Load (building if needed) the native text-signature hot path
    (UAX#29 tokenize + shingle XXH3 + minhash mix/min, SimHash-TF, TLSH),
    or None (callers keep the regex/numpy pipeline)."""
    out = build_host("textsig.cpp", "libucfptextsig.so",
                     headers=("wb_table.h", "xxhash.h"))
    if out is None:
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ucfp_text_tokens.restype = ctypes.c_int64
    # text rides as c_char_p: a pointer to the bytes object, no copy
    lib.ucfp_text_tokens.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, ctypes.c_int64
    ]
    lib.ucfp_minhash_mix_min.restype = None
    lib.ucfp_minhash_mix_min.argtypes = [
        u64p, ctypes.c_int64, u64p, ctypes.c_int32, u64p
    ]
    lib.ucfp_text_minhash_sig.restype = ctypes.c_int64
    lib.ucfp_text_minhash_sig.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        u64p, ctypes.c_int32, u64p
    ]
    lib.ucfp_tlsh_128_1.restype = ctypes.c_int
    lib.ucfp_tlsh_128_1.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p
    ]
    lib.ucfp_text_simhash64_tf.restype = ctypes.c_int
    lib.ucfp_text_simhash64_tf.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, u64p
    ]
    # full-Unicode (UTF-8) UAX#29 variants over wb_table.h
    lib.ucfp_text_tokens_u8.restype = ctypes.c_int64
    lib.ucfp_text_tokens_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, ctypes.c_int64
    ]
    lib.ucfp_text_minhash_sig_u8.restype = ctypes.c_int64
    lib.ucfp_text_minhash_sig_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        u64p, ctypes.c_int32, u64p
    ]
    lib.ucfp_text_simhash64_tf_u8.restype = ctypes.c_int
    lib.ucfp_text_simhash64_tf_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, u64p
    ]
    lib.ucfp_text_graphemes_u8.restype = ctypes.c_int64
    lib.ucfp_text_graphemes_u8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, i64p, ctypes.c_int64
    ]
    lib.ucfp_text_minhash_sig_gr.restype = ctypes.c_int64
    lib.ucfp_text_minhash_sig_gr.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        u64p, ctypes.c_int32, u64p
    ]
    return lib
