"""Native (C++) host components: the WAL engine and the batch image decoder.

The sources are copies of ucfp_tpu/native/walstore.cpp and imgbatch.cpp;
the loaders mirror ucfp_tpu/native/__init__.py but build into the port's
own ignored `_build/` directory (see ucfp_tpu_torch/_build.py). Either
returns None when the toolchain is unavailable, and the caller keeps its
pure-Python path, which writes and reads the same bytes.
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
