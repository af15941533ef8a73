"""ASan/UBSan (or TSan) run over the port's five native C++ modules:
the WAL engine (walstore.cpp), the batch image decoder (imgbatch.cpp),
the text signatures (textsig.cpp), BM25 (bm25.cpp) and the epoll HTTP
front (httpfront.cpp).

    python -m ucfp_tpu_torch.native.sanitize            # address,undefined
    python -m ucfp_tpu_torch.native.sanitize address    # ASan only
    python -m ucfp_tpu_torch.native.sanitize thread     # TSan

The launcher builds the sanitized `.san.so` libraries into `_build/`
(UCFP_NATIVE_SANITIZE, _build.build_host) and runs the driver
(`--drive`) in a subprocess with the sanitizer's runtime preloaded and
halt-on-error set; it exits with the driver's code. The driver imports
neither torch nor jax (their runtimes are not sanitizer-clean and would
drown the reports) and drives each module hard: the WAL's appends,
bulk replay, torn tails, rewrites and group commit under eight threads;
BM25 with hostile inputs and under a lock from six threads; the HTTP
front with hostile framing and concurrent clients; the image decoder's
frame errors and resizes; the text scanners over malformed UTF-8.
Prints SANITIZE_DRIVER_OK last when everything held. Copied from
scripts/native_sanitize_driver.py, with the port's imports.
"""

from __future__ import annotations

import ctypes
import os
import random
import socket
import subprocess
import sys
import tempfile
import threading


def drive_wal() -> None:
    from ucfp_tpu_torch.index.wal import open_wal

    d = tempfile.mkdtemp()
    path = os.path.join(d, "t.wal")
    w = open_wal(path, "native")
    rng = random.Random(0)
    evs = []
    for i in range(300):
        evs.append({
            "op": "upsert", "tenant_id": i % 7, "record_id": i,
            "modality": "text", "algorithm": "raw",
            "fingerprint": bytes(rng.randbytes(rng.randrange(0, 512))),
            "embedding": [rng.random() for _ in range(rng.randrange(0, 16))] or None,
            "model_id": None, "metadata": b"m" * (i % 33), "text": "t" * (i % 65),
            "config_hash": rng.randrange(0, 2**63), "format_version": 1,
        })
    w.append_events(evs[:150])
    w.append_events(evs[150:])
    w.flush()
    w.close()
    w2 = open_wal(path, "native")
    got = list(w2.replay())
    assert len(got) == 300, len(got)
    # bulk concat replay (ucfp_wal_replay_concat): same frames, one
    # C crossing — exercise the malloc'd buffer path under ASan
    from ucfp_tpu_torch.index.wal import fp_run_events

    flat = []
    for kind, payload in w2.replay_groups():
        flat.extend(fp_run_events(payload) if kind == "fp_run"
                    else payload)
    assert len(flat) == 300, len(flat)
    # torn tail: truncate mid-frame, replay must drop the tail only
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 13)
    w2.close()
    w3 = open_wal(path, "native")
    got2 = list(w3.replay())
    assert 0 < len(got2) < 300
    flat2 = []
    for kind, payload in w3.replay_groups():
        flat2.extend(fp_run_events(payload) if kind == "fp_run"
                     else payload)
    assert len(flat2) == len(got2)
    w3.rewrite(evs[:42])
    w3.append_events(evs[42:50])
    # fixed-length block append (ucfp_wal_append_fixed): the compaction
    # fast path — exercise header/CRC framing per block frame under ASan
    from ucfp_tpu_torch.index.wal import encode_fp_run_block

    block, frame_len, cnt = encode_fp_run_block(
        3, "image", [1000 + i for i in range(20)],
        [bytes([i] * 16) for i in range(20)], algorithm="raw")
    w3.append_block_nosync(block, frame_len, cnt)
    w3.flush()
    w3.close()
    w4 = open_wal(path, "native")
    assert len(list(w4.replay())) == 70
    w4.close()
    print("wal ok")


def drive_bm25() -> None:
    from ucfp_tpu_torch.index.bm25 import make_engine

    eng = make_engine(prefer_native=True)
    assert type(eng).__name__ == "NativeBm25Engine", type(eng)
    rng = random.Random(1)
    words = ["alpha", "beta", "gamma", "delta", "fox", "dog", "zeta",
             "sigma", "tau", "quick", "brown", "lazy"]
    for rid in range(500):
        text = " ".join(rng.choices(words, k=rng.randrange(1, 60)))
        eng.upsert_one(rid % 5, rid, text)
    for rid in range(0, 500, 7):
        eng.clear_one(rid % 5, rid)
    for rid in range(0, 500, 11):  # re-upsert replaces tf
        eng.upsert_one(rid % 5, rid, "fox fox fox unique" + str(rid))
    for t in range(5):
        res = eng.search_explain(t, ["fox", "dog", "nonexistent"], 25)
        for _d, s, th in res:
            assert s > 0 and len(th) <= 16
    # hostile inputs
    eng.upsert_one(0, 9001, "\x00\xff bin\xc3\xa9 " * 40)
    eng.upsert_one(0, 9002, "x" * 10_000)
    eng.search(0, ["biné", "x" * 300], 5)
    print("bm25 ok")


def drive_httpfront() -> None:
    from ucfp_tpu_torch.native import UcfpHttpReq, load_httpfront

    lib = load_httpfront()
    assert lib is not None, "httpfront failed to build"
    h = lib.ucfp_http_start(b"127.0.0.1", 0, 1 << 20)
    assert h
    port = lib.ucfp_http_port(h)
    stop = threading.Event()

    def responder():
        raw = UcfpHttpReq()
        while not stop.is_set():
            rc = lib.ucfp_http_next(h, 50, ctypes.byref(raw))
            if rc <= 0:
                continue
            body = b'{"ok":true}'
            lib.ucfp_http_respond(
                h, raw.id, 200, b"OK", b"application/json",
                body, len(body), 0,
            )
            lib.ucfp_http_free_req(ctypes.byref(raw))

    t = threading.Thread(target=responder, daemon=True)
    t.start()
    for i in range(50):
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        payload = b"x" * (i * 37 % 900)
        s.sendall(
            b"POST /v1/echo HTTP/1.1\r\nHost: a\r\nContent-Length: "
            + str(len(payload)).encode() + b"\r\nConnection: close\r\n\r\n"
            + payload
        )
        data = b""
        while b"}" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        assert b"200 OK" in data, data[:80]
        s.close()
    # hostile framing: oversized header, garbage request line, huge
    # content-length, abrupt disconnects
    for hostile in [
        b"GARBAGE\r\n\r\n",
        b"GET / HTTP/1.1\r\n" + b"X: " + b"y" * 100_000 + b"\r\n\r\n",
        b"POST / HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n",
        b"GET / HT",
    ]:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(hostile)
            s.settimeout(1.0)
            try:
                s.recv(4096)
            except socket.timeout:
                pass
            s.close()
        except OSError:
            pass
    stop.set()
    t.join(timeout=5)
    lib.ucfp_http_stop(h)
    print("httpfront ok")


def _ev(rid: int) -> dict:
    return {
        "op": "upsert", "tenant_id": rid % 5, "record_id": rid,
        "modality": "text", "algorithm": "raw",
        "fingerprint": bytes([rid % 251, (rid >> 8) % 251]),
        "embedding": None, "model_id": None, "metadata": b"",
        "text": None, "config_hash": 0, "format_version": 1,
    }


def drive_wal_concurrent() -> None:
    """Group-commit under contention: N appender threads + the dedicated
    sync thread + a concurrent rewrite (quiesce) — the exact thread
    topology production runs (GroupCommitWal over the native engine)."""
    from ucfp_tpu_torch.index.wal import GroupCommitWal, open_wal

    d = tempfile.mkdtemp()
    path = os.path.join(d, "gc.wal")
    w = GroupCommitWal(open_wal(path, "native"))
    errs: list = []
    n_threads, per = 8, 100

    def writer(base):
        try:
            for i in range(per):
                w.append_events([_ev(base + i)])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=writer, args=(t * 1000,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    # rewrite concurrently with live appenders: quiesce must serialize
    for _ in range(3):
        w.flush()
        w.rewrite([_ev(i) for i in range(10)])
    for t in ts:
        t.join()
    assert not errs, errs
    w.flush()
    w.close()
    w2 = open_wal(path, "native")
    n = len(list(w2.replay()))
    w2.close()
    assert n >= 10, n  # snapshot + everything appended after the last rewrite
    print("wal concurrent ok")


def drive_bm25_locked_concurrent() -> None:
    """The backend serializes every BM25 engine call under one lock;
    TSAN validates that discipline leaves no C++ race (mirrors
    index/embedded.py's self._lock usage)."""
    from ucfp_tpu_torch.index.bm25 import make_engine

    eng = make_engine(prefer_native=True)
    lock = threading.Lock()
    errs: list = []

    def worker(tid):
        try:
            rng = random.Random(tid)
            words = ["fox", "dog", "alpha", "beta", "lock", "race"]
            for i in range(200):
                op = rng.randrange(3)
                with lock:
                    if op == 0:
                        eng.upsert_one(
                            tid, i, " ".join(rng.choices(words, k=12)))
                    elif op == 1:
                        eng.search(tid, ["fox", "race"], 10)
                    else:
                        eng.clear_one(tid, rng.randrange(200))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    print("bm25 locked-concurrent ok")


def drive_httpfront_concurrent() -> None:
    """Epoll thread + TWO responder threads + four client threads: the
    GIL-released ctypes windows."""
    from ucfp_tpu_torch.native import UcfpHttpReq, load_httpfront

    lib = load_httpfront()
    assert lib is not None
    h = lib.ucfp_http_start(b"127.0.0.1", 0, 1 << 20)
    assert h
    port = lib.ucfp_http_port(h)
    stop = threading.Event()

    def responder():
        raw = UcfpHttpReq()
        while not stop.is_set():
            rc = lib.ucfp_http_next(h, 50, ctypes.byref(raw))
            if rc <= 0:
                continue
            body = b'{"ok":true}'
            lib.ucfp_http_respond(
                h, raw.id, 200, b"OK", b"application/json",
                body, len(body), 0,
            )
            lib.ucfp_http_free_req(ctypes.byref(raw))

    resp_threads = [threading.Thread(target=responder, daemon=True)
                    for _ in range(2)]
    for t in resp_threads:
        t.start()
    errs: list = []

    def client(n):
        try:
            for i in range(40):
                s = socket.create_connection(("127.0.0.1", port), timeout=10)
                payload = b"y" * ((n * 131 + i * 37) % 700)
                s.sendall(
                    b"POST /v1/x HTTP/1.1\r\nHost: a\r\nContent-Length: "
                    + str(len(payload)).encode()
                    + b"\r\nConnection: close\r\n\r\n" + payload)
                data = b""
                while b"}" not in data:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
                assert b"200 OK" in data, data[:80]
                s.close()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    cts = [threading.Thread(target=client, args=(n,)) for n in range(4)]
    for t in cts:
        t.start()
    for t in cts:
        t.join()
    assert not errs, errs
    stop.set()
    for t in resp_threads:
        t.join(timeout=5)
    lib.ucfp_http_stop(h)
    print("httpfront concurrent ok")


def drive_imgbatch() -> None:
    """Batch image decode + exact resize: probe/fill over well-formed,
    truncated, top-down, and odd-stride frame streams, then the
    two-stage fixed-point resize (down, up, identity) — all raw-pointer
    loops in imgbatch.cpp. Weights are built inline (any int32 rows
    summing to 2^15 exercise the same code paths)."""
    import struct

    from ucfp_tpu_torch.native import load_imgbatch

    lib = load_imgbatch()
    assert lib is not None

    def bmp(w, h, top_down=False, seed=1):
        stride = (w * 3 + 3) // 4 * 4
        rnd = random.Random(seed)
        px = bytes(rnd.randrange(256) for _ in range(stride * h))
        hdr = struct.pack("<2sIHHI", b"BM", 54 + len(px), 0, 0, 54)
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h,
                           1, 24, 0, len(px), 2835, 2835, 0, 0)
        return hdr + info + px

    def frames(pairs):
        out = bytearray()
        for rid, img in pairs:
            out += struct.pack("<QI", rid, len(img)) + img
        return bytes(out)

    for w, h, td in ((64, 64, False), (33, 17, True), (31, 9, False)):
        body = frames([(i, bmp(w, h, td, seed=i)) for i in range(5)])
        n = ctypes.c_int()
        hh = ctypes.c_int()
        ww = ctypes.c_int()
        rc = lib.ucfp_imgbatch_probe(body, len(body), 1024, 1, 8192,
                                     50 << 20, ctypes.byref(n),
                                     ctypes.byref(hh), ctypes.byref(ww))
        assert rc == 0 and n.value == 5, (rc, n.value)
        rids = (ctypes.c_uint64 * 5)()
        gray = (ctypes.c_uint8 * (5 * h * w))()
        got = lib.ucfp_imgbatch_fill(body, len(body), rids, gray, 5, h, w)
        assert got == 5
        # resize: down, up, and identity — rows sum to exactly 2^15
        for oh, ow in ((max(1, h // 2), max(1, w // 2)), (h * 2, w * 2),
                       (h, w)):
            def wmat(n_in, n_out):
                m = (ctypes.c_int32 * (n_out * n_in))()
                for o in range(n_out):
                    j = min(n_in - 1, (o * n_in) // n_out)
                    m[o * n_in + j] = 32768
                return m

            out = (ctypes.c_uint8 * (5 * oh * ow))()
            rc = lib.ucfp_imgbatch_resize(
                gray, 5, h, w, wmat(h, oh), oh, wmat(w, ow), ow, out)
            assert rc == 0
    # framing errors must return codes, never read past the buffer
    trunc = frames([(1, bmp(16, 16))])[:-7]
    n = ctypes.c_int()
    hh = ctypes.c_int()
    ww = ctypes.c_int()
    rc = lib.ucfp_imgbatch_probe(trunc, len(trunc), 1024, 1, 8192,
                                 50 << 20, ctypes.byref(n),
                                 ctypes.byref(hh), ctypes.byref(ww))
    assert rc == -2, rc
    rc = lib.ucfp_imgbatch_probe(trunc[:5], 5, 1024, 1, 8192, 50 << 20,
                                 ctypes.byref(n), ctypes.byref(hh),
                                 ctypes.byref(ww))
    assert rc == -1, rc
    print("imgbatch ok")


def drive_textsig() -> None:
    """Exercises the ASCII tokenizer (incl. boundary lookarounds at the
    buffer edges), the fused shingle-hash-minhash kernel across short/
    long/empty docs, and the mix+min reduction."""
    import ctypes
    import random

    import numpy as np

    from ucfp_tpu_torch.native import load_textsig

    lib = load_textsig()
    assert lib is not None, "textsig failed to build"
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)

    rng = random.Random(42)
    alpha = "abcdef aeiou' 0123,;.:_\t\r\n-\"!\x00\x7f"
    keys = np.arange(1, 129, dtype=np.uint64)
    sig = np.empty(128, dtype=np.uint64)
    docs = [
        b"", b"'", b"'a", b"a'", b"...", b"_",
        b"the quick brown fox jumps over the lazy dog" * 40,
        bytes([0x7F, 0x27, 0x61]),
    ] + [
        "".join(rng.choice(alpha) for _ in range(rng.randrange(0, 300))).encode()
        for _ in range(200)
    ]
    for raw in docs:
        cap = len(raw) + 1
        spans = np.empty(2 * cap, dtype=np.int64)
        n = lib.ucfp_text_tokens(raw, len(raw),
                                 spans.ctypes.data_as(i64p), cap)
        assert n >= 0
        rc = lib.ucfp_text_minhash_sig(
            raw, len(raw), 5, keys.ctypes.data_as(u64p), 128,
            sig.ctypes.data_as(u64p))
        assert rc >= 0
    # non-ASCII refusal (fresh buffer sized to the declared cap — the
    # loop's trailing `spans` can be as small as one pair)
    probe = np.empty(2 * 6, dtype=np.int64)
    assert lib.ucfp_text_tokens(b"caf\xc3\xa9", 5,
                                probe.ctypes.data_as(i64p), 6) == -1
    # capacity exhaustion reports -2, never writes past cap
    small = np.empty(2, dtype=np.int64)
    assert lib.ucfp_text_tokens(b"a b c", 5,
                                small.ctypes.data_as(i64p), 1) == -2
    base = np.arange(1000, dtype=np.uint64)
    out = np.empty(128, dtype=np.uint64)
    lib.ucfp_minhash_mix_min(base.ctypes.data_as(u64p), 1000,
                             keys.ctypes.data_as(u64p), 128,
                             out.ctypes.data_as(u64p))
    # TLSH: random, low-variation (-2), short (-1), boundary lengths
    from ucfp_tpu_torch.ops.textsig import _PEARSON_BYTES

    hexout = ctypes.create_string_buffer(70)
    for nn in (50, 51, 655, 656, 3199, 3200, 5000):
        blob = bytes(rng.randrange(256) for _ in range(nn))
        assert lib.ucfp_tlsh_128_1(blob, nn, 50, _PEARSON_BYTES, hexout) == 0
    assert lib.ucfp_tlsh_128_1(b"\x00" * 200, 200, 50, _PEARSON_BYTES,
                               hexout) == -2
    assert lib.ucfp_tlsh_128_1(b"short", 5, 50, _PEARSON_BYTES, hexout) == -1
    # simhash TF over the same doc corpus
    sh = ctypes.c_uint64(0)
    for raw in docs:
        assert lib.ucfp_text_simhash64_tf(raw, len(raw),
                                          ctypes.byref(sh)) >= 0
    assert lib.ucfp_text_simhash64_tf(b"caf\xc3\xa9", 5,
                                      ctypes.byref(sh)) == -1

    # full-Unicode scanner: multilingual docs, malformed UTF-8 (refusal
    # without reads past the buffer), truncated multi-byte tails, cap
    # exhaustion, and the fused u8 signature kernels over the same set
    uni_docs = [
        "café l'objectif l’école".encode(),
        "中文漢字 日本語テスト ひらがな カタカナ".encode(),
        "עברית א'ב א\"א א׳".encode(),
        "\U0001f1eb\U0001f1f7\U0001f1e9\U0001f1ea a‍\U0001f600 "
        "\U0001f44d\U0001f3fd".encode(),
        "á̈ ‌c ­ soft".encode(),
        ("mixte ASCII et accents: déjà vu, naïve, cœur. " * 30).encode(),
        b"", b"'", "’a".encode(), "\U0001f1eb".encode(),
    ] + [
        "".join(rng.choice(alpha + "éà中カא🇫́‍")
                for _ in range(rng.randrange(0, 200))).encode("utf-8")
        for _ in range(200)
    ]
    for raw in uni_docs:
        cap = len(raw) // 2 + 1
        spans = np.empty(2 * max(cap, 1), dtype=np.int64)
        n = lib.ucfp_text_tokens_u8(raw, len(raw),
                                    spans.ctypes.data_as(i64p), cap)
        assert n >= 0, raw
        rc = lib.ucfp_text_minhash_sig_u8(
            raw, len(raw), 5, keys.ctypes.data_as(u64p), 128,
            sig.ctypes.data_as(u64p))
        assert rc >= 0
        assert lib.ucfp_text_simhash64_tf_u8(raw, len(raw),
                                             ctypes.byref(sh)) >= 0
    bad_utf8 = [
        b"\xc3", b"a\xc3", b"\xe4\xb8", b"\xf0\x9f\x87", b"\x80",
        b"\xff\xfe", b"a\xc0\xaf", b"\xf8\x88\x80\x80\x80",
        "é".encode()[:1] + b"zz",
    ]
    for raw in bad_utf8:
        assert lib.ucfp_text_tokens_u8(raw, len(raw),
                                       probe.ctypes.data_as(i64p), 6) == -1
        assert lib.ucfp_text_minhash_sig_u8(
            raw, len(raw), 5, keys.ctypes.data_as(u64p), 128,
            sig.ctypes.data_as(u64p)) == -1
        assert lib.ucfp_text_simhash64_tf_u8(raw, len(raw),
                                             ctypes.byref(sh)) == -1
    assert lib.ucfp_text_tokens_u8("中 a 中".encode(), 9,
                                   small.ctypes.data_as(i64p), 1) == -2
    # grapheme scanner: same corpus + hangul jamo / ZWJ / tag-sequence
    # shapes, malformed refusal, cap exhaustion, fused gr minhash
    gr_docs = uni_docs + [
        "각각ᆨᅡ ؀ः \x0b é́".encode(),
        "\U0001f469‍\U0001f469‍\U0001f467"
        "\U0001f3f4\U000e0067\U000e0062\U000e007f".encode(),
    ]
    for raw in gr_docs:
        cap = max(len(raw), 1)
        spans = np.empty(2 * cap, dtype=np.int64)
        for skip in (0, 1):
            assert lib.ucfp_text_graphemes_u8(
                raw, len(raw), skip, spans.ctypes.data_as(i64p), cap) >= 0
        assert lib.ucfp_text_minhash_sig_gr(
            raw, len(raw), 5, keys.ctypes.data_as(u64p), 128,
            sig.ctypes.data_as(u64p)) >= 0
    for raw in bad_utf8:
        assert lib.ucfp_text_graphemes_u8(
            raw, len(raw), 1, probe.ctypes.data_as(i64p), 6) == -1
        assert lib.ucfp_text_minhash_sig_gr(
            raw, len(raw), 5, keys.ctypes.data_as(u64p), 128,
            sig.ctypes.data_as(u64p)) == -1
    assert lib.ucfp_text_graphemes_u8(b"abc", 3, 0,
                                      small.ctypes.data_as(i64p), 1) == -2
    print("textsig ok")


def _runtime(mode: str) -> str:
    """The sanitizer runtime g++ links for `mode`, for LD_PRELOAD."""
    name = ("libtsan.so" if "thread" in mode else "libasan.so" if "address" in mode
            else "libubsan.so")
    out = subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True,
                         text=True, timeout=60)
    path = out.stdout.strip()
    if out.returncode != 0 or not os.path.isabs(path) or not os.path.exists(path):
        raise RuntimeError(f"no {name} in the g++ toolchain")
    return path


def run_sanitized(mode: str = "address,undefined", timeout: float = 600.0):
    """Run the driver under `mode` in a subprocess -> CompletedProcess
    (stdout / stderr as text). Leak checks stay off: the host process is
    CPython, whose arenas report as leaks."""
    env = dict(os.environ, UCFP_NATIVE_SANITIZE=mode, LD_PRELOAD=_runtime(mode),
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1",
               TSAN_OPTIONS="halt_on_error=1:second_deadlock_stack=1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.run([sys.executable, "-m", "ucfp_tpu_torch.native.sanitize",
                           "--drive"], capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=root)


def drive() -> None:
    if not os.environ.get("UCFP_NATIVE_SANITIZE"):
        raise SystemExit("--drive runs under UCFP_NATIVE_SANITIZE (use the launcher)")
    drive_wal()
    drive_bm25()
    drive_httpfront()
    drive_imgbatch()
    drive_textsig()
    drive_wal_concurrent()
    drive_bm25_locked_concurrent()
    drive_httpfront_concurrent()
    print("SANITIZE_DRIVER_OK", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--drive"]:
        drive()
        return 0
    mode = argv[0] if argv else "address,undefined"
    proc = run_sanitized(mode)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode == 0 and "SANITIZE_DRIVER_OK" in proc.stdout:
        print(f"sanitized native run clean ({mode})")
        return 0
    return proc.returncode or 1


if __name__ == "__main__":
    sys.exit(main())
