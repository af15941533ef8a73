"""Text signature math: MinHash, SimHash, LSH bands, TLSH.

A copy of ucfp_tpu/ops/textsig.py (host numpy and the native textsig
library of this package); only its imports differ.

Rebuilds the fingerprint families the reference consumes from the
(non-vendored) txtfp SDK (call-sites: src/modality/text.rs:182-484).
Since txtfp's internal hash derivations are not recoverable from the
reference repo, the schemes here are *self-defined and documented*, with
the same wire layouts and parameters; goldens in tests/goldens/ lock them.

Design note (TPU): string hashing is byte-sequential host work, and the
per-slot mixing below is memory-bound over a few KiB per document — far
below the cost of a host->device round trip. It is therefore vectorized
on the host with numpy uint64 (xxh3 for the base hashes is C-backed).
Device work for text is the semantic-embedding path and the k-NN matrix.

Canonical MinHash scheme (h slots):
  base_s   = xxh3_64(shingle_s utf-8 bytes)
  key_i    = splitmix64(0x9E3779B97F4A7C15 * (i + 1) mod 2^64)
  v[s, i]  = mix64(base_s XOR key_i)        (splitmix64 finalizer)
  sig[i]   = min over s of v[s, i]
Wire: u16 schema=1 LE + 6 zero bytes + h x u64 LE  (1032 bytes at h=128,
matching the reference size contract, src/server/tests.rs:1114-1118).

SimHash64: token hash xxh3_64; accumulate +/- weight per bit; bit = acc>0.
Wire: one u64 LE (8 bytes; reference tags simhash-b64-*, text.rs:46-48).

LSH: the reference re-tags the MinHash record (text.rs:437-446) — the
fingerprint bytes are the same signature; banding happens at index time.
band_hashes() exposes the b x r banding (default 20 x 6 over 120 slots,
REPORT.md:677) for the LSH bucket index.

TLSH 128/1: standard published algorithm (Oliver et al. 2013): Pearson-
chained triplet bucket counts over a 5-byte sliding window, quartile
2-bit coding, 35-byte digest, 70-char hex, stored as the hex STRING's
bytes (text.rs:478). Requires >= 50 input bytes.
"""

from __future__ import annotations

import struct

import numpy as np
import xxhash

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
U64 = np.uint64


def _splitmix64_arr(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (mod-2^64 wraparound)."""
    with np.errstate(over="ignore"):
        z = x + GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _mix64_arr(x: np.ndarray) -> np.ndarray:
    """Stafford mix13 finalizer (the splitmix64 output mix), vectorized."""
    with np.errstate(over="ignore"):
        z = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


_slot_keys_cache: dict = {}


def slot_keys(h: int) -> np.ndarray:
    """Per-slot xor keys: splitmix64 of GOLDEN*(i+1). Cached: the hot
    paths hand the same array to the native kernels on every call."""
    keys = _slot_keys_cache.get(h)
    if keys is None:
        with np.errstate(over="ignore"):
            seeds = GOLDEN * np.arange(1, h + 1, dtype=np.uint64)
        keys = _splitmix64_arr(seeds)
        keys.setflags(write=False)
        _slot_keys_cache[h] = keys
    return keys


MINHASH_SCHEMA = 1


def _native_textsig():
    from ..native import load_textsig

    return load_textsig()


def _mix_min_numpy(base: np.ndarray, h: int) -> np.ndarray:
    keys = slot_keys(h)
    v = _mix64_arr(base[:, None] ^ keys[None, :])  # [S, h]
    return v.min(axis=0)


def minhash_signature(shingles: list[str], h: int = 128) -> np.ndarray:
    """[h] uint64 signature; empty shingle list -> all u64::MAX."""
    if not shingles:
        return np.full(h, np.iinfo(np.uint64).max, dtype=np.uint64)
    base = np.array(
        [xxhash.xxh3_64_intdigest(s.encode("utf-8")) for s in shingles],
        dtype=np.uint64,
    )
    lib = _native_textsig()
    if lib is not None:
        # single-pass C++ mix+min: the numpy broadcast builds multi-MB
        # [S, h] temporaries (2 ms/doc at S~1.1k); bit-equality with
        # _mix_min_numpy is pinned by tests/test_textsig_native.py
        import ctypes

        base = np.ascontiguousarray(base)
        out = np.empty(h, dtype=np.uint64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ucfp_minhash_mix_min(
            base.ctypes.data_as(u64p), base.size,
            slot_keys(h).ctypes.data_as(u64p), h,
            out.ctypes.data_as(u64p),
        )
        return out
    return _mix_min_numpy(base, h)


def text_minhash_fast(canon: str, k: int, h: int):
    """Fused native minhash for canonicalized ASCII text under the
    `word` tokenizer: UAX#29-ASCII tokenize -> k-shingle -> XXH3 ->
    mix/min in one C++ pass (no token/shingle materialization).

    Returns (sig[h] uint64, n_shingles) — n_shingles 0 means no tokens
    (caller raises its usual error) — or None when the native module is
    unavailable or the text turns out non-ASCII (caller falls back to
    the regex/numpy pipeline). Byte-identical to that pipeline; fuzzed
    in tests/test_textsig_native.py against random ASCII documents."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    try:
        raw = canon.encode("ascii")
    except UnicodeEncodeError:
        return None
    out = np.empty(h, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n = lib.ucfp_text_minhash_sig(
        raw, len(raw), k,
        slot_keys(h).ctypes.data_as(u64p), h,
        out.ctypes.data_as(u64p),
    )
    if n < 0:
        return None
    return out, int(n)


def text_simhash_tf_fast(canon: str):
    """Fused native TF SimHash for canonicalized ASCII text under the
    `word` tokenizer. Returns (hash:int, has_tokens:bool) or None when
    unavailable / non-ASCII. Byte-identical to
    simhash64(terms, tf-weights) — see textsig.cpp for the equivalence
    argument; fuzz-pinned in tests/test_textsig_native.py."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    try:
        raw = canon.encode("ascii")
    except UnicodeEncodeError:
        return None
    out = ctypes.c_uint64(0)
    rc = lib.ucfp_text_simhash64_tf(raw, len(raw), ctypes.byref(out))
    if rc < 0:
        return None
    return int(out.value), rc == 1


def tokenize_ascii_fast(canon: str):
    """Native UAX#29-ASCII word tokenization. Returns the token list
    (byte-identical to modality.text.tokenize_words, fuzz-pinned) or
    None when unavailable / non-ASCII."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    try:
        raw = canon.encode("ascii")
    except UnicodeEncodeError:
        return None
    # non-overlapping tokens, >=1 char each + a separator: (n+1)/2 bound
    cap = len(raw) // 2 + 1
    spans = np.empty(2 * cap, dtype=np.int64)
    n = lib.ucfp_text_tokens(
        raw, len(raw),
        spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n < 0:
        return None
    return [canon[spans[2 * i]:spans[2 * i + 1]] for i in range(n)]


def _encode_u8(canon: str):
    """UTF-8 bytes for the native full-Unicode path, or None when the
    string holds lone surrogates (only reachable via surrogatepass
    callers; the regex path handles those)."""
    try:
        return canon.encode("utf-8")
    except UnicodeEncodeError:
        return None


def tokenize_u8_fast(canon: str):
    """Native full-Unicode UAX#29 word tokenization (wb_table.h is
    generated from the regex engine; rule machine in textsig.cpp).
    Returns the token list — byte-identical to the regex path, fuzzed
    in tests/test_textsig_native.py — or None when unavailable."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    raw = _encode_u8(canon)
    if raw is None:
        return None
    # adjacent 1-byte tokens cannot touch (two ASCII word chars never
    # break between themselves), so every extra token costs >= 2 bytes:
    # len/2+1 span pairs bound the count; -2 (cap) falls back to regex
    cap = len(raw) // 2 + 1
    spans = np.empty(2 * cap, dtype=np.int64)
    n = lib.ucfp_text_tokens_u8(
        raw, len(raw),
        spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n < 0:
        return None
    return [raw[spans[2 * i]:spans[2 * i + 1]].decode("utf-8")
            for i in range(n)]


def text_minhash_u8_fast(canon: str, k: int, h: int):
    """Fused native minhash for canonicalized text of ANY script under
    the `word` tokenizer (the non-ASCII counterpart of
    text_minhash_fast; same return contract, same byte-identity fuzz)."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    raw = _encode_u8(canon)
    if raw is None:
        return None
    out = np.empty(h, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n = lib.ucfp_text_minhash_sig_u8(
        raw, len(raw), k,
        slot_keys(h).ctypes.data_as(u64p), h,
        out.ctypes.data_as(u64p),
    )
    if n < 0:
        return None
    return out, int(n)


def text_simhash_tf_u8_fast(canon: str):
    """Fused native TF SimHash for text of ANY script (the non-ASCII
    counterpart of text_simhash_tf_fast; same contract)."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    raw = _encode_u8(canon)
    if raw is None:
        return None
    out = ctypes.c_uint64(0)
    rc = lib.ucfp_text_simhash64_tf_u8(raw, len(raw), ctypes.byref(out))
    if rc < 0:
        return None
    return int(out.value), rc == 1


def tokenize_graphemes_fast(canon: str, skip_spaces: bool = False):
    """Native extended-grapheme-cluster segmentation (the regex
    engine's \\X; UAX#29 GB rules over the generated kGcbPages table).
    skip_spaces drops all-whitespace clusters (the tokenize()
    keep-filter). Returns the cluster list or None when unavailable."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    raw = _encode_u8(canon)
    if raw is None:
        return None
    cap = max(len(raw), 1)  # every cluster is >= 1 byte
    spans = np.empty(2 * cap, dtype=np.int64)
    n = lib.ucfp_text_graphemes_u8(
        raw, len(raw), 1 if skip_spaces else 0,
        spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n < 0:
        return None
    return [raw[spans[2 * i]:spans[2 * i + 1]].decode("utf-8")
            for i in range(n)]


def text_minhash_gr_fast(canon: str, k: int, h: int):
    """Fused native minhash for the `grapheme` tokenizer (non-space
    clusters -> k-shingles -> XXH3 -> mix/min; same return contract as
    text_minhash_u8_fast)."""
    lib = _native_textsig()
    if lib is None:
        return None
    import ctypes

    raw = _encode_u8(canon)
    if raw is None:
        return None
    out = np.empty(h, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    n = lib.ucfp_text_minhash_sig_gr(
        raw, len(raw), k,
        slot_keys(h).ctypes.data_as(u64p), h,
        out.ctypes.data_as(u64p),
    )
    if n < 0:
        return None
    return out, int(n)


def serialize_minhash(sig: np.ndarray) -> bytes:
    """u16 schema + 6 pad + h x u64 LE."""
    return struct.pack("<H6x", MINHASH_SCHEMA) + sig.astype("<u8").tobytes()


def minhash_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Jaccard estimate: matching slots / h."""
    return float(np.mean(a == b))


def simhash64(tokens: list[str], weights: list[float]) -> int:
    """Weighted 64-bit SimHash over token hashes."""
    if not tokens:
        return 0
    hs = np.array(
        [xxhash.xxh3_64_intdigest(t.encode("utf-8")) for t in tokens],
        dtype=np.uint64,
    )
    w = np.asarray(weights, dtype=np.float64)
    bits = ((hs[:, None] >> np.arange(64, dtype=np.uint64)[None, :]) & U64(1)).astype(
        np.float64
    )  # [T, 64]
    acc = ((bits * 2.0 - 1.0) * w[:, None]).sum(axis=0)
    out = np.uint64(0)
    for i in range(64):
        if acc[i] > 0:
            out |= U64(1) << U64(i)
    return int(out)


def band_hashes(sig: np.ndarray, bands: int = 20, rows: int = 6) -> list[int]:
    """LSH band keys over the first bands*rows slots (REPORT.md:677)."""
    out = []
    for j in range(bands):
        chunk = sig[j * rows : (j + 1) * rows].astype("<u8").tobytes()
        out.append(xxhash.xxh3_64_intdigest(chunk, seed=j))
    return out


# ---------------------------------------------------------------------------
# TLSH 128/1 (standard published algorithm)
# ---------------------------------------------------------------------------

# Pearson permutation table from the TLSH reference specification.
_PEARSON = [
    1, 87, 49, 12, 176, 178, 102, 166, 121, 193, 6, 84, 249, 230, 44, 163,
    14, 197, 213, 181, 161, 85, 218, 80, 64, 239, 24, 226, 236, 142, 38, 200,
    110, 177, 104, 103, 141, 253, 255, 50, 77, 101, 81, 18, 45, 96, 31, 222,
    25, 107, 190, 70, 86, 237, 240, 34, 72, 242, 20, 214, 244, 227, 149, 235,
    97, 234, 57, 22, 60, 250, 82, 175, 208, 5, 127, 199, 111, 62, 135, 248,
    174, 169, 211, 58, 66, 154, 106, 195, 245, 171, 17, 187, 182, 179, 0, 243,
    132, 56, 148, 75, 128, 133, 158, 100, 130, 126, 91, 13, 153, 246, 216, 219,
    119, 68, 223, 78, 83, 88, 201, 99, 122, 11, 92, 32, 136, 114, 52, 10,
    138, 30, 48, 183, 156, 35, 61, 26, 143, 74, 251, 94, 129, 162, 63, 152,
    170, 7, 115, 167, 241, 206, 3, 150, 55, 59, 151, 220, 90, 53, 23, 131,
    125, 173, 15, 238, 79, 95, 89, 16, 105, 137, 225, 224, 217, 160, 37, 123,
    118, 73, 2, 157, 46, 116, 9, 145, 134, 228, 207, 212, 202, 215, 69, 229,
    27, 188, 67, 124, 168, 252, 42, 4, 29, 108, 21, 247, 19, 205, 39, 203,
    233, 40, 186, 147, 198, 192, 155, 33, 164, 191, 98, 204, 165, 180, 117, 76,
    140, 36, 210, 172, 41, 54, 159, 8, 185, 232, 113, 196, 231, 47, 146, 120,
    51, 65, 28, 144, 254, 221, 93, 189, 194, 139, 112, 43, 71, 109, 184, 209,
]

TLSH_MIN_LEN = 50
_TLSH_BUCKETS = 128


def _b_mapping(salt: int, i: int, j: int, k: int) -> int:
    t = _PEARSON[salt]
    t = _PEARSON[t ^ i]
    t = _PEARSON[t ^ j]
    t = _PEARSON[t ^ k]
    return t


def _l_capturing(length: int) -> int:
    """Logarithmic length bucket (TLSH spec l_capturing): continuous
    log-base buckets with the published base switches at 656 and 3199."""
    import math

    if length <= 0:
        return 0
    if length <= 656:
        x = math.log(length) / math.log(1.5)
    elif length <= 3199:
        x = math.log(length) / math.log(1.3) - 8.72777
    else:
        x = math.log(length) / math.log(1.1) - 62.5472
    return min(max(int(x), 0), 255)


def _swap_nibbles(b: int) -> int:
    return ((b & 0x0F) << 4) | ((b & 0xF0) >> 4)


_PEARSON_BYTES = bytes(_PEARSON)


def tlsh_128_1(data: bytes) -> str:
    """TLSH 128-bucket / 1-byte-checksum digest -> 70-char lowercase hex.

    Raises ValueError on inputs shorter than TLSH_MIN_LEN or with too
    little variation (q3 == 0).

    The per-byte loop costs ~6.5 ms on a 5.6 KiB doc in CPython; the
    native port (textsig.cpp ucfp_tlsh_128_1, handed THIS module's
    Pearson table) runs it in ~25 us. Byte-identical by fuzz
    (tests/test_textsig_native.py) and by the TLSH goldens."""
    n = len(data)
    if n < TLSH_MIN_LEN:
        raise ValueError(f"TLSH requires >= {TLSH_MIN_LEN} bytes, got {n}")
    lib = _native_textsig()
    if lib is not None:
        import ctypes

        out = ctypes.create_string_buffer(70)
        rc = lib.ucfp_tlsh_128_1(data, n, TLSH_MIN_LEN, _PEARSON_BYTES, out)
        if rc == 0:
            return out.raw.decode("ascii")
        if rc == -2:
            raise ValueError("TLSH: insufficient variation in input")
        # -1 (too short) is unreachable — length was validated above —
        # so any other code is an ABI/logic mismatch, not a user error
        raise RuntimeError(f"native TLSH returned rc={rc}")
    buckets = [0] * 256
    checksum = 0
    for i in range(4, n):
        b0, b1, b2, b3, b4 = data[i], data[i - 1], data[i - 2], data[i - 3], data[i - 4]
        checksum = _b_mapping(0, b0, b1, checksum)
        buckets[_b_mapping(2, b0, b1, b2)] += 1
        buckets[_b_mapping(3, b0, b1, b3)] += 1
        buckets[_b_mapping(5, b0, b2, b3)] += 1
        buckets[_b_mapping(7, b0, b2, b4)] += 1
        buckets[_b_mapping(11, b0, b1, b4)] += 1
        buckets[_b_mapping(13, b0, b3, b4)] += 1
    bl = buckets[:_TLSH_BUCKETS]
    s = sorted(bl)
    q1, q2, q3 = s[31], s[63], s[95]
    if q3 == 0:
        raise ValueError("TLSH: insufficient variation in input")
    lvalue = _l_capturing(n)
    q1ratio = (q1 * 100 // q3) % 16
    q2ratio = (q2 * 100 // q3) % 16
    body = bytearray(32)
    # published packing (Oliver et al. 2013 reference impl): tmp byte i
    # holds buckets 4i..4i+3 at bit pairs 2j, and the OUTPUT reverses
    # byte order only — so output byte 0 carries buckets 124..127 with
    # bucket 124 in the low bits. All three header bytes are
    # nibble-swapped in the hex form (the impl's swap_byte on checksum,
    # lvalue, AND the q-ratio byte).
    for i in range(32):
        sextet = 0
        for j in range(4):
            k = bl[(31 - i) * 4 + j]
            if k <= q1:
                code = 0
            elif k <= q2:
                code = 1
            elif k <= q3:
                code = 2
            else:
                code = 3
            sextet |= code << (j * 2)
        body[i] = sextet
    header = bytes(
        [_swap_nibbles(checksum), _swap_nibbles(lvalue),
         _swap_nibbles((q1ratio << 4) | q2ratio)]
    )
    return (header + bytes(body)).hex()


def tlsh_distance(a: str, b: str) -> int:
    """Approximate TLSH distance: 2-bit code diff sum over the body plus
    header penalties (spec's diff with 6-point penalty for code distance 3)."""
    ba, bb = bytes.fromhex(a), bytes.fromhex(b)
    if len(ba) != 35 or len(bb) != 35:
        raise ValueError("bad TLSH digest length")
    dist = 0
    if ba[0] != bb[0]:
        dist += 1
    # header bytes are stored nibble-swapped; unswap before arithmetic
    la = _swap_nibbles(ba[1])
    lb = _swap_nibbles(bb[1])
    ldiff = abs(la - lb)
    dist += ldiff if ldiff <= 1 else ldiff * 12
    q1a, q2a = ba[2] >> 4, ba[2] & 0xF
    q1b, q2b = bb[2] >> 4, bb[2] & 0xF
    for da, db in ((q1a, q1b), (q2a, q2b)):
        d = abs(da - db)
        d = min(d, 16 - d)
        dist += d if d <= 1 else (d - 1) * 12
    for x, y in zip(ba[3:], bb[3:]):
        for shift in (0, 2, 4, 6):
            ca = (x >> shift) & 3
            cb = (y >> shift) & 3
            d = abs(ca - cb)
            dist += 6 if d == 3 else d
    return dist
