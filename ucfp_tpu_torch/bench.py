"""The port's bench entry point (port of bench.py, so far as the port's
modules reach): python -m ucfp_tpu_torch.bench [--device cuda|cpu]

It runs on the CUDA card; with no card and no --device it exits non-zero
with a message (--device cpu is for the tests, at tiny sizes). Every
catalog is drawn on the device from a torch.Generator with a fixed seed:
the reference draws its own with jax.random, which torch cannot
reproduce, so the two benches compare by shape and value range, not by
identical data.

Timing: each key runs a host loop of N queries (or image batches) in
which the next input depends on the previous answer's top hit, closed by
torch.cuda.synchronize(), and takes (t(N) - t(1)) / (N - 1), the median
of three pairs (the reference's calibration, bench.py:32-58).

Output: the 10M x 768 family as one JSON object on the line before the
last ({"10m_x768": {...}}), then one JSON object of at most 1.5 KB as the
last line: the headline "phash images/sec/chip", the device (with
nvidia-smi's name and power limit) and the other keys under "extra". A
key that raises ends the run with a non-zero exit; a key skipped by the
budget is printed as skipped, never as a number.

Knobs (the reference's): UCFP_BENCH_ONLY=<substr>[,<substr>...] runs the
keys whose name holds one of them (and the headline when one is a
substring of "phash"); UCFP_BENCH_FULL=1 adds the exact comparison keys
(f32 cosine at 1M x 64, Hamming and int8 cosine at 10M x 64, and the
per-shard int2 key); UCFP_BENCH_BUDGET_S (default 1800) skips the keys
that start after it.

The audio keys (the reference's names): audio_wang_xrt, audio_panako_xrt,
audio_haitsma_xrt and audio_haitsma_fft_xrt are a 60 s clip's extraction
time as a real-time factor (seconds of audio per second), each step's
clip nudged by the previous step's landmark count or words;
audio_match_p50_ms_1m_landmarks is knn_audio's p50 over 10^4 stored
records of 100 landmarks (host numpy, in an EmbeddedBackend on the device).

The text key (the reference's name): text_minhash_docs_per_sec is the
host MinHash fingerprint rate on the reference's 5.6 KiB bench document,
with text_minhash_ms_per_doc_5k6 and text_minhash_unicode_ms_per_doc_5k6
(the same size in mixed French and CJK) beside it; host code, so its
numbers say nothing of the card.

Not ported here: the HTTP keys, the serving-overhead key
(it drives scripts/ against the reference), parity (chip_smoke.py phase 4
holds the image digests on the card), the sharded merge model and every
key derived from it (its constants are link speeds of the reference's
hardware, which do not apply to this card).

UCFP_PROFILE_DIR=<dir> records the whole run with torch.profiler (CPU
activity, and CUDA activity on the card) and writes a Chrome trace
(ucfp-bench-<pid>.json, for chrome://tracing or Perfetto) into <dir>;
a profiler that cannot start or write stops the run with an error.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

from .device import resolve_device
from .ops import fused_scan, imagehash, knn

TILE = fused_scan.ROWS_PER_TILE * fused_scan.LANES  # 32,768 rows
#: the last stdout line's size limit in bytes
LAST_LINE_MAX = 1536


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _timed(fn, n_iters: int) -> float:
    """Seconds per iteration via the (t(N) - t(1)) / (N - 1) calibration,
    the median of three pairs (positives only), with the raw t(N) / N as
    the fallback. fn(n) runs n iterations and synchronizes."""
    fn(1)  # warm: the kernel build, the allocator
    fn(n_iters)
    estimates = []
    fallback = None
    for _ in range(3):
        t0 = time.perf_counter()
        fn(1)
        t1 = time.perf_counter()
        fn(n_iters)
        t2 = time.perf_counter()
        fallback = (t2 - t1) / n_iters
        delta = (t2 - t1) - (t1 - t0)
        if delta > 0:
            estimates.append(delta / (n_iters - 1))
    if estimates:
        return sorted(estimates)[len(estimates) // 2]
    return max(fallback, 1e-9)


def _loop(dev: torch.device, step, carry0):
    """run(n): n dependent steps from carry0, then a synchronize."""
    def run(n):
        carry = carry0
        for _ in range(n):
            carry = step(carry)
        _sync(dev)
        return carry

    return run


def _row(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """m[idx[0]] as a [1, ...] tensor, without a device-to-host read."""
    return torch.index_select(m, 0, idx.reshape(-1)[:1])


def _nudge_int8(q8: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """The reference's dependency step for int8 queries:
    clip(q + row // 127, -127, 127)."""
    step = torch.div(row.to(torch.int32), 127, rounding_mode="floor")
    return torch.clamp(q8.to(torch.int32) + step, -127, 127).to(torch.int8)


def _nudge_f32(q: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """clip(q + row / 127, -127, 127) on float32 queries (a tensor
    divisor: CUDA divides by a CPU scalar through its reciprocal)."""
    r = row.float()
    return torch.clamp(q + r / torch.full_like(r, 127.0), -127.0, 127.0)


def _row_norms_int8(m8: torch.Tensor, chunk: int) -> torch.Tensor:
    """|row| of an int8 matrix in row chunks, so the float temporaries
    stay one chunk (knn.int8_norms: exact integer sums, one sqrt)."""
    n = m8.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=m8.device)
    for lo in range(0, n, chunk):
        out[lo:lo + chunk] = knn.int8_norms(m8[lo:lo + chunk])
    return out


def _tiled_rows(n_rows: int) -> int:
    return (n_rows // TILE) * TILE


# -- image hashing -------------------------------------------------------------


def _images_per_sec(dev, batch: int, iters: int, hash_step) -> float:
    g = _gen(dev, 0)
    # select-chain: each step hashes one of 4 staged batches, picked by
    # the previous step's hash sum (a data dependency, no extra writes)
    stack4 = torch.randint(0, 256, (4, batch, 256, 256, 3), generator=g,
                           device=dev, dtype=torch.uint8)

    def step(carry):
        x = torch.index_select(stack4, 0, carry % 4)[0]
        return (carry + hash_step(x).to(torch.int64).sum()) % 1000003

    run = _loop(dev, step, torch.zeros(1, dtype=torch.int64, device=dev))
    return batch / _timed(run, iters)


def bench_phash(dev, batch: int = 512, iters: int = 256) -> float:
    """pHash images/s over batches of 256x256 RGB (the headline)."""
    return _images_per_sec(dev, batch, iters, lambda x: imagehash.single_hash_kernel(
        x, 256, 256, "phash", device=dev)[:, 0])


def bench_multihash(dev, batch: int = 256, iters: int = 256) -> float:
    """Multi-hash bundle images/s over batches of 256x256 RGB."""
    return _images_per_sec(dev, batch, iters, lambda x: imagehash.multihash_kernel(
        x, 256, 256, device=dev)["phash"][:, 0])


# -- 10M x 64 query keys -------------------------------------------------------


def bench_query_p50(dev, n: int = 1_000_000, d: int = 64, k: int = 10,
                    iters: int = 64) -> float:
    """Exact f32 cosine top-k over n rows (ms per query)."""
    g = _gen(dev, 0)
    matrix = torch.randn((n, d), generator=g, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q0 = torch.randn((1, d), generator=g, device=dev)

    def step(q):
        _vals, idx = knn.cosine_topk(q, matrix, valid, k)
        return q + _row(matrix, idx) * 1e-6

    return _timed(_loop(dev, step, q0), iters) * 1000.0


def bench_hamming_10m(dev, n: int = 10_000_000, w: int = 2, k: int = 10,
                      iters: int = 64) -> float:
    """Exact Hamming top-k over n packed 64-bit fingerprints (ms per
    query)."""
    g = _gen(dev, 0)
    matrix = torch.randint(0, 2**31 - 1, (n, w), generator=g, device=dev,
                           dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q0 = torch.tensor([[12345, 67890]], dtype=torch.int32, device=dev)

    def step(q):
        _dist, idx = knn.hamming_topk(q, matrix, valid, k)
        return torch.bitwise_xor(q, _row(matrix, idx))

    return _timed(_loop(dev, step, q0), iters) * 1000.0


def _int8_catalog(dev, n: int, d: int, seed: int):
    g = _gen(dev, seed)
    m8 = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    return m8, _row_norms_int8(m8, 1 << 20), g


def bench_cosine_int8_10m(dev, n: int = 10_000_000, d: int = 64, k: int = 10,
                          iters: int = 32) -> float:
    """Exhaustive int8 cosine top-k (knn.cosine_topk_int8: the int8
    product, every score, a stable sort) over n x d rows (ms per query)."""
    m8, rn, g = _int8_catalog(dev, n, d, 1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q0 = torch.randn((1, d), generator=g, device=dev)

    def step(q):
        _vals, idx = knn.cosine_topk_int8(q, m8, rn, valid, k)
        return q + _row(m8, idx).float() * 1e-6

    return _timed(_loop(dev, step, q0), iters) * 1000.0


def bench_hamming_10m_fused(dev, n: int | None = None, w: int = 2, k: int = 10,
                            iters: int = 64) -> float:
    """The fused per-(tile, lane) Hamming top-k (kernel #6) over 10M rows
    cut to whole tiles (ms per query)."""
    n = _tiled_rows(10_000_000) if n is None else n
    g = _gen(dev, 0)
    db = torch.randint(0, 2**31 - 1, (n, w), generator=g, device=dev, dtype=torch.int32)
    q0 = torch.tensor([12345, 678901], dtype=torch.int32, device=dev)

    def step(q):
        _dist, idx = fused_scan.hamming_topk_fused(q, db, k)
        return torch.bitwise_xor(q, _row(db, idx)[0])

    return _timed(_loop(dev, step, q0), iters) * 1000.0


def _cosine_int8_10m_x64(dev, topk, n, d: int, k: int, iters: int) -> float:
    n = _tiled_rows(10_000_000) if n is None else n
    m8, rn, g = _int8_catalog(dev, n, d, 0)
    q0 = torch.randint(-127, 128, (d,), generator=g, device=dev, dtype=torch.int8)

    def step(q):
        _vals, idx = topk(q, m8, rn, k)
        return _nudge_int8(q, _row(m8, idx)[0])

    return _timed(_loop(dev, step, q0), iters) * 1000.0


def bench_cosine_int8_10m_hybrid(dev, n: int | None = None, d: int = 64, k: int = 10,
                                 iters: int = 32) -> float:
    """The int8 product + the fused normalize/select kernel (#4) at 10M x
    64 (ms per query)."""
    return _cosine_int8_10m_x64(dev, fused_scan.cosine_int8_topk_hybrid, n, d, k, iters)


def bench_cosine_int8_10m_mxu(dev, n: int | None = None, d: int = 64, k: int = 10,
                              iters: int = 32) -> float:
    """The line-packed int8 cosine scan (#8) at 10M x 64 (ms per query)."""
    return _cosine_int8_10m_x64(dev, fused_scan.cosine_int8_topk_mxu, n, d, k, iters)


def bench_cosine_int8_10m_fused(dev, n: int | None = None, d: int = 64, k: int = 10,
                                iters: int = 32) -> float:
    """The fused int8 cosine scan (#7) at 10M x 64 (ms per query); the
    one key the reference lacks."""
    return _cosine_int8_10m_x64(dev, fused_scan.cosine_int8_topk_fused, n, d, k, iters)


# -- 10M x 768: every vector tier ------------------------------------------------


def _stats(xs):
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "range": [xs[0], xs[-1]]}


def bench_cosine_int8_10m_768(dev, k: int = 10, iters: int = 8, qbatch: int = 32,
                              n_rows: int = 10_000_000, rounds: int = 3,
                              recall_q: int = 104, shards: int = 8, d: int = 768,
                              recall_chunk: int = 26, shard_int2: bool = False) -> dict:
    """The int8 catalog of n_rows (cut to whole 32,768-row tiles) x d on
    the card, and every vector tier over it: exact (single and batch 32),
    int4 (single, batch 32 and 64), int2 (single and batch 2), sketch at
    the default and the fast pool; recall@10 of each approximate tier over
    recall_q random queries against the exact int8 ranking, with the 95%
    interval; planted near-duplicates at the fast sketch pool; and the
    per-shard keys at n / shards rows on this one card (int2's only with
    shard_int2). Latencies are
    measured `rounds` times, spread across the run, as median and range."""
    from .core import POOL_FRAC_TIERS

    n = _tiled_rows(n_rows)
    g = _gen(dev, 0)
    # uniform bytes, -128..127, as the reference's generator draws them
    m8 = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    rn = _row_norms_int8(m8, 1 << 18)
    q_single = torch.randint(-127, 128, (d,), generator=g, device=dev, dtype=torch.int8)
    q_batch = torch.randint(-127, 128, (qbatch, d), generator=g, device=dev,
                            dtype=torch.int8)
    qf = q_single.float()
    qbf = q_batch.float()
    qb64f = torch.randint(-127, 128, (64, d), generator=g, device=dev,
                          dtype=torch.int8).float()
    q2f = qbf[:2]
    valid = torch.ones(n, dtype=torch.bool, device=dev)

    def t_loop(step, q0, it=None):
        return _timed(_loop(dev, step, q0), iters if it is None else it) * 1000.0

    def t_exact(m=m8, rnv=rn, it=None):
        def step(q):
            _v, idx = fused_scan.cosine_int8_topk_hybrid(q, m, rnv, k)
            return _nudge_int8(q, _row(m, idx)[0])
        return t_loop(step, q_single, it)

    def t_batch():
        # the exact batched serving path: one int8 product for the block,
        # then the fused normalize/select kernel (#5)
        ones = torch.ones(qbatch, dtype=torch.float32, device=dev)

        def step(q):
            dots = knn.int8_dots(q, m8)
            _v, idx = fused_scan.dots_norm_topk_fused_batched(dots, rn, n, ones, k)
            return _nudge_int8(q, _row(m8, idx))  # the first query's top row, to all
        return t_loop(step, q_batch)

    # -- sketch prefilter (UCFP_KNN_QUANT=sketch) ----------------------
    planes = torch.as_tensor(knn.sketch_planes(d), device=dev)
    sketch = knn.tile_sketch(knn.build_sketch_chunked(m8, planes, chunk=TILE * 8))
    cand = knn.sketch_pool(n, k)  # default (quality) pool
    cand_fast = knn.sketch_pool(n, k, POOL_FRAC_TIERS[0])

    def t_sketch(pool, m=m8, rnv=rn, sk=None, vd=valid, it=None):
        sk = sketch if sk is None else sk

        def step(q):
            _v, idx = knn.cosine_sketch_topk(q, planes, m, rnv, sk, vd, k, pool)
            return _nudge_f32(q, _row(m, idx)[0])
        return t_loop(step, qf, it)

    # -- packed-int4 prefilter (UCFP_KNN_QUANT=int4) -------------------
    packed_t, inv_n4 = knn.pack_int4_cols_chunked(m8, chunk=TILE)
    pool_i4 = knn.int4_pool(n, k)
    pool_i4b = knn.int4_batch_pool(n, k)

    def t_int4(m=m8, rnv=rn, pk=None, inv=None, nv=n, pool=pool_i4, it=None):
        pk = packed_t if pk is None else pk
        inv = inv_n4 if inv is None else inv
        vd = torch.ones(m.shape[0], dtype=torch.bool, device=dev)

        def step(q):
            # n_valid: the fused masked-scores kernel, the unfiltered
            # serving path
            _v, idx = knn.cosine_int4_topk(q, m, rnv, pk, inv, vd, k, pool, n_valid=nv)
            return _nudge_f32(q, _row(m, idx)[0])
        return t_loop(step, qf, it)

    def t_i4_batch(qv=qbf, m=m8, rnv=rn, pk=None, inv=None, nv=n, pool=pool_i4b,
                   it=None):
        pk = packed_t if pk is None else pk
        inv = inv_n4 if inv is None else inv

        def step(q):
            _v, idx = knn.cosine_int4_topk_batched(q, m, rnv, pk, inv, nv, k, pool)
            return _nudge_f32(q, _row(m, idx))
        return t_loop(step, qv, it)

    # -- recall: chunks, so the timing rounds interleave with them ------
    gq = _gen(dev, 9)
    queries = torch.randn((recall_q, d), generator=gq, device=dev) * 40.0

    def ground_truth():
        out = []
        for i in range(0, recall_q, recall_chunk):
            _s, ig = knn.cosine_topk_int8(queries[i:i + recall_chunk], m8, rn, valid, k)
            out.extend(set(row) for row in ig.tolist())
        return out

    def single_hits(exact_sets, topk):
        return sum(len(es & set(topk(queries[i])[1].tolist()))
                   for i, es in enumerate(exact_sets))

    def batch_hits(exact_sets, topk):
        hits = 0
        for i in range(0, recall_q, recall_chunk):
            for j, row in enumerate(topk(queries[i:i + recall_chunk])[1].tolist()):
                hits += len(exact_sets[i + j] & set(row))
        return hits

    def sketch_topk(pool):
        return lambda q: knn.cosine_sketch_topk(q, planes, m8, rn, sketch, valid, k, pool)

    times: dict = {"exact": [], "sketch": [], "fast": [], "int4": [],
                   "batch": [], "int4b": [], "int4b64": []}
    exact_sets = []
    hits_q = hits_f = hits_i4 = hits_i4b = 0
    for r in range(rounds):
        times["exact"].append(t_exact())
        times["sketch"].append(t_sketch(cand))
        times["fast"].append(t_sketch(cand_fast))
        times["int4"].append(t_int4())
        times["batch"].append(t_batch())
        times["int4b"].append(t_i4_batch())
        times["int4b64"].append(t_i4_batch(qb64f))
        if r == 0:
            exact_sets = ground_truth()
        if r == min(1, rounds - 1):
            hits_q = single_hits(exact_sets, sketch_topk(cand))
            hits_i4 = single_hits(exact_sets, lambda q: knn.cosine_int4_topk(
                q, m8, rn, packed_t, inv_n4, valid, k, pool_i4, n_valid=n))
        if r == rounds - 1:
            hits_f = single_hits(exact_sets, sketch_topk(cand_fast))
            hits_i4b = batch_hits(exact_sets, lambda qs: knn.cosine_int4_topk_batched(
                qs, m8, rn, packed_t, inv_n4, n, k, pool_i4b))

    # planted near-duplicates (the product workload): a noisy copy of a
    # stored row at cosine ~0.99 / 0.7 / 0.5 must surface at the fast
    # pool. Per-dim noise sigma vs uniform-int8 rows (rms ~73.9 per dim):
    # tan(theta) = sigma / 73.9.
    sigma = {0.99: 10.5, 0.7: 75.0, 0.5: 128.0}
    planted = dict.fromkeys(sigma, 0)
    gp = _gen(dev, 10)
    plant_rows = torch.randint(0, n, (8,), generator=gp, device=dev).tolist()
    for row in plant_rows:
        for cos_t, sg in sigma.items():
            qp = m8[row].float() + torch.randn(d, generator=gp, device=dev) * sg
            _s, ipl = knn.cosine_sketch_topk(qp, planes, m8, rn, sketch, valid, k, cand_fast)
            planted[cos_t] += int(row in ipl.tolist())

    # -- one shard of an n / shards row-sharded catalog, on this card ----
    shard_n = _tiled_rows(n // shards)
    per_shard = {}
    if shard_n:
        m8_s, rn_s = m8[:shard_n], rn[:shard_n]
        pk_s, inv_s = packed_t[:, :shard_n].contiguous(), inv_n4[:shard_n]
        iters_shard = iters * 8
        per_shard = {
            "query_sharded_per_shard_exact_p50_ms": t_exact(m8_s, rn_s, iters_shard),
            "query_sharded_per_shard_p50_ms": t_sketch(
                knn.sketch_pool(shard_n, k), m8_s, rn_s,
                sketch[:shard_n // knn.SKETCH_LANES],
                torch.ones(shard_n, dtype=torch.bool, device=dev), iters_shard),
            "query_sharded_per_shard_int4_p50_ms": t_int4(
                m8_s, rn_s, pk_s, inv_s, shard_n, knn.int4_pool(shard_n, k), iters_shard),
        }
        pool_b_s = knn.int4_batch_pool(shard_n, k)
        b32 = t_i4_batch(qbf, m8_s, rn_s, pk_s, inv_s, shard_n, pool_b_s, iters * 4)
        b64 = t_i4_batch(qb64f, m8_s, rn_s, pk_s, inv_s, shard_n, pool_b_s, iters * 4)
        per_shard["query_sharded_per_shard_int4_batch32_ms_per_query"] = b32 / qbatch
        per_shard["query_sharded_per_shard_int4_batch64_ms_per_query"] = b64 / 64
        del pk_s, inv_s

    # -- packed-int2 prefilter (UCFP_KNN_QUANT=int2), after int4 and the
    # sketch are dropped -------------------------------------------------
    del packed_t, inv_n4, sketch
    packed2_t, inv_n2 = knn.pack_int2_cols_chunked(m8, chunk=TILE)
    pool_i2 = knn.int2_pool(n, k)
    pool_i2b = knn.int2_batch_pool(n, k)

    def t_int2(m=m8, rnv=rn, pk=None, inv=None, nv=n, pool=pool_i2, it=None):
        pk = packed2_t if pk is None else pk
        inv = inv_n2 if inv is None else inv
        vd = torch.ones(m.shape[0], dtype=torch.bool, device=dev)

        def step(q):
            _v, idx = knn.cosine_int2_topk(q, m, rnv, pk, inv, vd, k, pool, n_valid=nv)
            return _nudge_f32(q, _row(m, idx)[0])
        return t_loop(step, qf, it)

    def t_int2_batch2():
        # small-Q batched int2: the batch regime the cost model serves it in
        def step(q):
            _v, idx = knn.cosine_int2_topk_batched(q, m8, rn, packed2_t, inv_n2, n, k,
                                                   pool_i2b)
            return _nudge_f32(q, _row(m8, idx))
        return t_loop(step, q2f)

    times["int2"] = []
    times["int2b2"] = []
    hits_i2 = hits_i2b = 0
    for r in range(rounds):
        times["int2"].append(t_int2())
        times["int2b2"].append(t_int2_batch2())
        if r == 0:
            hits_i2 = single_hits(exact_sets, lambda q: knn.cosine_int2_topk(
                q, m8, rn, packed2_t, inv_n2, valid, k, pool_i2, n_valid=n))
        if r == min(1, rounds - 1):
            hits_i2b = batch_hits(exact_sets, lambda qs: knn.cosine_int2_topk_batched(
                qs, m8, rn, packed2_t, inv_n2, n, k, pool_i2b))
    if shard_n and shard_int2:
        per_shard["query_sharded_per_shard_int2_p50_ms"] = t_int2(
            m8[:shard_n], rn[:shard_n], packed2_t[:, :shard_n].contiguous(),
            inv_n2[:shard_n], shard_n, knn.int2_pool(shard_n, k), iters * 8)

    n_trials = recall_q * k

    def recall(hits):
        p = hits / n_trials
        return p, 1.96 * (p * (1.0 - p) / n_trials) ** 0.5

    st = {name: _stats(v) for name, v in times.items()}
    unstable = any(s["range"][0] > 0 and s["range"][1] / s["range"][0] > 2.0
                   for s in st.values())
    out = {
        "query_cosine_int8_p50_ms_10m_x768": st["exact"]["p50"],
        "query_cosine_int8_range_ms": st["exact"]["range"],
    }

    def per_query(key, name, q):
        out[f"query_cosine_{key}_ms_per_query_10m_x768"] = st[name]["p50"] / q
        out[f"query_cosine_{key}_range_ms_per_query"] = [x / q for x in st[name]["range"]]

    def single(key, name):
        out[f"query_cosine_{key}_p50_ms_10m_x768"] = st[name]["p50"]
        out[f"query_cosine_{key}_range_ms"] = st[name]["range"]

    def rec(prefix, hits):
        p, ci = recall(hits)
        out[f"{prefix}_recall10_random_10m_x768"] = p
        out[f"{prefix}_recall10_ci95"] = ci

    per_query("int8_batch32", "batch", qbatch)
    per_query("int4_batch32", "int4b", qbatch)
    per_query("int4_batch64", "int4b64", 64)
    rec("int4_batch", hits_i4b)
    single("sketch", "sketch")
    out["sketch_fast_p50_ms_10m_x768"] = st["fast"]["p50"]
    out["sketch_fast_range_ms"] = st["fast"]["range"]
    single("int4", "int4")
    rec("int4", hits_i4)
    single("int2", "int2")
    rec("int2", hits_i2)
    per_query("int2_batch2", "int2b2", 2)
    rec("int2_batch", hits_i2b)
    out["sketch_timing_unstable"] = unstable
    rec("sketch", hits_q)
    p, ci = recall(hits_f)
    out["sketch_fast_recall10_random"] = p
    out["sketch_fast_recall10_ci95"] = ci
    out["recall_queries"] = recall_q
    for cos_t, v in planted.items():
        out[f"sketch_top1_planted_cos{str(cos_t).replace('0.', '')}"] = v / len(plant_rows)
    out.update(per_shard)
    out["sharded_rows_per_shard"] = shard_n
    return out


# -- audio ------------------------------------------------------------------------


def _tone_clip(secs: float, sr: int, gated: bool) -> torch.Tensor:
    """The reference bench's 60 s test signal (440 Hz plus a 1200 Hz tone,
    gated at 0.5 Hz in the 8 kHz clip), as float32 on the host."""
    import numpy as np

    t = np.arange(int(secs * sr)) / sr
    hi = 0.2 * np.sin(2 * np.pi * 1200 * t)
    if gated:
        hi = hi * (np.sin(2 * np.pi * 0.5 * t) > 0)
    return torch.from_numpy((0.4 * np.sin(2 * np.pi * 440 * t) + hi).astype(np.float32))


def bench_audio_xrt(dev, algorithm: str = "wang", secs: float = 60.0,
                    iters: int = 128) -> float:
    """x real time of one clip's extraction on the device: wang / panako
    (integer spectrogram, peak picking, pairing; 8 kHz) or haitsma /
    haitsma_fft (5 kHz words). Each step adds (the previous step's
    landmark count, or its words' low bits, mod 7) * 1e-7 to the clip's
    first sample, a data dependency between steps."""
    from .ops.audio import constellation as con
    from .ops.audio import dsp as adsp
    from .ops.audio import haitsma as hops

    haitsma = algorithm.startswith("haitsma")
    x0 = _tone_clip(secs, hops.HAITSMA_SR if haitsma else 8000, not haitsma).to(dev)
    cfg = con.PanakoConfig() if algorithm == "panako" else con.WangConfig()
    pair = con.panako_triplets if algorithm == "panako" else con.wang_pairs

    def delta(x):
        if haitsma:
            w = hops.haitsma_words(x, 300.0, 2000.0, algorithm == "haitsma_fft")
            return (w & 7).sum() % 7
        power = adsp.stft_power_int(x, 1024, 256, True).to(torch.float32)
        t, f, v = con.pick_peaks(power, 8000 // 256, cfg.peaks_per_sec,
                                 cfg.min_anchor_mag_db)
        _h, _aux, ok = pair(t, f, v, cfg.fan_out, cfg.target_zone_t, cfg.target_zone_f)
        return ok.sum() % 7

    def step(x):
        return torch.cat([x[:1] + delta(x).to(torch.float32) * 1e-7, x[1:]])

    return secs / _timed(_loop(dev, step, x0), iters)


def bench_audio_match(dev, n_records: int = 10_000, per: int = 100,
                      queries: int = 15) -> float:
    """knn_audio p50 (ms) at n_records x per landmarks (10^6 postings):
    the host-side landmark vote, in an EmbeddedBackend on `dev`; every
    query (a stored record's landmarks shifted by 137 frames) must find
    its record at rank 1."""
    import asyncio
    import shutil
    import tempfile

    import numpy as np

    from .core import Modality, Record
    from .index.embedded import EmbeddedBackend

    rng = np.random.default_rng(7)
    tmp = tempfile.mkdtemp(prefix="ucfp-amatch-")
    b = EmbeddedBackend(tmp, device=dev)

    async def go():
        keep, batch = {}, []
        for rid in range(1, n_records + 1):
            h = rng.integers(0, 1 << 30, size=per, dtype=np.uint32)
            t = np.sort(rng.integers(0, 2000, size=per)).astype(np.uint32)
            pairs = np.stack([h, t], axis=1)
            if rid % 997 == 0:
                keep[rid] = pairs
            batch.append(Record(0, rid, Modality.AUDIO, "audiofp-wang-v1",
                                pairs.astype("<u4").tobytes()))
            if len(batch) >= 1000:
                await b.upsert(batch)
                batch = []
        if batch:
            await b.upsert(batch)
        lat, rids = [], sorted(keep)
        for i in range(queries):
            rid = rids[i % len(rids)]
            qp = keep[rid].copy()
            qp[:, 1] += 137
            t0 = time.perf_counter()
            hits = await b.knn_audio(0, "audiofp-wang-v1", qp.astype("<u4").tobytes(), 3)
            lat.append(time.perf_counter() - t0)
            if not hits or hits[0].record_id != rid:
                raise RuntimeError(f"audio match: record {rid} not at rank 1")
        return sorted(lat)[len(lat) // 2] * 1000.0

    try:
        return asyncio.run(go())
    finally:
        b.close()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_text_minhash(dev, n: int = 200) -> dict:
    """MinHash fingerprints per second of the reference bench's ~5.6 KiB
    pangram document (canonicalize, the native UAX#29 tokenizer and the
    fused shingle-XXH3-minhash of native/textsig.cpp: host code, `dev`
    is unused), and the ms per document of it and of a mixed French /
    CJK document of the same size (the full-Unicode native scanner)."""
    from .modality.text import fingerprint_minhash

    def per_doc(doc: str) -> float:
        fingerprint_minhash(doc, 1, 1)  # warm (builds the library if stale)
        t0 = time.perf_counter()
        for i in range(n):
            fingerprint_minhash(doc, 1, i)
        return (time.perf_counter() - t0) / n

    pangram = "The quick brown fox jumps over the lazy dog. "
    per = per_doc((pangram * (5734 // len(pangram) + 1))[:5734])
    udoc = ("Voilà l'objectif qu'il préférait — déjà vu, café, naïve, "
            "中文混入 textes français avec des accents éèêë. " * 64)[:5600]
    return {"text_minhash_docs_per_sec": round(1.0 / per, 1),
            "text_minhash_ms_per_doc_5k6": round(per * 1e3, 4),
            "text_minhash_unicode_ms_per_doc_5k6": round(per_doc(udoc) * 1e3, 4)}


# -- the run ----------------------------------------------------------------------


def _key_list(full: bool) -> list:
    """(key, bench function, its arguments) in the reference's order."""
    keys = [
        ("query_cosine_int8_p50_ms_10m_x768", bench_cosine_int8_10m_768,
         {"shard_int2": full}),
        ("multihash_images_per_sec", bench_multihash, {}),
        ("query_hamming_fused_p50_ms_10m_x64bit", bench_hamming_10m_fused, {"iters": 32}),
        ("query_cosine_int8_hybrid_p50_ms_10m_x64", bench_cosine_int8_10m_hybrid,
         {"iters": 16}),
        ("query_cosine_int8_mxu_p50_ms_10m_x64", bench_cosine_int8_10m_mxu, {"iters": 16}),
        ("query_cosine_int8_fused_p50_ms_10m_x64", bench_cosine_int8_10m_fused,
         {"iters": 16}),
        ("audio_wang_xrt", bench_audio_xrt, {"algorithm": "wang"}),
        ("audio_panako_xrt", bench_audio_xrt, {"algorithm": "panako"}),
        ("audio_haitsma_xrt", bench_audio_xrt, {"algorithm": "haitsma", "iters": 32}),
        ("audio_haitsma_fft_xrt", bench_audio_xrt, {"algorithm": "haitsma_fft",
                                                    "iters": 8}),
        ("audio_match_p50_ms_1m_landmarks", bench_audio_match, {}),
        ("text_minhash_docs_per_sec", bench_text_minhash, {}),
    ]
    if full:
        keys += [
            ("query_cosine_p50_ms_1m_x64", bench_query_p50, {}),
            ("query_hamming_p50_ms_10m_x64bit", bench_hamming_10m, {}),
            ("query_cosine_int8_p50_ms_10m_x64", bench_cosine_int8_10m, {}),
        ]
    return keys


def _release(dev: torch.device) -> None:
    """Drop the last key's catalogs before the next multi-GB one."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def card_line(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card ("cpu" on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return lines[min(index, len(lines) - 1)].strip()


def _run_all(dev: torch.device) -> tuple[dict, dict]:
    """Every key -> (the 10M x 768 family, the last line's object)."""
    only = [s for s in os.environ.get("UCFP_BENCH_ONLY", "").split(",") if s]
    full = os.environ.get("UCFP_BENCH_FULL") == "1"
    budget_s = float(os.environ.get("UCFP_BENCH_BUDGET_S", "1800"))
    t_start = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if not only or any(s in "phash" for s in only):
        headline = bench_phash(dev)
        _release(dev)
    else:
        headline = "skipped: not in UCFP_BENCH_ONLY"
    extra, x768 = {}, {}
    for name, fn, kwargs in _key_list(full):
        if only and not any(s in name for s in only):
            continue
        if time.perf_counter() - t_start > budget_s:
            (x768 if "x768" in name else extra)[name] = "skipped: bench budget exhausted"
            continue
        value = fn(dev, **kwargs)
        if isinstance(value, dict):  # a key with its companion keys
            target = x768 if "x768" in name else extra
            target[name] = value.pop(name)
            target.update(value)
        else:
            extra[name] = value
        _release(dev)
    device = {"type": dev.type, "card": card_line(dev)}
    if dev.type == "cuda":
        device.update(kind=torch.cuda.get_device_name(dev), count=torch.cuda.device_count(),
                      peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    last = {"metric": "phash images/sec/chip", "value": headline, "unit": "images/s",
            "device": device, "extra": extra,
            "seconds": time.perf_counter() - t_start}
    return x768, last


def run(dev: torch.device) -> tuple[dict, dict]:
    """Every key on dev -> (the 10M x 768 line, the last line); under
    torch.profiler when UCFP_PROFILE_DIR is set."""
    profile_dir = os.environ.get("UCFP_PROFILE_DIR")
    if not profile_dir:
        return _run_all(dev)
    from .server.profiler import record_trace

    out, info = record_trace(lambda: _run_all(dev), profile_dir,
                             f"ucfp-bench-{os.getpid()}.json")
    print(f"bench: trace written to {info['trace']}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ucfp_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; cpu only for the tests)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    x768, last = run(dev)
    line = json.dumps(last)
    if len(line.encode()) > LAST_LINE_MAX:
        raise RuntimeError(f"the last line is {len(line.encode())} bytes, "
                           f"over {LAST_LINE_MAX}")
    if x768:
        print(json.dumps({"10m_x768": x768}), flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
