#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ucfp_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernels from the checkout's sources,
and exits non-zero (printing no result) when there is no card, when the
package is missing, or when any phase fails. Phases, one findings line
each:

  1. device       the card's name and power limit (nvidia-smi)
  2. build        csrc/*.cu for sm_90a, and the build time
  3. kernels      every CUDA kernel of the served paths against its plain
                  PyTorch version on the card, at the served shapes and at
                  tie-heavy shapes: values and indices bit-equal (#4 / #5
                  at Q = 1, 5, 32 and 64, ties, n inside a tile). Kernel,
                  plain and library times (CUDA events, median of 25 runs)
                  and the bound for the same work; the int8 product
                  (torch._int_mm) held exact, its shape rules and its time;
                  the three int4 kernels bit-equal at 2^22 and 2^23 rows
                  (and D = 770), and the int4 pack on the card equal to
                  the pack on the CPU; the three int2 kernels (and their
                  indices) bit-equal at 2^22 and 2^23 rows (and D = 772),
                  the sketch scan bit-equal on three plans at 2^22 and
                  2^23, and the int2 pack and the sketch build on the card
                  equal to the same steps on the CPU; the single-query
                  Hamming scan (#6) bit-equal at 2^20 rows (a shard) and
                  2^23, W = 2 and 16, and on tie-heavy catalogs; the two
                  int8-cosine scans (#7 at the bench's 9,994,240 x 64 and
                  at 2^22 x 64; #8 at D = 64 over 9,994,240 rows, D = 32
                  and 128, and a line count that tiles by 800) bit-equal,
                  cells and top-k, with tie-heavy catalogs and an all-zero
                  query, and their errors raised; the shared top-k
                  selection kernel (select_topk) bit-equal to the stable
                  sort at 16,384, 39,040, 78,080 and 39,043 candidates,
                  Q = 1, 2 and 5 on each path (one block per query and a
                  cluster of 8 CTAs per query) and Q = 64, k from 1 to N
                  (above its shared-memory sort's 16,384 too), f32 / bf16
                  / int32, ties (across a cluster rank's boundary too),
                  +-0.0 and +-inf, and its path sweep (the cluster
                  threshold); #2 (the batched Hamming scan) bit-equal,
                  cells and top-k, on both its kernels (streaming, and the
                  int8 tensor cores) at Q = 1 to 64 on 2^23 x 2 words, at W
                  = 1, 3 and 16 with an all-invalid tile and on a tie-heavy
                  catalog, and its path sweep (the Q threshold); every
                  fused function's selection share beside torch.topk over
                  the same candidates; #3 at
                  the int4 pool (k = 2048) at 2^22, 2^23 and 9,994,240
                  rows and #1 at the int4 batch pool (bf16, k = 640); for
                  #1, #2, #3, #6, #7 and the selection also the card's own
                  time (torch.profiler)
  4. conformance  the image hashes computed on the card against
                  tests/goldens/conformance.json
  5. served       the port's EmbeddedBackend on the card, bulk-loaded with
                  2^23 pHash fingerprints, 2^20 multi bundles and
                  2^20 x 768 f32 vectors, served over loopback HTTP in this
                  process: image ingest (single and batch), the five query
                  forms, describe, delete
  6. int8         an EmbeddedBackend with knn_quant="int8" holding
                  2^21 x 768 vectors under two model ids, served over
                  loopback HTTP: vector, vectors x32, each with and without
                  a filter, and the exact tier; an upsert (the int8 row
                  patch), a query that finds it, a delete
  7. qbatch       UCFP_QUERY_BATCH_MS=2 on an int8 store of 2^19 x 768
                  vectors and 2^20 pHash rows: 32 client threads send 64
                  single vector and 64 single fingerprint_hex requests at
                  once; every answer equals the unbatched one and the
                  flushes are fewer than the requests
  8. int4         an EmbeddedBackend with knn_quant="int4" (and
                  UCFP_QUERY_BATCH_MS=2) holding 2^22 x 768 vectors under
                  two model ids, served over loopback HTTP: with batching
                  off, vector, vectors x32, each with and without a filter,
                  and the exact tier; an upsert (the packed column patch),
                  a query that finds it, a delete; then with batching on,
                  64 single vector requests from 32 client threads, each
                  answer equal to the unbatched one
  9. int2         an EmbeddedBackend with knn_quant="int2" holding
                  2^22 x 768 vectors under two model ids, served over
                  loopback HTTP: vector (and with a filter), vectors x1
                  and x32, the exact tier, and vector under
                  UCFP_INT2_TOPQ=1 (the in-kernel top-8 scan, whose hits
                  equal the default path's); an upsert (the packed column
                  patch), a query that finds it, a delete
 10. sketch       the same store shape under knn_quant="sketch": vector
                  at the fast and balanced recall tiers (and fast with a
                  filter), vector at the default tier (served exact by
                  the cost model), vectors x32, the exact tier; an upsert
                  (the tiled sketch patch), a fast query that finds it, a
                  delete
 11. sharded      a mesh of 8 shards on the one card: (a) every sharded
                  function of parallel.sharded_knn on device tensors made
                  from a seed (the fused Hamming scan at 2^23 x 2 words;
                  int8, int4, int2 and sketch at 2^22 x 768, single and
                  batched forms at Q = 1 and 32, filtered and not; int4
                  batched and sketch also on a 2 x 4 mesh) held against the
                  same function with every kernel swapped for its plain
                  version, values and rows bit-equal; (b) an int8
                  EmbeddedBackend on that mesh, bulk-loaded with 2^20 - 1024
                  pHash rows and 2^20 - 1024 x 768 vectors, served over
                  loopback HTTP: fingerprint_hex, fingerprints_hex x32,
                  vector, vectors x32, a filtered vector, the exact tier, an
                  upsert that a query finds, a delete
 12. bench        the port's bench entry point (ucfp_tpu_torch.bench) in
                  this process: the phash headline, the 10M x 64 query
                  keys (exact and fused Hamming; exact, hybrid, mxu and
                  fused int8 cosine) and the five audio keys (Wang,
                  Panako, Haitsma and Haitsma-FFT extraction xRT, the
                  landmark-vote p50), each a finite positive number, with
                  #4, #6, #7 and #8 launched and the last line parsed
 13. audio        the classical audio path: (a) the min-BER kernel
                  (csrc/min_ber.cu, the binary tensor cores) bit-equal to
                  its plain version (BER bits and offsets) at the served
                  shape (2^14 rows x Tb 4,096, a 359-word query), on a
                  tie-heavy catalog, with rows shorter than the query and
                  dead rows, at q_true = 1 and q_true = Tb, and on one row
                  of 2^18 words; and with random words past each row's
                  length and past q_true: at q_true = 100, at q_true = 0,
                  7, 8 and 9, at 201 offsets a row (no multiple of 128),
                  and at q_true = 1,100 (three passes of the kernel's 512
                  query words), and at Tb = 1,021 (rows not 16-byte
                  aligned); (b) the integer spectrograms (n_fft 1024 / shift
                  8, 2048 / shift 14, the integer FFT), the peak picker,
                  Wang pairs, Panako triplets and Haitsma words on a 60 s
                  clip on the card bit-equal to the CPU, and the 8
                  non-neural audio digests computed on the card equal to
                  tests/goldens/conformance.json; (c) an EmbeddedBackend
                  on the card holding 2^14 - 128 random 30 s Haitsma
                  streams and 10^4 Wang records of 100 landmarks, served
                  over loopback HTTP: batch ingest of 64 x 30 s s16 clips
                  and one single ingest per algorithm (wang, panako,
                  haitsma; fingerprints equal to the CPU's), a watermark
                  report, fingerprint_hex for each algorithm and
                  fingerprints_hex x 8 for Haitsma (each excerpt finds its
                  clip at rank 1), a Haitsma upsert a query then finds,
                  a delete

 14. text         text and hybrid search: (a) the 18 text/* digests
                  computed on this host (the native text code built here
                  with g++, and the Python path) equal to
                  tests/goldens/conformance.json, and the image/semantic
                  and audio/neural embeddings on the card at cosine >=
                  0.999999 to the port's on the CPU; (b) an EmbeddedBackend
                  on the card holding 2^18 - 1024 columnar rows each of
                  MinHash (258 words), SimHash and 384-d semantic vectors,
                  served over loopback HTTP: batch ingest of 2^14 documents
                  of 5.6 KiB (a Zipf vocabulary) as MinHash and as SimHash,
                  2^12 as LSH and as TLSH, 128 a request, 256 semantic
                  text ingests; terms (and ?explain=1), the hybrid (vector
                  + terms), vector, vectors x32, fingerprint_hex for
                  MinHash, SimHash, LSH and TLSH (each document's own at
                  rank 1), fingerprints_hex x32 SimHash, the semantic image
                  and neural audio ingest routes; hits equal to the plain
                  path (the exact MinHash / TLSH scan recomputed on the
                  device tensors as byte XOR and a popcount table), the
                  hybrid equal to RRF of its two legs computed apart, and
                  the native BM25 engine equal to the Python one over the
                  2^14 documents

In phases 5-11, 13 and 14 every served answer is checked against the plain
path on the same device tensors (or, in phases 7 and 8, the micro-batched
answer against the unbatched one), and the launch count of every kernel
that the phase's path runs must rise between a reset just before the
phase's requests and a read just after (in phase 12, around the bench's
run). Then one JSON line with every kernel's numbers (launches summed over
phases 5-14), and last the line {"ok": true, "device": {...}}.
--phases picks a subset (default: all fourteen). One more phase, ab, is
in no default run: the times of #13, #4 / #5, #6, #2, #7, the
one-query selection and min-BER alone, with no check, for an A/B against a parent's
checkout (phase_ab); and mma_rates, the throughput of three mma.sync
shapes (phase_mma_rates).
"""

import argparse
import asyncio
import contextlib
import http.client
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: the HBM3 rate at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# Issue rates per clock per SM of compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput). The scans do
# 32-bit compares, XORs and adds (64) and population counts (16); the
# data sheet's 67 T/s float32 rate counts an FMA as two operations and
# says nothing of integer logic. Times the card's SM count and its
# maximum SM clock, both read in this run.
ALU_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
# NVIDIA H100 SXM data sheet, dense, at 700 W: float32 outside the tensor
# cores, and int8 on the tensor cores
F32_OPS_PER_S = 67e12
INT8_MMA_OPS_PER_S = 1979e12
# The binary (b1) AND-popcount product on the tensor cores: the int8 rate
# x 8 (an m16n8k256 b1 product pairs 16 x 8 x 256 bits where an m16n8k32
# s8 product pairs 16 x 8 x 32 bytes) x the s8 / b1 SM clocks a product
# that phase mma_rates measured on an H100 (1.70 / 1.71). An AND and an
# add a bit pair count as 2 operations, as an int8 multiply-add does.
B1_MMA_OPS_PER_S = INT8_MMA_OPS_PER_S * 8 * 1.70 / 1.71
RUNS = 25  # CUDA-event samples per kernel timing

# the served catalogs (phase 5) and the timed requests per query form
PHASH_ROWS = 1 << 23  # the README's 10M x 64-bit Hamming shape, cut to 2^23
MULTI_ROWS = 1 << 20
VEC_ROWS = 1 << 20
DIM = 768  # the BASELINE image-embedding width
SERVED_REPS = 20
# phase 6: the README's int8 cosine 10M x 768 BASELINE, cut to 2^21 rows to
# keep the run's time: at 2^23 the bulk load met the 96 GiB host limit, and
# with phase 6 at 2^22 the whole run took 1,010 s on one H100, 250 s more
# than at 2^21 (PERF.md, Cells); #3-#5 and the int8 product all serve at
# 2^21.
# Phase 3 holds the int8 kernels at 2^22 (the other quantized phases'
# size) and 2^23 rows
INT8_SERVED_ROWS = 1 << 21
INT8_ROWS = 1 << 22
INT8_KERNEL_ROWS = (INT8_ROWS, 1 << 23)
# phase 7: micro-batching, on catalogs small enough to keep the run short
QBATCH_VEC_ROWS = 1 << 19  # 2^20 at first; halved to keep the whole run in time
QBATCH_PHASH_ROWS = 1 << 20
QBATCH_MS = 2
QBATCH_CLIENTS = 32
QBATCH_REQUESTS = 64  # per form (vector, fingerprint_hex)
# phase 8: the int4 tier at phase 6's size (the same host-memory cut), where
# the reference's cost model serves all three int4 kernels; phase 3 holds
# them at the served rows and at 2^23
INT4_ROWS = 1 << 22
INT4_KERNEL_ROWS = (INT4_ROWS, 1 << 23)
INT4_QBATCH_REQUESTS = 64
# phases 9 and 10: the int2 and sketch tiers at phase 6's size (the same
# host-memory cut); at 2^21 the reference's cost model serves neither the
# batched int2 scan nor the sketch scan at any Q or tier. Phase 3 holds
# their kernels at the served rows and at 2^23
INT2_ROWS = 1 << 22
INT2_KERNEL_ROWS = (INT2_ROWS, 1 << 23)
SKETCH_ROWS = INT2_ROWS
SKETCH_KERNEL_ROWS = (SKETCH_ROWS, 1 << 23)
# phase 11: 8 shards on the one card. The fused Hamming scan at phase 5's
# 2^23 x 64-bit shape (2^20 rows per shard, the shard size phase 3 holds
# #6 at); the quantized tiers at phases 8-10's 2^22 x 768 (2^19 rows per
# shard); the served store at 2^20 rows, to keep the phase near 150 s.
SHARDS = 8
SHARD_HAMMING_ROWS = 1 << 23
SHARD_VEC_ROWS = 1 << 22
SHARD_SERVED_ROWS = 1 << 20
SHARD_RUNS = 10  # CUDA-event samples per phase-11 timing
# #7 and #8 at the bench's 10M x 64 shape: 10M rows cut to whole 32,768-row
# tiles (bench.py:377-381; ucfp_tpu_torch.bench runs them there)
BENCH_X64_ROWS = (10_000_000 // (1 << 15)) * (1 << 15)
# phase 3's (rows, width, tie-heavy) cases of #7 and #8; #8's 2,000,000 rows
# of 64 are 1,000,000 lines, which _pick_rpt tiles by 800
COSINE_I8_CASES = ((BENCH_X64_ROWS, 64, False), (1 << 22, 64, False), (1 << 22, 64, True))
COSINE_I8_MXU_CASES = ((BENCH_X64_ROWS, 64, False), (1 << 22, 32, False),
                       (1 << 22, 128, False), (2_000_000, 64, False), (1 << 22, 64, True))

PHASH = "imgfprint-phash-v1"
MULTI = "imgfprint-multi-v1"
SEM = "embedding-image-local"


def say(line: str) -> None:
    print(line, flush=True)


def _kernel_modules():
    from ucfp_tpu_torch.ops import fused_scan, int2_scan, int4_scan, sketch_scan
    from ucfp_tpu_torch.ops.audio import haitsma

    return fused_scan, int4_scan, int2_scan, sketch_scan, haitsma


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by name."""
    return {name: n for mod in _kernel_modules() for name, n in mod.LAUNCHES.items()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, runs: int = RUNS) -> float:
    """Median of `runs` CUDA-event timings of fn() after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, runs: int = 20):
    """The card's own time for fn(): the CUDA kernels' time per call in a
    torch.profiler trace of `runs` calls, or None where the trace shows no
    device time. A small function's CUDA-event time is its host time when
    the wrapper takes longer to enqueue than the card takes to run."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return total / runs / 1e3 if total > 0 else None


def host_ms(torch, fn, calls: int = 200) -> float:
    """The host's time per call of fn(): `calls` calls enqueued back to
    back on the host clock, before the card is waited for (a few hundred
    launches stay inside the launch queue, so the host never waits for
    the card here)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def bound_ms(card: dict, nbytes: float, alu_ops: float = 0.0,
             popc_ops: float = 0.0, f32_ops: float = 0.0,
             int8_mma_ops: float = 0.0, b1_mma_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes over the HBM rate and the operations over
    the card's rate for their type; the ALU, popcount, float32 and tensor
    core pipes run side by side, so the busiest sets the operations'
    time."""
    clocks = card["sms"] * card["sm_clock_hz"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(alu_ops / (ALU_PER_CLK_SM * clocks),
                popc_ops / (POPC_PER_CLK_SM * clocks),
                f32_ops / F32_OPS_PER_S,
                int8_mma_ops / INT8_MMA_OPS_PER_S,
                b1_mma_ops / B1_MMA_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ----------------------------------------------------------------


def _smi(query: str, units: bool = True) -> str:
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}", fmt],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi {query}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    say(_smi("name,power.limit"))
    card = {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "sm_clock_hz": float(_smi("clocks.max.sm", units=False)) * 1e6}
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {torch.cuda.get_device_capability(0)}, "
        f"{card['sms']} SMs, max SM clock {card['sm_clock_hz'] / 1e6:.0f} MHz")
    return card


# -- phase 2 ----------------------------------------------------------------


def phase_build() -> None:
    from ucfp_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_kernels()
    secs = time.perf_counter() - t0
    regs = [ln.split("Used", 1)[1].split(",")[0].strip()
            for ln in _build.build_info["log"].splitlines() if "Used" in ln]
    spills = [ln.strip() for ln in _build.build_info["log"].splitlines()
              if "bytes spill" in ln and not ln.strip().startswith("0 bytes")]
    say(f"build: csrc/*.cu -> {os.path.relpath(_build.KERNEL_LIB, HERE)} in "
        f"{secs:.2f} s; {len(regs)} kernels, registers {sorted(set(regs))}; "
        f"spills {spills[:2]}")


# -- phase 3 ----------------------------------------------------------------


def _same_bits(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(a.dtype)
    return torch.equal(a.view(view), b.view(view)) if view else torch.equal(a, b)


def _max_abs(torch, a, b) -> float:
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    check(torch.equal(torch.isfinite(a), torch.isfinite(b)), "same non-finite slots")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def _select_split(torch, vals, gidx, k: int, largest: bool) -> dict:
    """A fused function's selection share: the selection kernel alone on
    the function's own candidates (CUDA events and card time), and
    torch.topk over the same candidates (the selection half's library
    yardstick)."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    def select():
        return fs._select_cuda(vals, gidx, k, largest)

    return {"select_ms": time_ms(torch, select), "select_device_ms": device_ms(torch, select),
            "select_library_ms": time_ms(torch, lambda: torch.topk(
                vals, k, dim=1, largest=largest))}


def _library_pair(torch, s, rows_per_tile: int, k: int, largest: bool = True) -> dict:
    """The scores scans' library yardsticks: torch.max (or min) over each
    (tile, lane) cell of [Q, C] scores, and that call followed by torch.topk
    over the cells' values, timed as one pair."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    q, c = s.shape
    s4 = s.view(q, c // (rows_per_tile * fs.LANES), rows_per_tile, fs.LANES)
    red = torch.max if largest else torch.min

    def pair():
        return torch.topk(red(s4, dim=2).values.reshape(q, -1), k, dim=1, largest=largest)

    return {"cells_library_ms": time_ms(torch, lambda: red(s4, dim=2)),
            "library_ms": time_ms(torch, pair)}


def phase_kernels(torch, dev, card: dict) -> dict:
    from ucfp_tpu_torch.ops import fused_scan as fs

    g = torch.Generator(device=dev).manual_seed(1234)
    k = 16
    results = {"scores": [], "hamming": []}

    # kernel #1: per-cell argbest over scores
    for q, c, dtype, ties in ((1, 1 << 20, torch.float32, False),
                              (32, 1 << 20, torch.float32, False),
                              (1, 1 << 20, torch.bfloat16, False),
                              (32, 1 << 20, torch.bfloat16, False),
                              (32, 1 << 20, torch.float32, True)):
        if ties:
            s = torch.zeros((q, c), device=dev)  # every cell ties
        else:
            s = torch.randn((q, c), generator=g, device=dev)
            s[:, 1000:1300] = s[:, 5:6]  # duplicated values inside a tile
            s[:, -70000:-40000] = float("-inf")  # invalid rows
        s = s.to(dtype).contiguous()
        cells_k = fs._scores_cells_cuda(s, True)
        torch.cuda.synchronize()
        cells_p = fs._scores_cells_plain(s, True)
        check(_same_bits(torch, cells_k[0], cells_p[0])
              and torch.equal(cells_k[1], cells_p[1]),
              f"scores cells bit-equal q={q} {dtype} ties={ties}")
        # k = 16, and for bf16 at Q = 32 also the int4 batch pool (k = 640)
        for kk in (k, 640) if dtype == torch.bfloat16 and q == 32 else (k,):
            vk, ik = fs.scores_topk_fused_batched(s, kk)
            torch.cuda.synchronize()
            vp, ip = fs.scores_topk_fused_batched_plain(s, kk)
            check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                  f"scores top-k bit-equal q={q} {dtype} ties={ties} k={kk}")
            esize = s.element_size()
            nbytes = q * c * esize + q * kk * (esize + 4)
            b, by = bound_ms(card, nbytes, alu_ops=q * c)  # one compare per score
            results["scores"].append({
                "q": q, "c": c, "k": kk, "dtype": str(dtype).replace("torch.", ""),
                "ties": ties, "max_abs_err": _max_abs(torch, vk, vp),
                "ms": time_ms(torch, lambda: fs.scores_topk_fused_batched(s, kk)),
                "device_ms": device_ms(torch, lambda: fs.scores_topk_fused_batched(s, kk)),
                "cells_ms": time_ms(torch, lambda: fs._scores_cells_cuda(s, True)),
                **_select_split(torch, *cells_k, kk, True),
                "plain_ms": time_ms(torch, lambda: fs.scores_topk_fused_batched_plain(s, kk)),
                **_library_pair(torch, s, fs.ROWS_PER_TILE, kk),
                "bound_ms": b, "bound_by": by,
            })

    _kernels_hamming(torch, dev, card, g, k, results)
    results.update(scores1=[], dots_norm=[], dots_norm_batched=[], int8_dots=[],
                   int_mm_rules=[_int_mm_rules(torch, dev)])
    for c in INT8_KERNEL_ROWS:
        _kernels_int8(torch, dev, card, g, k, c, results)
    # #3 at the served catalogs and at the bench's 10M rows (305 tiles)
    for c in (*INT8_KERNEL_ROWS, BENCH_X64_ROWS):
        _kernels_scores1(torch, dev, card, g, c, results)
    _kernels_select(torch, dev, card, g, results)
    results.update(int4_pack=[], int4_dots=[], int4_scores=[], int4_scores_batched=[])
    for c in INT4_KERNEL_ROWS:
        _kernels_int4(torch, dev, card, g, c, DIM, results)
    # an even width that is not a multiple of 8: a partial last dim group
    _kernels_int4(torch, dev, card, g, INT4_ROWS, DIM + 2, results)
    _kernels_int4_wide(torch, dev, g, results)
    results.update(int2_pack=[], int2_scores=[], int2_scores_batched=[], int2_topq=[])
    for c in INT2_KERNEL_ROWS:
        _kernels_int2(torch, dev, card, g, c, DIM, results)
    # a multiple of 4 that is not a multiple of 16: a partial last group
    _kernels_int2(torch, dev, card, g, INT2_ROWS, DIM + 4, results)
    _kernels_int2_wide(torch, dev, g, results)
    results.update(sketch_build=[], sketch=[])
    for c in SKETCH_KERNEL_ROWS:
        _kernels_sketch(torch, dev, card, g, c, results)
    results["hamming1"] = []
    # and at the bench's fused Hamming key, 9,994,240 x 64-bit (305 tiles of
    # 256 x 128 rows: 39,040 candidates)
    for c, w, ties in ((1 << 20, 2, False), (1 << 23, 2, False), (1 << 20, 16, False),
                       (1 << 23, 16, False), (1 << 20, 2, True), (1 << 23, 16, True),
                       (BENCH_X64_ROWS, 2, False)):
        _kernels_hamming1(torch, dev, card, g, k, c, w, ties, results)
    _kernels_cosine_int8(torch, dev, card, g, results)
    for name, rows in results.items():
        say(f"kernels/{name}: " + json.dumps(rows))
    return results


def _hamming_bound(card: dict, q: int, c: int, w: int, k: int) -> dict:
    """#2's bound, the least over its two formulations of the same work: W
    popcounts per (query, row) (16 per clock per SM), or the exact int8
    product of +1 / -1 query bits and 0 / 1 row bits (2 * 16 * ceil(Q / 16)
    * C * 32W operations on the tensor cores) and one max per (query, row);
    both read each row's 4W + 1 bytes once, the queries, and write the k
    best. The popcount form stays beside it as bound_popc_ms."""
    nbytes = c * (4 * w + 1) + q * w * 4 + q * k * 8
    # per (query, row): w XORs, w - 1 adds and one compare on the ALU pipe,
    # w popcounts on the popcount pipe
    popc = bound_ms(card, nbytes, alu_ops=q * c * 2 * w, popc_ops=q * c * w)
    mma = bound_ms(card, nbytes, alu_ops=q * c,
                   int8_mma_ops=2 * 16 * -(-q // 16) * c * 32 * w)
    b, by = min(popc, mma)
    return {"bound_ms": b, "bound_by": by, "bound_popc_ms": popc[0], "bound_mma_ms": mma[0]}


# #2's phase-3 cases: (Q values, rows, words, tie-heavy, an all-invalid tile);
# the served pHash shape at every Q a batch takes to either path, then the
# other widths at 2^20 rows
HAMMING_CASES = (((1, 2, 4, 5, 8, 9, 16, 17, 32, 33, 64), 1 << 23, 2, False, False),
                 ((5, 33), 1 << 20, 1, False, True), ((5, 33), 1 << 20, 3, False, True),
                 ((5, 33), 1 << 20, 16, False, True), ((1, 32), 1 << 20, 16, False, False),
                 ((32,), 1 << 20, 2, True, False))
HAMMING_SWEEP_QS = (1, 2, 3, 4, 6, 8)  # both paths, 2^23 x 2 words


def _kernels_hamming(torch, dev, card: dict, g, k: int, results: dict) -> None:
    """Kernel #2 against its plain version: cells and top-k bit-equal on
    each path that takes the batch (the streaming kernel up to its
    stream_max_q, the tensor cores at any Q) and through the wrapper's own
    pick, on random catalogs with one row copied into its own tile and the
    last one, an all-invalid tile, or four distinct rows (ties everywhere);
    the function, its cells and its selection timed by CUDA events and on
    the card. Then the path sweep: both cells kernels' card time at Q = 1 to
    8 on the served pHash shape, beside the threshold the wrapper uses."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    results["hamming"], sweep = [], []
    for qs_list, c, w, ties, dead_tile in HAMMING_CASES:
        info = fs.hamming_paths_info(w)
        if ties:
            base = torch.randint(-2**31, 2**31, (4, w), generator=g, device=dev,
                                 dtype=torch.int32)
            db = base[torch.randint(0, 4, (c,), generator=g, device=dev)]
        else:
            db = torch.randint(-2**31, 2**31, (c, w), generator=g, device=dev,
                               dtype=torch.int32)
            db[100:300] = db[7]
            db[c - 500:c - 300] = db[7]
        db = db.contiguous()
        valid = torch.rand(c, generator=g, device=dev) < 0.9
        if dead_tile:
            tile = fs.HAMMING_ROWS_PER_TILE * fs.LANES
            valid[tile:2 * tile] = False  # every cell of tile 1 holds no valid row
        for q in qs_list:
            qs = db[torch.randint(0, c, (q,), generator=g, device=dev)].clone()
            qs[0, 0] ^= 1
            what = f"q={q} c={c} w={w} ties={ties} dead_tile={dead_tile}"
            cells_p = fs._hamming_cells_plain(qs, db, valid)
            dp, ip = fs.hamming_topk_fused_batched_plain(qs, db, valid, k)
            paths = (0, 1) if q <= info["stream_max_q"] else (1,)
            for path in paths:
                cells_k = fs._hamming_cells_cuda(qs, db, valid, path)
                torch.cuda.synchronize()
                check(torch.equal(cells_k[0], cells_p[0]) and torch.equal(cells_k[1], cells_p[1]),
                      f"hamming cells equal path={path} {what}")
                dk, ik = fs._hamming_batched_topk_cuda(qs, db, valid, k, path)
                torch.cuda.synchronize()
                check(torch.equal(dk, dp) and torch.equal(ik, ip),
                      f"hamming top-k equal path={path} {what}")
            if dead_tile:
                cell = slice(fs.LANES, 2 * fs.LANES)  # tile 1's cells: (2^30, row 0)
                check(bool((cells_k[0][:, cell] == 2**30).all())
                      and torch.equal(cells_k[1][:, cell].long() % (fs.LANES * fs.LANES),
                                      torch.arange(fs.LANES, device=dev).expand(q, -1)),
                      f"hamming all-invalid tile {what}")
            dk, ik = fs.hamming_topk_fused_batched(qs, db, valid, k)
            torch.cuda.synchronize()
            check(torch.equal(dk, dp) and torch.equal(ik, ip), f"hamming top-k equal {what}")
            path = 1 if q >= info["mma_min_q"] else 0

            def whole():
                return fs.hamming_topk_fused_batched(qs, db, valid, k)

            def cells():
                return fs._hamming_cells_cuda(qs, db, valid)

            cells_k = cells()
            results["hamming"].append({
                "q": q, "c": c, "w": w, "ties": ties, "dead_tile": dead_tile,
                "path": ("stream", "mma")[path], "max_abs_err": _max_abs(torch, dk, dp),
                "ms": time_ms(torch, whole), "device_ms": device_ms(torch, whole),
                "cells_ms": time_ms(torch, cells), "cells_device_ms": device_ms(torch, cells),
                **_select_split(torch, *cells_k, k, False),
                "plain_ms": time_ms(torch, lambda: fs.hamming_topk_fused_batched_plain(
                    qs, db, valid, k)),
                "library_ms": None, **_hamming_bound(card, q, c, w, k),
                # the catalog's bytes the cells kernel reads: once for the
                # streaming kernel, once per block of queries on the tensor cores
                "kernel_bytes": (1 if path == 0 else -(-q // info["mma_block_q"]))
                * c * (4 * w + 1),
            })
            if c == 1 << 23 and w == 2 and not ties and q == 1:
                for sq in HAMMING_SWEEP_QS:
                    qq = db[torch.randint(0, c, (sq,), generator=g, device=dev)].clone()
                    row = {"q": sq}
                    for path, name in ((0, "stream"), (1, "mma")):
                        row[f"{name}_device_ms"] = device_ms(
                            torch, lambda: fs._hamming_cells_cuda(qq, db, valid, path))
                    sweep.append(row)
        del db, valid
        torch.cuda.empty_cache()
    faster = [r["q"] for r in sweep
              if None not in (r["mma_device_ms"], r["stream_device_ms"])
              and r["mma_device_ms"] < r["stream_device_ms"]]
    results["hamming_paths"] = [{**fs.hamming_paths_info(2), "c": 1 << 23, "w": 2,
                                 "sweep": sweep, "mma_faster_from_q": min(faster, default=None)}]


def int8_dots_plain(torch, qq, q8m, rows: int = 1 << 20):
    """The int8 product's plain version on the card, where an int32
    matmul does not run: float32 products with TF32 off, in row chunks.
    Exact for D <= 1040: every product and partial sum is an integer
    below 127^2 * D < 2^24, which float32 holds in any order."""
    q, d = qq.shape
    check(d <= 1040, "plain int8 dots are exact for D <= 1040 only")
    out = torch.empty((q, q8m.shape[0]), dtype=torch.int32, device=q8m.device)
    qf = qq.float()
    for lo in range(0, q8m.shape[0], rows):
        out[:, lo:lo + rows] = (qf @ q8m[lo:lo + rows, :d].float().T).to(torch.int32)
    return out


def _int_mm_rules(torch, dev) -> dict:
    """Which [M, K] x [K, N] shapes torch._int_mm takes on this card."""
    from ucfp_tpu_torch.ops import knn

    out = {}
    m0 = knn.INT_MM_MIN_M
    for m, kd, n in ((m0 - 1, 768, 1024), (m0, 768, 1024), (32, 772, 1024),
                     (32, 768, 1020), (32, 768, INT8_ROWS)):
        a = torch.zeros((m, kd), dtype=torch.int8, device=dev)
        b = torch.zeros((n, kd), dtype=torch.int8, device=dev)
        try:
            torch._int_mm(a, b.T)
            torch.cuda.synchronize()
            out[f"{m}x{kd}x{n}"] = "ok"
        except RuntimeError as e:
            out[f"{m}x{kd}x{n}"] = str(e).splitlines()[0][:160]
    check(out[f"{m0}x768x1024"] == "ok", f"torch._int_mm takes M={m0}: {out}")
    return out


def _kernels_int8(torch, dev, card: dict, g, k: int, c: int, results: dict) -> None:
    """Kernels #4 and #5 of the int8 tier against their plain versions, bit
    for bit, at C catalog rows and at tie-heavy shapes; then the int8
    product (a library call) against its plain version. #3 has its own
    helper (_kernels_scores1)."""
    from ucfp_tpu_torch.ops import fused_scan as fs
    from ucfp_tpu_torch.ops import knn

    tile = fs.ROWS_PER_TILE * fs.LANES
    dot_max = 127 * 127 * DIM

    def dots_case(q, ties):
        if ties:  # every dot and every norm equal
            return (torch.full((q, c), 4321, dtype=torch.int32, device=dev),
                    torch.full((c,), 5000.0, device=dev).sqrt(),
                    torch.full((q,), 0.01, device=dev))
        dots = torch.randint(-dot_max, dot_max + 1, (q, c), generator=g,
                             device=dev, dtype=torch.int32)
        rn = torch.randint(1, dot_max, (c,), generator=g, device=dev).float().sqrt()
        rn[torch.rand(c, generator=g, device=dev) < 0.05] = 0.0  # zero-norm rows
        for lo in (1000, c - 500):  # row 5 duplicated in its tile and the last
            dots[:, lo:lo + 200] = dots[:, 5:6]
            rn[lo:lo + 200] = rn[5]
        inv_q = 1.0 / torch.randint(1, dot_max, (q,), generator=g,
                                    device=dev).float().sqrt()
        return dots.contiguous(), rn, inv_q

    def dots_bound(q):
        # dots and norms read once, the k best written; per dot one
        # division and one product (float32) and one compare
        return bound_ms(card, q * c * 4 + c * 4 + q * k * 8, alu_ops=q * c,
                        f32_ops=2 * q * c)

    ns = (c, c - 1024, c - 3 * tile - 12345)  # n at C, below the last 1024 rows, mid-tile
    # kernel #4: one query
    for ties in (False, True):
        dots, rn, inv_q = dots_case(1, ties)
        d1 = dots[0]
        for n in ns:
            cells_k = fs._dots_norm_cells_cuda(dots, rn, n, inv_q, "dots_norm_topk_fused")
            torch.cuda.synchronize()
            cells_p = fs._dots_norm_cells_plain(dots, rn, n, inv_q)
            check(_same_bits(torch, cells_k[0], cells_p[0])
                  and torch.equal(cells_k[1], cells_p[1]),
                  f"dots-norm cells bit-equal q=1 n={n} ties={ties}")
            vk, ik = fs.dots_norm_topk_fused(d1, rn, n, inv_q[0], k)
            torch.cuda.synchronize()
            vp, ip = fs.dots_norm_topk_fused_plain(d1, rn, n, inv_q[0], k)
            check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                  f"dots_norm_topk_fused bit-equal n={n} ties={ties}")
            check(bool((ik[torch.isfinite(vk)] < n).all()), "no row beyond n")
        b, by = dots_bound(1)
        results["dots_norm"].append({
            "q": 1, "c": c, "ties": ties, "max_abs_err": _max_abs(torch, vk, vp),
            "ms": time_ms(torch, lambda: fs.dots_norm_topk_fused(d1, rn, c, inv_q[0], k)),
            "device_ms": device_ms(torch, lambda: fs.dots_norm_topk_fused(
                d1, rn, c, inv_q[0], k)),
            "cells_ms": time_ms(torch, lambda: fs._dots_norm_cells_cuda(
                dots, rn, c, inv_q, "dots_norm_topk_fused")),
            **_select_split(torch, *cells_k, k, True),
            "plain_ms": time_ms(torch, lambda: fs.dots_norm_topk_fused_plain(
                d1, rn, c, inv_q[0], k)),
            "library_ms": None, "bound_ms": b, "bound_by": by,
        })
        del dots, d1

    # kernel #5: one query, one partial block of QSEL, four and eight blocks
    for q in (1, 5, 32, 64):
        for ties in (False, True):
            dots, rn, inv_q = dots_case(q, ties)
            for n in ns:
                cells_k = fs._dots_norm_cells_cuda(dots, rn, n, inv_q,
                                                   "dots_norm_topk_fused_batched")
                torch.cuda.synchronize()
                cells_p = fs._dots_norm_cells_plain(dots, rn, n, inv_q)
                check(_same_bits(torch, cells_k[0], cells_p[0])
                      and torch.equal(cells_k[1], cells_p[1]),
                      f"dots-norm cells bit-equal q={q} n={n} ties={ties}")
                del cells_k, cells_p
                vk, ik = fs.dots_norm_topk_fused_batched(dots, rn, n, inv_q, k)
                torch.cuda.synchronize()
                vp, ip = fs.dots_norm_topk_fused_batched_plain(dots, rn, n, inv_q, k)
                check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                      f"dots_norm_topk_fused_batched bit-equal q={q} n={n} ties={ties}")
            if ties or q not in (1, 32):
                del dots
                continue
            b, by = dots_bound(q)
            cells_k = fs._dots_norm_cells_cuda(dots, rn, c, inv_q,
                                               "dots_norm_topk_fused_batched")

            def cells():
                return fs._dots_norm_cells_cuda(dots, rn, c, inv_q,
                                                "dots_norm_topk_fused_batched")

            results["dots_norm_batched"].append({
                "q": q, "c": c, "ties": ties, "max_abs_err": _max_abs(torch, vk, vp),
                "ms": time_ms(torch, lambda: fs.dots_norm_topk_fused_batched(
                    dots, rn, c, inv_q, k)),
                "device_ms": device_ms(torch, lambda: fs.dots_norm_topk_fused_batched(
                    dots, rn, c, inv_q, k)),
                "cells_ms": time_ms(torch, cells),
                "cells_device_ms": device_ms(torch, cells),
                "blocks_per_sm": fs.dots_norm_blocks_per_sm(q),
                **_select_split(torch, *cells_k, k, True),
                "plain_ms": time_ms(torch, lambda: fs.dots_norm_topk_fused_batched_plain(
                    dots, rn, c, inv_q, k)),
                "library_ms": None, "bound_ms": b, "bound_by": by,
            })
            del dots, cells_k

    # the int8 product: torch._int_mm, held exact against its plain version
    q8m = torch.randint(-127, 128, (c, knn.padded_dim(DIM)), generator=g,
                        device=dev, dtype=torch.int8)
    q8m[:2] = 127  # the largest products
    for q in (1, 32):
        qq = torch.randint(-127, 128, (q, DIM), generator=g, device=dev,
                           dtype=torch.int8)
        qq[0] = 127
        got = knn.int8_dots(qq, q8m)
        torch.cuda.synchronize()
        check(torch.equal(got, int8_dots_plain(torch, qq, q8m)),
              f"int8_dots exact q={q}")
        del got
        b, by = bound_ms(card, c * q8m.shape[1] + q * DIM + q * c * 4,
                         int8_mma_ops=2 * q * c * DIM)
        results["int8_dots"].append({
            "q": q, "c": c, "d": DIM,
            "route": f"torch._int_mm, M {q} -> {max(q, knn.INT_MM_MIN_M)}",
            "ms": time_ms(torch, lambda: knn.int8_dots(qq, q8m)),
            "plain_ms": time_ms(torch, lambda: int8_dots_plain(torch, qq, q8m)),
            "bound_ms": b, "bound_by": by,
        })
    del q8m
    torch.cuda.empty_cache()


def _kernels_scores1(torch, dev, card: dict, g, c: int, results: dict) -> None:
    """Kernel #3 (one query's scores, largest and smallest first) against
    its plain version, cells and top-k bit-equal at k = 16 and at the int4
    single-query pool (k = 2048), on random scores with ties inside and
    across tiles, +-0.0 and invalid rows, and on all-zero scores; timed
    (function, cells, selection, each half's library call and the pair)
    largest first on the random scores."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    for largest, ties in ((True, False), (False, False), (True, True), (False, True)):
        if ties:
            s = torch.zeros(c, device=dev)
        else:
            s = torch.randn(c, generator=g, device=dev)
            s[1000:1300] = s[5]
            s[c - 500:c - 300] = s[5]
            s[7], s[7 + 128], s[9 + 256 * 128] = -0.0, 0.0, -0.0  # signed zeros
            s[-70000:-40000] = float("-inf") if largest else float("inf")
        cells_k = fs._scores_cells_cuda(s[None], largest, "scores_topk_fused")
        torch.cuda.synchronize()
        cells_p = fs._scores_cells_plain(s[None], largest)
        check(_same_bits(torch, cells_k[0], cells_p[0])
              and torch.equal(cells_k[1], cells_p[1]),
              f"scores cells bit-equal q=1 c={c} largest={largest} ties={ties}")
        for k in (16, 2048):
            vk, ik = fs.scores_topk_fused(s, k, largest)
            torch.cuda.synchronize()
            vp, ip = fs.scores_topk_fused_plain(s, k, largest)
            check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                  f"scores_topk_fused bit-equal c={c} k={k} largest={largest} ties={ties}")
            if ties or not largest:
                continue
            b, by = bound_ms(card, c * 4 + k * 8, alu_ops=c)
            results["scores1"].append({
                "c": c, "k": k, "largest": largest, "ties": ties,
                "max_abs_err": _max_abs(torch, vk, vp),
                "ms": time_ms(torch, lambda: fs.scores_topk_fused(s, k, largest)),
                "device_ms": device_ms(torch, lambda: fs.scores_topk_fused(s, k, largest)),
                "cells_ms": time_ms(torch, lambda: fs._scores_cells_cuda(
                    s[None], largest, "scores_topk_fused")),
                **_select_split(torch, *cells_k, k, largest),
                "plain_ms": time_ms(torch, lambda: fs.scores_topk_fused_plain(s, k, largest)),
                **_library_pair(torch, s[None], fs.ROWS_PER_TILE, k, largest),
                "bound_ms": b, "bound_by": by,
            })
    del s
    torch.cuda.empty_cache()


# the selection kernel's phase-3 sizes: #3's candidates at 2^22 rows, the
# int4 batch pool's at 9,994,240 / 256 and #6's at the bench's 9,994,240 x
# 64-bit (39,040), and #7 / #8's at the bench's 10M x 64 (78,080); k =
# 20,000 is above its shared-memory sort. The cluster path is also held at
# an N that neither cluster size divides.
SELECT_NS = (16384, 39040, 78080)
SELECT_CLUSTER_NS = (*SELECT_NS, 39043)
SELECT_KS = (1, 10, 640, 2048, 20000)
# the path sweep: one block per query against a cluster of 8 CTAs per
# query, from N below the cluster threshold up to #7's candidates
SELECT_SWEEP_NS = (2048, 8192, 12288, 16384, 24576, 32768, 39040, 78080)
SELECT_SWEEP_KS = (10, 2048)


def _select_case(torch, dev, g, q: int, n: int, dtype, kind: str):
    """[q, n] candidate values of one kind: random, all zeros, 7 values
    repeated everywhere, a mix of +-0.0 and +-inf (floats), or "straddle":
    random values with a run of 16 equal best (+4.0) values across a rank
    boundary of the 8-CTA cluster and a run of 16 equal worst (-4.0) across
    one of the 16-CTA cluster, per query another boundary, so the ties the
    answer takes are split between two ranks."""
    if dtype == torch.int32:
        hi = {"random": 1 << 30, "zeros": 1, "repeats": 40, "straddle": 1 << 30}[kind]
        vals = torch.randint(0, hi, (q, n), generator=g, device=dev, dtype=torch.int32)
    else:
        vals = torch.randn((q, n), generator=g, device=dev)
        if kind == "zeros":
            vals.zero_()
        elif kind == "repeats":
            vals = vals[:, :7][:, torch.randint(0, 7, (n,), generator=g, device=dev)]
        elif kind == "signed":
            pick = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 1.5, -1.5], device=dev)
            vals = pick[torch.randint(0, len(pick), (q, n), generator=g, device=dev)]
    if kind == "straddle":
        best, worst = ((1 << 30) + 4, -4) if dtype == torch.int32 else (4.0, -4.0)
        for qi in range(q):
            b8 = -(-n // 8) * (1 + qi % 7)
            b16 = -(-n // 16) * (1 + qi % 15)
            vals[qi, b8 - 8:b8 + 8] = best
            vals[qi, b16 - 8:b16 + 8] = worst
    return vals.to(dtype).contiguous()


def _kernels_select(torch, dev, card: dict, g, results: dict) -> None:
    """The shared selection kernel (select_topk) against the stable sort
    (fused_scan._select_plain), values and indices bit-equal: N = 16,384,
    39,040, 78,080 and 39,043 candidates, Q = 1, 2 and 5 on every path (the
    path the kernel picks, one block per query, and a cluster of 8 CTAs per
    query) and Q = 64 on the path it picks (one block per query), k from 1
    to N, largest and smallest first, f32, bf16 and int32 values, on the
    kinds of _select_case. Then at Q = 1 its time beside torch.topk over
    the same candidates, the stable sort's, and the bound, and the path
    sweep (Q = 1 and 16) that sets the cluster threshold (csrc/select.cu
    CLUSTER_MIN_N)."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    results["select"], results["select_paths"] = [], []
    info = fs.select_cluster_info()
    results["select_info"] = [info]
    check(info["resident"] >= 1, f"the card schedules a cluster of 8 CTAs: {info}")
    try:  # a cluster size the kernel has no path for raises
        fs._select_cuda(torch.zeros((1, 16384), device=dev),
                        torch.zeros((1, 16384), device=dev, dtype=torch.int32), 10, True, 16)
        raised = False
    except RuntimeError:
        raised = True
    check(raised, "select_topk raises on a cluster size it does not take")
    for n in SELECT_CLUSTER_NS:
        for q in (1, 2, 5, 64) if n in SELECT_NS else (1, 2, 5):
            paths = (-1, 0, 8) if q <= 5 else (-1,)
            gidx = torch.randint(0, 1 << 30, (q, n), generator=g, device=dev,
                                 dtype=torch.int32)
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                for kind in ("random", "zeros", "repeats", "signed", "straddle"):
                    if dtype == torch.int32 and kind == "signed":
                        continue
                    vals = _select_case(torch, dev, g, q, n, dtype, kind)
                    for largest in (True, False):
                        for k in (*SELECT_KS, n // 2, n):
                            if k > n:
                                continue
                            vp, ip = fs._select_plain(vals, gidx, k, largest)
                            for path in paths:
                                vk, ik = fs._select_cuda(vals, gidx, k, largest, path)
                                torch.cuda.synchronize()
                                check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                                      f"select_topk bit-equal n={n} q={q} {dtype} {kind} "
                                      f"largest={largest} k={k} path={path}")
            del vals, gidx
    for n in SELECT_NS:
        vals = torch.randn((1, n), generator=g, device=dev)
        gidx = torch.randint(0, 1 << 30, (1, n), generator=g, device=dev, dtype=torch.int32)
        for k in (k for k in SELECT_KS[1:] if k <= n):
            vk, ik = fs._select_cuda(vals, gidx, k, True)
            torch.cuda.synchronize()
            vp, ip = fs._select_plain(vals, gidx, k, True)
            check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                  f"select_topk bit-equal on the timed inputs n={n} k={k}")
            # candidates and their k indices read once, k values and indices written
            b, by = bound_ms(card, n * 4 + k * 4 + k * 8)
            results["select"].append({
                "q": 1, "n": n, "k": k, "dtype": "float32",
                "max_abs_err": _max_abs(torch, vk, vp),
                "ms": time_ms(torch, lambda: fs._select_cuda(vals, gidx, k, True)),
                "device_ms": device_ms(torch, lambda: fs._select_cuda(vals, gidx, k, True)),
                "plain_ms": time_ms(torch, lambda: fs._select_plain(vals, gidx, k, True)),
                "library_ms": time_ms(torch, lambda: torch.topk(vals, k, dim=1)),
                "library_device_ms": device_ms(torch, lambda: torch.topk(vals, k, dim=1)),
                "bound_ms": b, "bound_by": by,
            })
    # Q = 1 over every N, and Q = 16 (the most the cluster path takes on
    # 132 SMs) over #6's and #7's candidates
    for q, n in (*((1, n) for n in SELECT_SWEEP_NS), (16, 39040), (16, 78080)):
        vals = torch.randn((q, n), generator=g, device=dev)
        gidx = torch.randint(0, 1 << 30, (q, n), generator=g, device=dev, dtype=torch.int32)
        for k in SELECT_SWEEP_KS:
            row = {"q": q, "n": n, "k": k}
            for path, name in ((0, "one_block"), (8, "cluster")):
                def run(path=path):
                    return fs._select_cuda(vals, gidx, k, True, path)
                row[f"{name}_ms"] = time_ms(torch, run)
                row[f"{name}_device_ms"] = device_ms(torch, run)
            results["select_paths"].append(row)
    torch.cuda.empty_cache()


def _int4_case(torch, dev, g, c: int, d: int, results: dict):
    """Packed columns of c random int8 rows, packed on the card, with the
    edge rows the checks need: zero rows (inv_n4 == 0), rows of all +7,
    all -7 and alternating +-7 codes, and one row holding every byte
    value. The card's pack is held equal to the CPU's on a slice."""
    from ucfp_tpu_torch.ops import knn

    q8 = torch.randint(-127, 128, (c, d), generator=g, device=dev, dtype=torch.int8)
    q8[3] = 0
    q8[c - 5] = 0
    q8[5] = 127
    q8[6] = -127
    q8[9, ::2] = 127
    q8[9, 1::2] = -90
    m = 1 << 16
    t0 = time.perf_counter()
    packed_t, inv_n4 = knn.pack_int4_cols_chunked(q8)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    p_cpu, i_cpu = knn.pack_int4_cols(q8[:m].cpu())
    check(torch.equal(packed_t[:, :m].cpu(), p_cpu)
          and _same_bits(torch, inv_n4[:m].cpu(), i_cpu),
          f"int4 pack on the card == on the CPU c={c} d={d}")
    check(bool((inv_n4[[3, c - 5]] == 0).all()), "zero rows: inv_n4 == 0")
    results["int4_pack"].append({"c": c, "d": d, "chunked_pack_s": pack_s})
    del q8
    dp = d // 2
    packed_t[:, 7] = (torch.arange(dp, device=dev) % 256 - 128).to(torch.int8)
    return packed_t, inv_n4


def _int4_unpacked(torch, packed_t):
    """The int4 values of packed_t as an int8 [C, D] catalog (hi dims, then
    the unbiased low dims): the library yardstick's input."""
    hi = torch.bitwise_right_shift(packed_t, 4)
    lo = torch.bitwise_and(packed_t, 15) - 8
    return torch.cat([hi, lo]).T.contiguous()


def _kernels_int4(torch, dev, card: dict, g, c: int, d: int, results: dict) -> None:
    """The three int4 kernels against their plain versions, bit for bit:
    Q in {1, 5, 32, 64, 70}, float32 and bfloat16 out, n at C, C - 1024
    and mid-tile; then, at the served width, each kernel's time beside
    its plain version's, torch._int_mm over the unpacked catalog (held
    exact against the corrected dots) and the bound."""
    from ucfp_tpu_torch.ops import int4_scan as i4
    from ucfp_tpu_torch.ops import knn

    dp = d // 2
    packed_t, inv_n4 = _int4_case(torch, dev, g, c, d, results)
    timed = d == DIM
    qmax = 70
    qs = torch.randint(-127, 128, (qmax, d), generator=g, device=dev, dtype=torch.int8)
    qs[0] = 127  # queries of all +-127
    qs[1] = -127
    qs[2, ::2] = -127
    wh, wl = qs[:, :dp].contiguous(), qs[:, dp:].contiguous()
    corrs = 8 * wl.to(torch.int32).sum(dim=1, dtype=torch.int32)
    ns = (c, c - 1024, c // 2 + 77)
    err = {"int4_dots": 0.0, "int4_scores": 0.0, "int4_scores_batched": 0.0}

    def same(key, got, want, what):
        torch.cuda.synchronize()
        check(_same_bits(torch, got, want), f"{what} c={c} d={d}")
        err[key] = max(err[key], _max_abs(torch, got, want))

    # #11: uncorrected dots, one query (the single kernel) and five
    for nq in (1, 5):
        h, lw = (wh[0], wl[0]) if nq == 1 else (wh[:nq], wl[:nq])
        same("int4_dots", i4.int4_dots(packed_t, h, lw), i4.int4_dots_plain(packed_t, h, lw),
             f"int4_dots bit-equal nq={nq}")
    # #9: one query's masked scores
    for n in ns:
        got = i4.int4_masked_scores(packed_t, wh[0], wl[0], inv_n4, corrs[0], n)
        same("int4_scores", got,
             i4.int4_masked_scores_plain(packed_t, wh[0], wl[0], inv_n4, corrs[0], n),
             f"int4_masked_scores bit-equal n={n}")
        check(bool(torch.isneginf(got[n:]).all()) and bool(torch.isneginf(got[3])),
              "-inf past n and on zero rows")
    # #10: query blocks, both output types
    for q in (1, 5, 32, 64, 70):
        for dtype in (torch.float32, torch.bfloat16):
            for n in ns:
                args = (packed_t, wh[:q], wl[:q], corrs[:q], inv_n4, n)
                same("int4_scores_batched",
                     i4.int4_masked_scores_batched(*args, out_dtype=dtype),
                     i4.int4_masked_scores_batched_plain(*args, out_dtype=dtype),
                     f"int4_masked_scores_batched bit-equal q={q} {dtype} n={n}")
    results["int4_pack"][-1]["max_abs_err"] = err
    if not timed:
        del packed_t, inv_n4
        torch.cuda.empty_cache()
        return

    unpacked = _int4_unpacked(torch, packed_t)

    def int_mm(q):
        a = torch.zeros((max(q, knn.INT_MM_MIN_M), d), dtype=torch.int8, device=dev)
        a[:q] = qs[:q]
        return torch._int_mm(a, unpacked.T)[:q]

    true_dots = i4.int4_dots(packed_t, wh[:32], wl[:32]) - corrs[:32, None]
    torch.cuda.synchronize()
    check(torch.equal(int_mm(32), true_dots),
          f"torch._int_mm over the unpacked catalog == corrected dots c={c}")
    del true_dots

    def bound(q, out_bytes, inv=True):
        return bound_ms(card, c * dp + (c * 4 if inv else 0) + q * c * out_bytes + q * d,
                        int8_mma_ops=2 * q * c * d)

    b, by = bound(1, 4, inv=False)
    results["int4_dots"].append({
        "q": 1, "c": c, "d": d, "max_abs_err": err["int4_dots"],
        "ms": time_ms(torch, lambda: i4.int4_dots(packed_t, wh[0], wl[0])),
        "plain_ms": time_ms(torch, lambda: i4.int4_dots_plain(packed_t, wh[0], wl[0])),
        "library_ms": time_ms(torch, lambda: int_mm(1)), "bound_ms": b, "bound_by": by,
    })
    b, by = bound(1, 4)
    results["int4_scores"].append({
        "q": 1, "c": c, "d": d, "max_abs_err": err["int4_scores"],
        "ms": time_ms(torch, lambda: i4.int4_masked_scores(
            packed_t, wh[0], wl[0], inv_n4, corrs[0], c)),
        "plain_ms": time_ms(torch, lambda: i4.int4_masked_scores_plain(
            packed_t, wh[0], wl[0], inv_n4, corrs[0], c)),
        "library_ms": time_ms(torch, lambda: int_mm(1)), "bound_ms": b, "bound_by": by,
    })
    for q in (32, 64):
        args = (packed_t, wh[:q], wl[:q], corrs[:q], inv_n4, c)
        b, by = bound(q, 2)
        results["int4_scores_batched"].append({
            "q": q, "c": c, "d": d, "dtype": "bfloat16",
            "max_abs_err": err["int4_scores_batched"],
            "ms": time_ms(torch, lambda: i4.int4_masked_scores_batched(
                *args, out_dtype=torch.bfloat16)),
            "plain_ms": time_ms(torch, lambda: i4.int4_masked_scores_batched_plain(
                *args, out_dtype=torch.bfloat16)),
            "library_ms": time_ms(torch, lambda: int_mm(q)), "bound_ms": b, "bound_by": by,
        })
    del packed_t, inv_n4, unpacked
    torch.cuda.empty_cache()


# a width past D/2 = 10,240, where one group of 8 queries' fragments no
# longer fits the batched kernel's shared memory and it reads them from
# global memory; D/2 = 10,301 also ends in a partial dim group and k-step
INT4_WIDE_D = 20602
INT4_WIDE_ROWS = 2176  # 8.5 tiles of 256 rows


def _kernels_int4_wide(torch, dev, g, results: dict) -> None:
    """The batched int4 kernel (#10, and #11 at nq > 1) at D = 20,602
    against the plain versions, bit for bit: Q in {2, 5, 64, 70}, dots,
    float32 and bfloat16 out, n at C, C - 1024 and mid-tile. The plain
    versions run on the CPU: on the card their float32 products are exact
    only below D/2 = 5,744."""
    from ucfp_tpu_torch.ops import int4_scan as i4

    c, d = INT4_WIDE_ROWS, INT4_WIDE_D
    dp = d // 2
    packed_t, inv_n4 = _int4_case(torch, dev, g, c, d, results)
    qs = torch.randint(-127, 128, (70, d), generator=g, device=dev, dtype=torch.int8)
    qs[0] = 127
    qs[1] = -127
    wh, wl = qs[:, :dp].contiguous(), qs[:, dp:].contiguous()
    corrs = 8 * wl.to(torch.int32).sum(dim=1, dtype=torch.int32)
    p_c, wh_c, wl_c, corrs_c, inv_c = (t.cpu() for t in (packed_t, wh, wl, corrs, inv_n4))
    err = {"int4_dots": 0.0, "int4_scores_batched": 0.0}
    for q in (2, 5, 64, 70):
        got = i4.int4_dots(packed_t, wh[:q], wl[:q]).cpu()
        check(torch.equal(got, i4.int4_dots_plain(p_c, wh_c[:q], wl_c[:q])),
              f"int4_dots bit-equal q={q} c={c} d={d}")
        for dtype in (torch.float32, torch.bfloat16):
            for n in (c, c - 1024, c // 2 + 77):
                got = i4.int4_masked_scores_batched(packed_t, wh[:q], wl[:q], corrs[:q],
                                                    inv_n4, n, out_dtype=dtype).cpu()
                want = i4.int4_masked_scores_batched_plain(p_c, wh_c[:q], wl_c[:q],
                                                           corrs_c[:q], inv_c, n,
                                                           out_dtype=dtype)
                check(_same_bits(torch, got, want),
                      f"int4_masked_scores_batched bit-equal q={q} {dtype} n={n} c={c} d={d}")
                err["int4_scores_batched"] = max(err["int4_scores_batched"],
                                                 _max_abs(torch, got, want))
    results["int4_pack"][-1]["max_abs_err"] = err
    del packed_t, inv_n4


def _int2_case(torch, dev, g, c: int, d: int, results: dict):
    """Packed int2 columns of c random int8 rows, packed on the card, with
    the edge rows the checks need: zero rows (inv_n2 == 0), rows whose
    every field is -2 or 1, duplicate rows inside one 512-row segment,
    and a column of every byte value. The card's pack is held equal to
    the CPU's on a slice."""
    from ucfp_tpu_torch.ops import knn

    q8 = torch.randint(-127, 128, (c, d), generator=g, device=dev, dtype=torch.int8)
    q8[3] = 0
    q8[c - 5] = 0
    q8[5] = -127  # a constant row: scale 1, every field -2
    q8[6] = 127  # every field 1
    q8[9, ::2] = 127
    q8[9, 1::2] = -90
    q8[1000:1010] = q8[1000]  # ties inside segment 1
    m = 1 << 16
    t0 = time.perf_counter()
    packed_t, inv_n2 = knn.pack_int2_cols_chunked(q8)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    p_cpu, i_cpu = knn.pack_int2_cols(q8[:m].cpu())
    check(torch.equal(packed_t[:, :m].cpu(), p_cpu)
          and _same_bits(torch, inv_n2[:m].cpu(), i_cpu),
          f"int2 pack on the card == on the CPU c={c} d={d}")
    check(bool((inv_n2[[3, c - 5]] == 0).all()), "zero rows: inv_n2 == 0")
    check(bool((packed_t[:, 5] == -128).all()) and bool((packed_t[:, 6] == 127).all()),
          "constant rows: every field -2 / every field 1")
    results["int2_pack"].append({"c": c, "d": d, "chunked_pack_s": pack_s})
    del q8
    dq = d // 4
    packed_t[:, 7] = (torch.arange(dq, device=dev) % 256 - 128).to(torch.int8)
    inv_n2[2048 + 5:2048 + 512] = 0.0  # segment 4 keeps 5 live rows
    return packed_t, inv_n2


def _int2_unpacked(torch, packed_t):
    """The int2 codes of packed_t as an int8 [C, D] catalog of 2v + 1 (the
    level v + 0.5, doubled): the library yardstick's input."""
    a = torch.bitwise_right_shift(torch.bitwise_and(packed_t, -64), 6)
    fields = [a] + [torch.bitwise_and(torch.bitwise_right_shift(packed_t, s), 3) - 2
                    for s in (4, 2, 0)]
    return (2 * torch.cat(fields) + 1).T.contiguous()


def _kernels_int2(torch, dev, card: dict, g, c: int, d: int, results: dict) -> None:
    """The three int2 kernels against their plain versions, bit for bit
    (values, -inf slots and #14's rows): Q in {1, 5, 32, 64, 70}, float32
    and bfloat16 out, n at C, C - 1024 and inside a segment; then, at the
    served width, each kernel's time beside its plain version's,
    torch._int_mm over the unpacked catalog (held exact against twice the
    corrected dots) and the bound."""
    from ucfp_tpu_torch.ops import int2_scan as i2
    from ucfp_tpu_torch.ops import knn

    packed_t, inv_n2 = _int2_case(torch, dev, g, c, d, results)
    timed = d == DIM
    qmax = 70
    qs = torch.randint(-127, 128, (qmax, d), generator=g, device=dev, dtype=torch.int8)
    qs[0] = 127  # queries of all +-127
    qs[1] = -127
    qs[2, ::2] = -127
    *quarters, corrs = knn._int2_query_parts(qs)
    one = [w[0] for w in quarters]
    ns = (c, c - 1024, c // 2 + 77)
    err = {"int2_scores": 0.0, "int2_scores_batched": 0.0, "int2_topq": 0.0}

    def same(key, got, want, what):
        torch.cuda.synchronize()
        check(_same_bits(torch, got, want), f"{what} c={c} d={d}")
        err[key] = max(err[key], _max_abs(torch, got, want))

    # #12: one query's masked scores; #14: its per-segment top 8
    for n in ns:
        got = i2.int2_masked_scores(packed_t, *one, corrs[0], inv_n2, n)
        same("int2_scores", got, i2.int2_masked_scores_plain(packed_t, *one, corrs[0], inv_n2, n),
             f"int2_masked_scores bit-equal n={n}")
        check(bool(torch.isneginf(got[n:]).all()) and bool(torch.isneginf(got[3])),
              "-inf past n and on zero rows")
        for qi in (0, 3):
            args = (packed_t, *[w[qi] for w in quarters], corrs[qi], inv_n2, n)
            vk, ik = i2.int2_topq_scores(*args)
            vp, ip = i2.int2_topq_scores_plain(*args)
            same("int2_topq", vk, vp, f"int2_topq_scores values bit-equal n={n} q={qi}")
            check(torch.equal(ik, ip), f"int2_topq_scores rows equal n={n} q={qi}")
    # #13: query blocks, both output types (Q = 1 runs the single-query
    # kernel; Q >= 2 the tensor cores)
    for q in (1, 2, 5, 32, 64, 70):
        for dtype in (torch.float32, torch.bfloat16):
            for n in ns:
                args = (packed_t, *[w[:q] for w in quarters], corrs[:q], inv_n2, n)
                same("int2_scores_batched",
                     i2.int2_masked_scores_batched(*args, out_dtype=dtype),
                     i2.int2_masked_scores_batched_plain(*args, out_dtype=dtype),
                     f"int2_masked_scores_batched bit-equal q={q} {dtype} n={n}")
    results["int2_pack"][-1]["max_abs_err"] = err
    if not timed:
        del packed_t, inv_n2
        torch.cuda.empty_cache()
        return

    unpacked = _int2_unpacked(torch, packed_t)

    def int_mm(q):
        a = torch.zeros((max(q, knn.INT_MM_MIN_M), d), dtype=torch.int8, device=dev)
        a[:q] = qs[:q]
        return torch._int_mm(a, unpacked.T)[:q]

    dots = i2._int2_dots_plain(packed_t, [w[:32] for w in quarters])
    torch.cuda.synchronize()
    check(torch.equal(int_mm(32), 2 * dots - (2 * corrs[:32, None]).int()),
          f"torch._int_mm over the unpacked catalog == twice the corrected dots c={c}")
    del dots
    dq = d // 4

    def bound(q, out_bytes):
        return bound_ms(card, c * dq + c * 4 + out_bytes + q * d,
                        int8_mma_ops=2 * q * c * d)

    b, by = bound(1, c * 4)
    results["int2_scores"].append({
        "q": 1, "c": c, "d": d, "max_abs_err": err["int2_scores"],
        "ms": time_ms(torch, lambda: i2.int2_masked_scores(
            packed_t, *one, corrs[0], inv_n2, c)),
        "plain_ms": time_ms(torch, lambda: i2.int2_masked_scores_plain(
            packed_t, *one, corrs[0], inv_n2, c)),
        "library_ms": time_ms(torch, lambda: int_mm(1)), "bound_ms": b, "bound_by": by,
    })
    b, by = bound(1, c // i2.TOPQ_SEG * i2.TOPQ * 8)
    results["int2_topq"].append({
        "q": 1, "c": c, "d": d, "max_abs_err": err["int2_topq"],
        "ms": time_ms(torch, lambda: i2.int2_topq_scores(
            packed_t, *one, corrs[0], inv_n2, c)),
        "plain_ms": time_ms(torch, lambda: i2.int2_topq_scores_plain(
            packed_t, *one, corrs[0], inv_n2, c)),
        "library_ms": time_ms(torch, lambda: int_mm(1)), "bound_ms": b, "bound_by": by,
    })
    for q in (1, 2, 32, 64):
        args = (packed_t, *[w[:q] for w in quarters], corrs[:q], inv_n2, c)
        b, by = bound(q, q * c * 2)

        def scan():
            return i2.int2_masked_scores_batched(*args, out_dtype=torch.bfloat16)

        results["int2_scores_batched"].append({
            "q": q, "c": c, "d": d, "dtype": "bfloat16",
            "max_abs_err": err["int2_scores_batched"],
            "ms": time_ms(torch, scan), "device_ms": device_ms(torch, scan),
            "blocks_per_sm": i2.batched_blocks_per_sm(dq, q) if q > 1 else None,
            "plain_ms": time_ms(torch, lambda: i2.int2_masked_scores_batched_plain(
                *args, out_dtype=torch.bfloat16)),
            "library_ms": time_ms(torch, lambda: int_mm(q)), "bound_ms": b, "bound_by": by,
        })
    del packed_t, inv_n2, unpacked
    torch.cuda.empty_cache()


# widths past D/4 = 5,120, where one group of 8 queries' fragments no
# longer fits the batched int2 kernel's shared memory and it reads them from
# global memory: 5,125 (also a partial word and chunk) and the widest the
# kernels take, int2_scan.MAX_DQ
INT2_WIDE_DQ = (5125, 8192)
INT2_WIDE_ROWS = 2176  # 8.5 tiles of 256 rows


def _kernels_int2_wide(torch, dev, g, results: dict) -> None:
    """The batched int2 kernel (#13) at D/4 = 5,125 (Q = 2, 5, 70) and
    8,192 (Q = 9) against its plain version, bit for bit: float32 and
    bfloat16 out, n at C, C - 1024 and mid-tile, on random packed bytes
    with a zero column, one of every field at -2 and one at 1, and zero
    inv_n2 slots. The plain version's float32 products are exact on the card
    up to D/4 = 12,007."""
    from ucfp_tpu_torch.ops import int2_scan as i2
    from ucfp_tpu_torch.ops import knn

    c = INT2_WIDE_ROWS
    err = 0.0
    for dq, qcount in zip(INT2_WIDE_DQ, ((2, 5, 70), (9,))):
        packed_t = torch.randint(-128, 128, (dq, c), generator=g, device=dev,
                                 dtype=torch.int8)
        packed_t[:, 3] = 0
        packed_t[:, 5] = -128
        packed_t[:, 6] = 127
        inv_n2 = torch.rand(c, generator=g, device=dev)
        inv_n2[[3, 9]] = 0.0
        qs = torch.randint(-127, 128, (max(qcount), 4 * dq), generator=g, device=dev,
                           dtype=torch.int8)
        qs[0] = 127
        qs[1] = -127
        *quarters, corrs = knn._int2_query_parts(qs)
        for q in qcount:
            for dtype in (torch.float32, torch.bfloat16):
                for n in (c, c - 1024, c // 2 + 77):
                    args = (packed_t, *[w[:q] for w in quarters], corrs[:q], inv_n2, n)
                    got = i2.int2_masked_scores_batched(*args, out_dtype=dtype)
                    torch.cuda.synchronize()
                    want = i2.int2_masked_scores_batched_plain(*args, out_dtype=dtype)
                    check(_same_bits(torch, got, want),
                          f"int2_masked_scores_batched bit-equal q={q} {dtype} n={n} c={c} "
                          f"d/4={dq}")
                    err = max(err, _max_abs(torch, got, want))
        del packed_t, inv_n2
    results["int2_pack"].append({"c": c, "d": [4 * dq for dq in INT2_WIDE_DQ],
                                 "max_abs_err": {"int2_scores_batched": err}})


def _kernels_sketch(torch, dev, card: dict, g, c: int, results: dict) -> None:
    """The sketch scan against its plain version, bit for bit, on three
    plans: a random query's, a one-hot query's (every |projection| equal:
    all planes in one level, three weights 0) and a random plan over a
    catalog of duplicate sketch rows; the sketch built on the card equal
    to the CPU's on a slice; then the scan's time, its plain version's
    and the bound."""
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.ops import sketch_scan as sk

    q8 = torch.randint(-127, 128, (c, DIM), generator=g, device=dev, dtype=torch.int8)
    planes_np = knn.sketch_planes(DIM)
    planes = torch.from_numpy(planes_np).to(dev)
    t0 = time.perf_counter()
    tiled = knn.tile_sketch(knn.build_sketch_chunked(q8, planes))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = 1 << 16
    cpu = knn.tile_sketch(knn.build_sketch_chunked(q8[:m].cpu(), torch.from_numpy(planes_np)))
    check(torch.equal(tiled[:m // knn.SKETCH_LANES].cpu(), cpu),
          f"sketch build on the card == on the CPU c={c}")
    del q8
    query = torch.randn(DIM, generator=g, device=dev)
    onehot = torch.zeros(DIM, device=dev)
    onehot[0] = 5.0
    plans = {"random": knn.sketch_query_plan(query, planes)[:4],
             "onehot": knn.sketch_query_plan(onehot, planes)[:4]}
    check(int((plans["onehot"][2] == 0).sum()) == 3, "one-hot plan: three weights 0")
    base = tiled.reshape(-1, knn.SKETCH_WORDS, knn.SKETCH_LANES)
    dup = base[:, :, torch.randint(0, 4, (knn.SKETCH_LANES,), generator=g,
                                   device=dev)].contiguous()  # 4 distinct rows per group
    err = 0.0
    for name, plan in plans.items():
        for cat in ((tiled,) if name == "onehot" else (tiled, dup)):
            got = sk.asym_sketch_scores_tiled(cat, *plan)
            torch.cuda.synchronize()
            want = sk.asym_sketch_scores_tiled_plain(cat, *plan)
            check(_same_bits(torch, got, want),
                  f"asym_sketch_scores_tiled bit-equal plan={name} dup={cat is dup} c={c}")
            err = max(err, _max_abs(torch, got, want))
    del dup
    plan = plans["random"]
    nbytes = c * knn.SKETCH_WORDS * 4 + c * 4
    # per row and word: one XOR, four AND and four adds; four popcounts
    b, by = bound_ms(card, nbytes, alu_ops=9 * c * knn.SKETCH_WORDS,
                     popc_ops=4 * c * knn.SKETCH_WORDS)
    results["sketch_build"].append({"c": c, "d": DIM, "build_s": build_s})
    results["sketch"].append({
        "c": c, "d": DIM, "max_abs_err": err,
        "ms": time_ms(torch, lambda: sk.asym_sketch_scores_tiled(tiled, *plan)),
        "plain_ms": time_ms(torch, lambda: sk.asym_sketch_scores_tiled_plain(tiled, *plan)),
        "library_ms": None, "bound_ms": b, "bound_by": by,
    })
    del tiled
    torch.cuda.empty_cache()


def _kernels_hamming1(torch, dev, card: dict, g, k: int, c: int, w: int, ties: bool,
                      results: dict) -> None:
    """Kernel #6 (one query, no mask, 256-row tiles) against its plain
    version, cells and top-k bit-equal: a random catalog with one row
    copied into its own tile and into the last one, or a tie-heavy catalog
    of four distinct rows, where the (tile, lane) position order decides
    every tie."""
    from ucfp_tpu_torch.ops import fused_scan as fs

    if ties:
        base = torch.randint(-2**31, 2**31, (4, w), generator=g, device=dev,
                             dtype=torch.int32)
        db = base[torch.randint(0, 4, (c,), generator=g, device=dev)].contiguous()
    else:
        db = torch.randint(-2**31, 2**31, (c, w), generator=g, device=dev,
                           dtype=torch.int32)
        db[100:300] = db[7]
        db[c - 500:c - 300] = db[7]
    for qi, q in enumerate((db[7].clone(), db[c - 1] ^ 1, db[5] ^ -1)):
        cells_k = fs._hamming1_cells_cuda(q, db)
        torch.cuda.synchronize()
        cells_p = fs._hamming1_cells_plain(q, db)
        check(torch.equal(cells_k[0], cells_p[0]) and torch.equal(cells_k[1], cells_p[1]),
              f"hamming1 cells equal c={c} w={w} ties={ties}")
        dk, ik = fs.hamming_topk_fused(q, db, k)
        torch.cuda.synchronize()
        dp, ip = fs.hamming_topk_fused_plain(q, db, k)
        check(torch.equal(dk, dp) and torch.equal(ik, ip),
              f"hamming_topk_fused equal c={c} w={w} ties={ties}")
        if qi == 0:
            # lane 0's cell holds copies of row 7 (rows 128, 256): at
            # distance 0 the lower cell position wins, not the lower row
            check(int(dk[0]) == 0 and (ties or int(ik[0]) == 128),
                  f"hamming_topk_fused position order c={c} w={w}")
    # rows read once, the query, the k best written; per row w XORs, w - 1
    # adds and a compare (ALU), w popcounts
    b, by = bound_ms(card, c * 4 * w + w * 4 + k * 8, alu_ops=c * 2 * w, popc_ops=c * w)
    results["hamming1"].append({
        "c": c, "w": w, "ties": ties, "max_abs_err": _max_abs(torch, dk, dp),
        "ms": time_ms(torch, lambda: fs.hamming_topk_fused(q, db, k)),
        "device_ms": device_ms(torch, lambda: fs.hamming_topk_fused(q, db, k)),
        "cells_ms": time_ms(torch, lambda: fs._hamming1_cells_cuda(q, db)),
        "cells_device_ms": device_ms(torch, lambda: fs._hamming1_cells_cuda(q, db)),
        **_select_split(torch, *cells_k, k, False),
        "plain_ms": time_ms(torch, lambda: fs.hamming_topk_fused_plain(q, db, k)),
        "library_ms": None, "bound_ms": b, "bound_by": by,
    })
    del db
    torch.cuda.empty_cache()


def _kernels_cosine_int8(torch, dev, card: dict, g, results: dict) -> None:
    """Kernels #7 (cosine_int8_topk_fused) and #8 (cosine_int8_topk_mxu)
    against their plain versions (whose dots come from ops.knn.int8_dots),
    cells and top-k (k = 10 and 16) bit-equal: #7 at the bench's 9,994,240
    x 64 and at 2^22 x 64, with the hybrid (#4 on the same dots) held at
    the bench's shape too; #8 at D = 64 over 9,994,240 rows (4,997,120
    lines, rpt 1024), D = 32 and 128 at 2^22 rows, and 1,000,000 lines of
    D = 64 (rpt 800); each on a random catalog with one row copied inside
    its cell and into other cells, on a tie-heavy catalog of four distinct
    rows, and under an all-zero query (every score ties). Then the errors:
    #7's C % 16,384 != 0 and #8's k above the candidate pool raise."""
    from ucfp_tpu_torch.ops import fused_scan as fs
    from ucfp_tpu_torch.ops import knn

    def catalog(c, d, ties):
        if ties:
            base = torch.randint(-128, 128, (4, d), generator=g, device=dev,
                                 dtype=torch.int8)
            db = base[torch.randint(0, 4, (c,), generator=g, device=dev)].contiguous()
        else:
            db = torch.randint(-128, 128, (c, d), generator=g, device=dev,
                               dtype=torch.int8)
            db[640 + 3::128 * 7][:9] = db[3]  # row 3 again in its lane, later tiles
            db[200:260] = db[7]  # row 7 in neighbouring lanes and cells
            db[c - 64:] = db[7]  # ...and in the last tile
            db[11] = 0  # a zero row: its norm floors to 1e-9
        rn = torch.cat([knn.int8_norms(db[lo:lo + (1 << 22)])
                        for lo in range(0, c, 1 << 22)])
        return db, rn

    def queries(db):
        return (("row7", db[7].clone()), ("zero", torch.zeros_like(db[7])))

    def hold(name, cells_cuda, cells_plain, topk, topk_plain, db, rn, q, ks):
        cells_k = cells_cuda()
        torch.cuda.synchronize()
        cells_p = cells_plain()
        check(_same_bits(torch, cells_k[0], cells_p[0])
              and torch.equal(cells_k[1], cells_p[1]), f"{name} cells bit-equal")
        for k in ks:
            vk, ik = topk(q, db, rn, k)
            torch.cuda.synchronize()
            vp, ip = topk_plain(q, db, rn, k)
            check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
                  f"{name} top-{k} bit-equal")
        return _max_abs(torch, vk, vp)

    results.update(cosine_i8=[], cosine_i8_mxu=[])
    k = 10
    one = torch.ones(1, device=dev)  # the hybrid's 1/|q|
    for c, d, ties in COSINE_I8_CASES:
        db, rn = catalog(c, d, ties)
        err = 0.0
        for qname, q in queries(db):
            err = max(err, hold(
                f"cosine_int8_topk_fused c={c} d={d} ties={ties} q={qname}",
                lambda: fs._cosine_i8_cells_cuda(q, db, rn),
                lambda: fs._cosine_i8_cells_plain(q, db, rn),
                fs.cosine_int8_topk_fused, fs.cosine_int8_topk_fused_plain, db, rn, q,
                (10, 16)))
            if c == BENCH_X64_ROWS:
                # the bench's hybrid key runs #4 on these dots (305 tiles)
                dots = fs._row_dots(q, db)
                hold(f"cosine_int8_topk_hybrid (#4) c={c} d={d} q={qname}",
                     lambda: fs._dots_norm_cells_cuda(dots[None], rn, c, one,
                                                      "dots_norm_topk_fused"),
                     lambda: fs._dots_norm_cells_plain(dots[None], rn, c, one),
                     fs.cosine_int8_topk_hybrid,
                     lambda q, db, rn, k: fs.dots_norm_topk_fused_plain(dots, rn, c, 1.0, k),
                     db, rn, q, (10, 16))
                del dots
        q = db[7].clone()
        # rows and norms read once, the query, the k best written; per row
        # D/4 __dp4a and one compare (ALU), one division (float32)
        b, by = bound_ms(card, c * d + c * 4 + d + k * 8, alu_ops=c * (d // 4 + 1),
                         f32_ops=c)
        results["cosine_i8"].append({
            "c": c, "d": d, "ties": ties, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fs.cosine_int8_topk_fused(q, db, rn, k)),
            "device_ms": device_ms(torch, lambda: fs.cosine_int8_topk_fused(q, db, rn, k)),
            "cells_ms": time_ms(torch, lambda: fs._cosine_i8_cells_cuda(q, db, rn)),
            "cells_device_ms": device_ms(torch, lambda: fs._cosine_i8_cells_cuda(q, db, rn)),
            **_select_split(torch, *fs._cosine_i8_cells_cuda(q, db, rn), k, True),
            "plain_ms": time_ms(torch, lambda: fs.cosine_int8_topk_fused_plain(q, db, rn, k)),
            "library_ms": time_ms(torch, lambda: fs.cosine_int8_topk_hybrid(q, db, rn, k)),
            "bound_ms": b, "bound_by": by,
        })
        if not ties and c != BENCH_X64_ROWS:
            try:
                fs.cosine_int8_topk_fused(q, db[:c - 128], rn[:c - 128], k)
                raised = False
            except ValueError:
                raised = True
            check(raised, "cosine_int8_topk_fused raises on C % 16384 != 0")
        del db, rn
        torch.cuda.empty_cache()

    for c, d, ties in COSINE_I8_MXU_CASES:
        db, rn = catalog(c, d, ties)
        per, lines, rpt = fs._mxu_layout(c, d)
        pool = lines // rpt * fs.SUB * per
        err = 0.0
        for qname, q in queries(db):
            err = max(err, hold(
                f"cosine_int8_topk_mxu c={c} d={d} rpt={rpt} ties={ties} q={qname}",
                lambda: fs._cosine_i8_mxu_cells_cuda(q, db),
                lambda: fs._cosine_i8_mxu_cells_plain(q, db),
                fs.cosine_int8_topk_mxu, fs.cosine_int8_topk_mxu_plain, db, rn, q, (10, 16)))
        q = db[7].clone()
        # the catalog read once, the candidates' norms gathered, the query,
        # the k best written; per row D/4 __dp4a and one compare
        b, by = bound_ms(card, c * d + pool * 4 + d + k * 8, alu_ops=c * (d // 4 + 1),
                         f32_ops=pool)
        hybrid_ok = c % (fs.ROWS_PER_TILE * fs.LANES) == 0
        dots_m, gidx_m = fs._cosine_i8_mxu_cells_cuda(q, db)
        cand = dots_m / torch.clamp(rn[gidx_m.long()], min=1e-9)  # what #8 selects over
        results["cosine_i8_mxu"].append({
            "c": c, "d": d, "rpt": rpt, "ties": ties, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fs.cosine_int8_topk_mxu(q, db, rn, k)),
            "cells_ms": time_ms(torch, lambda: fs._cosine_i8_mxu_cells_cuda(q, db)),
            **_select_split(torch, cand[None], gidx_m[None], k, True),
            "plain_ms": time_ms(torch, lambda: fs.cosine_int8_topk_mxu_plain(q, db, rn, k)),
            "library_ms": time_ms(torch, lambda: fs.cosine_int8_topk_hybrid(q, db, rn, k))
            if hybrid_ok else None,
            "bound_ms": b, "bound_by": by,
        })
        if d == 128 and not ties:
            try:
                fs.cosine_int8_topk_mxu(q, db, rn, pool + 1)
                raised = False
            except ValueError:
                raised = True
            check(raised, "cosine_int8_topk_mxu raises on k above the candidate pool")
        del db, rn, dots_m, gidx_m, cand
        torch.cuda.empty_cache()


# -- phase 4 ----------------------------------------------------------------


def _fixed_png(seed: int, w: int, h: int) -> bytes:
    """The conformance corpus's image generator (tests/test_conformance.py)."""
    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def phase_conformance(dev) -> None:
    import xxhash

    from ucfp_tpu_torch.modality import image as imod

    golden = json.loads(open(os.path.join(HERE, "tests", "goldens",
                                          "conformance.json")).read())
    got = {}
    for seed, w, h in ((10, 64, 64), (11, 100, 37), (12, 256, 256), (13, 48, 640)):
        png = _fixed_png(seed, w, h)
        got[f"image/multi/{w}x{h}"] = imod.fingerprint_multi(
            png, 0, 1, device=dev).fingerprint
        if seed != 13:
            for algo in ("phash", "dhash", "ahash"):
                got[f"image/{algo}/{w}x{h}"] = imod.fingerprint_single(
                    png, algo, 0, 1, device=dev).fingerprint
    bad = [k for k, fp in got.items() if xxhash.xxh3_64_hexdigest(fp) != golden[k]]
    check(not bad, f"conformance digests on the card: {bad}")
    want = {k for k in golden if k.startswith("image/") and "semantic" not in k}
    check(set(got) == want, "every non-semantic image golden covered")
    say(f"conformance: {len(got)} image digests computed on the card equal the goldens")


# -- phase 5 ----------------------------------------------------------------


class _ServerThread:
    """The port's HTTP server on a loopback port, on its own event loop
    thread in this process (so the launch counters are readable)."""

    def __init__(self, state):
        from ucfp_tpu_torch.server.app import build_server

        self.server = build_server(state, timeout_secs=900.0)
        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        check(self.ready.wait(60), "server started")

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def start():
            self.srv = await self.server.serve("127.0.0.1", 0)
            self.port = self.srv.sockets[0].getsockname()[1]

        self.loop.run_until_complete(start())
        self.ready.set()
        self.loop.run_forever()

    def stop(self):
        async def shut():
            self.srv.close()
            await self.server.drain(10)

        asyncio.run_coroutine_threadsafe(shut(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        check(not self.thread.is_alive(), "server thread stopped")


class _Client:
    def __init__(self, port: int, token: str):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
        self.token = token

    def __call__(self, method, path, body=b"", query=""):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        url = path + (f"?{query}" if query else "")
        t0 = time.perf_counter()
        self.conn.request(method, url, body=body,
                          headers={"authorization": f"Bearer {self.token}",
                                   "content-length": str(len(body))})
        resp = self.conn.getresponse()
        data = resp.read()
        ms = (time.perf_counter() - t0) * 1e3
        return resp.status, (json.loads(data) if data else None), ms


def _bmp(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="BMP")
    return buf.getvalue()


def _bulk_load(torch, backend, n_phash, n_multi, n_vec, dim, seed, dev,
               model_ids=("smoke",), vec_fp_bytes=None):
    """Chunked bulk load through the columnar batch upserts; the data is
    made on the card from `seed` (bundles are real multi hashes of random
    32x32 images). Vector chunks take the model ids in turn; each vector
    row's fingerprint is its f32 bytes, or `vec_fp_bytes` random bytes
    (an image record's 8-byte hash: a quarter of the host memory per
    row, measured on the CPU)."""
    from ucfp_tpu_torch.ops import imagehash

    g = torch.Generator(device=dev).manual_seed(seed)
    chunk = 1 << 17
    t0 = time.perf_counter()
    for lo in range(0, n_phash, chunk):
        m = min(chunk, n_phash - lo)
        raw = torch.randint(0, 256, (m, 8), generator=g, device=dev,
                            dtype=torch.uint8).cpu().numpy()
        asyncio.run(backend.upsert_fingerprint_batch(
            0, PHASH, list(range(lo, lo + m)), [r.tobytes() for r in raw]))
    t_phash = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, n_multi, chunk):
        m = min(chunk, n_multi - lo)
        gray = torch.randint(0, 256, (m, 32, 32), generator=g, device=dev,
                             dtype=torch.uint8)
        out = imagehash.multihash_kernel_gray(gray, 32, 32, device=dev)
        packed = torch.cat([out["phash"], out["dhash"], out["ahash"],
                            out["hist"].contiguous().view(torch.uint8),
                            out["block"]], dim=1).cpu().numpy()
        check(packed.shape[1] == imagehash.MULTIHASH_BYTES, "bundle width")
        asyncio.run(backend.upsert_fingerprint_batch(
            0, MULTI, list(range(10**8 + lo, 10**8 + lo + m)),
            [r.tobytes() for r in packed]))
    t_multi = time.perf_counter() - t0
    t0 = time.perf_counter()
    vchunk = 1 << 15
    for lo in range(0, n_vec, vchunk):
        m = min(vchunk, n_vec - lo)
        mat = torch.randn((m, dim), generator=g, device=dev).cpu().numpy()
        fps = None
        if vec_fp_bytes:
            fps = [r.tobytes() for r in torch.randint(
                0, 256, (m, vec_fp_bytes), generator=g, device=dev,
                dtype=torch.uint8).cpu().numpy()]
        asyncio.run(backend.upsert_embedding_batch(
            0, SEM, list(range(2 * 10**8 + lo, 2 * 10**8 + lo + m)), mat,
            fingerprints=fps, model_id=model_ids[(lo // vchunk) % len(model_ids)]))
    t_vec = time.perf_counter() - t0
    return {"phash_s": t_phash, "multi_s": t_multi, "vectors_s": t_vec}


def _plain_hamming_hits(torch, backend, hexes, k, algorithm=PHASH):
    import numpy as np

    from ucfp_tpu_torch.ops import fused_scan as fs

    cache = backend._ham[(0, algorithm)]
    matrix, valid = cache.device
    qm = np.stack([np.frombuffer(bytes.fromhex(h), "<u4") for h in hexes])
    q = torch.from_numpy(qm.view(np.int32)).to(matrix.device)
    kk = min(k, cache.n)
    d, i = fs.hamming_topk_fused_batched_plain(q, matrix, valid, kk)
    out = []
    for dr, ir in zip(d.cpu().numpy(), i.cpu().numpy()):
        rows = sorted((cache.rids[int(x)], int(y)) for y, x in zip(dr, ir) if y < 2**30)
        rows.sort(key=lambda t: (t[1], t[0]))
        out.append([(rid, 1.0 - dd / (32 * cache.width)) for rid, dd in rows])
    return out


def _plain_cosine_hits(torch, backend, vecs, k):
    import numpy as np

    from ucfp_tpu_torch.ops import fused_scan as fs
    from ucfp_tpu_torch.ops import knn

    cache = backend._vec[(0, len(vecs[0]))]
    matrix, valid = cache.device
    q = torch.from_numpy(np.asarray(vecs, np.float32)).to(matrix.device)
    kk = min(k, cache.n)
    s, i = fs.scores_topk_fused_batched_plain(knn._cosine_scores(q, matrix, valid), kk)
    out = []
    for sr, ir in zip(s.cpu().numpy(), i.cpu().numpy()):
        rows = [(cache.rids[int(x)], float(y)) for y, x in zip(sr, ir) if np.isfinite(y)]
        rows.sort(key=lambda t: (-t[1], t[0]))
        out.append(rows)
    return out


def _plain_multi_hits(torch, backend, hexes, k):
    import numpy as np

    from ucfp_tpu_torch.ops import imagehash

    cache = backend._ham[(0, MULTI)]
    matrix, valid = cache.device
    qm = np.stack([np.frombuffer(bytes.fromhex(h), "<u4") for h in hexes])
    params = torch.from_numpy(imagehash.multihash_params(None)).to(matrix.device)
    s, i = imagehash.multihash_weighted_topk(
        torch.from_numpy(qm.view(np.int32)).to(matrix.device), matrix, valid,
        params, min(k, cache.n))
    out = []
    for sr, ir in zip(s.cpu().numpy(), i.cpu().numpy()):
        rows = [(cache.rids[int(x)], float(y)) for y, x in zip(sr, ir) if np.isfinite(y)]
        rows.sort(key=lambda t: (-t[1], t[0]))
        out.append(rows)
    return out


def _hit_rows(hits):
    return [(h["record_id"], h["score"]) for h in hits]


def phase_served(torch, dev) -> dict:
    import numpy as np

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    headroom = 1024  # served ingests land below the loaded capacity
    n_phash, n_multi, n_vec = (PHASH_ROWS - headroom, MULTI_ROWS - headroom,
                               VEC_ROWS - headroom)
    k = 10
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev)
    server = None
    try:
        load = _bulk_load(torch, backend, n_phash, n_multi, n_vec, DIM,
                          seed=7, dev=dev)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend,
                                           api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        rng = np.random.default_rng(11)
        ingested = {}
        for i, algo in enumerate(("phash", "multi", "phash", "multi")):
            rid = 5 * 10**8 + i
            png = _fixed_png(100 + i, 256, 256)
            st, body, _ = call("POST", f"/v1/ingest/image/0/{rid}", png,
                               f"algorithm={algo}")
            check(st == 201, f"ingest {algo}: {st} {body}")
            ingested[rid] = (algo, body["fingerprint_hex"])
        batch_ms = []
        for b in range(5):
            imgs = rng.integers(0, 256, (64, 256, 256, 3), np.uint8)
            body = b"".join(struct.pack("<QI", 6 * 10**8 + 64 * b + j, len(x)) + x
                            for j, x in enumerate(_bmp(a) for a in imgs))
            st, res, ms = call("POST", "/v1/ingest/image/batch/0", body)
            check(st == 201 and res["count"] == 64, f"batch ingest: {st}")
            batch_ms.append(ms)
        phash_rids = [r for r, (a, _) in ingested.items() if a == "phash"]
        multi_rids = [r for r, (a, _) in ingested.items() if a == "multi"]

        lat = {}

        def timed(form, body, reps=SERVED_REPS):
            out = None
            times = []
            for _ in range(reps + 1):  # the first call uploads/warms
                st, out, ms = call("POST", "/v1/query", body)
                check(st == 200, f"{form}: {st} {out}")
                times.append(ms)
            lat[form] = statistics.median(times[1:])
            return out

        ph = ingested[phash_rids[0]][1]
        res = timed("fingerprint_hex", {"tenant_id": 0, "modality": "image",
                                        "k": k, "algorithm": "phash",
                                        "fingerprint_hex": ph})
        check(res["hits"][0]["record_id"] == phash_rids[0]
              and res["hits"][0]["score"] == 1.0, "ingested pHash at rank 1, distance 0")
        check(_hit_rows(res["hits"]) == _plain_hamming_hits(torch, backend, [ph], k)[0],
              "fingerprint_hex hits == plain path")
        cache = backend._ham[(0, PHASH)]
        stored = [cache.rids[int(x)] for x in rng.integers(0, n_phash, 30)]
        hexes = [ingested[r][1] for r in phash_rids] + [
            backend.get_record(0, r)["fingerprint"].hex() for r in stored]
        res = timed("fingerprints_hex", {"tenant_id": 0, "modality": "image",
                                         "k": k, "algorithm": "phash",
                                         "fingerprints_hex": hexes})
        check([r["hits"][0]["record_id"] for r in res["results"]]
              == phash_rids + stored, "32 pHash queries find themselves at rank 1")
        check([_hit_rows(r["hits"]) for r in res["results"]]
              == _plain_hamming_hits(torch, backend, hexes, k),
              "fingerprints_hex hits == plain path")
        check(res.get("approximate") is True, "fused path marked approximate")
        mh = ingested[multi_rids[0]][1]
        res = timed("fingerprint_hex_multi", {"tenant_id": 0, "modality": "image",
                                              "k": k, "algorithm": "multi",
                                              "fingerprint_hex": mh})
        check(res["hits"][0]["record_id"] == multi_rids[0]
              and abs(res["hits"][0]["score"] - 1.0) < 1e-6, "ingested bundle at rank 1")
        check(_hit_rows(res["hits"]) == _plain_multi_hits(torch, backend, [mh], k)[0],
              "multi hits == plain path")
        vcache = backend._vec[(0, DIM)]
        picks = [int(x) for x in rng.integers(0, n_vec, 32)]
        vecs = [(vcache.data[p] + rng.normal(0, 0.01, DIM)).astype(np.float32)
                for p in picks]
        want = [vcache.rids[p] for p in picks]
        res = timed("vector", {"tenant_id": 0, "modality": "image", "k": k,
                               "vector": [float(x) for x in vecs[0]]})
        check(res["hits"][0]["record_id"] == want[0], "noisy stored vector at rank 1")
        check(_hit_rows(res["hits"]) == _plain_cosine_hits(torch, backend, vecs[:1], k)[0],
              "vector hits == plain path")
        res = timed("vectors", {"tenant_id": 0, "modality": "image", "k": k,
                                "vectors": [[float(x) for x in v] for v in vecs]})
        check([r["hits"][0]["record_id"] for r in res["results"]] == want,
              "32 noisy stored vectors at rank 1")
        check([_hit_rows(r["hits"]) for r in res["results"]]
              == _plain_cosine_hits(torch, backend, vecs, k), "vectors hits == plain path")
        st, desc, _ = call("GET", f"/v1/records/0/{phash_rids[0]}")
        check(st == 200 and desc["algorithm"] == PHASH, "describe")
        st, _, _ = call("DELETE", f"/v1/records/0/{phash_rids[0]}")
        check(st == 200, "delete")
        st, res, _ = call("POST", "/v1/query", {"tenant_id": 0, "modality": "image",
                                                 "k": k, "algorithm": "phash",
                                                 "fingerprint_hex": ph})
        check(st == 200 and all(h["record_id"] != phash_rids[0] for h in res["hits"]),
              "deleted record no longer returned")
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in ("scores_topk_fused_batched",
                                                   "hamming_topk_fused_batched",
                                                   "select_topk")),
              f"every kernel of the f32 and Hamming paths launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        served = {
            "rows": {"phash": cache.n, "multi": backend._ham[(0, MULTI)].n,
                     "vectors": vcache.n, "dim": DIM},
            "capacity": {"phash": cache.data.shape[0],
                         "multi": backend._ham[(0, MULTI)].data.shape[0],
                         "vectors": vcache.data.shape[0]},
            "load_s": load,
            "p50_ms": lat,
            "batch_ingest_images_per_s": 64 / (statistics.median(batch_ms) / 1e3),
            "batch_ingest_ms": batch_ms,
            "launches": launches,
            "peak_device_gib": peak, "host_gib": host_gib(),
        }
        say("served: " + json.dumps(served))
        return served
    finally:
        _close_backend(torch, server, backend, tmp)


# -- phase 6 ----------------------------------------------------------------


@contextlib.contextmanager
def _plain_quant_path(torch):
    """The quantized paths' kernels and the int8 product swapped for their
    plain versions, so the backend answers a query the plain way on the
    same device tensors."""
    from ucfp_tpu_torch.ops import knn

    swaps = {(knn, "int8_dots"): lambda qq, q8m: int8_dots_plain(torch, qq, q8m)}
    for mod in _kernel_modules():
        for name in mod.LAUNCHES:
            # select_topk has no wrapper of its own: it runs inside the fused
            # wrappers, whose plain twins select with the stable sort
            if hasattr(mod, name):
                swaps[(mod, name)] = getattr(mod, name + "_plain")
    saved = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _served_rows(body: dict, res: dict) -> list:
    """A /v1/query answer -> one [(record_id, score)] list per query."""
    if "vector" in body:
        return [_hit_rows(res["hits"])]
    return [_hit_rows(r["hits"]) for r in res["results"]]


def _plain_quant_rows(torch, backend, body: dict) -> list:
    from ucfp_tpu_torch.core import POOL_FRAC_TIERS

    tier = body.get("recall_tier")
    kw = {"filter": body.get("filter"), "exact": tier == "exact"}
    with _plain_quant_path(torch):
        if "vector" in body:
            pool_frac = {"fast": POOL_FRAC_TIERS[0], "balanced": POOL_FRAC_TIERS[1]}.get(tier)
            res = [asyncio.run(backend.knn(0, body["vector"], body["k"],
                                           pool_frac=pool_frac, **kw))]
        else:
            res = asyncio.run(backend.knn_batch(0, body["vectors"], body["k"], **kw))
    return [[(h.record_id, h.score) for h in hits] for hits in res]


def host_gib() -> dict:
    """This process's resident host memory now and at its peak."""
    import resource

    now = int(open("/proc/self/statm").read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return {"rss": now / 2**30, "peak_rss": peak / 2**30}


def _close_backend(torch, server, backend, tmp) -> None:
    import gc
    import shutil

    if server is not None:
        server.stop()
    backend.close()
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def _vector_store(torch, backend, n: int, seed: int, rng_seed: int, count: int = 32):
    """Bulk-load n x DIM vectors under two model ids -> (load seconds,
    cache, `count` noisy stored vectors, their record ids, their model
    ids)."""
    import numpy as np

    load_s = _bulk_load(torch, backend, 0, 0, n, DIM, seed=seed, dev=backend.device,
                        model_ids=("m0", "m1"), vec_fp_bytes=8)["vectors_s"]
    vcache = backend._vec[(0, DIM)]
    check(vcache.n == n, f"{n} vectors in the store")
    rng = np.random.default_rng(rng_seed)
    picks = [int(x) for x in rng.integers(0, n, count)]
    vecs = [[float(x) for x in vcache.data[p] + rng.normal(0, 0.01, DIM)] for p in picks]
    # bulk chunks of 2^15 rows alternate m0 / m1 (rows in load order)
    model = ["m0" if (p >> 15) % 2 == 0 else "m1" for p in picks]
    return load_s, vcache, vecs, [vcache.rids[p] for p in picks], model


def _served_checker(torch, backend, call, lat):
    def served(form, body, reps=SERVED_REPS):
        times = []
        for _ in range(reps):
            st, res, ms = call("POST", "/v1/query", body)
            check(st == 200, f"{form}: {st} {res}")
            times.append(ms)
        lat[form] = statistics.median(times)
        rows = _served_rows(body, res)
        check(rows == _plain_quant_rows(torch, backend, body),
              f"{backend.knn_quant} {form} hits == plain path")
        return res, rows
    return served


def _upsert_find_delete(torch, backend, call, base: dict, rid: int, seed: int) -> None:
    """An upsert after the device cache exists (the row patches), a query
    that finds it at rank 1 (held against the plain path), a delete."""
    import numpy as np

    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, DIM)
    st, res, _ = call("POST", "/v1/records", {"records": [{
        "tenant_id": 0, "record_id": rid, "modality": "image",
        "algorithm": SEM, "fingerprint": list(range(8)),
        "embedding": [float(x) for x in emb], "model_id": "m1"}]})
    check(st == 200, f"upsert: {st} {res}")
    body = {**base, "vector": [float(x) for x in emb + rng.normal(0, 0.01, DIM)]}
    st, res, _ = call("POST", "/v1/query", body)
    check(st == 200 and res["hits"][0]["record_id"] == rid, "upserted vector at rank 1")
    check(_served_rows(body, res) == _plain_quant_rows(torch, backend, body),
          "after the row patches: hits == plain path")
    st, _, _ = call("DELETE", f"/v1/records/0/{rid}")
    check(st == 200, "delete")
    st, res, _ = call("POST", "/v1/query", body)
    check(st == 200 and all(h["record_id"] != rid for h in res["hits"]),
          "deleted vector no longer returned")


def phase_int8(torch, dev) -> dict:
    """The int8 tier served at the README's int8 shape cut to 2^21 rows:
    the single and batched forms, filtered and not, and the exact tier,
    each held against the plain path; an upsert (the int8 row patch), a
    query that finds it and a delete."""

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    n = INT8_SERVED_ROWS - 1024  # served upserts land below the loaded capacity
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-int8-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev, knn_quant="int8")
    server = None
    try:
        load_s, vcache, vecs, want, model = _vector_store(torch, backend, n, 8, 12)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend,
                                           api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        base = {"tenant_id": 0, "modality": "image", "k": 10}
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        t0 = time.perf_counter()
        st, res, _ = call("POST", "/v1/query", {**base, "vector": vecs[0]})
        first_s = time.perf_counter() - t0  # builds the int8 device cache
        check(st == 200, f"first int8 query: {st} {res}")
        lat = {}
        served = _served_checker(torch, backend, call, lat)
        res, rows = served("vector", {**base, "vector": vecs[0]})
        check(rows[0][0][0] == want[0] and res.get("approximate") is True,
              "noisy stored vector at rank 1, marked approximate")
        res, rows = served("vectors", {**base, "vectors": vecs})
        check([r[0][0] for r in rows] == want, "32 noisy stored vectors at rank 1")
        res, rows = served("vector_filter", {**base, "vector": vecs[0],
                                             "filter": {"model_id": model[0]}})
        check(rows[0][0][0] == want[0], "filtered: noisy stored vector at rank 1")
        res, rows = served("vectors_filter", {**base, "vectors": vecs,
                                              "filter": {"model_id": "m0"}})
        check(all(r[0][0] == w for r, w, m in zip(rows, want, model) if m == "m0"),
              "filtered batch: the m0 vectors at rank 1")
        res, rows = served("vector_exact", {**base, "vector": vecs[0],
                                            "recall_tier": "exact"})
        check(rows[0][0][0] == want[0] and "approximate" not in res,
              "exact tier: rank 1, not marked approximate")
        _upsert_find_delete(torch, backend, call, base, 7 * 10**8, seed=19)
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in (
            "scores_topk_fused_batched", "scores_topk_fused",
            "dots_norm_topk_fused", "dots_norm_topk_fused_batched", "select_topk")),
            f"every kernel of the int8 path launched: {launches}")
        out = {
            "rows": vcache.n, "capacity": vcache.data.shape[0], "dim": DIM,
            "load_s": load_s, "first_query_s": first_s,
            "p50_ms": lat, "launches": launches,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_gib": host_gib(),
        }
        say("int8: " + json.dumps(out))
        return out
    finally:
        _close_backend(torch, server, backend, tmp)


# -- phase 7 ----------------------------------------------------------------


def phase_qbatch(torch, dev) -> dict:
    """Query micro-batching (UCFP_QUERY_BATCH_MS) under concurrent single
    requests: vector queries coalesce onto kernel #5, fingerprint queries
    onto kernel #2, and each answer equals the unbatched one."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    n_vec, n_ph = QBATCH_VEC_ROWS - 1024, QBATCH_PHASH_ROWS - 1024
    k = 10
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-qbatch-")
    os.environ["UCFP_QUERY_BATCH_MS"] = str(QBATCH_MS)
    try:
        backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev,
                                  knn_quant="int8")
    finally:
        del os.environ["UCFP_QUERY_BATCH_MS"]
    server = None
    clients = []
    try:
        check(backend._qbatch_ms == QBATCH_MS, "UCFP_QUERY_BATCH_MS read")
        load = _bulk_load(torch, backend, n_ph, 0, n_vec, DIM, seed=9, dev=dev,
                          vec_fp_bytes=8)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend,
                                           api_keys=StaticSingleKey(token)))
        rng = np.random.default_rng(13)
        vcache, hcache = backend._vec[(0, DIM)], backend._ham[(0, PHASH)]
        base = {"tenant_id": 0, "modality": "image", "k": k}
        vpicks = [int(x) for x in rng.integers(0, n_vec, QBATCH_REQUESTS)]
        fpicks = [int(x) for x in rng.integers(0, n_ph, QBATCH_REQUESTS)]
        bodies = []
        for vp, fp in zip(vpicks, fpicks):
            bodies.append({**base, "vector": [
                float(x) for x in vcache.data[vp] + rng.normal(0, 0.01, DIM)]})
            bodies.append({**base, "algorithm": "phash", "fingerprint_hex": backend.get_record(
                0, hcache.rids[fp])["fingerprint"].hex()})
        want = [r for pair in zip((vcache.rids[p] for p in vpicks),
                                  (hcache.rids[p] for p in fpicks)) for r in pair]
        local = threading.local()

        def send(body):
            if not hasattr(local, "call"):
                local.call = _Client(server.port, token)
                clients.append(local.call)
            return local.call("POST", "/v1/query", body)

        for body in bodies[:2]:  # build the device caches
            check(send(body)[0] == 200, "warm-up query")

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        f0, i0 = backend._qbatch_flushes, backend._qbatch_items
        with ThreadPoolExecutor(QBATCH_CLIENTS) as ex:
            t0 = time.perf_counter()
            got = list(ex.map(send, bodies))
            wall = time.perf_counter() - t0
        launches = read_counts()
        flushes = backend._qbatch_flushes - f0
        items = backend._qbatch_items - i0
        # ---- end of the main path
        check(all(st == 200 for st, _, _ in got), "every batched request answered")
        check([res["hits"][0]["record_id"] for _, res, _ in got] == want,
              "every query finds its stored row at rank 1")
        check(items == len(bodies) and flushes < len(bodies),
              f"coalesced: {items} queries in {flushes} flushes")
        check(launches["dots_norm_topk_fused_batched"] > 0
              and launches["hamming_topk_fused_batched"] > 0
              and launches["select_topk"] > 0
              and launches["dots_norm_topk_fused"] == 0,
              f"batched kernels only: {launches}")
        backend._qbatch_ms = 0.0  # the same queries, one at a time
        for body, (_, res, _) in zip(bodies, got):
            st, res1, _ = send(body)
            check(st == 200 and res1["hits"] == res["hits"],
                  "micro-batched answer == unbatched answer")
        out = {
            "rows": {"vectors": vcache.n, "phash": hcache.n, "dim": DIM},
            "load_s": load, "batch_ms": QBATCH_MS, "clients": QBATCH_CLIENTS,
            "requests": len(bodies), "flushes": flushes,
            "items_per_flush": items / flushes,
            "requests_per_s": len(bodies) / wall, "launches": launches,
            "host_gib": host_gib(),
        }
        say("qbatch: " + json.dumps(out))
        return out
    finally:
        for c in clients:
            c.conn.close()
        _close_backend(torch, server, backend, tmp)


# -- phase 8 ----------------------------------------------------------------


def phase_int4(torch, dev) -> dict:
    """The int4 tier at phase 6's size, where the reference's cost model
    serves all three int4 kernels: with batching off, the single and
    batched forms, filtered and not, and the exact tier, each held against
    the plain path; an upsert (the packed column patch), a query that
    finds it and a delete; then micro-batched single queries (kernel #10
    at each flush's size), each equal to the unbatched answer (#9)."""
    from concurrent.futures import ThreadPoolExecutor

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    n = INT4_ROWS - 1024  # served upserts land below the loaded capacity
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-int4-")
    os.environ["UCFP_QUERY_BATCH_MS"] = str(QBATCH_MS)
    try:
        backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev, knn_quant="int4")
    finally:
        del os.environ["UCFP_QUERY_BATCH_MS"]
    server = None
    clients = []
    try:
        check(backend._qbatch_ms == QBATCH_MS, "UCFP_QUERY_BATCH_MS read")
        backend._qbatch_ms = 0.0  # off until the micro-batched block
        load_s, vcache, vecs, want, model = _vector_store(
            torch, backend, n, 10, 14, count=32 + INT4_QBATCH_REQUESTS)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend,
                                           api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        clients.append(call)
        base = {"tenant_id": 0, "modality": "image", "k": 10}
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        t0 = time.perf_counter()
        st, res, _ = call("POST", "/v1/query", {**base, "vector": vecs[0]})
        first_s = time.perf_counter() - t0  # builds the int8 + packed int4 cache
        check(st == 200, f"first int4 query: {st} {res}")
        lat = {}
        served = _served_checker(torch, backend, call, lat)
        res, rows = served("vector", {**base, "vector": vecs[0]})
        check(rows[0][0][0] == want[0] and res.get("approximate") is True,
              "int4 vector: rank 1, marked approximate")
        res, rows = served("vectors", {**base, "vectors": vecs[:32]})
        check([r[0][0] for r in rows] == want[:32] and res.get("approximate") is True,
              "int4 vectors: 32 noisy stored vectors at rank 1, marked approximate")
        res, rows = served("vector_filter", {**base, "vector": vecs[0],
                                             "filter": {"model_id": model[0]}})
        check(rows[0][0][0] == want[0], "int4 filtered vector at rank 1")
        res, rows = served("vectors_filter", {**base, "vectors": vecs[:32],
                                              "filter": {"model_id": "m0"}})
        check(all(r[0][0] == w for r, w, m in zip(rows, want, model[:32]) if m == "m0"),
              "int4 filtered batch: the m0 vectors at rank 1")
        res, rows = served("vector_exact", {**base, "vector": vecs[0],
                                            "recall_tier": "exact"})
        check(rows[0][0][0] == want[0] and "approximate" not in res,
              "int4 exact tier: rank 1, not marked approximate")
        _upsert_find_delete(torch, backend, call, base, 8 * 10**8, seed=20)
        unbatched_launches = read_counts()

        # micro-batching: single vector requests from many clients at once
        backend._qbatch_ms = float(QBATCH_MS)
        local = threading.local()

        def send(b):
            if not hasattr(local, "call"):
                local.call = _Client(server.port, token)
                clients.append(local.call)
            return local.call("POST", "/v1/query", b)

        bodies = [{**base, "vector": v} for v in vecs[32:]]
        f0, i0 = backend._qbatch_flushes, backend._qbatch_items
        with ThreadPoolExecutor(QBATCH_CLIENTS) as ex:
            t0 = time.perf_counter()
            got = list(ex.map(send, bodies))
            wall = time.perf_counter() - t0
        flushes = backend._qbatch_flushes - f0
        items = backend._qbatch_items - i0
        batched_launches = read_counts()
        backend._qbatch_ms = 0.0  # the same queries, one at a time
        for b, (st, res, _) in zip(bodies, got):
            check(st == 200 and res.get("approximate") is True,
                  "micro-batched int4 answer, marked approximate")
            st1, res1, _ = call("POST", "/v1/query", b)
            check(st1 == 200 and res1["hits"] == res["hits"],
                  "micro-batched int4 answer == unbatched answer")
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in (
            "int4_dots", "int4_masked_scores", "int4_masked_scores_batched",
            "scores_topk_fused", "scores_topk_fused_batched", "select_topk")),
            f"every kernel of the int4 path launched: {launches}")
        mb = {name: batched_launches[name] - unbatched_launches[name]
              for name in launches}
        check(mb["int4_masked_scores_batched"] > 0 and mb["int4_masked_scores"] == 0,
              f"micro-batched singles ride kernel #10 only: {mb}")
        check([res["hits"][0]["record_id"] for _, res, _ in got] == want[32:],
              "every micro-batched query finds its stored row at rank 1")
        check(items == len(bodies) and flushes < len(bodies),
              f"coalesced: {items} queries in {flushes} flushes")
        peak_device = torch.cuda.max_memory_allocated() / 2**30

        # the pack alone at the served size, and the patched columns equal
        # to a fresh pack of the same rows
        q8m, _, packed_t, inv_n4 = vcache.device[:4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pk, inv = knn.pack_int4_cols_chunked(q8m[:, :DIM])
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        check(torch.equal(pk, packed_t) and _same_bits(torch, inv, inv_n4),
              "the patched packed columns == a fresh pack")
        del pk, inv
        out = {
            "rows": vcache.n, "capacity": vcache.data.shape[0], "dim": DIM,
            "load_s": load_s, "first_query_s": first_s, "pack_s": pack_s,
            "p50_ms": lat, "launches": launches, "micro_batched_launches": mb,
            "qbatch": {"requests": len(bodies), "flushes": flushes,
                       "items_per_flush": items / flushes,
                       "requests_per_s": len(bodies) / wall},
            "peak_device_gib": peak_device, "host_gib": host_gib(),
        }
        say("int4: " + json.dumps(out))
        return out
    finally:
        for c in clients:
            c.conn.close()
        _close_backend(torch, server, backend, tmp)


# -- phases 9 and 10 ------------------------------------------------------------


def phase_int2(torch, dev) -> dict:
    """The int2 tier at phase 6's size, where the reference's cost model
    serves #12 (filtered too) and #13 at Q = 1: vector, filtered vector,
    vectors x1 and x32, the exact tier, and vector under UCFP_INT2_TOPQ=1
    (#14), each held against the plain path; an upsert (the packed column
    patch), a query that finds it and a delete."""
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    n = INT2_ROWS - 1024  # served upserts land below the loaded capacity
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-int2-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev, knn_quant="int2")
    server = None
    try:
        load_s, vcache, vecs, want, model = _vector_store(torch, backend, n, 11, 15)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend, api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        base = {"tenant_id": 0, "modality": "image", "k": 10}
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        t0 = time.perf_counter()
        st, res, _ = call("POST", "/v1/query", {**base, "vector": vecs[0]})
        first_s = time.perf_counter() - t0  # builds the int8 + packed int2 cache
        check(st == 200, f"first int2 query: {st} {res}")
        lat = {}
        served = _served_checker(torch, backend, call, lat)
        res, rows = served("vector", {**base, "vector": vecs[0]})
        check(rows[0][0][0] == want[0] and res.get("approximate") is True,
              "int2 vector: rank 1, marked approximate")
        default_rows = rows
        res, rows = served("vector_filter", {**base, "vector": vecs[0],
                                             "filter": {"model_id": model[0]}})
        check(rows[0][0][0] == want[0], "int2 filtered vector at rank 1")
        res, rows = served("vectors_1", {**base, "vectors": vecs[:1]})
        check(rows[0][0][0] == want[0] and res.get("approximate") is True,
              "int2 vectors x1: rank 1, marked approximate")
        res, rows = served("vectors", {**base, "vectors": vecs})
        check([r[0][0] for r in rows] == want, "int2 vectors: 32 noisy stored vectors at rank 1")
        res, rows = served("vector_exact", {**base, "vector": vecs[0], "recall_tier": "exact"})
        check(rows[0][0][0] == want[0] and "approximate" not in res,
              "int2 exact tier: rank 1, not marked approximate")
        os.environ["UCFP_INT2_TOPQ"] = "1"
        try:
            res, rows = served("vector_topq", {**base, "vector": vecs[0]})
        finally:
            del os.environ["UCFP_INT2_TOPQ"]
        check(rows == default_rows, "UCFP_INT2_TOPQ=1 hits == the default path's")
        _upsert_find_delete(torch, backend, call, base, 9 * 10**8, seed=16)
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in (
            "int2_masked_scores", "int2_masked_scores_batched", "int2_topq_scores",
            "dots_norm_topk_fused_batched", "select_topk")),
            f"every kernel of the int2 path launched: {launches}")
        peak_device = torch.cuda.max_memory_allocated() / 2**30

        # the pack alone at the served size, and the patched columns equal
        # to a fresh pack of the same rows
        q8m, _, packed_t, inv_n2 = vcache.device[:4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pk, inv = knn.pack_int2_cols_chunked(q8m[:, :DIM])
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        check(torch.equal(pk, packed_t) and _same_bits(torch, inv, inv_n2),
              "the patched packed int2 columns == a fresh pack")
        del pk, inv, q8m, packed_t, inv_n2
        out = {
            "rows": vcache.n, "capacity": vcache.data.shape[0], "dim": DIM,
            "load_s": load_s, "first_query_s": first_s, "pack_s": pack_s,
            "p50_ms": lat, "launches": launches,
            "peak_device_gib": peak_device, "host_gib": host_gib(),
        }
        say("int2: " + json.dumps(out))
        return out
    finally:
        _close_backend(torch, server, backend, tmp)


def phase_sketch(torch, dev) -> dict:
    """The sketch tier at phase 6's size: vector at the fast and balanced
    recall tiers (#15; fast also with a filter), vector at the default
    tier (the cost model serves the exact int8 path there, and #15 does
    not launch), vectors x32 and the exact tier, each held against the
    plain path; an upsert (the tiled sketch patch), a fast query that
    finds it and a delete. The store is loaded anew: reopening phase 9's
    data directory replayed its 13 GB log in 259 s against a 107 s bulk
    load (PERF.md)."""
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    n = SKETCH_ROWS - 1024
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-sketch-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev, knn_quant="sketch")
    server = None
    try:
        load_s, vcache, vecs, want, model = _vector_store(torch, backend, n, 12, 17)
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend, api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        base = {"tenant_id": 0, "modality": "image", "k": 10}
        fast = {**base, "recall_tier": "fast"}
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        t0 = time.perf_counter()
        st, res, _ = call("POST", "/v1/query", {**fast, "vector": vecs[0]})
        first_s = time.perf_counter() - t0  # builds the int8 + sketch cache
        check(st == 200, f"first sketch query: {st} {res}")
        lat = {}
        served = _served_checker(torch, backend, call, lat)
        for tier in ("fast", "balanced"):
            res, rows = served(f"vector_{tier}", {**base, "vector": vecs[0],
                                                  "recall_tier": tier})
            check(rows[0][0][0] == want[0] and res.get("approximate") is True,
                  f"sketch {tier} vector: rank 1, marked approximate")
        res, rows = served("vector_fast_filter", {**fast, "vector": vecs[1],
                                                  "filter": {"model_id": model[1]}})
        check(rows[0][0][0] == want[1], "sketch fast filtered vector at rank 1")
        scans = read_counts()["asym_sketch_scores_tiled"]
        res, rows = served("vector_default", {**base, "vector": vecs[0]})
        check(rows[0][0][0] == want[0], "sketch default tier: rank 1")
        check(read_counts()["asym_sketch_scores_tiled"] == scans,
              "the default tier is served by the exact int8 path (no sketch scan)")
        res, rows = served("vectors", {**base, "vectors": vecs})
        check([r[0][0] for r in rows] == want, "sketch vectors: 32 noisy stored vectors at rank 1")
        res, rows = served("vector_exact", {**base, "vector": vecs[0], "recall_tier": "exact"})
        check(rows[0][0][0] == want[0] and "approximate" not in res,
              "sketch exact tier: rank 1, not marked approximate")
        _upsert_find_delete(torch, backend, call, fast, 10 * 10**8, seed=18)
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in (
            "asym_sketch_scores_tiled", "dots_norm_topk_fused",
            "dots_norm_topk_fused_batched", "select_topk")),
            f"every kernel of the sketch path launched: {launches}")
        peak_device = torch.cuda.max_memory_allocated() / 2**30

        # the sketch build alone at the served size, and the patched
        # sketch equal to a fresh build of the same rows
        q8m, _, tiled = vcache.device[:3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = knn.tile_sketch(knn.build_sketch_chunked(q8m[:, :DIM],
                                                         backend._sketch_planes(DIM)))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(torch.equal(fresh, tiled), "the patched sketch == a fresh build")
        del fresh, q8m, tiled
        out = {
            "rows": vcache.n, "capacity": vcache.data.shape[0], "dim": DIM,
            "load_s": load_s, "first_query_s": first_s,
            "sketch_build_s": build_s, "p50_ms": lat, "launches": launches,
            "peak_device_gib": peak_device, "host_gib": host_gib(),
        }
        say("sketch: " + json.dumps(out))
        return out
    finally:
        _close_backend(torch, server, backend, tmp)


# -- phase 11 -------------------------------------------------------------------


def _same_result(torch, got, want) -> bool:
    return _same_bits(torch, got[0], want[0]) and torch.equal(got[1], want[1])


def _vec_shards(torch, dev, g, c: int, meshes) -> dict:
    """A 2^22 x 768 int8 catalog made on the card, with a zero row and a
    row copied into another shard, cut into the mesh's row blocks, with
    each block's packed int4 and int2 columns and tiled sketch built on
    the card (column and tile-row blocks of the whole)."""
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.parallel.sharded_knn import ShardedTensor, shard_tensor

    mesh = meshes["1d"]
    q8 = torch.randint(-127, 128, (c, knn.padded_dim(DIM)), generator=g, device=dev,
                       dtype=torch.int8)
    q8[3] = 0
    q8[c // 2 + 9] = q8[9]  # a tie across shards
    rn = torch.empty(c, device=dev)
    for lo in range(0, c, 1 << 18):
        rn[lo:lo + (1 << 18)] = knn.int8_norms(q8[lo:lo + (1 << 18), :DIM])
    rows = c // SHARDS
    blocks = [q8[s * rows:(s + 1) * rows, :DIM] for s in range(SHARDS)]
    planes = torch.from_numpy(knn.sketch_planes(DIM)).to(dev)
    p4 = [knn.pack_int4_cols_chunked(b) for b in blocks]
    p2 = [knn.pack_int2_cols_chunked(b) for b in blocks]
    n = c - 1024
    valid = torch.arange(c, device=dev) < n
    fvalid = valid & (torch.arange(c, device=dev) % 3 != 0)
    picks = torch.randint(0, n, (32,), generator=g, device=dev)
    picks[0] = 9
    picks[1] = 6  # a filtered-out row (6 % 3 == 0) for the unfiltered forms
    noise = torch.randn((32, DIM), generator=g, device=dev) * 2.0
    return {
        "q8": shard_tensor(q8, mesh), "rn": shard_tensor(rn, mesh),
        "valid": shard_tensor(valid, mesh), "fvalid": shard_tensor(fvalid, mesh),
        "p4": ShardedTensor([p[0] for p in p4], 1), "i4": ShardedTensor([p[1] for p in p4]),
        "p2": ShardedTensor([p[0] for p in p2], 1), "i2": ShardedTensor([p[1] for p in p2]),
        "sketch": ShardedTensor([knn.tile_sketch(knn.build_sketch_chunked(b, planes))
                                 for b in blocks]),
        "planes": planes, "n": n, "picks": picks.tolist(),
        "queries": q8[picks, :DIM].float() + noise,
    }


def _sharded_direct(torch, dev, g, meshes) -> list:
    """Phase 11(a): every sharded function with the kernels, then with
    their plain versions (the int8 product too), on the same tensors;
    values and rows bit-equal, the stored row at rank 1. Returns the
    (name, call) pairs to time, run after the launch counts are read."""
    from ucfp_tpu_torch.ops import knn
    from ucfp_tpu_torch.parallel import sharded_knn as sk

    k = 10
    mesh = meshes["1d"]
    timings = []

    def hold(name, fn, want_rows=None, mesh_name="1d", timed=True):
        got = fn(meshes[mesh_name])
        torch.cuda.synchronize()
        with _plain_quant_path(torch):
            want = fn(meshes[mesh_name])
        check(_same_result(torch, got, want), f"sharded {name} ({mesh_name}) == plain path")
        if want_rows is not None:
            top = got[1] if got[1].dim() == 1 else got[1][:, 0]
            check(top.reshape(-1)[:len(want_rows)].tolist() == want_rows,
                  f"sharded {name}: stored rows at rank 1")
        if timed:
            timings.append((name, lambda: fn(meshes[mesh_name])))
        return got

    # the fused Hamming scan (#6 per shard) at 2^23 x 2 words, rows of one
    # value repeated so that cell position order decides ties
    c = SHARD_HAMMING_ROWS
    db = torch.randint(-2**31, 2**31, (c, 2), generator=g, device=dev, dtype=torch.int32)
    db[1000:1300] = db[7]
    db[c - 5000:c - 4000] = db[7]
    dbs = sk.shard_tensor(db, mesh)
    for name, q in (("hamming_fused", db[7].clone()), ("hamming_fused_far", db[7] ^ -1),
                    ("hamming_fused_last", db[c - 1] ^ 3)):
        got = hold(name, lambda m, q=q: sk.sharded_hamming_topk_fused(q, dbs, k, m),
                   timed=name == "hamming_fused")
        if name == "hamming_fused":
            # rows 1024 and 1152 hold row 7's value in cell (0, 0): the
            # lower cell position wins over the lower row
            check(got[0].tolist()[:2] == [0, 0] and int(got[1][0]) == 1024,
                  f"sharded fused Hamming position order: {got[1][:4].tolist()}")
    exact = sk.sharded_hamming_topk(db[7][None], dbs, sk.shard_tensor(
        torch.ones(c, dtype=torch.bool, device=dev), mesh), k, mesh)
    check(exact[1][0, 0].item() == 7 and int(exact[0][0, 0]) == 0,
          "exact sharded Hamming: row 7 at distance 0")

    v = _vec_shards(torch, dev, g, SHARD_VEC_ROWS, meshes)
    qs, picks, n = v["queries"], v["picks"], v["n"]
    qq = knn._quantize_query(qs[0])
    cand_fast = knn.sketch_pool(SHARD_VEC_ROWS, k, 0.0066)
    cand = knn.sketch_pool(SHARD_VEC_ROWS, k)
    hold("int8", lambda m: sk.sharded_cosine_int8_topk(qq, v["q8"], v["rn"], v["valid"],
                                                       k, m), [9])
    for q in (1, 32):
        hold(f"int8_batch_q{q}", lambda m, q=q: sk.sharded_cosine_int8_batch_topk(
            qs[:q], v["q8"], v["rn"], v["valid"], k, m), picks[:q])
    for kind, fn, fn_b in (("int4", sk.sharded_cosine_int4_topk,
                            sk.sharded_cosine_int4_batch_topk),
                           ("int2", sk.sharded_cosine_int2_topk,
                            sk.sharded_cosine_int2_batch_topk)):
        pk, inv = v["p4" if kind == "int4" else "p2"], v["i4" if kind == "int4" else "i2"]
        hold(kind, lambda m, fn=fn, pk=pk, inv=inv: fn(
            qs[0], v["q8"], v["rn"], pk, inv, v["valid"], k, m, m.axis_names, n_valid=n), [9])
        hold(f"{kind}_filter", lambda m, fn=fn, pk=pk, inv=inv: fn(
            qs[1], v["q8"], v["rn"], pk, inv, v["fvalid"], k, m, m.axis_names))
        for q in (1, 32):
            hold(f"{kind}_batch_q{q}", lambda m, q=q, fn_b=fn_b, pk=pk, inv=inv: fn_b(
                qs[:q], v["q8"], v["rn"], pk, inv, n, k, m, m.axis_names), picks[:q])
    for tier, cnd in (("fast", cand_fast), ("default", cand)):
        hold(f"sketch_{tier}", lambda m, cnd=cnd: sk.sharded_cosine_sketch_topk(
            qs[0], v["planes"], v["q8"], v["rn"], v["sketch"], v["valid"], k, cnd, m,
            m.axis_names), [9])
    hold("sketch_fast_filter", lambda m: sk.sharded_cosine_sketch_topk(
        qs[1], v["planes"], v["q8"], v["rn"], v["sketch"], v["fvalid"], k, cand_fast, m,
        m.axis_names), timed=False)
    # the 2 x 4 mesh: the hierarchical merge gives the 1-D mesh's answer
    for name, fn in (
            ("int4_batch_q32", lambda m: sk.sharded_cosine_int4_batch_topk(
                qs, v["q8"], v["rn"], v["p4"], v["i4"], n, k, m, m.axis_names)),
            ("sketch_fast", lambda m: sk.sharded_cosine_sketch_topk(
                qs[0], v["planes"], v["q8"], v["rn"], v["sketch"], v["valid"], k,
                cand_fast, m, m.axis_names))):
        got = hold(f"{name}_2x4", fn, mesh_name="2x4", timed=False)
        check(_same_result(torch, got, fn(mesh)), f"sharded {name}: 2 x 4 mesh == 1-D mesh")
    return timings


def _time_sharded(torch, timings: list) -> dict:
    """Each sharded call's time with the kernels and with the plain
    versions (CUDA events, median of SHARD_RUNS)."""
    out = {"ms": {}, "plain_ms": {}}
    for name, fn in timings:
        out["ms"][name] = time_ms(torch, fn, SHARD_RUNS)
        with _plain_quant_path(torch):
            out["plain_ms"][name] = time_ms(torch, fn, SHARD_RUNS)
    return out


def _sharded_plain_hits(torch, backend, body, k):
    """The plain path of a served phase-11 request, on the backend's own
    device tensors: the kernels and the int8 product swapped for their
    plain versions (vectors); for fingerprints the unsharded exact scan
    over the gathered shards."""
    import numpy as np

    from ucfp_tpu_torch.ops import knn

    if "vector" in body or "vectors" in body:
        return _plain_quant_rows(torch, backend, body)
    cache = backend._ham[(0, PHASH)]
    matrix, valid = (t.full() for t in cache.device)
    hexes = body.get("fingerprints_hex") or [body["fingerprint_hex"]]
    qm = np.stack([np.frombuffer(bytes.fromhex(h), "<u4") for h in hexes])
    d, i = knn.hamming_topk(torch.from_numpy(qm.view(np.int32)).to(matrix.device),
                            matrix, valid, min(k, cache.n))
    out = []
    for dr, ir in zip(d.cpu().numpy(), i.cpu().numpy()):
        rows = [(cache.rids[int(x)], 1.0 - int(y) / 64) for y, x in zip(dr, ir) if y < 2**30]
        rows.sort(key=lambda t: (-t[1], t[0]))
        out.append(rows)
    return out


def phase_sharded(torch, dev, n_served: int = SHARD_SERVED_ROWS) -> dict:
    """Phase 11: (a) the sharded functions on device tensors, (b) an int8
    EmbeddedBackend on a mesh of 8 shards of the card, served over
    loopback HTTP, every answer held against the plain path."""
    import numpy as np

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.parallel import mesh as pm
    from ucfp_tpu_torch.parallel.sharded_knn import ShardedTensor
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4321)
    meshes = {"1d": pm.data_mesh(SHARDS, devices=[dev] * SHARDS),
              "2x4": pm.data_mesh_2d(2, SHARDS // 2, devices=[dev] * SHARDS)}

    # ---- (a), the direct calls: launch counts read over exactly this block
    reset_counts()
    timings = _sharded_direct(torch, dev, g, meshes)
    launches_a = read_counts()
    # ---- end of (a)
    check(all(launches_a[name] > 0 for name in (
        "hamming_topk_fused", "int4_masked_scores", "int4_dots",
        "int4_masked_scores_batched", "scores_topk_fused_batched", "int2_masked_scores",
        "int2_masked_scores_batched", "asym_sketch_scores_tiled", "select_topk")),
        f"every per-shard kernel of the sharded functions launched: {launches_a}")
    direct = _time_sharded(torch, timings)
    del timings
    torch.cuda.empty_cache()
    t_direct = time.perf_counter() - t_phase

    # ---- (b), served
    n = n_served - 1024  # served upserts land below the loaded capacity
    k = 10
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-sharded-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev, knn_quant="int8",
                              mesh=meshes["1d"])
    server = None
    try:
        check(backend._n_shards() == SHARDS, "the backend took the 8-shard mesh")
        load = _bulk_load(torch, backend, n, 0, n, DIM, seed=21, dev=dev,
                          model_ids=("m0", "m1"), vec_fp_bytes=8)
        vcache, hcache = backend._vec[(0, DIM)], backend._ham[(0, PHASH)]
        rng = np.random.default_rng(22)
        picks = [int(x) for x in rng.integers(0, n, 32)]
        vecs = [[float(x) for x in vcache.data[p] + rng.normal(0, 0.01, DIM)] for p in picks]
        want = [vcache.rids[p] for p in picks]
        model = ["m0" if (p >> 15) % 2 == 0 else "m1" for p in picks]
        fpicks = [int(x) for x in rng.integers(0, n, 32)]
        hexes = [backend.get_record(0, hcache.rids[p])["fingerprint"].hex() for p in fpicks]
        token = "smoke-token"
        server = _ServerThread(ServerState(index=backend, api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        base = {"tenant_id": 0, "modality": "image", "k": k}
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        t0 = time.perf_counter()
        st, res, _ = call("POST", "/v1/query", {**base, "vector": vecs[0]})
        first_s = time.perf_counter() - t0  # builds the 8 int8 shards
        check(st == 200, f"first sharded query: {st} {res}")
        lat = {}

        def served(form, body):
            times = []
            for _ in range(SERVED_REPS):
                st, res, ms = call("POST", "/v1/query", body)
                check(st == 200, f"sharded {form}: {st} {res}")
                times.append(ms)
            lat[form] = statistics.median(times)
            rows = _served_rows(body, res) if ("vector" in body or "vectors" in body) else (
                [_hit_rows(r["hits"]) for r in res["results"]] if "results" in res
                else [_hit_rows(res["hits"])])
            check(rows == _sharded_plain_hits(torch, backend, body, k),
                  f"sharded {form} hits == plain path")
            check("approximate" not in res, f"sharded {form}: exact, not marked approximate")
            return rows

        fp = {**base, "algorithm": "phash"}
        rows = served("fingerprint_hex", {**fp, "fingerprint_hex": hexes[0]})
        check(rows[0][0] == (hcache.rids[fpicks[0]], 1.0), "stored pHash at rank 1")
        rows = served("fingerprints_hex", {**fp, "fingerprints_hex": hexes})
        check([r[0] for r in rows] == [(hcache.rids[p], 1.0) for p in fpicks],
              "32 stored pHashes at rank 1")
        rows = served("vector", {**base, "vector": vecs[0]})
        check(rows[0][0][0] == want[0], "sharded int8: noisy stored vector at rank 1")
        rows = served("vectors", {**base, "vectors": vecs})
        check([r[0][0] for r in rows] == want, "sharded int8: 32 noisy stored vectors at rank 1")
        rows = served("vector_filter", {**base, "vector": vecs[0],
                                        "filter": {"model_id": model[0]}})
        check(rows[0][0][0] == want[0], "sharded int8 filtered vector at rank 1")
        rows = served("vector_exact", {**base, "vector": vecs[0], "recall_tier": "exact"})
        check(rows[0][0][0] == want[0], "sharded int8 exact tier at rank 1")
        shards = [list(t.shards) for t in vcache.device[:-1]]
        _upsert_find_delete(torch, backend, call, base, 11 * 10**8, seed=23)
        launches_b = read_counts()
        # ---- end of the main path
        check([list(t.shards) for t in vcache.device[:-1]] == shards
              and all(isinstance(t, ShardedTensor) for t in vcache.device),
              "the row patches stayed in the 8 shard tensors")
        launches = {name: launches_a[name] + launches_b[name] for name in launches_a}
        out = {
            "shards": SHARDS, "direct": direct, "direct_s": t_direct,
            "served": {"rows": {"vectors": vcache.n, "phash": hcache.n, "dim": DIM},
                       "load_s": load, "first_query_s": first_s, "p50_ms": lat,
                       "launches": launches_b},
            "launches": launches, "phase_s": time.perf_counter() - t_phase,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_gib": host_gib(),
        }
        say("sharded: " + json.dumps(out))
        return out
    finally:
        _close_backend(torch, server, backend, tmp)


# -- phase 12 ---------------------------------------------------------------


# the bench keys phase 12 runs: the headline and the 10M x 64 query keys
BENCH_ONLY = "phash,10m_x64,audio"
BENCH_KEYS = ("query_hamming_p50_ms_10m_x64bit", "query_hamming_fused_p50_ms_10m_x64bit",
              "query_cosine_int8_p50_ms_10m_x64", "query_cosine_int8_hybrid_p50_ms_10m_x64",
              "query_cosine_int8_mxu_p50_ms_10m_x64", "query_cosine_int8_fused_p50_ms_10m_x64",
              "audio_wang_xrt", "audio_panako_xrt", "audio_haitsma_xrt",
              "audio_haitsma_fft_xrt", "audio_match_p50_ms_1m_landmarks")
# the kernels those keys run: #4 (hybrid), #6 (fused Hamming), #7, #8
BENCH_KERNELS = ("dots_norm_topk_fused", "hamming_topk_fused", "cosine_int8_topk_fused",
                 "cosine_int8_topk_mxu", "select_topk")


def phase_bench(torch, dev) -> dict:
    """The port's bench entry point (ucfp_tpu_torch.bench.main), in this
    process so the launch counts show what it ran: the phash headline, the
    10M x 64 keys and the five audio keys (UCFP_BENCH_ONLY=phash,10m_x64,
    audio with UCFP_BENCH_FULL=1 for the exact ones). Every key must be a finite
    positive number, #4, #6, #7 and #8 must launch, and the last line must
    parse and hold at most 1.5 KB."""
    import math

    from ucfp_tpu_torch import bench

    t_phase = time.perf_counter()
    env = {"UCFP_BENCH_ONLY": BENCH_ONLY, "UCFP_BENCH_FULL": "1"}
    saved = {name: os.environ.get(name) for name in (*env, "UCFP_BENCH_BUDGET_S")}
    os.environ.update(env)
    os.environ.pop("UCFP_BENCH_BUDGET_S", None)
    buf = io.StringIO()
    try:
        reset_counts()
        # ---- the main path: the bench as a user runs it, on the card
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", str(dev)])
        launches = read_counts()
        # ---- end of the main path
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    check(rc == 0, f"bench exit code {rc}")
    lines = buf.getvalue().strip().splitlines()
    check(len(lines) >= 1 and len(lines[-1].encode()) <= bench.LAST_LINE_MAX,
          "bench last line at most 1.5 KB")
    last = json.loads(lines[-1])

    def positive(x):
        return isinstance(x, float) and math.isfinite(x) and x > 0

    check(positive(last["value"]), f"bench headline {last['value']!r}")
    check(set(last["extra"]) == set(BENCH_KEYS), f"bench keys {sorted(last['extra'])}")
    for key in BENCH_KEYS:
        check(positive(last["extra"][key]), f"bench {key} = {last['extra'][key]!r}")
    for name in BENCH_KERNELS:
        check(launches[name] > 0, f"the bench launched {name}")
    check(last["device"]["card"] == _smi("name,power.limit"),
          f"the bench names the card: {last['device']}")
    out = {"bench": last, "last_line_bytes": len(lines[-1].encode()),
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    say("bench: " + json.dumps(out))
    return out


# -- phase 13 -----------------------------------------------------------------

# (a) min-BER: the served shape (2^14 rows of 30 s Haitsma streams, 2,311
# words each in Tb = 4,096 columns, against a 359-word query in Qb = 512)
# and the edge cases
MINBER_ROWS = 1 << 14
MINBER_TB = 4096
MINBER_WORDS = 2311  # 30 s at 5 kHz: (150,000 - 2,048) // 64 words
MINBER_Q = 359
MINBER_QB = 512
MINBER_PLAIN_RUNS = 3  # the plain version takes about a second a call there
# (b) the ops on a 60 s clip; (c) the served catalogs: random 30 s Haitsma
# streams (room left below 2^14 rows for the ingests) and 10^4 Wang records
# of 100 landmarks (the reference bench's audio-match shape)
AUDIO_SECS = 60.0
HAITSMA_SERVED = (1 << 14) - 128
WANG_SERVED = 10_000
WANG_PER = 100
AUDIO_BATCH = 64  # 30 s s16 clips at 8 kHz per batch request
AUDIO_CLIP_S = 30.0
AUDIO_QUERY_S = 5.0
AUDIO_REPS = 10
AUDIO_ALGOS = ("wang", "panako", "haitsma")


def _fixed_audio(secs: float = 3.0, sr: int = 8000):
    """The conformance corpus's audio generator (tests/test_conformance.py)."""
    import math

    import numpy as np

    t = np.arange(int(secs * sr)) / sr
    x = (0.4 * np.sin(2 * math.pi * 440 * t)
         + 0.25 * np.sin(2 * math.pi * 1200 * t) * (np.sin(2 * math.pi * 0.7 * t) > 0)
         + 0.1 * np.sin(2 * math.pi * 2500 * t) * (t > 1.0))
    return x.astype(np.float32)


def _audio_clip(i: int, secs: float = AUDIO_CLIP_S, sr: int = 8000):
    """Clip i of the served catalog: two tones and a gate of its own, and
    noise drawn from seed i, as s16 samples."""
    import numpy as np

    t = np.arange(int(secs * sr)) / sr
    rng = np.random.default_rng(1000 + i)
    x = (0.3 * np.sin(2 * np.pi * (300 + 37 * i) * t)
         + 0.2 * np.sin(2 * np.pi * (900 + 53 * i) * t)
         * (np.sin(2 * np.pi * (0.3 + 0.013 * i) * t) > 0)
         + rng.normal(0, 0.05, t.size))
    return np.clip(np.round(x * 20000), -32768, 32767).astype(np.int16)


def _minber_case(torch, dev, g, r: int, tb: int, lens, q_true: int, qb: int,
                 periodic: bool = False, dirty: bool = False):
    """(db, lens, q_pad) on the card: random u32 words (or period-4 rows
    over 4 values, where many offsets tie), zero past each row's length,
    and a query cut from a live row with about 1 word in 32 scrambled,
    zero past q_true. With dirty, the padding is left unmasked: random
    words past each row's length and past q_true, which no answer may
    depend on."""
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    if periodic:
        vals = torch.tensor([0x0F0F0F0F, 0x33333333, 0x0F0F0F0F, 0x55555555],
                            dtype=torch.int32, device=dev)
        db = vals[torch.arange(tb, device=dev) % 4].expand(r, tb).clone()
    else:
        db = torch.randint(0, 2**32, (r, tb), generator=g, device=dev,
                           dtype=torch.int64).to(torch.int32)
    if not dirty:
        db.masked_fill_(torch.arange(tb, device=dev)[None, :] >= lens[:, None].long(), 0)
    src = int(torch.argmax(lens).item())
    q = db[src, 3:3 + q_true].clone() if q_true <= int(lens[src]) - 3 else db[src, :q_true].clone()
    flips = torch.randint(0, 2**32, (q_true,), generator=g, device=dev, dtype=torch.int64)
    sparse = torch.randint(0, 32, (q_true,), generator=g, device=dev) == 0
    if not periodic:  # a periodic query matches exactly at every 4th offset
        q ^= torch.where(sparse, flips, torch.zeros_like(flips)).to(torch.int32)
    q_pad = torch.zeros(qb, dtype=torch.int32, device=dev)
    if dirty:
        q_pad = torch.randint(-2**31, 2**31, (qb,), generator=g, device=dev, dtype=torch.int32)
    q_pad[:q_true] = q
    return db, lens, q_pad


def _minber_bound(card: dict, lens, tb: int, q_true: int, qb: int) -> dict:
    """min-BER's bound, the least over three formulations of the work this
    run's lengths need, as #2's (_hamming_bound): q_true popcounts per
    offset (16 per clock per SM); an exact int8 product on the tensor
    cores (the query's bits as +1 / -1 in 8 pieces as the N columns, each
    window of row bits at every offset as the M rows, a Toeplitz operand,
    2 * 32 * q_true operations per offset, then the 8 pieces' sums added
    along the diagonals and one compare per offset on the ALU); or the b1
    AND-popcount product (the query shifted a word a column as B, 2 * 32 *
    q_true bit operations per offset, errs = S + Pq - 2 D: one popcount a
    row word for S, and about 6 ALU operations an offset for S, errs, the
    key and the compare). Each reads the row words that valid offsets
    reach (words 0 .. last + q_true - 1 of a row with an offset), the
    lengths and the live query once, and writes (ber, offset). The forms
    stay beside it as bound_popc_ms, bound_mma_ms and bound_b1_ms."""
    import numpy as np

    lens = np.asarray(lens, np.int64)
    last = np.minimum(lens - q_true, tb - qb)
    n_off = float(np.clip(last + 1, 0, None).sum())
    words = float(np.where(last >= 0, last + q_true, 0).sum())
    nbytes = words * 4 + len(lens) * (4 + 8) + q_true * 4
    popc = bound_ms(card, nbytes, popc_ops=n_off * q_true)
    mma = bound_ms(card, nbytes, alu_ops=n_off * 9, int8_mma_ops=2 * 32 * n_off * q_true)
    b1 = bound_ms(card, nbytes, alu_ops=n_off * 6, popc_ops=words,
                  b1_mma_ops=2 * 32 * n_off * q_true)
    b, by = min(popc, mma, b1)
    return {"bound_ms": b, "bound_by": by, "bound_popc_ms": popc[0], "bound_mma_ms": mma[0],
            "bound_b1_ms": b1[0]}


def _audio_kernel(torch, dev, card: dict) -> dict:
    """13(a): ucfp_min_ber against min_ber_batch_plain on the card."""
    from ucfp_tpu_torch.ops.audio import haitsma as hops

    g = torch.Generator(device=dev).manual_seed(4321)
    lens_served = torch.full((MINBER_ROWS,), MINBER_WORDS, dtype=torch.int32)
    lens_served[::97] = torch.randint(0, MINBER_TB + 1, (len(lens_served[::97]),),
                                      generator=torch.Generator().manual_seed(5),
                                      dtype=torch.int32)
    lens_served[5] = 0
    short = torch.randint(0, 100, (512,), generator=torch.Generator().manual_seed(6),
                          dtype=torch.int32)
    short[::3] = 0
    short[7] = 512

    def mixed(r: int, tb: int, seed: int):
        """lengths 0..tb: dead rows, rows shorter than any query, full rows"""
        lens = torch.randint(0, tb + 1, (r,), generator=torch.Generator().manual_seed(seed),
                             dtype=torch.int32)
        lens[::5] = 0
        lens[1::7] = tb
        return lens

    # (name, rows, Tb, lens, q_true, Qb, period-4 rows, padding left unmasked)
    cases = (
        ("served", MINBER_ROWS, MINBER_TB, lens_served, MINBER_Q, MINBER_QB, False, False),
        ("ties", 1024, 1024, torch.full((1024,), 900, dtype=torch.int32), 40, 64, True, False),
        ("short_and_dead", 512, 512, short, 64, 64, False, False),
        ("q_true_1", 4096, 1024, torch.full((4096,), 1000, dtype=torch.int32), 1, 64, False,
         False),
        ("q_true_tb", 256, 2048, torch.full((256,), 2048, dtype=torch.int32), 2048, 2048,
         False, False),
        ("one_long_row", 1, 1 << 18, [(1 << 18) - 5], MINBER_Q, MINBER_QB, False, False),
        # the words past each row's length and past q_true random
        ("dirty_padding", 2048, 1024, mixed(2048, 1024, 7), 100, 128, False, True),
        ("q_true_0", 512, 1024, mixed(512, 1024, 8), 0, 64, False, True),
        ("q_true_7", 2048, 1024, mixed(2048, 1024, 9), 7, 64, False, True),
        ("q_true_8", 2048, 1024, mixed(2048, 1024, 10), 8, 64, False, True),
        ("q_true_9", 2048, 1024, mixed(2048, 1024, 11), 9, 64, False, True),
        # 201 offsets a row: no multiple of 128
        ("offsets_201", 4096, 712, mixed(4096, 712, 12), MINBER_Q, MINBER_QB, False, True),
        # three passes of the kernel's 512 query words
        ("q_chunks", 1024, 2048, mixed(1024, 2048, 13), 1100, 1100, False, True),
        # rows not 16-byte aligned: the kernel's word-by-word staging
        ("tb_1021", 1024, 1021, mixed(1024, 1021, 14), 100, 128, False, True),
    )
    rows = []
    for name, r, tb, lens, q_true, qb, periodic, dirty in cases:
        db, lens_d, q_pad = _minber_case(torch, dev, g, r, tb, lens, q_true, qb, periodic,
                                         dirty)
        bk, ok = hops._min_ber_cuda(db, lens_d, q_pad, q_true)
        torch.cuda.synchronize()
        bp, op = hops.min_ber_batch_plain(db, lens_d, q_pad, q_true)
        check(_same_bits(torch, bk, bp) and torch.equal(ok, op),
              f"min-BER {name}: ber bits and offsets equal the plain version")
        row = {"case": name, "r": r, "tb": tb, "q_true": q_true, "qb": qb,
               "max_abs_err": _max_abs(torch, bk, bp),
               "no_offset_rows": int((ok < 0).sum()),
               "ms": time_ms(torch, lambda: hops._min_ber_cuda(db, lens_d, q_pad, q_true))}
        if name == "ties":
            check(int((bk == 0).sum()) > 0, "ties: some rows match exactly")
        if name in ("served", "one_long_row"):
            row.update(device_ms=device_ms(torch, lambda: hops._min_ber_cuda(
                db, lens_d, q_pad, q_true)),
                plain_ms=time_ms(torch, lambda: hops.min_ber_batch_plain(
                db, lens_d, q_pad, q_true), runs=MINBER_PLAIN_RUNS),
                **_minber_bound(card, lens_d.cpu().numpy(), tb, q_true, qb),
                library_ms=None)
        rows.append(row)
        del db, lens_d, q_pad
    return {"min_ber": rows}


def _audio_ops(torch, dev) -> dict:
    """13(b): the ops on a 60 s clip on the card, bit-equal to the same
    port functions on the CPU; the 8 non-neural audio digests on the card."""
    import numpy as np
    import xxhash

    from ucfp_tpu_torch.modality import audio as amod
    from ucfp_tpu_torch.ops.audio import constellation as con
    from ucfp_tpu_torch.ops.audio import dsp as adsp
    from ucfp_tpu_torch.ops.audio import haitsma as hops
    from ucfp_tpu_torch.ops.audio import intfft

    cpu = torch.device("cpu")
    x8 = torch.from_numpy(adsp.quantize_samples_i16(_fixed_audio(AUDIO_SECS, 8000)))
    x5 = torch.from_numpy(adsp.quantize_samples_i16(_fixed_audio(AUDIO_SECS, 5000)))
    wang, pan = con.WangConfig(), con.PanakoConfig()
    times = {}

    def on_both(name, fn, *args):
        t0 = time.perf_counter()
        card = fn(*[a.to(dev) if hasattr(a, "to") else a for a in args])
        card = card if isinstance(card, tuple) else (card,)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        host = fn(*[a.to(cpu) if hasattr(a, "to") else a for a in args])
        host = host if isinstance(host, tuple) else (host,)
        check(all(torch.equal(c.cpu(), h) for c, h in zip(card, host)),
              f"{name} on the card == on the CPU")
        return host

    (p8,) = on_both("stft_power_int_1024_s8", adsp.stft_power_int, x8, 1024, 256, True, 8)
    on_both("stft_power_int_2048_s14", adsp.stft_power_int, x5, 2048, 64, False, 14)
    on_both("stft_power_int_fft", intfft.stft_power_int_fft, x5, 2048, 64, False)
    peaks = on_both("pick_peaks", con.pick_peaks, p8.to(torch.float32), 8000 // 256,
                    wang.peaks_per_sec, wang.min_anchor_mag_db, False)
    check(bool(peaks[2].any()), "60 s clip: valid peaks")
    on_both("wang_pairs", con.wang_pairs, *peaks, wang.fan_out, wang.target_zone_t,
            wang.target_zone_f)
    on_both("panako_triplets", con.panako_triplets, *peaks, pan.fan_out, pan.target_zone_t,
            pan.target_zone_f)
    for fft in (False, True):
        on_both(f"haitsma_words_fft{int(fft)}", hops.haitsma_words, x5, 300.0, 2000.0, fft)

    golden = json.loads(open(os.path.join(HERE, "tests", "goldens",
                                          "conformance.json")).read())
    x, short = _fixed_audio(), _fixed_audio(secs=1.0)
    got = {
        "audio/wang/8k": amod.fingerprint_wang(x, 8000, 0, 1, device=dev),
        "audio/wang/16k-resampled": amod.fingerprint_wang(np.repeat(x, 2), 16000, 0, 1,
                                                          device=dev),
        "audio/panako/8k": amod.fingerprint_panako(x, 8000, 0, 1, device=dev),
        "audio/haitsma/8k": amod.fingerprint_haitsma(x, 8000, 0, 1, device=dev),
        "audio/wang/1s": amod.fingerprint_wang(short, 8000, 0, 1, device=dev),
        "audio/haitsma/44k1-resampled": amod.fingerprint_haitsma(
            _fixed_audio(secs=2.0, sr=44100), 44100, 0, 1, device=dev),
        "audio/wang/tuned": amod.fingerprint_wang(
            x, 8000, 0, 1, amod.WangConfig(fan_out=4, target_zone_t=32, target_zone_f=32,
                                           peaks_per_sec=15, min_anchor_mag_db=-40.0),
            device=dev),
        "audio/haitsma/tuned": amod.fingerprint_haitsma(
            x, 8000, 0, 1, amod.HaitsmaConfig(fmin=200.0, fmax=1800.0), device=dev),
    }
    bad = [k for k, r in got.items() if xxhash.xxh3_64_hexdigest(r.fingerprint) != golden[k]]
    check(not bad, f"audio conformance digests on the card: {bad}")
    check(set(got) == {k for k in golden if k.startswith("audio/") and "neural" not in k},
          "every non-neural audio golden covered")
    return {"ops_card_s": times, "digests": len(got)}


def _audio_load(backend, seed: int) -> dict:
    """The served catalogs, written through backend.upsert: HAITSMA_SERVED
    random 30 s Haitsma streams and WANG_SERVED Wang records of WANG_PER
    random landmarks."""
    import numpy as np

    from ucfp_tpu_torch.core import Modality, Record

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for lo in range(0, HAITSMA_SERVED, 1024):
        n = min(1024, HAITSMA_SERVED - lo)
        words = rng.integers(0, 2**32, (n, MINBER_WORDS), dtype=np.uint64).astype("<u4")
        asyncio.run(backend.upsert([
            Record(0, 10**5 + lo + i, Modality.AUDIO, "audiofp-haitsma-v1",
                   words[i].tobytes()) for i in range(n)]))
    t1 = time.perf_counter()
    for lo in range(0, WANG_SERVED, 1000):
        recs = []
        for rid in range(lo + 1, min(lo + 1000, WANG_SERVED) + 1):
            h = rng.integers(0, 1 << 30, size=WANG_PER, dtype=np.uint32)
            t = np.sort(rng.integers(0, 2000, size=WANG_PER)).astype(np.uint32)
            recs.append(Record(0, rid, Modality.AUDIO, "audiofp-wang-v1",
                               np.stack([h, t], axis=1).astype("<u4").tobytes()))
        asyncio.run(backend.upsert(recs))
    return {"haitsma_s": t1 - t0, "wang_s": time.perf_counter() - t1}


def phase_audio(torch, dev, card: dict) -> dict:
    """Phase 13: (a) the min-BER kernel against its plain version, (b) the
    ops on the card against the CPU and the audio digests, (c) an
    EmbeddedBackend on the card served over loopback HTTP: batch and single
    ingest of every classical algorithm, the watermark report, queries by
    fingerprint_hex (each excerpt finds its clip at rank 1) and
    fingerprints_hex x 8 for Haitsma, a Haitsma upsert a query then finds,
    and a delete. Every answer equals the plain path's, and min-BER and the
    selection (the peak picker's) launch."""
    import numpy as np

    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.modality import audio as amod
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    t_phase = time.perf_counter()
    out = _audio_kernel(torch, dev, card)
    out.update(_audio_ops(torch, dev))
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-audio-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev)
    server = None
    # 64 x 30 s of s16 is 30.7 MB a request; the plain checks between two
    # requests may outlast the default 30 s keep-alive
    env = {"UCFP_BODY_LIMIT_MB": "64", "UCFP_READ_TIMEOUT_SECS": "900"}
    saved = {name: os.environ.get(name) for name in env}
    try:
        load = _audio_load(backend, seed=13)
        token = "smoke-token"
        os.environ.update(env)
        server = _ServerThread(ServerState(index=backend, api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)
        clips = [_audio_clip(i) for i in range(AUDIO_BATCH + 2)]
        base = {"wang": 1_000_000, "panako": 2_000_000, "haitsma": 3_000_000}
        k = 5
        fns = {"wang": amod.fingerprint_wang, "panako": amod.fingerprint_panako,
               "haitsma": amod.fingerprint_haitsma}

        def excerpt(i, start, secs=AUDIO_QUERY_S):
            """secs of clip i from sample 512 * start: whole frames at 8 kHz
            (hop 256) and at 5 kHz (hop 64, 320 samples)"""
            lo = 512 * start
            return clips[i][lo:lo + int(secs * 8000)].astype(np.float32) / 32768.0

        def plain_haitsma(fp):
            """knn_haitsma's answer with min-BER swapped for its plain twin,
            on the backend's own device tensors"""
            with _plain_quant_path(torch):
                return [(h.record_id, h.score)
                        for h in asyncio.run(backend.knn_haitsma(0, fp, k))]

        # the queries' fingerprints, on the card and on the CPU, before the
        # main path's counts start: they are the client's work, not the
        # server's
        fp_one = {}
        for j, algo in enumerate(AUDIO_ALGOS):
            x = excerpt(3 + 5 * j, 170 + 9 * j)
            fp_one[algo] = fns[algo](x, 8000, 0, 0, device=dev).fingerprint
            check(fp_one[algo] == fns[algo](x, 8000, 0, 0, device="cpu").fingerprint,
                  f"{algo} query fingerprint on the card == on the CPU")
        fps = [amod.fingerprint_haitsma(excerpt(i, 30 + 40 * i), 8000, 0, 0,
                                        device=dev).fingerprint for i in range(8)]
        q_new = amod.fingerprint_haitsma(excerpt(AUDIO_BATCH + 1, 160), 8000, 0, 0,
                                         device=dev).fingerprint

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        ingest_ms, single = {}, {}
        for algo in AUDIO_ALGOS:
            body = b"".join(struct.pack("<QI", base[algo] + i, len(c.tobytes())) + c.tobytes()
                            for i, c in enumerate(clips[:AUDIO_BATCH]))
            st, res, ms = call("POST", "/v1/ingest/audio/batch/0", body,
                               f"sample_rate=8000&encoding=s16&algorithm={algo}")
            check(st == 201 and res["count"] == AUDIO_BATCH, f"{algo} batch ingest: {st}")
            ingest_ms[algo] = ms
            for i in (0, AUDIO_BATCH - 1):
                want = amod.fingerprint_audio_batch(algo, [clips[i]], 8000, 0, [0],
                                                    device="cpu")[0].fingerprint
                check(res["records"][i]["fingerprint_hex"] == want.hex(),
                      f"{algo} batch clip {i} == the CPU's fingerprint")
            # one single-clip request per algorithm (f32 body)
            x = clips[AUDIO_BATCH].astype(np.float32) / 32768.0
            rid = base[algo] + AUDIO_BATCH
            st, res, ms = call("POST", f"/v1/ingest/audio/0/{rid}", x.astype("<f4").tobytes(),
                               f"sample_rate=8000&algorithm={algo}")
            check(st == 201 and res["fingerprint_hex"] == fns[algo](
                x, 8000, 0, rid, device="cpu").fingerprint.hex(),
                f"{algo} single ingest == the CPU's fingerprint")
            single[algo] = ms
        wcfg = amod.WatermarkConfig(key="smoke-key")
        marked = amod.embed_watermark(_fixed_audio(5.0), 8000, 0xBEEF, wcfg)
        st, res, _ = call("POST", "/v1/ingest/audio/0/5000000", marked.astype("<f4").tobytes(),
                          "sample_rate=8000&algorithm=watermark&watermark_key=smoke-key")
        check(st == 200 and res["detected"] and res["payload"] == 0xBEEF,
              f"watermark report: {st} {res}")
        ingest_launches = read_counts()
        check(ingest_launches["select_topk"] > 0,
              f"the served ingest ran the peak picker's selection: {ingest_launches}")

        lat = {}

        def query(form, body, reps=AUDIO_REPS):
            times, res = [], None
            for _ in range(reps + 1):  # the first call uploads / warms
                st, res, ms = call("POST", "/v1/query", body)
                check(st == 200, f"{form}: {st} {res}")
                times.append(ms)
            lat[form] = statistics.median(times[1:])
            return res

        for j, algo in enumerate(AUDIO_ALGOS):
            i, fp = 3 + 5 * j, fp_one[algo]
            res = query(f"fingerprint_hex_{algo}", {
                "tenant_id": 0, "modality": "audio", "k": k, "algorithm": algo,
                "fingerprint_hex": fp.hex()})
            check(res["hits"][0]["record_id"] == base[algo] + i,
                  f"{algo}: the excerpt's clip at rank 1: {res['hits'][:2]}")
            want = (plain_haitsma(fp) if algo == "haitsma" else
                    [(h.record_id, h.score) for h in asyncio.run(backend.knn_audio(
                        0, amod.ALGORITHM_WANG if algo == "wang" else amod.ALGORITHM_PANAKO,
                        fp, k))])
            check(_hit_rows(res["hits"]) == want, f"{algo} hits == plain path")
        res = query("fingerprints_hex_haitsma", {
            "tenant_id": 0, "modality": "audio", "k": k, "algorithm": "haitsma",
            "fingerprints_hex": [f.hex() for f in fps]})
        check([r["hits"][0]["record_id"] for r in res["results"]]
              == [base["haitsma"] + i for i in range(8)], "8 Haitsma excerpts at rank 1")
        check([_hit_rows(r["hits"]) for r in res["results"]]
              == [plain_haitsma(f) for f in fps],
              "fingerprints_hex hits == plain path")
        # a Haitsma upsert a query then finds (the stream matrix re-uploads),
        # and a delete
        new = clips[AUDIO_BATCH + 1]
        st, _, _ = call("POST", "/v1/ingest/audio/0/4000000",
                        (new.astype(np.float32) / 32768.0).astype("<f4").tobytes(),
                        "sample_rate=8000&algorithm=haitsma")
        check(st == 201, "haitsma upsert")
        body = {"tenant_id": 0, "modality": "audio", "k": k, "algorithm": "haitsma",
                "fingerprint_hex": q_new.hex()}
        st, res, _ = call("POST", "/v1/query", body)
        check(st == 200 and res["hits"][0]["record_id"] == 4000000, "upserted clip at rank 1")
        check(_hit_rows(res["hits"]) == plain_haitsma(q_new),
              "after the upsert: hits == plain path")
        st, _, _ = call("DELETE", "/v1/records/0/4000000")
        check(st == 200, "delete")
        st, res, _ = call("POST", "/v1/query", body)
        check(st == 200 and all(h["record_id"] != 4000000 for h in res["hits"]),
              "deleted clip no longer returned")
        check(_hit_rows(res["hits"]) == plain_haitsma(q_new),
              "after the delete: hits == plain path")
        launches = read_counts()
        # ---- end of the main path
        check(launches["min_ber_batch"] > 0, f"min-BER launched: {launches}")
        cache = backend._haitsma[0]
        out.update({
            "rows": {"haitsma": cache.n, "haitsma_capacity": list(cache.data.shape),
                     "wang_postings": len(backend._audio[(0, amod.ALGORITHM_WANG)])},
            "load_s": load,
            "p50_ms": lat,
            "batch_ingest_clips_per_s": {a: AUDIO_BATCH / (ms / 1e3)
                                         for a, ms in ingest_ms.items()},
            "single_ingest_ms": single,
            "launches": launches,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": time.perf_counter() - t_phase,
        })
        say("audio: " + json.dumps(out))
        return out
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        _close_backend(torch, server, backend, tmp)


# -- phase 14: text and hybrid search ---------------------------------------------

TEXT_DOCS = 1 << 14
TEXT_DOC_BYTES = 5734  # the reference bench's document (bench.py:1765-1782)
TEXT_VOCAB = 50_000
TEXT_ZIPF = 1.1
TEXT_BATCH = 128  # documents a batch request
TEXT_SIDE = 1 << 12  # LSH and TLSH documents
TEXT_SEMANTIC = 256  # documents ingested one by one as semantic records
TEXT_BULK = (1 << 18) - 1024  # columnar rows of each of MinHash, SimHash, semantic
TEXT_DIM = 384
TEXT_REPS = 20
TEXT_INGEST_REPS = 10
TEXT_BASE = {"minhash": 10**7, "simhash-tf": 2 * 10**7, "lsh": 3 * 10**7,
             "tlsh": 4 * 10**7, "semantic": 5 * 10**7}
TEXT_ALGOS = {"minhash": "minhash-h128", "simhash-tf": "simhash-b64-tf",
              "lsh": "minhash-lsh-h128", "tlsh": "tlsh-128-1",
              "semantic": "embedding-local"}

# the conformance corpus's text inputs (tests/test_conformance.py)
PANGRAM = "the quick brown fox jumps over the lazy dog"
LONG_TEXT = (
    "Pack my box with five dozen liquor jugs. How vexingly quick daft "
    "zebras jump! The five boxing wizards jump quickly. Sphinx of black "
    "quartz, judge my vow. " * 3
)
UNICODE_TEXT = "Ｈｅｌｌｏ Ｗorld — Grüße aus München! Καλημέρα κόσμε 你好"


def _text_corpus(t) -> dict:
    """text/* golden key -> the record the port's text modality builds."""
    o = t.TextOpts
    return {
        "text/minhash/pangram": lambda: t.fingerprint_minhash(PANGRAM, 0, 1),
        "text/minhash/long": lambda: t.fingerprint_minhash(LONG_TEXT, 0, 1),
        "text/minhash/unicode": lambda: t.fingerprint_minhash(UNICODE_TEXT, 0, 1),
        "text/minhash/h64-k3": lambda: t.fingerprint_minhash(LONG_TEXT, 0, 1, o(h=64, k=3)),
        "text/minhash/grapheme": lambda: t.fingerprint_minhash(
            PANGRAM, 0, 1, o(tokenizer="grapheme")),
        "text/simhash-tf/long": lambda: t.fingerprint_simhash(LONG_TEXT, 0, 1),
        "text/simhash-idf/long": lambda: t.fingerprint_simhash(
            LONG_TEXT, 0, 1, idf={"quick": 2.0, "jump": 3.0}),
        "text/tlsh/long": lambda: t.fingerprint_tlsh(LONG_TEXT, 0, 1),
        "text/lsh/pangram": lambda: t.fingerprint_lsh(PANGRAM, 0, 1),
        "text/semantic/long": lambda: t.fingerprint_semantic(LONG_TEXT, 0, 1),
        "text/minhash/nfc-nofold": lambda: t.fingerprint_minhash(
            UNICODE_TEXT, 0, 1, o(normalization="nfc", case_fold=False)),
        "text/minhash/confusables": lambda: t.fingerprint_minhash(
            "сар fits like a cap", 0, 1, o(apply_confusable=True)),
        "text/minhash/cjk": lambda: t.fingerprint_minhash(
            "北京大学的计算机科学课程非常好", 0, 1, o(tokenizer="cjk", k=3)),
        "text/minhash/char-tok": lambda: t.fingerprint_minhash(
            PANGRAM, 0, 1, o(tokenizer="char")),
        "text/tlsh/pangram-x4": lambda: t.fingerprint_tlsh(PANGRAM * 4, 0, 1),
        "text/minhash/uax29": lambda: t.fingerprint_minhash(
            "don't e-mail rock 'n' roll 1,234.56 items can't-do "
            "naïve café-au-lait O'Brien's 3.14159", 0, 1, o(k=2)),
        "text/minhash/grapheme-emoji": lambda: t.fingerprint_minhash(
            "family \U0001F468‍\U0001F469‍\U0001F467 flag "
            "\U0001F1FA\U0001F1F8 thumbs \U0001F44D\U0001F3FD done",
            0, 1, o(tokenizer="grapheme", k=3)),
        "text/minhash/html-preprocess": lambda: t.fingerprint_minhash(
            f"<html><body><p>{LONG_TEXT}</p></body></html>", 0, 1,
            o(preprocess="html")),
    }


def _cos(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def _text_conformance(dev) -> dict:
    """14(a): the 18 text/* digests through the port on this host (the
    native text code built here with g++, and the Python path), and the
    semantic image and neural audio embeddings on the card against the
    port on the CPU."""
    import numpy as np
    import xxhash

    from ucfp_tpu_torch.modality import audio as amod
    from ucfp_tpu_torch.modality import image as imod
    from ucfp_tpu_torch.modality import text as tmod
    from ucfp_tpu_torch.models import encoders
    from ucfp_tpu_torch.native import load_bm25, load_textsig
    from ucfp_tpu_torch.ops import textsig

    t0 = time.perf_counter()
    check(load_textsig() is not None, "native textsig.cpp built with g++ on this host")
    check(load_bm25() is not None, "native bm25.cpp built with g++ on this host")
    golden = json.loads(open(os.path.join(HERE, "tests", "goldens",
                                          "conformance.json")).read())
    corpus = _text_corpus(tmod)
    check(set(corpus) == {k for k in golden if k.startswith("text/")},
          "every text golden covered")
    bad = [k for k, fn in corpus.items()
           if xxhash.xxh3_64_hexdigest(fn().fingerprint) != golden[k]]
    native = textsig._native_textsig
    textsig._native_textsig = lambda: None
    try:
        bad += [k + " (python path)" for k, fn in corpus.items()
                if xxhash.xxh3_64_hexdigest(fn().fingerprint) != golden[k]]
    finally:
        textsig._native_textsig = native
    check(not bad, f"text digests on this host: {bad}")
    t_digests = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoders.image_params(), encoders.audio_params()  # numpy regeneration
    t_weights = time.perf_counter() - t0
    png = _fixed_png(10, 64, 64)
    a = imod.fingerprint_semantic(png, 0, 1, device=dev)
    b = imod.fingerprint_semantic(png, 0, 1, device="cpu")
    cos_image = _cos(a.embedding, b.embedding)
    x = _fixed_audio()
    a = amod.fingerprint_neural(x, 8000, 0, 1, device=dev)
    b = amod.fingerprint_neural(x, 8000, 0, 1, device="cpu")
    ea = np.frombuffer(a.fingerprint, "<f4").reshape(-1, 128)
    eb = np.frombuffer(b.fingerprint, "<f4").reshape(-1, 128)
    check(ea.shape == eb.shape, "neural windows on the card == on the CPU")
    cos_neural = min(_cos(u, v) for u, v in zip(ea, eb))
    check(min(cos_image, cos_neural) >= 0.999999,
          f"embeddings on the card vs the CPU: image {cos_image}, neural {cos_neural}")
    return {"digests": len(corpus), "digest_paths": ["native", "python"],
            "digests_s": t_digests, "weights_s": t_weights,
            "cos_image_semantic_64x64": cos_image, "cos_audio_neural_8k_worst": cos_neural}


def _text_docs(seed: int, n_docs: int):
    """n_docs documents of TEXT_DOC_BYTES bytes over a vocabulary of
    TEXT_VOCAB random lowercase words: every other word is drawn from one
    Zipf law shared by the corpus (terms common to every document), the
    others from the same law over the vocabulary rotated by an offset of
    the document's own (its topic), so BM25 has frequent and rare terms
    to rank and the documents' SimHashes differ."""
    import operator

    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    lens = rng.integers(3, 11, TEXT_VOCAB)
    chars = rng.choice(letters, int(lens.sum()))
    ends = np.cumsum(lens)
    vocab = [chars[e - n:e].tobytes().decode() for e, n in zip(ends, lens)]
    words = TEXT_DOC_BYTES // 10
    shared = np.minimum(rng.zipf(TEXT_ZIPF, (n_docs, words)) - 1, TEXT_VOCAB - 1)
    own = np.minimum(rng.zipf(TEXT_ZIPF, (n_docs, words)) - 1, TEXT_VOCAB - 1)
    own = (own + rng.integers(0, TEXT_VOCAB, (n_docs, 1))) % TEXT_VOCAB
    idx = np.stack([shared, own], axis=2).reshape(n_docs, 2 * words)
    docs = [" ".join(operator.itemgetter(*row)(vocab))[:TEXT_DOC_BYTES] for row in idx]
    return vocab, docs


def _text_terms(vocab) -> list:
    """The served terms query: a frequent, a middling and a rarer word."""
    return [vocab[3], vocab[40], vocab[700]]


def _bm25_pair_worker(seed: int, n_docs: int, out) -> None:
    """The native BM25 engine against the Python one over the phase's
    documents (the same corpus in both), search and explain bit-equal, in
    a process of its own: both engines are single-threaded host code, so
    it overlaps the served part of phase 14. Puts {"bad": [...], "s": t}
    or {"error": ...} on `out`."""
    try:
        from ucfp_tpu_torch.index.bm25 import Bm25Engine, NativeBm25Engine
        from ucfp_tpu_torch.native import load_bm25

        t0 = time.perf_counter()
        vocab, docs = _text_docs(seed, n_docs)
        native, python = NativeBm25Engine(load_bm25()), Bm25Engine()
        for i, d in enumerate(docs):
            native.upsert_one(0, i, d)
            python.upsert_one(0, i, d)
        bad = []
        for q in (_text_terms(vocab), [vocab[0]], [vocab[1], vocab[2]], vocab[100:106],
                  [vocab[4000], vocab[40000]], ["zzzzzzzz"]):
            if native.search(0, q, 10) != python.search(0, q, 10):
                bad.append(("search", q))
            a, b = native.search_explain(0, q, 10), python.search_explain(0, q, 10)
            if ([(d, s, [(t.term, t.idf, t.tf, t.contribution) for t in th])
                 for d, s, th in a]
                    != [(d, s, [(t.term, t.idf, t.tf, t.contribution) for t in th])
                        for d, s, th in b]):
                bad.append(("explain", q))
        out.put({"bad": bad, "docs": len(docs), "s": time.perf_counter() - t0})
    except Exception as e:  # noqa: BLE001 - reported to the parent, which fails
        out.put({"error": repr(e)})


def _bulk_text(torch, backend, dev, seed: int) -> dict:
    """TEXT_BULK MinHash rows (the 1,032-byte layout: schema 1, 128 random
    u64 slots), TEXT_BULK random SimHash rows and TEXT_BULK random 384-d
    semantic rows under the stand-in text model, through the columnar
    batch upserts; data made on the card from `seed`."""
    import numpy as np

    from ucfp_tpu_torch.core import Modality
    from ucfp_tpu_torch.models import TEXT_MODEL_ID

    g = torch.Generator(device=dev).manual_seed(seed)
    chunk = 1 << 15
    head = np.zeros(8, np.uint8)
    head[0] = 1
    t0 = time.perf_counter()
    for lo in range(0, TEXT_BULK, chunk):
        m = min(chunk, TEXT_BULK - lo)
        raw = torch.randint(0, 256, (m, 1024), generator=g, device=dev,
                            dtype=torch.uint8).cpu().numpy()
        fps = [head.tobytes() + r.tobytes() for r in raw]
        asyncio.run(backend.upsert_fingerprint_batch(
            0, TEXT_ALGOS["minhash"], list(range(10**9 + lo, 10**9 + lo + m)), fps,
            modality=Modality.TEXT))
        raw = torch.randint(0, 256, (m, 8), generator=g, device=dev,
                            dtype=torch.uint8).cpu().numpy()
        asyncio.run(backend.upsert_fingerprint_batch(
            0, TEXT_ALGOS["simhash-tf"], list(range(2 * 10**9 + lo, 2 * 10**9 + lo + m)),
            [r.tobytes() for r in raw], modality=Modality.TEXT))
        mat = torch.randn((m, TEXT_DIM), generator=g, device=dev)
        mat = (mat / mat.norm(dim=1, keepdim=True)).cpu().numpy()
        asyncio.run(backend.upsert_embedding_batch(
            0, TEXT_ALGOS["semantic"], list(range(3 * 10**9 + lo, 3 * 10**9 + lo + m)),
            mat, modality=Modality.TEXT, model_id=TEXT_MODEL_ID))
    return {"bulk_s": time.perf_counter() - t0}


def _plain_exact_hamming(torch, backend, algorithm: str, fp: bytes, k: int):
    """The exact Hamming answer for a wide fingerprint, on the backend's
    own device tensors, another way: bytes XOR and a popcount table, a
    stable sort (ties to the lower row), then (distance, record id)."""
    import numpy as np

    cache = backend._ham[(0, algorithm)]
    matrix, valid = cache.device
    words = np.zeros(cache.width * 4, np.uint8)
    words[:len(fp)] = np.frombuffer(fp, np.uint8)
    q = torch.from_numpy(words).to(matrix.device)
    lut = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32,
                       device=matrix.device)
    m8 = matrix.contiguous().view(torch.uint8)
    dist = torch.cat([lut[torch.bitwise_xor(m8[lo:lo + 65536], q[None, :]).long()]
                      .sum(dim=1) for lo in range(0, m8.shape[0], 65536)])
    dist = torch.where(valid, dist, torch.full_like(dist, 2**31 - 1))
    order = torch.sort(dist, stable=True).indices[:min(k, cache.n)].cpu().numpy()
    d = dist.cpu().numpy()
    rows = sorted(((cache.rids[int(i)], int(d[i])) for i in order if d[i] < 2**30),
                  key=lambda t: (t[1], t[0]))
    bits = cache.width * 32
    return [(rid, 1.0 - dd / bits) for rid, dd in rows]


def _self_first(hits, rid) -> bool:
    """rid is among the best-scored hits (a tie at the top may order
    another record with the same score first)."""
    return bool(hits) and any(h["record_id"] == rid for h in hits
                              if h["score"] == hits[0]["score"])


def phase_text(torch, dev) -> dict:
    """Phase 14: (a) the text digests on this host and the float encoders
    on the card against the CPU; (b) a text store on the card served over
    loopback HTTP: batch ingest of MinHash, SimHash, LSH and TLSH
    documents, semantic text ingest, BM25 terms queries (with explain),
    the hybrid, vectors x32, fingerprint queries of each family, and the
    semantic image and neural audio routes. Every answer is checked
    against the plain path, its legs, or the record's own fingerprint."""
    import numpy as np

    import multiprocessing

    from ucfp_tpu_torch.core import HitSource
    from ucfp_tpu_torch.index.embedded import EmbeddedBackend
    from ucfp_tpu_torch.matcher.rrf import rrf_with_sources
    from ucfp_tpu_torch.server.app import ServerState
    from ucfp_tpu_torch.server.auth import StaticSingleKey

    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    pair_out = ctx.Queue()
    pair = ctx.Process(target=_bm25_pair_worker, args=(14, TEXT_DOCS, pair_out),
                       daemon=True)
    pair.start()
    out = _text_conformance(dev)
    t0 = time.perf_counter()
    vocab, docs = _text_docs(14, TEXT_DOCS)
    out["docs_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="ucfp-smoke-text-")
    backend = EmbeddedBackend(os.path.join(tmp, "db"), device=dev)
    server = None
    env = {"UCFP_READ_TIMEOUT_SECS": "900"}
    saved = {name: os.environ.get(name) for name in env}
    k = 10
    try:
        out.update(_bulk_text(torch, backend, dev, seed=15))
        token = "smoke-token"
        os.environ.update(env)
        server = _ServerThread(ServerState(index=backend, api_keys=StaticSingleKey(token)))
        call = _Client(server.port, token)

        # ---- the main path: launch counts are read over exactly this block
        reset_counts()
        ingest = {}
        for algo, n in (("minhash", TEXT_DOCS), ("simhash-tf", TEXT_DOCS),
                        ("lsh", TEXT_SIDE), ("tlsh", TEXT_SIDE)):
            t0, times = time.perf_counter(), []
            for lo in range(0, n, TEXT_BATCH):
                body = "\n".join(json.dumps({"record_id": TEXT_BASE[algo] + i,
                                             "text": docs[i]})
                                 for i in range(lo, lo + TEXT_BATCH)).encode()
                st, res, ms = call("POST", "/v1/ingest/text/batch/0", body,
                                   f"algorithm={algo}&quiet=1")
                check(st == 201 and res["count"] == TEXT_BATCH and "errors" not in res,
                      f"{algo} batch ingest: {st} {res}")
                times.append(ms)
            ingest[algo] = {"docs_per_s": n / (time.perf_counter() - t0),
                            "p50_ms_per_request": statistics.median(times)}
        sem_ms = []
        for i in range(TEXT_SEMANTIC):
            st, res, ms = call("POST", f"/v1/ingest/text/0/{TEXT_BASE['semantic'] + i}",
                               docs[i].encode(), "algorithm=semantic")
            check(st == 201 and res["has_embedding"], f"semantic text ingest: {st}")
            sem_ms.append(ms)
        ingest["semantic_p50_ms"] = statistics.median(sem_ms)

        lat = {}

        def timed(form, body, query="", reps=TEXT_REPS):
            res = None
            times = []
            for _ in range(reps + 1):  # the first call uploads / warms
                st, res, ms = call("POST", "/v1/query", body, query)
                check(st == 200, f"{form}: {st} {res}")
                times.append(ms)
            lat[form] = statistics.median(times[1:])
            return res

        base = {"tenant_id": 0, "modality": "text", "k": k}
        terms = _text_terms(vocab)
        res_terms = timed("terms", {**base, "terms": terms})
        check(len(res_terms["hits"]) == k and all(h["source"] == "bm25"
                                                 for h in res_terms["hits"]),
              f"terms: {res_terms['hits'][:2]}")
        res_explain = timed("terms_explain", {**base, "terms": terms}, "explain=1")
        check([h["record_id"] for h in res_explain["hits"]]
              == [h["record_id"] for h in res_terms["hits"]]
              and all(h.get("term_hits") for h in res_explain["hits"]),
              "explain: the same hits, each with its term breakdown")
        sem = [backend.get_record(0, TEXT_BASE["semantic"] + i)["embedding"]
               for i in range(32)]
        vec = [float(v) for v in sem[7]]
        res_hybrid = timed("hybrid", {**base, "terms": terms, "vector": vec})
        res_vector = timed("vector", {**base, "vector": vec})
        check(res_vector["hits"][0]["record_id"] == TEXT_BASE["semantic"] + 7,
              "semantic vector of a document: its own record at rank 1")
        res_vectors = timed("vectors", {**base, "vectors": [[float(v) for v in e]
                                                            for e in sem]})
        check([r["hits"][0]["record_id"] for r in res_vectors["results"]]
              == [TEXT_BASE["semantic"] + i for i in range(32)],
              "32 semantic vectors find their own records at rank 1")
        fp = {algo: backend.get_record(0, TEXT_BASE[algo] + 11)["fingerprint"]
              for algo in ("minhash", "simhash-tf", "lsh", "tlsh")}
        res_fp = {}
        for algo in ("minhash", "simhash-tf", "lsh", "tlsh"):
            res_fp[algo] = timed(f"fingerprint_hex_{algo}", {
                **base, "algorithm": algo, "fingerprint_hex": fp[algo].hex()})
            check(_self_first(res_fp[algo]["hits"], TEXT_BASE[algo] + 11)
                  and res_fp[algo]["hits"][0]["score"] == 1.0,
                  f"{algo}: the document's own fingerprint at rank 1: "
                  f"{res_fp[algo]['hits'][:2]}")
        sim_hexes = [backend.get_record(0, TEXT_BASE["simhash-tf"] + (TEXT_DOCS // 32) * i)
                     ["fingerprint"].hex() for i in range(32)]
        res_sims = timed("fingerprints_hex_simhash", {
            **base, "algorithm": "simhash-tf", "fingerprints_hex": sim_hexes})
        for i, r in enumerate(res_sims["results"]):
            check(_self_first(r["hits"], TEXT_BASE["simhash-tf"] + (TEXT_DOCS // 32) * i),
                  f"SimHash batch query {i}: its own record at rank 1")
        # the semantic image route and the neural audio route
        png = _fixed_png(10, 256, 256)
        clip = (_audio_clip(1, 10.0).astype(np.float32) / 32768.0).astype("<f4").tobytes()
        for form, path, body, query in (
                ("ingest_image_semantic", "/v1/ingest/image/0/{}/semantic", png, ""),
                ("ingest_audio_neural", "/v1/ingest/audio/0/{}", clip,
                 "algorithm=neural&sample_rate=8000")):
            times = []
            for rep in range(TEXT_INGEST_REPS + 1):
                st, res, ms = call("POST", path.format(6 * 10**7 + rep), body, query)
                check(st == 201 and res["has_embedding"], f"{form}: {st} {res}")
                times.append(ms)
            ingest[f"{form}_p50_ms"] = statistics.median(times[1:])
        launches = read_counts()
        # ---- end of the main path
        check(all(launches[name] > 0 for name in ("scores_topk_fused_batched",
                                                   "hamming_topk_fused_batched",
                                                   "select_topk")),
              f"every kernel of the text path launched: {launches}")

        # the served answers against the plain path and the legs
        t0 = time.perf_counter()
        svecs = [np.asarray(e, np.float32) for e in sem]
        check(_hit_rows(res_vector["hits"])
              == _plain_cosine_hits(torch, backend, svecs[7:8], k)[0],
              "vector hits == plain path")
        check([_hit_rows(r["hits"]) for r in res_vectors["results"]]
              == _plain_cosine_hits(torch, backend, svecs, k), "vectors hits == plain path")
        check(_hit_rows(res_fp["simhash-tf"]["hits"]) == _plain_hamming_hits(
            torch, backend, [fp["simhash-tf"].hex()], k, TEXT_ALGOS["simhash-tf"])[0],
            "SimHash hits == plain path")
        check([_hit_rows(r["hits"]) for r in res_sims["results"]]
              == _plain_hamming_hits(torch, backend, sim_hexes, k,
                                     TEXT_ALGOS["simhash-tf"]),
              "SimHash batch hits == plain path")
        for algo in ("minhash", "tlsh"):
            check(_hit_rows(res_fp[algo]["hits"]) == _plain_exact_hamming(
                torch, backend, TEXT_ALGOS[algo], fp[algo], k),
                f"{algo} hits == the plain exact Hamming on the device tensors")
        check(_hit_rows(res_terms["hits"])
              == [(d, s) for d, s in backend._bm25.search(0, terms, k)],
              "terms hits == the backend's BM25 engine")
        # the hybrid: RRF over the two legs computed apart
        vec_leg = asyncio.run(backend.knn(0, vec, k))
        bm_leg = asyncio.run(backend.bm25(0, terms, k))
        fused = rrf_with_sources([vec_leg, bm_leg], [HitSource.VECTOR, HitSource.BM25],
                                 60)[:k]
        check([(h["record_id"], h["score"], h["source"]) for h in res_hybrid["hits"]]
              == [(h.record_id, h.score, h.source.value) for h in fused],
              "hybrid == RRF of the vector and BM25 legs")
        got = {h["record_id"] for h in res_hybrid["hits"]}
        check(got & {h.record_id for h in vec_leg} and got & {h.record_id for h in bm_leg},
              "the hybrid holds hits of both legs")
        out["plain_checks_s"] = time.perf_counter() - t0

        # BM25: the native engine against the Python engine (the worker)
        pair_res = pair_out.get(timeout=900)
        pair.join(60)
        check(not pair.is_alive(), "BM25 pair process stopped")
        check("error" not in pair_res and not pair_res["bad"]
              and pair_res["docs"] == TEXT_DOCS,
              f"native BM25 == Python BM25 over the {TEXT_DOCS} documents: {pair_res}")
        out["bm25_pair_s"] = pair_res["s"]

        out.update({
            "rows": {a: backend._ham[(0, TEXT_ALGOS[a])].n
                     for a in ("minhash", "simhash-tf", "tlsh")},
            "vectors": backend._vec[(0, TEXT_DIM)].n,
            "bm25": backend._bm25.stats(0),
            "ingest": ingest,
            "p50_ms": lat,
            "launches": launches,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "phase_s": time.perf_counter() - t_phase,
        })
        say("text: " + json.dumps(out))
        return out
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        _close_backend(torch, server, backend, tmp)
        if pair.is_alive():
            pair.terminate()
            pair.join(60)


# -- the A/B timings -----------------------------------------------------------


def phase_ab(torch, dev) -> dict:
    """Times only, no checks: #13 at Q = 1, 2, 32 and 64 (bf16) and #4 / #5
    (the function and its cells, Q = 1 and 32) at 2^22 x 768 rows; #6 at
    2^20 x 2 and 9,994,240 x 2 words, #2 at 2^23 x 2 words (Q = 1 and 32),
    #7 at 9,994,240 x 64 (k = 10), and the selection at one query over
    39,040 and 78,080 candidates (k = 10 and 2048), these five also by the
    host's time per call (host_ms); and min-BER at the served shape (2^14
    rows x Tb 4,096, 2,311 live words, a 359-word query in Qb 512), by
    the same three times; on random inputs from a seed, through wrappers
    that every checkout since the selection kernel has
    (fs.hamming_topk_fused, fs.hamming_topk_fused_batched,
    fs.cosine_int8_topk_fused, fs._select_cuda(vals, gidx, k, largest)),
    and haitsma.min_ber_batch, which checkouts since the audio path have. A
    parent's checkout runs the same code when this file is copied into it:
    `python3 chip_smoke.py --phases device,build,ab` in each tree, in
    turns, in one call."""
    from ucfp_tpu_torch.ops import fused_scan as fs
    from ucfp_tpu_torch.ops import int2_scan as i2
    from ucfp_tpu_torch.ops import knn

    g = torch.Generator(device=dev).manual_seed(99)
    c, k = INT2_ROWS, 16
    out = {"c": c, "d": DIM}
    packed_t = torch.randint(-128, 128, (DIM // 4, c), generator=g, device=dev,
                             dtype=torch.int8)
    inv_n2 = torch.rand(c, generator=g, device=dev)
    *quarters, corrs = knn._int2_query_parts(
        torch.randint(-127, 128, (64, DIM), generator=g, device=dev, dtype=torch.int8))
    for q in (1, 2, 32, 64):
        args = (packed_t, *[w[:q] for w in quarters], corrs[:q], inv_n2, c)

        def scan():
            return i2.int2_masked_scores_batched(*args, out_dtype=torch.bfloat16)

        out[f"int2_masked_scores_batched_q{q}"] = {"ms": time_ms(torch, scan),
                                                   "device_ms": device_ms(torch, scan)}
    del packed_t
    dot_max = 127 * 127 * DIM
    rn = torch.randint(1, dot_max, (c,), generator=g, device=dev).float().sqrt()
    for q, name in ((1, "dots_norm_topk_fused"), (32, "dots_norm_topk_fused_batched")):
        dots = torch.randint(-dot_max, dot_max + 1, (q, c), generator=g, device=dev,
                             dtype=torch.int32)
        inv_q = 1.0 / torch.randint(1, dot_max, (q,), generator=g, device=dev).float().sqrt()

        def cells():
            return fs._dots_norm_cells_cuda(dots, rn, c, inv_q, name)

        def whole():
            if q == 1:
                return fs.dots_norm_topk_fused(dots[0], rn, c, inv_q[0], k)
            return fs.dots_norm_topk_fused_batched(dots, rn, c, inv_q, k)

        out[f"{name}_q{q}"] = {"ms": time_ms(torch, whole), "device_ms": device_ms(torch, whole),
                               "cells_ms": time_ms(torch, cells),
                               "cells_device_ms": device_ms(torch, cells)}
        del dots
    del rn
    torch.cuda.empty_cache()

    def timed(fn):
        return {"ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
                "host_ms": host_ms(torch, fn)}

    # #6 at a shard of the sharded pHash path and at the bench's 10M x 64-bit
    for rows in (1 << 20, BENCH_X64_ROWS):
        db = torch.randint(-2**31, 2**31, (rows, 2), generator=g, device=dev,
                           dtype=torch.int32)
        q = db[7] ^ 1
        out[f"hamming_topk_fused_c{rows}_w2"] = timed(lambda: fs.hamming_topk_fused(q, db, 10))
        del db
    # #2 at the served pHash shape, one query and a batch of 32 (a tenth of
    # the rows invalid)
    db = torch.randint(-2**31, 2**31, (PHASH_ROWS, 2), generator=g, device=dev,
                       dtype=torch.int32)
    valid = torch.rand(PHASH_ROWS, generator=g, device=dev) < 0.9
    for q in (1, 32):
        qs = db[:q] ^ 1
        out[f"hamming_topk_fused_batched_c{PHASH_ROWS}_w2_q{q}"] = timed(
            lambda: fs.hamming_topk_fused_batched(qs, db, valid, 10))
    del db, valid
    # #7 at the bench's 10M x 64
    db8 = torch.randint(-128, 128, (BENCH_X64_ROWS, 64), generator=g, device=dev,
                        dtype=torch.int8)
    rn8 = torch.rand(BENCH_X64_ROWS, generator=g, device=dev) * 1000 + 1
    q8 = db8[7].clone()
    out[f"cosine_int8_topk_fused_c{BENCH_X64_ROWS}_d64"] = timed(
        lambda: fs.cosine_int8_topk_fused(q8, db8, rn8, 10))
    del db8, rn8
    torch.cuda.empty_cache()
    # the selection at one query over #6's and #7's candidate counts
    for n in (39040, 78080):
        vals = torch.randn((1, n), generator=g, device=dev)
        gidx = torch.randint(0, 1 << 30, (1, n), generator=g, device=dev, dtype=torch.int32)
        for kk in (10, 2048):
            out[f"select_topk_n{n}_k{kk}"] = timed(
                lambda: fs._select_cuda(vals, gidx, kk, True))
    del vals, gidx
    # min-BER at the served shape (phase 13(a)'s rows, all 2,311 words live)
    from ucfp_tpu_torch.ops.audio import haitsma

    lens = torch.full((MINBER_ROWS,), MINBER_WORDS, dtype=torch.int32)
    db, lens_d, q_pad = _minber_case(torch, dev, g, MINBER_ROWS, MINBER_TB, lens, MINBER_Q,
                                     MINBER_QB)
    out[f"min_ber_batch_r{MINBER_ROWS}_tb{MINBER_TB}_q{MINBER_Q}"] = timed(
        lambda: haitsma.min_ber_batch(db, lens_d, q_pad, MINBER_Q))
    say("ab: " + json.dumps(out))
    return out


MMA_RATES_CU = r"""
// the throughput of one mma.sync shape: 8 independent accumulators a warp
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void rate(int* out, int iters) {
  uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  int c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#define UCFP_MMA(SHAPE)                                                                       \
  asm volatile("mma.sync.aligned." SHAPE " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};" \
               : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])                    \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))
      if constexpr (KIND == 0) UCFP_MMA("m16n8k32.row.col.s32.s8.u8.s32");
      else if constexpr (KIND == 1) UCFP_MMA("m16n8k64.row.col.s32.s4.u4.s32");
      else UCFP_MMA("m16n8k256.row.col.s32.b1.b1.s32.and.popc");
    }
  }
  int s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int KIND>
float run(int sms, int* out, int iters) {
  rate<KIND><<<2 * sms, 256>>>(out, iters);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<KIND><<<2 * sms, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
int main() {
  int sms = 0, *out = nullptr;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaMalloc(&out, 2 * sms * 256 * sizeof(int));
  const int iters = 2000;  // 2 blocks x 8 warps x iters x 8 products per SM
  printf("%d %f %f %f\n", 2 * 8 * iters * 8, run<0>(sms, out, iters), run<1>(sms, out, iters),
         run<2>(sms, out, iters));
  return 0;
}
"""


def phase_mma_rates(card: dict) -> dict:
    """The throughput of three mma.sync shapes on this card, each warp
    keeping 8 independent accumulators (2 blocks of 8 warps per SM): s8 x
    u8 m16n8k32 (what #2's tensor-core kernel runs), s4 x u4 m16n8k64 and
    b1 AND-popcount m16n8k256 (two ways to more bits a product), as ns and
    SM clocks per product per SM. Built with nvcc into the ignored build
    directory; in no default run."""
    from ucfp_tpu_torch import _build

    d = os.path.join(_build.BUILD_DIR, "mma_rates")
    os.makedirs(d, exist_ok=True)
    src, exe = os.path.join(d, "mma_rates.cu"), os.path.join(d, "mma_rates")
    with open(src, "w") as f:
        f.write(MMA_RATES_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-o", exe, src], check=True,
                   capture_output=True, timeout=300)
    out = subprocess.run([exe], check=True, capture_output=True, text=True, timeout=120)
    per_sm, *ms = out.stdout.split()
    rates = {}
    for name, t in zip(("s8_u8_m16n8k32", "s4_u4_m16n8k64", "b1_and_popc_m16n8k256"), ms):
        ns = float(t) * 1e6 / int(per_sm)
        check(ns > 0, f"mma rate {name} ran")
        rates[name] = {"ns_per_mma_per_sm": ns,
                       "clocks_per_mma_per_sm": ns * card["sm_clock_hz"] / 1e9}
    say("mma_rates: " + json.dumps(rates))
    return rates


# -- main ---------------------------------------------------------------------


def _findings_line(kernels: dict, served: list) -> dict:
    """One entry per ported kernel: its launches summed over the served
    phases, and its numbers at the shape the served path gives it."""
    launches = {}
    for phase in served:
        for name, n in phase["launches"].items():
            launches[name] = launches.get(name, 0) + n

    def pick(rows, **want):
        return next(r for r in rows if all(r[key] == v for key, v in want.items()))

    scan, int4, int2, knn = "pallas_scan.py", "pallas_int4.py", "pallas_int2.py", "knn.py"
    source = {scan: "fused_scan.cu", int4: "int4_scan.cu", int2: "int2_scan.cu",
              knn: "sketch_scan.cu"}
    int8_src = "int8_scan.cu"  # #7 and #8, pallas_scan.py's int8-cosine scans
    src = {"cosine_i8": int8_src, "cosine_i8_mxu": int8_src, "select": "select.cu"}
    rows = (
        ("scores_topk_fused_batched", scan, 487, "scores",
         pick(kernels["scores"], q=32, dtype="float32", ties=False), {"q": 32}),
        ("hamming_topk_fused_batched", scan, 163, "hamming",
         pick(kernels["hamming"], q=32, c=PHASH_ROWS, w=2, ties=False), {"q": 32, "w": 2}),
        ("scores_topk_fused", scan, 314, "scores1",
         pick(kernels["scores1"], c=INT8_ROWS, k=2048), {"q": 1, "k": 2048}),
        ("dots_norm_topk_fused", scan, 261, "dots_norm",
         pick(kernels["dots_norm"], c=INT8_ROWS, ties=False), {"q": 1}),
        ("dots_norm_topk_fused_batched", scan, 422, "dots_norm_batched",
         pick(kernels["dots_norm_batched"], c=INT8_ROWS, q=32, ties=False), {"q": 32}),
        ("int4_masked_scores", int4, 144, "int4_scores",
         pick(kernels["int4_scores"], c=INT4_ROWS), {"q": 1, "d": DIM}),
        ("int4_masked_scores_batched", int4, 210, "int4_scores_batched",
         pick(kernels["int4_scores_batched"], c=INT4_ROWS, q=32),
         {"q": 32, "d": DIM, "dtype": "bfloat16"}),
        ("int4_dots", int4, 79, "int4_dots",
         pick(kernels["int4_dots"], c=INT4_ROWS), {"q": 1, "d": DIM}),
        ("int2_masked_scores", int2, 100, "int2_scores",
         pick(kernels["int2_scores"], c=INT2_ROWS), {"q": 1, "d": DIM}),
        ("int2_masked_scores_batched", int2, 162, "int2_scores_batched",
         pick(kernels["int2_scores_batched"], c=INT2_ROWS, q=32),
         {"q": 32, "d": DIM, "dtype": "bfloat16"}),
        ("int2_topq_scores", int2, 257, "int2_topq",
         pick(kernels["int2_topq"], c=INT2_ROWS), {"q": 1, "d": DIM}),
        ("asym_sketch_scores_tiled", knn, 366, "sketch",
         pick(kernels["sketch"], c=SKETCH_ROWS), {"q": 1, "bits": 768}),
        ("hamming_topk_fused", scan, 95, "hamming1",
         pick(kernels["hamming1"], c=SHARD_HAMMING_ROWS // SHARDS, w=2, ties=False),
         {"q": 1, "w": 2}),
        ("cosine_int8_topk_fused", scan, 604, "cosine_i8",
         pick(kernels["cosine_i8"], c=BENCH_X64_ROWS, d=64, ties=False), {"q": 1, "d": 64}),
        ("cosine_int8_topk_mxu", scan, 718, "cosine_i8_mxu",
         pick(kernels["cosine_i8_mxu"], c=BENCH_X64_ROWS, d=64, ties=False),
         {"q": 1, "d": 64, "rpt": 1024}),
        # the lax.top_k every scan runs after its pallas_call (here #3's)
        ("select_topk", scan, 309, "select",
         pick(kernels["select"], n=16384, k=2048), {"q": 1, "k": 2048}),
    )
    kernels_line = [
        {"name": name, "route": "cuda",
         "source": "ucfp_tpu_torch/csrc/" + src.get(key, source[path]),
         "replaces": f"ucfp_tpu/ops/{path}:{line}",
         "launches": launches.get(name),
         "max_abs_err": max(r["max_abs_err"] for r in kernels[key]),
         **{f: row[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         # the fused scans' two halves: cells kernel and selection
         **{f: row[f] for f in ("cells_ms", "select_ms", "device_ms", "cells_device_ms",
                                "select_device_ms", "blocks_per_sm", "bound_popc_ms",
                                "bound_mma_ms", "kernel_bytes", "path") if f in row},
         "shape": {**shape, **({"c": row["c"]} if "c" in row else {"n": row["n"]})}}
        for name, path, line, key, row, shape in rows
    ]
    # min-BER (phase 13): no Pallas kernel; it replaces min_ber_batch's
    # lax.fori_loop
    audio = next((p for p in served if "min_ber" in p), None)
    if audio is not None:
        row = next(r for r in audio["min_ber"] if r["case"] == "served")
        kernels_line.append({
            "name": "min_ber_batch", "route": "cuda", "source": "ucfp_tpu_torch/csrc/min_ber.cu",
            "replaces": "ucfp_tpu/ops/audio/haitsma.py:203",
            "launches": launches.get("min_ber_batch"),
            "max_abs_err": max(r["max_abs_err"] for r in audio["min_ber"]),
            **{f: row[f] for f in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "bound_popc_ms", "bound_mma_ms",
                                   "bound_b1_ms")},
            "shape": {"r": row["r"], "tb": row["tb"], "q_true": row["q_true"],
                      "qb": row["qb"]}})
    return {"kernels": kernels_line}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases",
                   default="device,build,kernels,conformance,served,int8,qbatch,int4,"
                           "int2,sketch,sharded,bench,audio,text")
    args = p.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ucfp_tpu_torch")):
        print("chip_smoke: run it from a checkout (ucfp_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    dev = torch.device("cuda", 0)
    card = phase_device(torch)
    if "build" in phases:
        phase_build()
    kernels = phase_kernels(torch, dev, card) if "kernels" in phases else None
    if "ab" in phases:
        phase_ab(torch, dev)
    if "mma_rates" in phases:
        phase_mma_rates(card)
    if "conformance" in phases:
        phase_conformance(dev)
    served = []
    for name, phase in (("served", phase_served), ("int8", phase_int8),
                        ("qbatch", phase_qbatch), ("int4", phase_int4),
                        ("int2", phase_int2), ("sketch", phase_sketch),
                        ("sharded", phase_sharded), ("bench", phase_bench)):
        if name in phases:
            served.append(phase(torch, dev))
    if "audio" in phases:
        served.append(phase_audio(torch, dev, card))
    if "text" in phases:
        served.append(phase_text(torch, dev))
    if kernels is not None:
        say(json.dumps(_findings_line(kernels, served)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
