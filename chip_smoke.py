#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ucfp_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
It needs one CUDA card, builds the kernels from the checkout's sources,
and exits non-zero (printing no result) when there is no card, when the
package is missing, or when any phase fails. Phases, one findings line
each:

  1. device       the card's name and power limit (nvidia-smi)
  2. build        csrc/*.cu for sm_90a, and the build time
  3. kernels      every CUDA kernel of the served path against its plain
                  PyTorch version on the card, at the served shapes and at
                  tie-heavy shapes: values and indices bit-equal. Kernel,
                  plain and library times (CUDA events, median of 25 runs)
                  and the bound for the same work
  4. conformance  the image hashes computed on the card against
                  tests/goldens/conformance.json
  5. served       the port's EmbeddedBackend on the card, bulk-loaded with
                  2^23 pHash fingerprints, 2^20 multi bundles and
                  2^20 x 768 f32 vectors, served over loopback HTTP in this
                  process: image ingest (single and batch), the five query
                  forms, describe, delete. Each served answer is checked
                  against the plain path on the same device tensors, and
                  every kernel's launch count must rise during this phase

Then one JSON line with every kernel's numbers, and last the line
{"ok": true, "device": {...}}.
"""

import argparse
import asyncio
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
RUNS = 25  # CUDA-event samples per kernel timing

# the served catalogs (phase 5) and the timed requests per query form
PHASH_ROWS = 1 << 23  # the README's 10M x 64-bit Hamming shape, cut to 2^23
MULTI_ROWS = 1 << 20
VEC_ROWS = 1 << 20
DIM = 768  # the BASELINE image-embedding width
SERVED_REPS = 20

PHASH = "imgfprint-phash-v1"
MULTI = "imgfprint-multi-v1"
SEM = "embedding-image-local"


def say(line: str) -> None:
    print(line, flush=True)


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


def bound_ms(card: dict, nbytes: float, alu_ops: float,
             popc_ops: float = 0.0) -> tuple[float, str]:
    """The larger of the bytes over the HBM rate and the operations over
    the card's issue rate; the ALU and popcount pipes issue side by side,
    so the busier of the two sets the operations' time."""
    clocks = card["sms"] * card["sm_clock_hz"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(alu_ops / (ALU_PER_CLK_SM * clocks),
                popc_ops / (POPC_PER_CLK_SM * clocks)) * 1e3
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
        vk, ik = fs.scores_topk_fused_batched(s, k)
        torch.cuda.synchronize()
        vp, ip = fs.scores_topk_fused_batched_plain(s, k)
        check(_same_bits(torch, vk, vp) and torch.equal(ik, ip),
              f"scores top-k bit-equal q={q} {dtype} ties={ties}")
        esize = s.element_size()
        nbytes = q * c * esize + q * k * (esize + 4)
        b, by = bound_ms(card, nbytes, alu_ops=q * c)  # one compare per score
        t = c // (fs.ROWS_PER_TILE * fs.LANES)
        results["scores"].append({
            "q": q, "c": c, "dtype": str(dtype).replace("torch.", ""),
            "ties": ties, "max_abs_err": _max_abs(torch, vk, vp),
            "ms": time_ms(torch, lambda: fs.scores_topk_fused_batched(s, k)),
            "cells_ms": time_ms(torch, lambda: fs._scores_cells_cuda(s, True)),
            "plain_ms": time_ms(torch, lambda: fs.scores_topk_fused_batched_plain(s, k)),
            "library_ms": time_ms(torch, lambda: torch.max(
                s.view(q, t, fs.ROWS_PER_TILE, fs.LANES), dim=2)),
            "bound_ms": b, "bound_by": by,
        })

    # kernel #2: fused XOR-popcount + per-cell argmin
    for q, c, w, ties in ((1, 1 << 23, 2, False), (32, 1 << 23, 2, False),
                          (1, 1 << 20, 16, False), (32, 1 << 20, 16, False),
                          (32, 1 << 20, 2, True)):
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
        qs = db[torch.randint(0, c, (q,), generator=g, device=dev)].clone()
        qs[0, 0] ^= 1
        cells_k = fs._hamming_cells_cuda(qs, db, valid)
        torch.cuda.synchronize()
        cells_p = fs._hamming_cells_plain(qs, db, valid)
        check(torch.equal(cells_k[0], cells_p[0]) and torch.equal(cells_k[1], cells_p[1]),
              f"hamming cells equal q={q} w={w} ties={ties}")
        dk, ik = fs.hamming_topk_fused_batched(qs, db, valid, k)
        torch.cuda.synchronize()
        dp, ip = fs.hamming_topk_fused_batched_plain(qs, db, valid, k)
        check(torch.equal(dk, dp) and torch.equal(ik, ip),
              f"hamming top-k equal q={q} w={w} ties={ties}")
        nbytes = c * (4 * w + 1) + q * w * 4 + q * k * 8
        # per (query, row): w XORs, w - 1 adds and one compare on the ALU
        # pipe, w popcounts on the popcount pipe
        b, by = bound_ms(card, nbytes, alu_ops=q * c * 2 * w, popc_ops=q * c * w)
        results["hamming"].append({
            "q": q, "c": c, "w": w, "ties": ties,
            "max_abs_err": _max_abs(torch, dk, dp),
            "ms": time_ms(torch, lambda: fs.hamming_topk_fused_batched(qs, db, valid, k)),
            "cells_ms": time_ms(torch, lambda: fs._hamming_cells_cuda(qs, db, valid)),
            "plain_ms": time_ms(torch, lambda: fs.hamming_topk_fused_batched_plain(
                qs, db, valid, k)),
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "kernel_bytes": -(-q // fs.QSEL) * c * (4 * w + 1),
        })
    for name, rows in results.items():
        say(f"kernels/{name}: " + json.dumps(rows))
    return results


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


def _bulk_load(torch, backend, n_phash, n_multi, n_vec, dim, seed, dev):
    """Chunked bulk load through the columnar batch upserts; the data is
    made on the card from `seed` (bundles are real multi hashes of random
    32x32 images)."""
    import numpy as np

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
        asyncio.run(backend.upsert_embedding_batch(
            0, SEM, list(range(2 * 10**8 + lo, 2 * 10**8 + lo + m)), mat,
            model_id="smoke"))
    t_vec = time.perf_counter() - t0
    return {"phash_s": t_phash, "multi_s": t_multi, "vectors_s": t_vec}


def _plain_hamming_hits(torch, backend, hexes, k):
    import numpy as np

    from ucfp_tpu_torch.ops import fused_scan as fs

    cache = backend._ham[(0, PHASH)]
    matrix, valid = cache.device
    qm = np.stack([np.frombuffer(bytes.fromhex(h), "<u4") for h in hexes])
    q = torch.from_numpy(qm.view(np.int32)).to(matrix.device)
    kk = min(k, cache.n)
    d, i = fs.hamming_topk_fused_batched_plain(q, matrix, valid, kk)
    out = []
    for dr, ir in zip(d.cpu().numpy(), i.cpu().numpy()):
        rows = sorted((cache.rids[int(x)], int(y)) for y, x in zip(dr, ir) if y < 2**30)
        rows.sort(key=lambda t: (t[1], t[0]))
        out.append([(rid, 1.0 - dd / 64) for rid, dd in rows])
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
    from ucfp_tpu_torch.ops import fused_scan as fs
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
        fs.reset_launch_counts()
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
        launches = dict(fs.LAUNCHES)
        # ---- end of the main path
        check(all(n > 0 for n in launches.values()), f"every kernel launched: {launches}")
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
            "peak_device_gib": peak,
        }
        say("served: " + json.dumps(served))
        return served
    finally:
        if server is not None:
            server.stop()
        backend.close()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


# -- main ---------------------------------------------------------------------


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="device,build,kernels,conformance,served")
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
    if "conformance" in phases:
        phase_conformance(dev)
    served = phase_served(torch, dev) if "served" in phases else None
    if kernels is not None:
        launches = served["launches"] if served else {}
        main_scores = next(r for r in kernels["scores"]
                           if r["q"] == 32 and r["dtype"] == "float32" and not r["ties"])
        main_ham = next(r for r in kernels["hamming"]
                        if r["q"] == 32 and r["w"] == 2 and not r["ties"])
        line = {"kernels": [
            {"name": "scores_topk_fused_batched", "route": "cuda",
             "source": "ucfp_tpu_torch/csrc/fused_scan.cu",
             "replaces": "ucfp_tpu/ops/pallas_scan.py:487",
             "launches": launches.get("scores_topk_fused_batched"),
             "max_abs_err": max(r["max_abs_err"] for r in kernels["scores"]),
             **{key: main_scores[key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shape": {"q": 32, "c": main_scores["c"], "dtype": "float32"}},
            {"name": "hamming_topk_fused_batched", "route": "cuda",
             "source": "ucfp_tpu_torch/csrc/fused_scan.cu",
             "replaces": "ucfp_tpu/ops/pallas_scan.py:163",
             "launches": launches.get("hamming_topk_fused_batched"),
             "max_abs_err": max(r["max_abs_err"] for r in kernels["hamming"]),
             **{key: main_ham[key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             "shape": {"q": 32, "c": main_ham["c"], "w": 2}},
        ]}
        say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
