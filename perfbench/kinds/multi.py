"""Weighted multi-hash catalogs: 536-byte bundles (pHash, dHash and aHash
as u64, a 64-bin float32 histogram, 256 block bytes) and requests that
each carry `per_request` bundles in `fingerprints_hex`.

Only the functions that make and format requests run in the load
generator, which imports no torch: torch is imported where it is used."""

from __future__ import annotations

import json

import numpy as np

from perfbench import catalog, schedule

INDEX_METHOD = "knn_multihash"  # the index layer's entry the window drives
PORT_OP = ("ucfp_tpu_torch.ops.imagehash", "multihash_weighted_topk")


def catalog_chunk(cfg: dict, seed: int, lo: int, m: int, device):
    """Rows lo .. lo + m of the catalog, [m, 536] uint8 on `device`, the
    same on every call (each chunk has a generator of its own)."""
    import torch

    g = torch.Generator(device=device).manual_seed(
        schedule.sub_seed(seed, "catalog", lo // catalog.CHUNK))
    hashes = torch.randint(0, 256, (m, 24), generator=g, device=device, dtype=torch.uint8)
    hist = -torch.log(torch.rand((m, 64), generator=g, device=device).clamp_min(1e-12))
    hist = (hist / hist.sum(dim=1, keepdim=True)).to(torch.float32)
    blocks = torch.randint(0, 256, (m, 256), generator=g, device=device, dtype=torch.uint8)
    return torch.cat([hashes, hist.contiguous().view(torch.uint8), blocks], dim=1)


def upsert(backend, cfg: dict, seed: int, lo: int, rows_u8: np.ndarray, device):
    """The coroutines that store one chunk through the columnar batch path."""
    return [backend.upsert_fingerprint_batch(
        cfg["tenant_id"], cfg["algorithm"], catalog.record_ids(seed, lo, len(rows_u8)),
        [r.tobytes() for r in rows_u8])]


def make_items(cfg: dict, traffic: dict, seed: int, n: int, device) -> np.ndarray:
    """[n, per_request, 536] uint8: request i's bundles. Exactly
    copy_share of all bundles are edited copies of stored bundles, at
    places and of rows drawn from the seed; the rest are fresh draws."""
    per = int(traffic["request"]["per_request"])
    total = n * per
    r = schedule.rng(seed, "queries.copies")
    n_copy = int(round(total * float(traffic["request"]["copy_share"])))
    where = r.permutation(total)[:n_copy]
    src = r.integers(0, cfg["rows"], n_copy)
    fresh = catalog_chunk(cfg, schedule.sub_seed(seed, "queries.fresh"), 0, total,
                          device).cpu().numpy()
    out = fresh.copy()
    for c in np.unique(src // catalog.CHUNK):
        lo = int(c) * catalog.CHUNK
        m = min(catalog.CHUNK, cfg["rows"] - lo)
        rows = catalog_chunk(cfg, seed, lo, m, device).cpu().numpy()
        sel = np.nonzero(src // catalog.CHUNK == c)[0]
        out[where[sel]] = rows[src[sel] - lo]
    if n_copy:
        out[where] = _edit(out[where], r)
    return out.reshape(n, per, cfg["bundle_bytes"])


def _edit(copies: np.ndarray, r: np.random.Generator) -> np.ndarray:
    """Edited copies: 0-3 bits of each hash flipped, the histogram's bins
    scaled by 1 + 0.1 N(0, 1) and renormalised, block bytes moved -4..4."""
    n = len(copies)
    bits = np.unpackbits(copies[:, :24], axis=1, bitorder="little").reshape(n, 3, 64)
    for h in range(3):
        for j in range(n):
            flips = r.choice(64, size=int(r.integers(0, 4)), replace=False)
            bits[j, h, flips] ^= 1
    copies[:, :24] = np.packbits(bits.reshape(n, 192), axis=1, bitorder="little")
    hist = copies[:, 24:280].copy().view("<f4").astype(np.float64)
    hist = np.clip(hist * (1.0 + 0.1 * r.standard_normal(hist.shape)), 0.0, None)
    hist /= hist.sum(axis=1, keepdims=True)
    copies[:, 24:280] = hist.astype("<f4").view(np.uint8)
    blocks = copies[:, 280:].astype(np.int16) + r.integers(-4, 5, (n, 256))
    copies[:, 280:] = np.clip(blocks, 0, 255).astype(np.uint8)
    return copies


def bodies(items: np.ndarray, cfg: dict, traffic: dict) -> list[bytes]:
    """One /v1/query body per request (numpy only)."""
    head = ('{"tenant_id":%d,"modality":"image","algorithm":"%s","k":%d,'
            '"fingerprints_hex":[' % (cfg["tenant_id"], cfg["algorithm"],
                                      int(traffic["request"]["k"])))
    return [(head + ",".join('"%s"' % b.tobytes().hex() for b in req) + "]}").encode()
            for req in items]


def queries_of(items: np.ndarray, item: int):
    """The bundles of request `item`, [per_request, 536] uint8."""
    return items[item]


def parse(answer: bytes) -> list[list[tuple[int, float]]]:
    """(record id, score) per hit, per bundle of the request."""
    return [[(h["record_id"], h["score"]) for h in res["hits"]]
            for res in json.loads(answer)["results"]]


def least_work(cfg: dict, traffic: dict) -> dict:
    """The least work of one compare call, counted from the definition of
    the score, not from any implementation: every stored row read once,
    the queries read and the top-k written once; per (query, row) pair,
    three 64-bit XOR-and-popcounts (6 XORs, 6 adds, 6 popcounts on 32-bit
    words), the histogram's 64 |a - b| terms and their sum (128 float
    operations) and 5 weighted terms (10), and the 256 block matches at
    four bytes a 32-bit word (64 words x absolute difference, compare and
    count)."""
    q = int(traffic["request"]["per_request"])
    k = int(traffic["request"]["k"])
    pairs = q * cfg["rows"]
    return {"nbytes": (cfg["rows"] + q) * cfg["bundle_bytes"] + q * k * 12,
            "alu_ops": pairs * (12 + 64 * 3), "popc_ops": pairs * 6,
            "f32_ops": pairs * (128 + 10)}
