"""The weighted multi-hash score of every (query bundle, stored bundle)
pair, in float64, from the 536-byte bundles themselves:

    score = wp * (1 - popcount(pq ^ pr) / 64) + wd * (same, dHash)
          + wa * (same, aHash) + wg * clamp(1 - 0.5 * sum_j |hq_j - hr_j|, 0, 1)
          + wb * #{j : |bq_j - br_j| <= threshold} / 256

over the u64 hashes at bytes 0-24, the float32 histogram at 24-280 and
the block bytes at 280-536, with the weights as float32 numbers. Also the
control: the same score computed in bfloat16, in the program's place."""

from __future__ import annotations

import numpy as np
import torch

_W_KEYS = ("phash_weight", "dhash_weight", "ahash_weight", "global_weight", "block_weight")


def _fields(b: torch.Tensor, dtype):
    """[n, 536] uint8 -> (hash bits [n, 192], histogram [n, 64], blocks [n, 256])."""
    shifts = torch.arange(8, device=b.device, dtype=torch.uint8)
    bits = ((b[:, :24, None] >> shifts) & 1).reshape(len(b), 192).to(dtype)
    hist = b[:, 24:280].contiguous().view(torch.float32).to(dtype)
    return bits, hist, b[:, 280:].to(torch.int16)


def _weights(cfg: dict, dtype) -> list[float]:
    w = [float(np.float32(cfg["weights"][k])) for k in _W_KEYS]
    return [torch.tensor(x, dtype=dtype).item() for x in w]


def _pair_terms(qb, rb, dtype, thresh: int):
    """(hash sims [3, Q, C], L1 [Q, C], block matches [Q, C]) in `dtype`;
    the histogram and block terms in blocks of queries that keep each
    temporary under 2^26 elements on a card, 2^22 on the host."""
    qbits, qh, qblk = qb
    rbits, rh, rblk = rb
    sims = []
    for h in range(3):
        a, b = qbits[:, 64 * h: 64 * (h + 1)], rbits[:, 64 * h: 64 * (h + 1)]
        d = a.sum(1, keepdim=True) + b.sum(1)[None, :] - 2 * (a @ b.T)
        sims.append(1 - d / 64)
    budget = 1 << (26 if rh.is_cuda else 22)
    step = max(1, budget // (len(rh) * 256))
    l1, nmatch = [], []
    for s in range(0, len(qh), step):
        l1.append((qh[s:s + step, None, :] - rh[None]).abs().sum(-1, dtype=dtype))
        nmatch.append(((qblk[s:s + step, None, :] - rblk[None]).abs() <= thresh)
                      .sum(-1).to(dtype))
    return torch.stack(sims), torch.cat(l1), torch.cat(nmatch)


def scores(queries: np.ndarray, rows: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[Q, 536] uint8 query bundles against [C, 536] uint8 stored bundles
    (on any device) -> [Q, C] float64 scores."""
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(rows.device)
    sims, l1, nmatch = _pair_terms(_fields(q, torch.float64), _fields(rows, torch.float64),
                                   torch.float64, int(cfg["weights"]["block_distance_threshold"]))
    wp, wd, wa, wg, wb = _weights(cfg, torch.float64)
    gsim = torch.clamp(1 - 0.5 * l1, 0, 1)
    return wp * sims[0] + wd * sims[1] + wa * sims[2] + wg * gsim + wb * nmatch / 256


def control_op(cfg: dict):
    """The reference in bfloat16, with the signature of the program's
    compare (query words [Q, 134] int32, stored words [C, 134] int32,
    valid [C] bool, params, k) -> (scores [Q, k] float32, rows [Q, k])."""
    bf = torch.bfloat16
    thresh = int(cfg["weights"]["block_distance_threshold"])

    def op(qm, db, valid, params, k):
        q = _fields(qm.contiguous().view(torch.uint8), bf)
        wp, wd, wa, wg, wb = [torch.tensor(w, dtype=bf, device=db.device)
                              for w in _weights(cfg, torch.float32)]
        out = []
        for lo in range(0, len(db), 1 << 16):
            r = _fields(db[lo:lo + (1 << 16)].contiguous().view(torch.uint8), bf)
            sims, l1, nmatch = _pair_terms(q, r, bf, thresh)
            gsim = torch.clamp(1 - l1 * 0.5, 0, 1)
            s = wp * sims[0] + wd * sims[1] + wa * sims[2] + wg * gsim + wb * (nmatch / 256)
            out.append(s.float())
        s = torch.where(valid[None, :], torch.cat(out, 1), float("-inf"))
        order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
        return torch.gather(s, 1, order), order

    return op
