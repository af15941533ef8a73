"""The comparison that decides `correct`: answers the window served
against the plain reference, recomputed from the inputs the benchmark made.

For each sampled request, each of its queries' served hits (record id,
score) is held against the reference's score of every stored row, the
catalog made again chunk by chunk from the seed:

  score_gap   the widest gap between a served score and the reference's
              score of the same record;
  rank_gap    the widest amount by which a served record's reference
              score lies below the reference's k-th best;
  wrong_hits  queries whose answer has the wrong number of hits, a record
              id that names no stored row, or a record twice;
  unanswered  requests due (or sent) in the window that got no 200 answer.

Each is held to its limit in the configuration's `limits`."""

from __future__ import annotations

import numpy as np

from perfbench import catalog


def compare(cell, seed: int, items: np.ndarray, sample: list[tuple[int, bytes]],
            device) -> dict:
    import torch

    cfg, kind, ref = cell.config, cell.kind, cell.reference
    rows = cfg["rows"]
    k = min(int(cell.traffic["request"]["k"]), rows)
    queries, served, wrong = [], [], 0
    for item, answer in sample:
        per = kind.parse(answer)
        qx = kind.queries_of(items, item)
        if len(per) != len(qx):
            wrong += len(qx)
            continue
        queries.extend(qx)
        served.extend(per)
    pq, prow, pscore = [], [], []
    for qi, hits in enumerate(served):
        seen, bad = set(), len(hits) != k
        for rid, score in hits:
            r = catalog.row_of(seed, rid, rows)
            if r < 0 or r in seen:
                bad = True
                continue
            seen.add(r)
            pq.append(qi)
            prow.append(r)
            pscore.append(float(score))
        wrong += bad
    if not queries:
        return {"score_gap": 0.0, "rank_gap": 0.0, "wrong_hits": wrong}
    q = np.stack(queries)
    pq_t = torch.tensor(pq, dtype=torch.int64, device=device)
    prow_t = torch.tensor(prow, dtype=torch.int64, device=device)
    ref_served = torch.full((len(pq),), float("nan"), dtype=torch.float64, device=device)
    best = torch.full((len(q), k), float("-inf"), dtype=torch.float64, device=device)
    for lo, m in catalog.chunks(rows):
        s = ref.scores(q, kind.catalog_chunk(cfg, seed, lo, m, device), cfg)
        best = torch.topk(torch.cat([best, s], 1), k, dim=1).values
        sel = (prow_t >= lo) & (prow_t < lo + m)
        ref_served[sel] = s[pq_t[sel], prow_t[sel] - lo]
    ref_served = ref_served.cpu().numpy()
    kth = best[:, k - 1].cpu().numpy()
    score_gap = float(np.max(np.abs(np.asarray(pscore) - ref_served))) if pq else 0.0
    rank_gap = float(max(0.0, np.max(kth[np.asarray(pq)] - ref_served))) if pq else 0.0
    return {"score_gap": score_gap, "rank_gap": rank_gap, "wrong_hits": wrong}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
