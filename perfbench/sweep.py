"""The knee of an open-loop cell: one set-up, then one window at each
offered rate, in the order given.

    python3 -m perfbench.sweep --workload multi-open8 --seed 5 --seconds 20 \
        --rates 8,10,12,14,16,18

Prints one JSON line per rate: the requests completed per second, the
latency median and 95th percentile from the due time, and the backlog's
growth (the median latency of the window's last quarter over its
first's). The knee is the highest rate the port sustains without a
backlog that grows through the window; the mix's rate_per_s is set once,
by hand, to about 4/5 of it. The benchmark's runs never sweep."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from perfbench import run, spec


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    run.prepare_env(cell.config)
    import torch

    if not torch.cuda.is_available():
        run.log("the sweep needs a CUDA card")
        return 3
    top = dict(cell.traffic, rate_per_s=max(rates))
    bench = run.Bench(cell, args.seed, "cuda:0", run.n_requests(top, args.seconds))
    try:
        bench.load()
        for rate in rates:
            traffic = dict(cell.traffic, rate_per_s=rate)
            w = bench.window(traffic, args.seconds, False)
            rows = w["rows"]
            s = run.summarize(traffic, rows, w["t0"], w["t_end"], args.seconds)
            due_in = (rows["due"] >= w["t0"]) & (rows["due"] < w["t_end"])
            ok = due_in & (rows["status"] == 200)
            lat = (rows["done"] - rows["due"])[ok] * 1e3
            q = max(1, len(lat) // 4)
            done_in = ok & (rows["done"] < w["t_end"])
            print(json.dumps({
                "rate_per_s": rate, "completed_per_s": float(done_in.sum()) / args.seconds,
                "p50_ms": s["e2e"]["lookup_p50_ms"], "p95_ms": s["e2e"]["lookup_p95_ms"],
                "growth": float(np.median(lat[-q:]) / np.median(lat[:q])) if len(lat) else None,
                "failed": s["failed"], "attempted": s["attempted"], "loadgen": s["loadgen"]}),
                flush=True)
    finally:
        bench.close()
        bench.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
