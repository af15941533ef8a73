"""One run of one cell of BENCHMARK.json.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up: the card comes up; the catalog is made on it from the seed and
written through EmbeddedBackend's columnar batch upserts into a store
under TMPDIR (WAL, group-commit fsync); the port's app is served on
loopback from this process, on an event loop thread of its own, with its
production middleware; two requests of the cell's own shape warm it up.
The load generator, a process of its own, then offers the mix's traffic:
warmup_s seconds of it, then the measured window of --seconds. With
--trace 1 the harness times the index layer's calls, reads the program's
/metrics at the window's start and end, and records the device with
torch.profiler over the window's last trace_s seconds (prepared in
set-up, before any traffic).

After the window: every request due in it is waited for, the card's
memory peak is read, the server is stopped through its own shutdown and
the backend closed, and a sample of the answers drawn from the seed is
compared with the plain reference (perfbench/check.py). The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exit codes: 0 with a result (correct or not); 2 bad arguments; 3 no card
or too few; 4 a forbidden module was loaded; 1 any other failure."""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from perfbench import catalog, check, faults, schedule, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ucfp_tpu")
CACHE_DIR = os.path.join(spec.ROOT, ".perfbench-cache")
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda", "TORCHINDUCTOR_CACHE_DIR": "inductor"}
GRACE_S = 60.0  # how long past the window's close an answer is waited for
INF_MS = 1e12  # a percentile that falls on a failed request


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def prepare_env(cfg: dict) -> None:
    """The port's settings as the configuration states them and no
    others; the build and kernel caches at fixed paths in the checkout;
    no library may load JAX by itself."""
    for key in [k for k in os.environ if k.startswith("UCFP_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in cfg["settings"]["env"].items()})
    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE_DIR, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ.update({"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"})


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def nearest_rank(values: np.ndarray, p: float) -> float:
    v = np.sort(values)
    return float(v[max(0, math.ceil(p * len(v)) - 1)]) if len(v) else float("nan")


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class LoadGen:
    """The load generator process (python3 -m perfbench.loadgen)."""

    def __init__(self, setup: dict):
        self.proc = subprocess.Popen([sys.executable, "-m", "perfbench.loadgen"],
                                     cwd=spec.ROOT, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE)
        self.proc.stdin.write((json.dumps(setup) + "\n").encode())
        self.proc.stdin.flush()

    def go(self, msg: dict) -> None:
        if self.proc.stdout.readline().strip() != b"ready":
            raise RuntimeError("the load generator did not get ready")
        self.proc.stdin.write((json.dumps(msg) + "\n").encode())
        self.proc.stdin.close()

    def result(self) -> dict:
        out = self.proc.stdout.read()
        if self.proc.wait(timeout=120) != 0:
            raise RuntimeError(f"the load generator exited with {self.proc.returncode}")
        return pickle.loads(out)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


class Bench:
    """A loaded catalog served by the port: set up once, then driven by
    one or more windows of traffic (a benchmark run drives one; the knee
    sweep drives several)."""

    def __init__(self, cell, seed: int, device, n_requests: int, inject: str | None = None):
        import torch

        self.torch = torch
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.kind = cell.config, cell.kind
        self.tmp = tempfile.mkdtemp(prefix="perfbench-")
        self.timings: dict = {}
        self.app = self.backend = self.restore = None
        t = time.monotonic()
        self.items = self.kind.make_items(self.cfg, cell.traffic, seed, n_requests, device)
        self.items_path = os.path.join(self.tmp, "items.npy")
        np.save(self.items_path, self.items)
        self.timings["items_s"] = time.monotonic() - t
        from ucfp_tpu_torch.index.embedded import EmbeddedBackend

        self.restore = faults.install(inject, cell) if inject else None
        self.backend = EmbeddedBackend(os.path.join(self.tmp, "db"), device=device)

    def loadgen(self, traffic: dict, seconds: float) -> LoadGen:
        return LoadGen({"kind": self.cfg["kind"], "items": self.items_path,
                        "config": self.cfg, "traffic": traffic, "seed": self.seed,
                        "seconds": seconds})

    def load(self) -> None:
        t = time.monotonic()
        loop = asyncio.new_event_loop()
        try:
            for lo, m in catalog.chunks(self.cfg["rows"]):
                rows = self.kind.catalog_chunk(self.cfg, self.seed, lo, m, self.device)
                for coro in self.kind.upsert(self.backend, self.cfg, self.seed, lo,
                                             rows.cpu().numpy(), self.device):
                    loop.run_until_complete(coro)
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            loop.close()
        self.timings["load_s"] = time.monotonic() - t
        from perfbench.server import ServedApp

        t = time.monotonic()
        self.app = ServedApp(self.backend, self.cfg, self.tmp)
        for body in self.kind.bodies(self.items[:2], self.cfg, self.cell.traffic):
            status, answer = self.app.post("/v1/query", body)
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}: {answer[:300]!r}")
        self.timings["warmup_s"] = time.monotonic() - t
        # the load leaves a dict per record for the cyclic collector: one
        # full pass here, as a server pays once after its boot, and not at
        # a time of its own inside the window
        t = time.monotonic()
        gc.collect()
        self.timings["gc_s"] = time.monotonic() - t

    def window(self, traffic: dict, seconds: float, traced: bool, lg: LoadGen | None = None,
               trace_s: float = 0.0) -> dict:
        """Drive one window; -> the load generator's rows and the window's
        times, plus with `traced` the counters, index spans and trace."""
        from perfbench.trace import DeviceTrace

        lg = lg or self.loadgen(traffic, seconds)
        spans: list = []
        dt = None
        if traced:
            # CUPTI's one-time set-up, before any traffic (it stalls the
            # process for seconds): the session is started and stopped
            # once, over the window's last trace_s seconds
            dt = DeviceTrace(self.torch)
            dt.prepare()
            name = self.kind.INDEX_METHOD
            orig = getattr(self.backend, name)

            async def timed(*a, **kw):
                t = time.monotonic()
                try:
                    return await orig(*a, **kw)
                finally:
                    spans.append((t, time.monotonic()))

            setattr(self.backend, name, timed)
        t_begin = time.monotonic() + 1.0
        t0 = t_begin + float(traffic["warmup_s"])
        t_end = t0 + seconds
        lg.go({"port": self.app.port, "token": self.app.token, "t_begin": t_begin,
               "t0": t0, "t_end": t_end, "grace_s": GRACE_S})
        out = {"t0": t0, "t_end": t_end, "spans": spans, "counters": {}, "trace": None}
        _sleep_until(t0)
        if traced:
            out["counters"]["start"] = self.app.get("/metrics")[1].decode()
            _sleep_until(max(t0, t_end - trace_s))
            dt.start()
            _sleep_until(t_end)
            dt.stop()
            out["counters"]["end"] = self.app.get("/metrics")[1].decode()
            out["trace"] = dt
        else:
            _sleep_until(t_end)
        out["rows"] = lg.result()
        if traced:
            delattr(self.backend, self.kind.INDEX_METHOD)
        return out

    def close(self) -> None:
        """Stop the server, close the backend and free its device state."""
        try:
            if self.app is not None:
                self.app.stop()
            if self.backend is not None:
                self.backend.close()
        finally:
            self.app = self.backend = None
            gc.collect()
            if self.torch.cuda.is_available():
                self.torch.cuda.synchronize()
                self.torch.cuda.empty_cache()

    def cleanup(self) -> None:
        if self.restore is not None:
            self.restore()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _sleep_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.5))


def n_requests(traffic: dict, seconds: float) -> int:
    if traffic["loop"] == "open":
        plan = schedule.open_loop(traffic["rate_per_s"], traffic["warmup_s"], seconds)
        return plan["n_warm"] + plan["n_window"]
    return int(traffic["request"]["query_pool"])


def summarize(traffic: dict, rows: dict, t0: float, t_end: float, seconds: float) -> dict:
    """Attempted and failed requests, the open loop's latency percentiles
    (from each request's due time; a failed one counts as infinitely late)
    or the closed loop's completed lookups per second, the generator's
    lateness and status counts, and which requests the check may sample."""
    ok = rows["status"] == 200
    per = int(traffic["request"]["per_request"])
    if traffic["loop"] == "open":
        due_in = (rows["due"] >= t0) & (rows["due"] < t_end)
        lat = np.where(ok, rows["done"] - rows["due"], np.inf)[due_in] * 1e3
        late = (rows["sent"] - rows["due"])[due_in & ok] * 1e3
        p50, p95 = nearest_rank(lat, 0.50), nearest_rank(lat, 0.95)
        e2e = {"lookup_p50_ms": p50 if math.isfinite(p50) else INF_MS,
               "lookup_p95_ms": p95 if math.isfinite(p95) else INF_MS}
        attempted = int(due_in.sum())
        failed = int((due_in & ~ok).sum())
        candidates = np.nonzero(due_in & ok)[0]
        gen = {"requests": attempted, "late_p50_ms": nearest_rank(late, 0.5),
                    "late_p99_ms": nearest_rank(late, 0.99),
                    "late_max_ms": float(late.max()) if len(late) else float("nan")}
    else:
        done_in = ok & (rows["done"] >= t0) & (rows["done"] < t_end)
        sent_in = (rows["sent"] >= t0) & (rows["sent"] < t_end)
        e2e = {"lookups_per_s": float(done_in.sum()) * per / seconds}
        attempted = int(sent_in.sum())
        failed = int((sent_in & ~ok).sum())
        candidates = np.nonzero(done_in)[0]
        gen = {"requests_done": int(done_in.sum())}
    codes, counts = np.unique(rows["status"], return_counts=True)
    gen["status"] = {int(c): int(n) for c, n in zip(codes, counts)}
    bad = np.nonzero(~ok)[0]
    if len(bad):
        gen["first_failure"] = rows["answer"][bad[0]][:300].decode("utf-8", "replace")
    return {"e2e": e2e, "attempted": attempted, "failed": failed,
            "candidates": candidates, "loadgen": gen}


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             inject: str | None = None) -> dict:
    """One run; -> the result line's object (and `extra`, the earlier lines)."""
    import torch

    traffic = cell.traffic
    kind_name = (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                 else str(device))
    card = power_limit() if torch.device(device).type == "cuda" else None
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bench = Bench(cell, seed, device, n_requests(traffic, seconds), inject)
    try:
        lg = bench.loadgen(traffic, seconds)
        try:
            bench.load()
            w = bench.window(traffic, seconds, traced, lg, float(traffic.get("trace_s", 4.0)))
        finally:
            lg.stop()
        setup_s = w["t0"] - t_start
        s = summarize(traffic, w["rows"], w["t0"], w["t_end"], seconds)
        reduced = None
        if traced:
            from perfbench.peaks import peaks_for
            from perfbench.trace import reduce

            dt = w["trace"]
            rows = w["rows"]
            req_spans = [(a, b) for a, b in zip(rows["sent"], rows["done"]) if b > a]
            reduced = reduce(dt.device_events(), dt.t_start, dt.t_stop, w["spans"], req_spans)
            ctx = {"cfg": cell.config, "traffic": traffic, "window": (w["t0"], w["t_end"]),
                   "counters": w["counters"], "index_spans": w["spans"], "trace": reduced,
                   "peaks": peaks_for(kind_name)}
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if torch.device(device).type == "cuda" else 0)
        bench.close()
        t = time.monotonic()
        rows = w["rows"]
        pick = schedule.rng(seed, "sample").permutation(len(s["candidates"]))
        chosen = np.sort(s["candidates"][pick[:int(traffic["check"]["sample_requests"])]])
        numbers = check.compare(cell, seed, bench.items,
                                [(int(rows["item"][i]), rows["answer"][i]) for i in chosen],
                                device)
        numbers["unanswered"] = s["failed"]
        ok, checks = check.judge(numbers, cell.config["limits"])
        ref_s = time.monotonic() - t
    finally:
        bench.close()
        bench.cleanup()
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(s["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_out = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                  "kind": kind_name, "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(ok and s["attempted"] > 0), "attempted": s["attempted"],
              "failed": s["failed"], "metrics": metrics, "device": device_out}
    if reduced is not None:
        device_out["busy_s"] = reduced["busy_s"]
        device_out["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["card"] = {"name_power_limit": card}
    result["checks"] = checks
    extra = {"loadgen": s["loadgen"],
             "setup": dict(bench.timings, setup_s=setup_s, reference_s=ref_s),
             "sample": {"requests": int(len(chosen)), "seed": seed}}
    if reduced is not None:
        extra["trace"] = {k: reduced[k] for k in ("window_s", "busy_s", "kernel_s", "kernels",
                                                    "in_flight_s", "served_idle_s",
                                                    "served_requests")}
        extra["trace"]["prepare_s"] = w["trace"].prepare_s
    return {"result": result, "extra": extra}


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--inject", choices=faults.NAMES, default=None,
                    help="put a control or a fault in the program's place (tests and "
                         "control runs only)")
    try:
        args = ap.parse_args(argv)
        cell = spec.Cell(spec.load_benchmark(), args.workload)
    except (SystemExit, KeyError, OSError, ValueError) as e:
        log(f"bad arguments: {e}")
        return 2
    prepare_env(cell.config)
    try:
        import torch
    except ImportError as e:
        log(f"no torch: {e}")
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start,
                       args.inject)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 4
    print(json.dumps(out["extra"]), flush=True)
    for name, c in out["result"]["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out["result"]), flush=True)
    return 0
