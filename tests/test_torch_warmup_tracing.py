"""Boot warm-up, the trace knobs and the sanitizer knob of the port, on
the CPU.

  * warm-up (server/warmup.py) runs every family of the reference's
    (text, image, the coalesced launch when on, audio, ANN) and reaches
    each fused scan family's wrapper of the configured tier at the fused
    floor of 32,768 rows; the launcher starts it by default and it logs
    "warmup complete";
  * UCFP_PROFILE_DIR: the port bench writes a Chrome trace there;
  * UCFP_PROFILER_PORT (server/profiler.py): the trace endpoint answers
    with a trace of every thread's operators, refuses bad windows, and a
    port it cannot bind is an error at start;
  * UCFP_NATIVE_SANITIZE: build_host's flags and the `.san.so` names;
    the port's ASan/UBSan driver over its five native modules (skipped
    without libasan, as tests/test_sanitizers.py is).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from ucfp_tpu_torch import _build, bench
from ucfp_tpu_torch.ops import fused_scan, int2_scan, int4_scan, sketch_scan
from ucfp_tpu_torch.server import profiler, warmup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR = fused_scan.ROWS_PER_TILE * fused_scan.LANES


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, **kw):
        self.lines.append(("info", msg, kw))

    def warn(self, msg, **kw):
        self.lines.append(("warn", msg, kw))


# the tier -> the kernel wrappers its warm-up must reach
WANT = {
    "none": {"scores_topk_fused_batched", "scores_topk_fused", "hamming_topk_fused_batched"},
    "int8": {"dots_norm_topk_fused", "dots_norm_topk_fused_batched",
             "hamming_topk_fused_batched"},
    "int4": {"dots_norm_topk_fused", "int4_masked_scores", "int4_dots",
             "int4_masked_scores_batched"},
    "int2": {"dots_norm_topk_fused", "int2_masked_scores", "int2_masked_scores_batched"},
    "sketch": {"dots_norm_topk_fused", "asym_sketch_scores_tiled"},
}


@pytest.mark.parametrize("quant", sorted(WANT))
def test_warmup_runs_every_family(monkeypatch, quant):
    monkeypatch.setenv("UCFP_KNN_QUANT", quant)
    monkeypatch.setenv("UCFP_WARMUP_DIMS", "64")
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "2")
    monkeypatch.setenv("UCFP_INGEST_COALESCE_ROWS", "64")
    log = _Log()
    monkeypatch.setattr(warmup, "logger", lambda: log)
    rows = {}
    for mod in (fused_scan, int4_scan, int2_scan, sketch_scan):
        for name in mod.LAUNCHES:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def spy(*a, _fn=fn, _name=name, **kw):
                rows.setdefault(_name, set()).update(
                    n for t in a if isinstance(t, torch.Tensor) for n in t.shape)
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    warmup._work(torch.device("cpu"))
    assert [(lv, msg) for lv, msg, _ in log.lines] == [("info", "warmup complete")], log.lines
    kernels = log.lines[0][2]["kernels"].split(",")
    assert kernels == ["text", "image", "image-coalesced", "audio",
                       "ann" if quant == "none" else f"ann-{quant}"]
    assert WANT[quant] <= set(rows), rows
    # every scan ran over the fused floor's rows (the tiled sketch holds
    # them as FLOOR / 128 tiles of 128 lanes)
    assert all(FLOOR in sizes or FLOOR // fused_scan.LANES in sizes
               for sizes in rows.values()), rows


def test_warmup_failure_is_logged_not_raised(monkeypatch):
    log = _Log()
    monkeypatch.setattr(warmup, "logger", lambda: log)
    monkeypatch.setenv("UCFP_WARMUP_DIMS", "64")

    def broken(*a, **kw):
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(fused_scan, "hamming_topk_fused_batched", broken)
    t = warmup.start_background_warmup("cpu")
    t.join(300)
    assert not t.is_alive()
    (lv, msg, kw), = log.lines
    assert (lv, msg) == ("warn", "warmup error") and "failed to load" in kw["err"]
    assert kw["completed"] == "text,image,audio"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, timeout=60):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, method="POST"),
                                    timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_starts_warmup_and_profiler(tmp_path):
    """python -m ucfp_tpu_torch.server: warm-up by default (it logs its
    completion), and UCFP_PROFILER_PORT's endpoint answers with a trace
    of the requests served in its window."""
    port, prof = _free_port(), _free_port()
    env = dict(os.environ, UCFP_WARMUP_DIMS="64", UCFP_PROFILER_PORT=str(prof),
               UCFP_LOG="info", UCFP_SHARD="off",
               # the traffic below runs flat out: no 429 from the limiter
               UCFP_RATELIMIT_RPS="100000", UCFP_RATELIMIT_BURST="100000")
    env.pop("UCFP_WARMUP", None)
    log_path = tmp_path / "log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ucfp_tpu_torch.server", "--bind", f"127.0.0.1:{port}",
             "--token", "t", "--data-dir", str(tmp_path / "d"), "--device", "cpu"],
            env=env, cwd=REPO, stderr=log)
    try:
        deadline = time.time() + 180
        lines = []
        while time.time() < deadline:
            lines = [json.loads(ln) for ln in open(log_path) if ln.startswith("{")]
            if any(ln["msg"] in ("warmup complete", "warmup error") for ln in lines):
                break
            assert proc.poll() is None, open(log_path).read()
            time.sleep(0.3)
        done = [ln for ln in lines if ln["msg"].startswith("warmup")]
        assert done and done[0]["msg"] == "warmup complete", done
        assert done[0]["kernels"] == "text,image,audio,ann" and done[0]["secs"] > 0
        assert any(ln["msg"] == "profiler" and ln["port"] == prof for ln in lines)

        def call(path, doc):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", method="POST",
                headers={"Authorization": "Bearer t"}, data=json.dumps(doc).encode())
            return urllib.request.urlopen(req, timeout=30).read()

        done = threading.Event()
        errors = []

        def traffic():  # a write and a vector query (torch operators) a turn
            try:
                turns()
            except Exception as e:
                errors.append(e)

        def turns():
            i = 0
            while not done.is_set():
                i += 1
                vec = [float((i * 7 + j) % 5) for j in range(16)]
                call("/v1/records", {"records": [{
                    "tenant_id": 0, "record_id": i, "modality": "image",
                    "algorithm": "embedding-image-local", "fingerprint": [1],
                    "embedding": vec}]})
                call("/v1/query", {"tenant_id": 0, "modality": "image", "k": 3,
                                   "vector": vec})

        t = threading.Thread(target=traffic)
        t.start()
        st, body = _post(f"http://127.0.0.1:{prof}/trace?duration_ms=1500"
                         f"&dir={tmp_path / 'traces'}")
        done.set()
        t.join(60)
        assert not errors, errors
        assert st == 200 and os.path.exists(body["trace"]), body
        trace = json.load(open(body["trace"]))
        assert trace["traceEvents"] and body["events"] > 0
    finally:
        proc.terminate()
        proc.wait(30)


def test_profiler_endpoint_answers_and_refuses(tmp_path):
    srv = profiler.start_profiler_server(0)
    port = srv.server_address[1]
    try:
        stop = threading.Event()

        def work():  # operators on another thread, inside the window
            x = torch.randn(64, 64)
            while not stop.is_set():
                (x @ x).sum()

        t = threading.Thread(target=work)
        t.start()
        st, body = _post(f"http://127.0.0.1:{port}/trace?duration_ms=300&dir={tmp_path}")
        stop.set()
        t.join()
        assert st == 200 and body["duration_ms"] == 300.0
        names = {e.get("name") for e in json.load(open(body["trace"]))["traceEvents"]}
        assert "aten::mm" in names  # the other thread's product
        assert _post(f"http://127.0.0.1:{port}/trace?duration_ms=0")[0] == 400
        assert _post(f"http://127.0.0.1:{port}/trace?duration_ms=abc")[0] == 400
        assert _post(f"http://127.0.0.1:{port}/other")[0] == 404
        # one trace at a time
        slow = threading.Thread(target=_post, args=(
            f"http://127.0.0.1:{port}/trace?duration_ms=1500&dir={tmp_path}",))
        slow.start()
        deadline = time.time() + 30
        while not profiler._Handler.busy.locked() and time.time() < deadline:
            time.sleep(0.01)
        assert _post(f"http://127.0.0.1:{port}/trace?duration_ms=10&dir={tmp_path}")[0] == 409
        slow.join(30)
        # a port that is taken: an error at start, not a quiet no-op
        with pytest.raises(OSError):
            profiler.start_profiler_server(port)
    finally:
        srv.shutdown()
        srv.server_close()


def test_bench_writes_a_trace_under_profile_dir(tmp_path, monkeypatch, capsys):
    for name in ("UCFP_BENCH_FULL", "UCFP_BENCH_BUDGET_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("UCFP_BENCH_ONLY", "text")
    monkeypatch.setenv("UCFP_PROFILE_DIR", str(tmp_path / "prof"))
    fn = bench.bench_text_minhash
    monkeypatch.setattr(bench, "bench_text_minhash", lambda dev, **kw: fn(dev, n=3))
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last["extra"]["text_minhash_docs_per_sec"] > 0
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == f"ucfp-bench-{os.getpid()}.json" and "trace written" in out.err
    assert json.load(open(tmp_path / "prof" / trace))["traceEvents"]


@pytest.mark.parametrize("mode,name", [
    ("", "libucfpwal.so"),
    ("address,undefined", "libucfpwal.address-undefined.san.so"),
    ("address", "libucfpwal.address.san.so"),
    ("thread", "libucfpwal.thread.san.so"),
])
def test_sanitized_builds_have_their_own_names(monkeypatch, mode, name):
    monkeypatch.setenv("UCFP_NATIVE_SANITIZE", mode)
    assert _build.host_lib_name("libucfpwal.so") == name
    flags = _build.sanitize_flags()
    assert flags == ([f"-fsanitize={mode}", "-fno-omit-frame-pointer", "-g"] if mode else [])


def _libasan():
    try:
        out = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                             timeout=30, text=True)
        p = out.stdout.strip()
        return p if p and os.path.exists(p) else None
    except (OSError, subprocess.TimeoutExpired):
        return None


@pytest.mark.skipif(_libasan() is None, reason="no g++/libasan toolchain")
def test_native_modules_clean_under_asan_ubsan():
    from ucfp_tpu_torch.native.sanitize import run_sanitized

    proc = run_sanitized("address,undefined", timeout=600)
    assert proc.returncode == 0, f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}"
    assert proc.stdout.strip().splitlines()[-1] == "SANITIZE_DRIVER_OK"
    for mod in ("wal", "bm25", "http", "imgbatch", "textsig"):
        assert os.path.exists(os.path.join(
            _build.BUILD_DIR, f"libucfp{mod}.address-undefined.san.so")), mod
