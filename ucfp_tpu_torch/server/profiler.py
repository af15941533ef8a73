"""On-demand trace endpoint (UCFP_PROFILER_PORT): the port's counterpart
of the reference's jax.profiler.start_server.

PyTorch has no live profiler server to attach a viewer to, so this is
the nearest equivalent: a loopback HTTP endpoint that, per request,
records torch.profiler (CPU activity, and CUDA activity when the process
holds a card) for a stated window and writes the Chrome trace to a
directory, for chrome://tracing or Perfetto.

    curl -X POST 'http://127.0.0.1:PORT/trace?duration_ms=2000&dir=/tmp/traces'
    -> {"trace": "/tmp/traces/ucfp-<pid>-<n>.json", "duration_ms": 2000,
        "events": N}

The profiler records every thread of the process, so requests the server
answers during the window (on its event loop and its worker threads)
appear in the trace. One trace at a time (409 while one runs). `dir`
defaults to UCFP_PROFILE_DIR, else <tmp>/ucfp-traces. A trace that
cannot be recorded answers 500 with the reason; a port that cannot be
bound raises at start.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections.abc import Callable
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TypeVar
from urllib.parse import parse_qs, urlparse

MAX_WINDOW_MS = 60_000
_TRACE_SEQ = itertools.count(1)  # trace file numbers in this process
T = TypeVar("T")


def record_trace(work: Callable[[], T], out_dir: str, name: str | None = None
                 ) -> tuple[T, dict]:
    """Run work() under torch.profiler (CPU activity, and CUDA activity
    when the process holds a card) and write a Chrome trace into out_dir
    as name (default ucfp-<pid>-<n>.json); -> (work's result,
    {"trace": path, "events": count})."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name or f"ucfp-{os.getpid()}-{next(_TRACE_SEQ)}.json")
    # the CPU operators of every thread, not only this one's: the server
    # runs them on its event loop and its worker threads (CUDA kernels
    # are recorded process-wide either way)
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=config) as prof:
        out = work()
    prof.export_chrome_trace(path)
    return out, {"trace": path, "events": len(prof.events())}


class _Handler(BaseHTTPRequestHandler):
    busy = threading.Lock()

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):  # noqa: N802 - http.server's name
        url = urlparse(self.path)
        if url.path != "/trace":
            return self._reply(404, {"error": "not_found"})
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            ms = float(q.get("duration_ms", "1000"))
        except ValueError:
            return self._reply(400, {"error": "duration_ms must be a number"})
        if not 0 < ms <= MAX_WINDOW_MS:
            return self._reply(400, {"error": f"duration_ms must be in (0, {MAX_WINDOW_MS}]"})
        out_dir = q.get("dir") or os.environ.get("UCFP_PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "ucfp-traces")
        if not self.busy.acquire(blocking=False):
            return self._reply(409, {"error": "a trace is already being recorded"})
        try:
            _, body = record_trace(lambda: time.sleep(ms / 1000.0), out_dir)
            body["duration_ms"] = ms
        except Exception as e:
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            self.busy.release()
        self._reply(200, body)

    do_GET = do_POST

    def log_message(self, fmt, *args):  # request lines stay off stderr
        pass


def start_profiler_server(port: int, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve the trace endpoint on host:port from a daemon thread; raises
    OSError when the port cannot be bound."""
    from .logging import logger

    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, name="ucfp-profiler", daemon=True).start()
    logger().info("profiler", port=srv.server_address[1])
    return srv
