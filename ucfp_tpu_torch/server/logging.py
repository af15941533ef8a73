"""Structured JSON request logging (reference: tracing_subscriber JSON
init at src/bin/ucfp.rs:209-215 + TraceLayer per-request spans).

One JSON line per request to stderr; level filtered via UCFP_LOG
(error|warn|info|debug, default info), mirroring the reference's
EnvFilter default `ucfp=info`.

Copied from ucfp_tpu/server/logging.py; only its imports and one comment
differ (it no longer quotes the reference's measurements).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

_LEVELS = {"error": 40, "warn": 30, "info": 20, "debug": 10}


class JsonLogger:
    # info-line buffering: the per-request write+flush syscall pair is
    # a visible share of a small request's host time. info lines coalesce into ONE write per <=64 lines /
    # 100 ms window; warn+ and anything after them flush immediately
    # (errors are never delayed), and close()/atexit drains the tail.
    # UCFP_LOG_FLUSH=line restores per-line flushing.
    _MAX_BUF = 64
    _MAX_HOLD_S = 0.1

    def __init__(self, stream=None, level: str | None = None):
        self.stream = stream or sys.stderr
        self.level = _LEVELS.get(
            (level or os.environ.get("UCFP_LOG", "info")).lower(), 20
        )
        self._line_flush = (
            os.environ.get("UCFP_LOG_FLUSH", "").lower() == "line")
        self._buf: list[str] = []
        self._buf_t = 0.0
        # the logger is shared between the asyncio loop, the warmup
        # thread, and to_thread workers: append+flush must be atomic or
        # concurrent flushes double-write / drop lines
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None

    def _drain(self) -> None:
        """Swap the buffer out under the lock, then write outside it."""
        with self._lock:
            buf, self._buf = self._buf, []
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        if not buf:
            # still flush the stream: a caller may rely on close() to
            # push through any line a previous write left in libc
            try:
                self.stream.flush()
            except (ValueError, OSError):
                pass
            return
        # the atexit drain can run after the interpreter (or a test
        # harness) already closed the stream — dropping the tail lines
        # then is fine, raising at exit is not
        try:
            self.stream.write("".join(buf))
            self.stream.flush()
        except (ValueError, OSError):
            pass

    def log(self, level: str, msg: str, **fields) -> None:
        lv = _LEVELS.get(level, 20)
        if lv < self.level:
            return
        rec = {
            "ts": round(time.time(), 6),
            "level": level,
            "msg": msg,
            **fields,
        }
        # default=repr: a log call in the request path must never raise
        # on a non-JSON-serializable field (bytes, exceptions, Paths)
        line = json.dumps(rec, separators=(",", ":"), default=repr) + "\n"
        # only the hot per-request access lines buffer: lifecycle lines
        # ("listening", "draining", ...) are watched live by operators
        # and subprocess tests, and warn+ must never be delayed
        if self._line_flush or lv >= 30 or msg != "request":
            with self._lock:
                self._buf.append(line)
            self._drain()
            return
        drain = False
        with self._lock:
            now = time.monotonic()
            if not self._buf:
                self._buf_t = now
                # after a burst stops, nothing would ever evaluate the
                # 100 ms deadline — a daemon timer guarantees the hold
                # window to an operator tailing the log
                if self._timer is None:
                    t = threading.Timer(self._MAX_HOLD_S, self._drain)
                    t.daemon = True
                    self._timer = t
                    t.start()
            self._buf.append(line)
            drain = (len(self._buf) >= self._MAX_BUF
                     or now - self._buf_t >= self._MAX_HOLD_S)
        if drain:
            self._drain()

    def close(self) -> None:
        self._drain()

    def info(self, msg: str, **fields) -> None:
        self.log("info", msg, **fields)

    def warn(self, msg: str, **fields) -> None:
        self.log("warn", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self.log("error", msg, **fields)

    def debug(self, msg: str, **fields) -> None:
        self.log("debug", msg, **fields)


_GLOBAL: JsonLogger | None = None


def logger() -> JsonLogger:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = JsonLogger()
        import atexit

        atexit.register(_GLOBAL.close)
    return _GLOBAL
