"""What the per-layer metric readers share. A reader takes the run's
context and returns a number, or None where it finds nothing to read
(the harness then leaves the metric out of the line).

The context: `cfg` and `traffic` (the cell's files), `window` (t0, t_end
on the monotonic clock), `counters` (the program's /metrics text at the
window's start and end), `index_spans` (start, end of every call of the
index layer's entry, timed by the harness around the bound method),
`trace` (trace.reduce's dict, or None) and `peaks` (peaks.peaks_for)."""

from __future__ import annotations

import importlib
import re

from perfbench import peaks as peaks_mod


def _counter(text: str, name: str, method: str, path: str) -> float | None:
    pat = re.compile(r'^%s\{method="%s",path="%s"\} (\S+)$'
                     % (re.escape(name), re.escape(method), re.escape(path)), re.M)
    m = pat.search(text)
    return float(m.group(1)) if m else None


def server_ms(ctx: dict) -> float | None:
    """Mean server time of POST /v1/query over the window, from the
    program's Prometheus histogram's _sum and _count."""
    vals = {}
    for when in ("start", "end"):
        text = ctx["counters"][when]
        vals[when] = [_counter(text, "ucfp_http_request_duration_seconds_" + s,
                               "POST", "/v1/query") or 0.0 for s in ("sum", "count")]
    n = vals["end"][1] - vals["start"][1]
    return (vals["end"][0] - vals["start"][0]) / n * 1e3 if n > 0 else None


def index_ms(ctx: dict) -> float | None:
    """Mean wall time of the index layer's calls that began in the window."""
    t0, t1 = ctx["window"]
    d = [b - a for a, b in ctx["index_spans"] if t0 <= a < t1 and b >= a]
    return sum(d) / len(d) * 1e3 if d else None


def idle_ms(ctx: dict) -> float | None:
    """Time in which a request was in flight and the card ran nothing, per
    request, ms: what the host adds to a request while the card waits.
    Time with no request in flight (gaps between an open loop's arrivals)
    is left out, and it is a time, not a share of the request's, so that
    a faster kernel reads no worse."""
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0 or tr["served_requests"] <= 0:
        return None
    return 1e3 * tr["served_idle_s"] / tr["served_requests"]


def roofline_pct(ctx: dict, kind: str) -> float | None:
    """The least time of the calls of the index layer in the traced part
    (a call counts by the share of its span inside it) over the time in
    which a kernel ran there, in %, for a cell of configuration kind
    `kind`; None elsewhere."""
    tr, pk = ctx["trace"], ctx["peaks"]
    if ctx["cfg"]["kind"] != kind or tr is None or pk is None or tr["kernel_s"] <= 0:
        return None
    work = importlib.import_module(f"perfbench.kinds.{kind}").least_work(
        ctx["cfg"], ctx["traffic"])
    least, _ = peaks_mod.least_time_s(pk, **work)
    calls = 0.0
    for a, b in ctx["index_spans"]:
        if b > a:
            calls += max(0.0, min(b, tr["t_stop"]) - max(a, tr["t_start"])) / (b - a)
    return 100.0 * calls * least / tr["kernel_s"] if calls > 0 else None
