"""The device trace of a traced run, and its reduction.

torch.profiler is started and stopped once, on the harness's main
thread, with CUDA activity alone: CUPTI records the kernels, copies and
sets of every thread of the process, and no operator of any thread is
recorded on the host (on an H100, a third session in one process, with
CPU activity, beside a thread that launched, aborted the process with
"double free or corruption"). The profiler's one-time preparation
(CUPTI's set-up: 7-35 s on an H100, stalling the process) is made in
set-up, before any traffic, so that the traced part starts when it is
due and no request waits behind it. The events'
times, on the wall clock, are put on the monotonic clock that the
harness's spans and the load generator use."""

from __future__ import annotations

import time

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _wall_minus_mono_ns() -> int:
    a = time.monotonic_ns()
    w = time.time_ns()
    b = time.monotonic_ns()
    return w - (a + b) // 2


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t_start = self.t_stop = 0.0

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.cuda = self.torch.cuda.is_available()
        # the host-only build has no CUDA activity; its traces are empty
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        t = time.monotonic()
        self.prof.prepare_trace()
        self.prepare_s = time.monotonic() - t

    def start(self) -> None:
        self.prof.start_trace()
        self.offset_ns = _wall_minus_mono_ns()
        self.t_start = time.monotonic()

    def stop(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        self.t_stop = time.monotonic()
        self.offset_ns = (self.offset_ns + _wall_minus_mono_ns()) // 2
        self.prof.stop_trace()

    def device_events(self) -> list[tuple[str, str, float, float]]:
        """(name, activity, start, end) of every device operation, in
        monotonic seconds, cut to the traced part."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            act = _activity(ev, self.torch)
            if act not in DEVICE_ACTIVITIES:
                continue
            a = (ev.start_ns() - self.offset_ns) / 1e9
            b = a + ev.duration_ns() / 1e9
            a, b = max(a, self.t_start), min(b, self.t_stop)
            if b > a:
                out.append((ev.name(), act, a, b))
        return out


def _activity(ev, torch) -> str:
    """The event's kind; torch builds without activity_type() tell a
    device operation by its device type and a copy or set by its name."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if ev.device_type() != torch.autograd.DeviceType.CUDA or (
            hasattr(ev, "is_user_annotation") and ev.is_user_annotation()):
        return "other"
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _covered(spans, t: float) -> bool:
    return any(a <= t < b for a, b in spans)


def _overlap(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(events, t_start: float, t_stop: float, index_spans, request_spans) -> dict:
    """Busy and kernel time, the device operations that took most time,
    and the longest idle gaps, each labelled by what the host was doing:
    inside a call of the index layer, serving a request outside it, or
    nothing (no request in flight). Also the time in which a request was
    in flight and no device operation ran (`served_idle_s`), and the
    requests it is spread over (`served_requests`: each request counts
    by the share of its time in flight that lies in the traced part)."""
    busy = union([(a, b) for _, _, a, b in events])
    kernels = union([(a, b) for _, act, a, b in events if act == "kernel"])
    by_name: dict[str, float] = {}
    for name, _, a, b in events:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    edges = [t_start] + [x for iv in busy for x in iv] + [t_stop]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    index_spans = sorted(index_spans)
    request_spans = sorted(request_spans)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        if _covered(index_spans, mid):
            label = "host inside an index call (snapshot, launches, resolve)"
        elif _covered(request_spans, mid):
            label = "host serving a request outside the index (HTTP, middleware, JSON)"
        else:
            label = "no request in flight"
        labelled.append([label, b - a])
    window = t_stop - t_start
    clipped = [(max(a, t_start), min(b, t_stop)) for a, b in request_spans]
    in_flight = union([(a, b) for a, b in clipped if b > a])
    served_requests = sum((min(b, t_stop) - max(a, t_start)) / (b - a)
                          for a, b in request_spans if min(b, t_stop) > max(a, t_start))
    in_flight_s = sum(b - a for a, b in in_flight)
    return {
        "window_s": window,
        "busy_s": sum(b - a for a, b in busy),
        "kernel_s": sum(b - a for a, b in kernels),
        "kernels": sum(1 for e in events if e[1] == "kernel"),
        "device_ops": [[n[:160], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": labelled,
        "in_flight_s": in_flight_s,
        "served_idle_s": in_flight_s - _overlap(in_flight, busy),
        "served_requests": served_requests,
        "t_start": t_start,
        "t_stop": t_stop,
    }
