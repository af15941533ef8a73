"""The reduction of a device trace, on made-up events: busy time, and the
idle time with a request in flight that device_idle_ms.* reads."""

import pytest

from perfbench import spec, trace


def _ctx(events, requests, t0=0.0, t1=5.0):
    return {"trace": trace.reduce(events, t0, t1, [], requests)}


READ = spec.metric_reader("device_idle_ms.multi")


def test_idle_is_counted_only_while_a_request_is_in_flight():
    events = [("k", "kernel", 1.0, 1.5), ("k", "kernel", 3.05, 3.1)]
    ctx = _ctx(events, [(0.9, 1.6), (3.0, 3.2)])
    tr = ctx["trace"]
    assert tr["busy_s"] == pytest.approx(0.55)
    assert tr["in_flight_s"] == pytest.approx(0.9)
    # 0.2 + 0.15 s idle in flight over 2 requests; the 1.4 s between them is left out
    assert READ(ctx) == pytest.approx(175.0)


def test_a_faster_kernel_reads_no_worse():
    slow = _ctx([("k", "kernel", 1.0, 1.5)], [(0.9, 1.6)])
    fast = _ctx([("k", "kernel", 1.0, 1.05)], [(0.9, 1.15)])
    assert READ(fast) <= READ(slow)


def test_overlapping_requests_share_the_idle_time():
    # two requests in flight together, the card idle for all of it but 0.1 s
    ctx = _ctx([("k", "kernel", 1.2, 1.3)], [(1.0, 2.0), (1.5, 2.0)])
    assert ctx["trace"]["served_idle_s"] == pytest.approx(0.9)
    assert READ(ctx) == pytest.approx(450.0)


def test_a_request_counts_by_its_share_inside_the_traced_part():
    ctx = _ctx([("k", "kernel", 0.1, 0.2)], [(-1.0, 1.0)], t0=0.0, t1=5.0)
    assert ctx["trace"]["served_requests"] == pytest.approx(0.5)
    assert READ(ctx) == pytest.approx(1e3 * 0.9 / 0.5)


def test_nothing_to_read_without_a_request_or_a_device_operation():
    assert READ(_ctx([("k", "kernel", 1.0, 1.5)], [])) is None
    assert READ(_ctx([], [(1.0, 2.0)])) is None
