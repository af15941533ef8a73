"""The traced run on a card at a small size: the profiler's device
events are read, and every share stays a share. Skips without a card
(python -m pytest perfbench/test_perfbench_card.py on the chip)."""

import pytest

from perfbench.conftest import run_small


@pytest.mark.parametrize("name", ["multi-open8"])
def test_traced_run_reads_the_device(name, card):
    out = run_small(name, traced=True, seconds=50.0, device=card)
    res = out["result"]
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert res["breakdown"]["device_ops"]
    for m, v in res["metrics"].items():
        if m.endswith("_pct") or "roofline" in m:
            assert 0 <= v["value"] <= 105, (m, v)
