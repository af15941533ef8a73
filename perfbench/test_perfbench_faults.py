"""The comparison that decides `correct`, driven end to end at a small
size on the CPU (the look for a card skipped): a sound run is correct;
the control (the reference in the next precision down, in the program's
place) and each fault that the cell can have are not."""

import pytest

from perfbench.conftest import run_small, small_cell

CELLS = ("multi-open8",)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_small(name)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert out["extra"]["sample"]["requests"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run_small(name, inject="control")["result"]
    assert not res["correct"]
    limits = small_cell(name).config["limits"]
    assert res["checks"]["score_gap"]["value"] > 3 * limits["score_gap"]


# a multi request carries 8 queries, so half of its batch can be left out
FAULTS = [(c, f) for c in CELLS for f in ("answer_altered", "half_catalog", "half_batch")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
    res = run_small(name, inject=fault)["result"]
    assert not res["correct"], res["checks"]
