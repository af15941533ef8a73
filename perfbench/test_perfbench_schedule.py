"""The load and its inputs repeat exactly from --seed."""

import numpy as np
import pytest

from perfbench import catalog, schedule
from perfbench.conftest import small_cell

SEEDS = (0, 1, 2**31 + 5, 2**40 + 3, -7)


def test_open_loop_is_one_trace_for_every_seed():
    a = schedule.open_loop(12.0, 5.0, 30.0)
    b = schedule.open_loop(12.0, 5.0, 30.0)
    assert np.array_equal(a["due"], b["due"])
    assert a["n_window"] == 360 and a["n_warm"] == 60
    win = a["due"][a["n_warm"]:]
    assert win.min() == 5.0 and win.max() < 35.0
    assert np.all(np.diff(a["due"]) >= 0)
    assert np.std(np.diff(win)) > 0.5 / 12.0  # exponential gaps, not a metronome
    assert abs(np.mean(np.diff(win)) - 1 / 12.0) < 0.01


def test_items_and_catalog_repeat():
    cell = small_cell("multi-open8")
    k = cell.kind
    a = k.make_items(cell.config, cell.traffic, 2**33 + 1, 6, "cpu")
    b = k.make_items(cell.config, cell.traffic, 2**33 + 1, 6, "cpu")
    c = k.make_items(cell.config, cell.traffic, 2**33 + 2, 6, "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    x = k.catalog_chunk(cell.config, 9, 0, 100, "cpu")
    y = k.catalog_chunk(cell.config, 9, 0, 100, "cpu")
    assert bool((x == y).all())
    assert k.bodies(a, cell.config, cell.traffic) == k.bodies(b, cell.config, cell.traffic)


def test_multi_copies_are_stored_rows_edited():
    cell = small_cell("multi-open8", rows=2000)
    items = cell.kind.make_items(cell.config, cell.traffic, 3, 40, "cpu").reshape(-1, 536)
    cat = cell.kind.catalog_chunk(cell.config, 3, 0, 2000, "cpu").numpy()
    blocks = np.abs(items[:, None, 280:].astype(int) - cat[None, :, 280:].astype(int))
    near = (blocks.max(-1) <= 4).any(1)
    assert near.sum() == round(0.1 * len(items))


@pytest.mark.parametrize("seed", SEEDS)
def test_record_ids_are_a_bijection(seed):
    rids = catalog.record_ids(seed, 5000, 300)
    assert len(set(rids)) == 300
    assert [catalog.row_of(seed, r, 10**6) for r in rids] == list(range(5000, 5300))
    assert catalog.row_of(seed, rids[0], 5000) == -1
    assert catalog.row_of(seed, -1, 10**6) == -1
