"""BENCHMARK.json against the contract's shape, and every file it names:
each cell, configuration, mix and per-layer metric loads, and a cell
defined only by new data files is found."""

import json
import os
import re
import shutil

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert all("/" not in w or w.startswith("perfbench") for w in BENCH["command"])


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


ALL = BENCH


@pytest.mark.parametrize("name", [w["name"] for w in ALL["workloads"]])
def test_cell_loads(name):
    cell = spec.Cell(ALL, name)
    assert cell.chips == 1
    assert cell.kind.INDEX_METHOD and cell.reference.scores
    assert set(cell.config["limits"]) == {"score_gap", "rank_gap", "wrong_hits", "unanswered"}
    assert cell.traffic["loop"] in ("open", "closed")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= e2e


@pytest.mark.parametrize("metric", ALL["per_layer"])
def test_metric_reader_found(metric):
    read = spec.metric_reader(metric["name"])
    assert callable(read)
    assert metric["moves"] in {m["name"] for m in ALL["end_to_end"]}
    ctx = {"cfg": {"kind": "none"}, "traffic": {}, "window": (0.0, 1.0),
           "counters": {"start": "", "end": ""}, "index_spans": [], "trace": None,
           "peaks": None}
    assert read(ctx) is None  # nothing to read: no number, and never 0


def test_config_files_hold_what_the_entries_say():
    for c in ALL["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] and len(c["source"]) <= 200


def _new_mix(root, name: str, **changes) -> dict:
    """A checkout under `root` with the configurations, one new mix file
    (multi-open8's with `changes`) and BENCHMARK.json's entries plus a
    cell of that mix: data files and entries, no code."""
    if not (root / "perfbench" / "configs").exists():
        shutil.copytree(os.path.join(spec.ROOT, "perfbench", "configs"),
                        root / "perfbench" / "configs")
    (root / "perfbench" / "traffic").mkdir(parents=True, exist_ok=True)
    mix = dict(json.load(open(os.path.join(spec.HERE, "traffic", "multi-open8.json"))),
               name=name)
    request = dict(mix["request"], **changes.pop("request", {}))
    mix.update(changes, request=request)
    (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": "disc21-multi-1m",
                               "traffic": name, "chips": 1, "why": "x"})
    return bench


def test_new_cell_from_data_files_alone(tmp_path):
    bench = _new_mix(tmp_path, "multi-open16", rate_per_s=3.0,
                     request={"per_request": 16})
    cell = spec.Cell(bench, "multi-open16", root=str(tmp_path))
    assert cell.traffic["request"]["per_request"] == 16
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    items = cell.kind.make_items(dict(cell.config, rows=500), cell.traffic, 5, 2, "cpu")
    assert items.shape == (2, 16, 536)


def test_closed_loop_mix_from_data_files_alone_runs(tmp_path):
    """A closed loop (clients that each wait for their answer) over the
    multi-hash configuration, from a mix file and entries alone, runs and
    is correct at a small size on the CPU, and reports lookups/s."""
    from perfbench.conftest import run_small, small_cell

    bench = _new_mix(tmp_path, "multi-c4", loop="closed", clients=4,
                     request={"query_pool": 50})
    bench["end_to_end"].append({"name": "lookups_per_s", "unit": "lookups/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["multi-c4"]})
    cell = small_cell("multi-c4", bench=bench, root=str(tmp_path))
    res = run_small("multi-c4", cell=cell)["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["lookups_per_s"]["value"] > 0
