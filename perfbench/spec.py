"""What a cell is made of, found by name: the cell in BENCHMARK.json, its
configuration file, its traffic mix, the kind module that makes the
configuration's data, its plain reference, and the per-layer metric
readers. Nothing here knows a particular cell; a later change adds a
cell, a configuration, a mix or a metric by adding files and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK_JSON = os.path.join(ROOT, "BENCHMARK.json")


def load_benchmark(path: str = BENCHMARK_JSON) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with its configuration, mix and metrics."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.traffic = _load_json(os.path.join(root, "perfbench", "traffic",
                                               self.entry["traffic"] + ".json"))
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    @property
    def kind(self):
        """The module that makes this configuration's data and requests."""
        return importlib.import_module(f"perfbench.kinds.{self.config['kind']}")

    @property
    def reference(self):
        """The plain reference of this configuration's answers."""
        return importlib.import_module(f"perfbench.reference.{self.config['kind']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str):
    """The reader of per-layer metric `name`: perfbench/metrics/<name>.py,
    whose read(ctx) returns a number or None (nothing to read)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
