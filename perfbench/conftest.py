"""Shared pieces of the benchmark's own tests (run on the CPU:
python -m pytest perfbench/ -q; tests that need a card skip without one)."""

import time

import pytest

from perfbench import run, spec


def small_cell(name: str, rows: int = 3000, bench: dict | None = None,
               root: str = spec.ROOT) -> spec.Cell:
    """The cell (of BENCHMARK.json, or of `bench` with its files under
    `root`) at a size a CPU test holds: fewer rows, a slow open loop or 4
    clients, a short warm-up and a small check sample."""
    cell = spec.Cell(bench or spec.load_benchmark(), name, root=root)
    cell.config["rows"] = rows
    t = cell.traffic
    t["warmup_s"] = 0.5
    t["trace_s"] = 1.0
    t["check"]["sample_requests"] = 6
    if t["loop"] == "open":
        t["rate_per_s"] = 4.0
    else:
        t["clients"] = 4
        t["request"]["query_pool"] = 200
    return cell


def run_small(name: str, seed: int = 2**31 + 7, inject=None, traced=False,
              seconds=2.0, device="cpu", cell: spec.Cell | None = None) -> dict:
    cell = cell or small_cell(name)
    run.prepare_env(cell.config)
    return run.run_cell(cell, seed, seconds, traced, device, time.monotonic(), inject)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
