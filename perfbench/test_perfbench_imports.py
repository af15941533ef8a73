"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ucfp_tpu_torch begins with ucfp_tpu), and
the plain references load nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ucfp_tpu"}


def _top_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = _top_modules(
        "import perfbench.run, perfbench.loadgen, perfbench.check, perfbench.trace, "
        "perfbench.server, perfbench.readers, perfbench.faults\n"
        "from perfbench import spec\n"
        "b = spec.load_benchmark()\n"
        "[spec.Cell(b, w['name']).kind for w in b['workloads']]\n"
        "[spec.metric_reader(m['name']) for m in b['per_layer']]\n"
        "import ucfp_tpu_torch.server.app, ucfp_tpu_torch.index.embedded")
    assert "ucfp_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_a_whole_small_run_loads_no_jax():
    mods = _top_modules(
        "from perfbench.conftest import run_small\n"
        "assert run_small('multi-open8')['result']['correct']")
    assert not mods & FORBIDDEN


def test_references_load_nothing_of_the_program():
    mods = _top_modules("import perfbench.reference.multi")
    assert not mods & (FORBIDDEN | {"ucfp_tpu_torch"})


def test_no_source_names_a_forbidden_module():
    for path in glob.glob(os.path.join(spec.HERE, "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if os.sep + "reference" + os.sep in path:
                    assert n.split(".")[0] != "ucfp_tpu_torch", (path, n)


def test_no_all_threads_profiling():
    for path in glob.glob(os.path.join(spec.HERE, "**", "*.py"), recursive=True):
        assert "profile_all_" + "threads" not in open(path).read(), path
