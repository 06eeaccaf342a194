"""What the benchmark loads: nothing of JAX, flax, the JAX package or the
root `bench` script, anywhere under `benchmark/`; and nothing of the
measured program in the reference.  Top-level module names are compared
whole (`peppa_tpu_torch` is not `peppa_tpu`)."""

import ast
import json
import subprocess
import sys

from benchmark.cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "peppa_tpu", "bench"}
DIR = ROOT / "benchmark"


def imported(path):
    """Top-level names of every import in a file, lazy ones included."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_file_imports_jax_or_the_jax_package():
    for path in DIR.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (DIR / "reference").rglob("*.py"):
        assert "peppa_tpu_torch" not in imported(path), path
    loaded = loaded_after("import benchmark.reference.model, "
                          "benchmark.reference.train, "
                          "benchmark.reference.serve")
    assert "peppa_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_a_run_loads_no_jax():
    loaded = loaded_after(
        "import benchmark.run, benchmark.calibrate\n"
        "import benchmark.kinds.train, benchmark.kinds.serve, "
        "benchmark.kinds.encode\n"
        "from benchmark.cells import Bench\n"
        "b = Bench()\n"
        "[b.reader(m['name']) for g in ('end_to_end', 'per_layer') "
        "for m in b.spec[g]]")
    assert "peppa_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
