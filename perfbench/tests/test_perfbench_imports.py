"""Nothing the benchmark runs is JAX or the JAX package, and the reference
takes nothing from the program. Top-level module names are compared whole:
``repro_torch`` is not ``repro``."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = ROOT / "perfbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_under_perfbench_imports_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = set(_imports(path))
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "dataclasses", "math", "numpy", "torch",
                        "perfbench"}, (path, tops)


SNIPPET = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[0:0] = [str(root), str(root / "src")]
import perfbench.run, perfbench.harness, perfbench.trace, perfbench.traffic, perfbench.readings
from perfbench import harness
cell = harness.Cell(root, "tablev-fabric.flash")
driver = cell.driver()
system = driver.System(cell.config, cell.mix, cell.spec, "cpu", batch=1)
system.build()
for m in cell.bench["end_to_end"] + cell.bench["per_layer"]:
    cell.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax_and_no_repro():
    done = subprocess.run([sys.executable, "-c", SNIPPET, str(ROOT)], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    tops = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
