"""A cell, a traffic mix and a metric written only as new files are found
and run without a code edit."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT

SNIPPET = """
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
sys.path[0:0] = [str(root), sys.argv[2]]
from perfbench import harness
cell = harness.Cell(root, "tablev-fused.sparse")
out = harness.measure(cell, 2**31 + 9, 0.0, False, "cpu", time.perf_counter(), batch=2)
line = harness.result_line(cell, out, False, {"platform": "cpu", "kind": "cpu", "count": 1})
print(json.dumps({"correct": out["correct"], "steps": out["record"]["steps"],
                  "metrics": sorted(line["metrics"]), "lines": out["lines"]}))
"""


def test_new_cell_from_data_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tablev-fused.sparse", "config": "tablev-fused",
                               "traffic": "sparse", "chips": 1, "why": "a test's cell"})
    # a metric whose name holds a dot, read from a file of that name
    bench["end_to_end"].append({"name": "stream_steps_per_s.sparse", "unit": "stream-steps/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tablev-fused.sparse"]})
    shutil.copy(ROOT / "perfbench" / "metrics" / "stream_steps_per_s.py",
                tmp_path / "perfbench" / "metrics" / "stream_steps_per_s.sparse.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "perfbench" / "traffic" / "gaps.json").read_text())
    mix.update(steps=4, events_per_step=4, on_steps=2, onset_max=2)
    (tmp_path / "perfbench" / "traffic" / "sparse.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "perfbench" / "workloads" / "tablev-fused.gaps.json").read_text())
    spec.update(check_batches=1, check_within=1)
    (tmp_path / "perfbench" / "workloads" / "tablev-fused.sparse.json").write_text(
        json.dumps(spec))
    done = subprocess.run([sys.executable, "-c", SNIPPET, str(tmp_path), str(ROOT / "src")],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["correct"], got["lines"]
    assert got["steps"] == 4
    assert {"setup_s", "stream_steps_per_s", "stream_steps_per_s.sparse"} <= set(got["metrics"])
