"""Without a card, or without the program, a run exits non-zero and prints
no result."""

import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

ARGS = ["--workload", "tablev-fused.flash", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_run_without_a_card_exits_nonzero_and_prints_nothing(no_card):
    done = _run(ROOT)
    assert done.returncode != 0
    assert done.stdout == ""
    assert "CUDA" in done.stderr


def test_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = _run(tmp_path)
    assert done.returncode != 0
    assert done.stdout == ""
