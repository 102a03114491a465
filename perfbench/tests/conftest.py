"""Shared set-up of the benchmark's own tests: the repository root and the
port's package on the path, and a small cell run on the CPU."""

import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("tablev-fused.flash", "tablev-fabric.flash", "tablev-fused.gaps", "tablev-fabric.gaps")


def small_cell(name: str, steps: int | None = None, check_batches: int = 1):
    """The cell's files, with one checked batch among the first and, when
    given, streams of ``steps`` steps."""
    from perfbench import harness

    cell = harness.Cell(ROOT, name)
    cell.spec = dict(copy.deepcopy(cell.spec), check_batches=check_batches,
                     check_within=check_batches, trace_batches=1)
    if steps is not None:
        cell.mix = dict(cell.mix, steps=steps)
    return cell


def run_small(cell, seed: int = 2**31 + 3, batch: int = 4, traced: bool = False) -> dict:
    """One run of ``cell`` on the CPU through the port's plain versions:
    set-up, a window that ends after its first batch, and the comparison."""
    from perfbench import harness

    return harness.measure(cell, seed, 0.0, traced, "cpu", time.perf_counter(), batch=batch)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's delivery kernels have no CPU mode")
    return torch.device("cuda", 0)
