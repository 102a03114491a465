"""The engine's profiler spans (``repro_torch/core/tracing.py``) on the CPU.

Under ``torch.profiler`` an ``EventEngine.run`` over T steps shows
``repro_torch.run`` once and ``step``, ``deliver``, ``deliver.queue`` (on
every queued path) and ``neuron`` T times each, nested on the host thread
as the engine calls them. With the profiler on or off the engine computes
the same bits, and with it off :func:`span` opens no ``record_function``.
Table-V tables, B = 2, T = 3.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import cnn as tcnn
from repro_torch.core import event_engine as tee
from repro_torch.core import tracing
from repro_torch.serve import aer as taer

B, T = 2, 3
# engine path -> does a step fill the AER queue (compaction or ring admission)
PATHS = {"fused": True, "fabric_ring": True, "fabric_roll": True, "queued": True,
         "dense": False}
SPANS = ("run", "step", "deliver", "deliver.queue", "neuron")


@pytest.fixture(scope="module")
def tables():
    return tcnn.compile_poker_cnn().tables


def _engine(path, tables):
    if path == "fused":
        return taer.build_poker_engine(tables, "fused", device="cpu")
    if path == "fabric_ring":
        return taer.build_poker_engine(tables, "fabric", device="cpu")
    if path == "fabric_roll":
        return taer.build_poker_engine(tables, "fabric", device="cpu",
                                       fabric_options={"ring": False})
    return tee.EventEngine(tables, queue_capacity=64 if path == "queued" else None,
                           device="cpu")


def _inputs(tables, seed=3):
    rng = np.random.default_rng(seed)
    shape = (T, B, tables.n_clusters, tables.k_tags)
    return (rng.random(shape) < 0.02).astype(np.float32) * 8.0


def _leaves(tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if hasattr(tree, "_fields"):
        return [x for name in tree._fields for x in _leaves(getattr(tree, name))]
    return [x for item in tree for x in _leaves(item)]


def _run(engine, tables):
    return engine.run(engine.init_state(batch=B), _inputs(tables))


def _spans(prof) -> dict[str, list]:
    out = {name: [] for name in SPANS}
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            out[e.name.removeprefix("repro_torch.")].append(e)
    return out


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_count_and_nest_over_a_run(path, tables):
    engine = _engine(path, tables)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(engine, tables)
    spans = _spans(prof)
    want = {"run": 1, "step": T, "deliver": T, "deliver.queue": T if PATHS[path] else 0,
            "neuron": T}
    assert {k: len(v) for k, v in spans.items()} == want
    (run,) = spans["run"]
    for step in spans["step"]:
        assert _inside(step, run)
    for name in ("deliver", "neuron"):
        for e in spans[name]:
            assert sum(_inside(e, step) for step in spans["step"]) == 1, name
    for e in spans["deliver.queue"]:
        assert sum(_inside(e, d) for d in spans["deliver"]) == 1


@pytest.mark.parametrize("path", list(PATHS))
def test_profiler_on_and_off_compute_the_same_bits(path, tables):
    engine = _engine(path, tables)
    off = _leaves(_run(engine, tables))
    with profile(activities=[ProfilerActivity.CPU]):
        on = _leaves(_run(engine, tables))
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


def test_span_is_the_shared_no_op_with_the_profiler_off(monkeypatch, tables):
    assert tracing.span("repro_torch.step") is tracing.span("repro_torch.neuron")
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("repro_torch.step")
    assert isinstance(on, torch.autograd.profiler.record_function)

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was entered with the profiler off")

    monkeypatch.setattr(tracing._profiler, "record_function", refuse)
    engine = _engine("fabric_ring", tables)
    _run(engine, tables)
    _run(_engine("fused", tables), tables)
