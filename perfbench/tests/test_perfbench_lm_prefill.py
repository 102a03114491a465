"""The language-model prefill cell (``drivers/lm_prefill.py``), run small on
the CPU through the harness at the configuration's ``smoke()`` sizes; its
readers on synthetic records; its work counts at the published sizes."""

import copy
import time

import pytest
import torch
from conftest import ROOT

from perfbench import harness
from perfbench.reference import counts_moe_experts, counts_prefill
from perfbench.reference.compare_lm import numbers
from perfbench.reference.compare import verdict

CELL = "deepseek-v2-lite.prefill4k"
SEED = 2**31 + 23


def _small(prompt_len=24):
    from perfbench.drivers import lm_prefill
    from repro_torch.configs import get_config

    cell = harness.Cell(ROOT, CELL)
    cell.config = dict(cell.config, smoke=True,
                       **lm_prefill.published(get_config(cell.config["arch"], smoke=True)))
    cell.mix = dict(cell.mix, prompt_len=prompt_len)
    cell.spec = dict(copy.deepcopy(cell.spec), check_batches=1, check_within=1, trace_batches=1)
    return cell


def test_the_file_holds_the_program_s_published_numbers():
    from perfbench.drivers import lm_prefill
    from repro_torch.configs import get_config

    cell = harness.Cell(ROOT, CELL)
    ours = lm_prefill.published(get_config(cell.config["arch"]))
    assert {k: cell.config[k] for k in ours} == ours
    assert cell.config["reduced"] == [] and cell.entry["chips"] == 1


def test_a_small_traced_run_agrees_with_the_reference_on_the_cpu():
    cell = _small()
    out = harness.measure(cell, SEED, 0.0, True, "cpu", time.perf_counter(), batch=2)
    assert out["correct"], out["lines"]
    assert out["failed"] == 0 and out["values"]["dropped_assignments"] == 0
    assert out["values"]["route_gap"] == 0 and out["values"]["logits_gap"] < 1e-5
    assert out["record"]["steps"] == 24 and out["attempted"] == 2
    line = harness.result_line(cell, out, True, {"platform": "cpu", "kind": "cpu", "count": 1})
    # no device trace on the CPU: the span times and the shares fall silent
    assert set(line["metrics"]) == {"expert_load_max_over_mean", "device_ops_per_prefill"}
    assert line["metrics"]["expert_load_max_over_mean"]["value"] >= 1.0


def test_an_altered_answer_and_a_drop_are_not_correct(monkeypatch):
    from repro_torch.models import moe

    dropless = moe.moe_dropless

    def lossy(params, x, cfg):
        y, aux = dropless(params, x, cfg)
        y = y.clone()
        y[::2] = 0  # half the tokens lose their routed experts
        return y, dict(aux, dropped=aux["dropped"] + x.shape[0] // 2 * cfg.top_k)

    monkeypatch.setattr(moe, "moe_dropless", lossy)
    out = harness.measure(_small(), SEED, 0.0, False, "cpu", time.perf_counter(), batch=2)
    assert not out["correct"], out["lines"]
    assert out["values"]["dropped_assignments"] > 0 and out["failed"] == 2


def test_float8_control_is_not_correct_and_float64_witness_is():
    cell = _small()
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, "cpu", batch=2)
    picks = driver.checked_batches(SEED, cell.spec)
    limits = cell.spec["limits"]
    control = system.reference_answers(SEED, picks, torch.float8_e4m3fn)
    ok, lines = verdict(system.check(SEED, control)[0], limits)
    assert not ok, lines
    witness = system.reference_answers(SEED, picks, torch.float64)
    ok, lines = verdict(system.check(SEED, witness)[0], limits)
    assert ok, lines


def test_sound_answers_read_zero():
    cell = _small(prompt_len=8)
    system = cell.driver().System(cell.config, cell.mix, cell.spec, "cpu", batch=2)
    answers = system.reference_answers(5, [0], torch.float32)
    values, failed = numbers(list(answers.values()), system._reference(5, [0]))
    assert failed == 0 and all(v == 0 for v in values.values())


def _record(work: dict, busy_s=2.0, ops=40000):
    cell = harness.Cell(ROOT, CELL)
    shape = cell.driver().System(cell.config, cell.mix, cell.spec, "cpu").shape()
    return {"trace": {"work": work, "busy_s": busy_s, "indices": [7, 8], "ops": ops},
            "shape": shape}


def test_the_readers_read_the_spans_and_the_counters():
    cell = harness.Cell(ROOT, CELL)
    rows = 2 * 26 * 16384 * 6
    work = {"prefills": 2.0, "tokens": 2 * 16384.0, "mla_s": 2.0, "moe_dispatch_s": 0.1,
            "expert_ffn_s": 0.2, "expert_rows": float(rows), "load_max_over_mean": 3.4,
            "dropped": 0.0}
    got = {m["name"]: cell.reader(m["name"]).read(_record(work))
           for m in cell.metrics("per_layer")}
    assert got["mla_ms_per_prefill"] == pytest.approx(1000.0)
    assert got["moe_dispatch_ms_per_prefill"] == pytest.approx(50.0)
    assert got["expert_ffn_ms_per_prefill"] == pytest.approx(100.0)
    least = 6 * 2048 * 1408 * rows / 989.4e12
    assert got["expert_ffn_roofline"] == pytest.approx(100 * least / 0.2)
    assert got["prefill_mfu"] == pytest.approx(100 * 82.7336e12 / 989.4e12 / 1.0, rel=1e-5)
    assert got["expert_load_max_over_mean"] == pytest.approx(1.7)
    assert got["device_ops_per_prefill"] == 20000


def test_the_span_readers_fall_silent_without_the_spans():
    cell = harness.Cell(ROOT, CELL)
    work = {"prefills": 1.0}
    for name in ("mla_ms_per_prefill", "moe_dispatch_ms_per_prefill",
                 "expert_ffn_ms_per_prefill", "expert_ffn_roofline",
                 "expert_load_max_over_mean"):
        assert cell.reader(name).read(_record(work)) is None, name
    assert cell.reader("prefill_mfu").read(_record(work, busy_s=0.0)) is None


def test_work_counts_at_the_published_sizes():
    shape = _record({})["shape"]
    t = counts_prefill.terms(shape)
    assert sum(t["ops"].values()) == pytest.approx(82.7336e12, rel=1e-5)
    assert counts_prefill.total_params(shape) == pytest.approx(15.706e9, rel=1e-3)
    e = counts_moe_experts.terms(shape, {"prefills": 1.0, "expert_rows": 26 * 16384 * 6})
    assert sum(e["ops"].values()) == pytest.approx(26 * 1.7e12, rel=0.01)
    assert e["bytes"]["weights"] == 26 * 64 * 3 * 2048 * 1408 * 2
