"""The port's training launcher in-process on the CPU (no subprocess).

- an injected failure (``--fail-at 4``, checkpoints every 3 steps, a slow
  disk: step 3's save is still being written when step 4 fails): the
  supervisor reports it, resumes from step 3, completes, and the resumed
  steps' losses and the final checkpoint equal an unbroken run's bit for bit;
- ``PREEMPT`` in the checkpoint directory: a checkpoint and exit code 42;
- a NaN loss raises once the failure budget is spent;
- the flag set, types and defaults equal ``repro.launch.train``'s plus
  ``--device`` (the default checkpoint directory sits under the temporary
  directory); without CUDA the default device raises instead of falling
  back to the CPU.
"""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import train as ttrain
from torch_train_common import one_torch_thread  # noqa: F401 (an autouse fixture)


def _args(tmp_path, name, **kw):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / name), "--ckpt-every", "3", "--log-every", "1",
            "--restart-delay", "0"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return ttrain.build_parser().parse_args(argv)


def _final_checkpoint(args):
    """{leaf key: array} of the last checkpoint, read from its files."""
    step = Checkpointer(args.ckpt_dir).latest_step()
    assert step == args.steps
    path = os.path.join(args.ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {e["key"]: np.load(os.path.join(path, e["file"])) for e in leaves}


def test_injected_failure_resumes_bit_for_bit(tmp_path, capsys, monkeypatch):
    clean, broken = [], []
    assert ttrain.run(_args(tmp_path, "clean"), clean) == 0
    # a slow disk: step 3's async save is still being written when step 4
    # fails, and the supervisor must resume from it all the same
    real_save = ckpt_mod.np.save

    def slow_save(*a, **kw):
        time.sleep(0.002)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt_mod.np, "save", slow_save)
    assert ttrain.run(_args(tmp_path, "broken", fail_at=4), broken) == 0
    monkeypatch.undo()
    out = capsys.readouterr().out
    assert "[supervisor] failure #1: RuntimeError: injected failure (test)" in out
    assert "[supervisor] resumed from step 3" in out
    assert out.count("[supervisor] training complete") == 2
    assert [s for s, *_ in clean] == list(range(6))
    assert [s for s, *_ in broken] == [0, 1, 2, 3, 3, 4, 5]
    assert broken[:4] == clean[:4] and broken[4:] == clean[3:]
    a = _final_checkpoint(_args(tmp_path, "clean"))
    b = _final_checkpoint(_args(tmp_path, "broken"))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_preempt_checkpoints_and_exits_42(tmp_path, capsys):
    args = _args(tmp_path, "pre")
    (tmp_path / "pre").mkdir()
    (tmp_path / "pre" / "PREEMPT").touch()
    assert ttrain.run(args) == 42
    assert "[supervisor] preemption requested; checkpointing" in capsys.readouterr().out
    assert Checkpointer(args.ckpt_dir).latest_step() == 0
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--smoke", "--device", "cpu", "--ckpt-dir", args.ckpt_dir])
    assert e.value.code == 42


def test_nan_loss_raises_when_the_budget_is_spent(tmp_path, monkeypatch, capsys):
    real = ttrain.make_train_step

    def nan_step(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            return state, {**metrics, "loss": torch.tensor(float("nan"))}
        return wrapped

    monkeypatch.setattr(ttrain, "make_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="loss NaN at step 0"):
        ttrain.run(_args(tmp_path, "nan", max_failures=1))
    out = capsys.readouterr().out
    assert "failure #2: FloatingPointError" in out and "failure budget exhausted" in out


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its ``parse_args``."""
    seen = []

    def capture(self, *a, **kw):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main()
    monkeypatch.undo()
    return seen[0]


def test_flags_are_repros_plus_device(monkeypatch):
    def flags(parser):
        return {a.dest: (a.option_strings, a.type, a.default) for a in parser._actions
                if a.dest != "help"}

    want = flags(_parser_of(jtrain.main, monkeypatch))
    got = flags(_parser_of(ttrain.main, monkeypatch))
    assert set(got) == set(want) | {"device"}
    assert got["device"] == (["--device"], None, "cuda")
    for dest, (opts, typ, default) in want.items():
        if dest == "ckpt_dir":  # under the temporary directory, as repro's /tmp/repro_ckpt
            assert got[dest][:2] == (opts, typ) and got[dest][2].endswith("repro_ckpt")
        else:
            assert got[dest] == (opts, typ, default), dest


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid here")
    args = _args(tmp_path, "dev")
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(args)
