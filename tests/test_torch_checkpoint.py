"""The port's Checkpointer, and the LM server's ``--ckpt-dir``.

The checkpointer keeps repro's on-disk layout (``step_<n>/manifest.json``
with one ``leaf_<i>.npy`` per leaf, written to ``step_<n>.tmp`` and
renamed), so each package reads the other's numpy leaves. Its failure
paths are repro's (tests/test_checkpoint.py): an async write error
re-raises on ``wait()`` and on the next ``save()``, a crash before the
rename leaves only the ``.tmp`` directory, ``keep`` retains the newest
steps. bfloat16 is stored as uint16 and comes back bit for bit.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro_torch.checkpoint.checkpointer as ckpt_mod
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.neuron import NeuronState
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig


def _tree(v):
    return {"a": torch.full((3,), float(v)), "b": torch.arange(4) * v}


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return NeuronState(*(torch.randn((2, 5), generator=g) for _ in range(3)),
                       i_syn=torch.randn((2, 5, 4), generator=g))


def _assert_same(got, want):
    """Same structure, dtypes and bits; a numpy leaf comes back as an array."""
    if not isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want)
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.device == want.device
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bool else got,
                           want.view(torch.uint8) if want.dtype == torch.bool else want)
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_round_trip_of_a_nested_tree_is_exact(tmp_path):
    g = torch.Generator().manual_seed(3)
    tree = {
        "carry": (_state(1), torch.rand((2, 5), generator=g) < 0.5,
                  torch.randn((2, 3, 2, 8), generator=g), torch.tensor(2, dtype=torch.int32)),
        "meta": np.frombuffer(b'{"x": 1}', dtype=np.uint8).copy(),
        "z": [torch.arange(6, dtype=torch.int64).reshape(2, 3), np.float64(2.5)],
        "bf16": torch.randn((4, 7), generator=g).to(torch.bfloat16),
        "f8": torch.randn((9,), generator=g).to(torch.float8_e4m3fn),
        "none": None,
    }
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree, blocking=True)
    assert sorted(os.listdir(tmp_path)) == ["step_7"]
    files = sorted(os.listdir(tmp_path / "step_7"))
    assert files == sorted(["manifest.json"] + [f"leaf_{i}.npy" for i in range(12)])
    like = {
        "carry": (_state(9), torch.zeros((2, 5), dtype=torch.bool), torch.zeros((2, 3, 2, 8)),
                  torch.zeros((), dtype=torch.int32)),
        "meta": np.zeros(0, np.uint8),  # variable length: a 0-size prototype
        "z": [torch.zeros((2, 3), dtype=torch.int64), np.float64(0)],
        "bf16": torch.zeros((4, 7), dtype=torch.bfloat16),
        "f8": torch.zeros((9,), dtype=torch.float8_e4m3fn),
        "none": None,
    }
    _assert_same(ck.restore(7, like), tree)


def test_layout_and_keys_are_repros(tmp_path):
    """repro's checkpointer reads the port's leaves under the same keys
    (bf16 included, as ml_dtypes' bfloat16 with the same bits), and the port
    reads repro's."""
    g = torch.Generator().manual_seed(0)
    bf = torch.randn((3, 4), generator=g).to(torch.bfloat16)
    tree = {"carry": (torch.arange(5, dtype=torch.float32), torch.tensor(3, dtype=torch.int32)),
            "w": bf}
    Checkpointer(str(tmp_path / "port")).save(1, tree, blocking=True)
    manifest = json.loads((tmp_path / "port" / "step_1" / "manifest.json").read_text())
    assert [e["key"] for e in manifest["leaves"]] == ["['carry'][0]", "['carry'][1]", "['w']"]
    assert [e["dtype"] for e in manifest["leaves"]] == ["float32", "int32", "bfloat16"]
    assert np.load(tmp_path / "port" / "step_1" / "leaf_2.npy").dtype == np.uint16
    jlike = {"carry": (jnp.zeros(5), jnp.int32(0)), "w": jnp.zeros((3, 4), jnp.bfloat16)}
    back = JCheckpointer(str(tmp_path / "port")).restore(1, jlike)
    np.testing.assert_array_equal(np.asarray(back["carry"][0]), np.arange(5, dtype=np.float32))
    assert int(back["carry"][1]) == 3
    assert np.asarray(back["w"]).dtype == ml_dtypes.bfloat16
    assert np.asarray(back["w"]).view(np.uint16).tobytes() == \
        bf.view(torch.int16).numpy().tobytes()
    JCheckpointer(str(tmp_path / "jax")).save(
        4, {"carry": (jnp.arange(5.0), jnp.int32(2)), "w": jnp.asarray(np.asarray(back["w"]))},
        blocking=True)
    got = Checkpointer(str(tmp_path / "jax")).restore(4, tree)
    assert torch.equal(got["carry"][0], torch.arange(5, dtype=torch.float32))
    assert got["carry"][1].shape == () and int(got["carry"][1]) == 2
    assert torch.equal(got["w"], bf)


def test_restore_checks_shapes_and_structure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), blocking=True)
    with pytest.raises(ValueError, match=r"leaf \"\['a'\]\" has shape \(3,\)"):
        ck.restore(1, {"a": torch.zeros(4), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="has no leaf"):
        ck.restore(1, {"a": torch.zeros(3), "c": torch.zeros(4)})
    with pytest.raises(TypeError, match="cannot checkpoint a object"):
        ck.save(2, {"a": object()}, blocking=True)


def test_async_save_copies_leaves_before_writing(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(1)
    ck.save(1, tree)  # async
    tree["a"].fill_(99.0)  # the caller moves on and overwrites its tensor
    ck.wait()
    assert torch.equal(ck.restore(1, _tree(0))["a"], torch.full((3,), 1.0))


def test_async_write_failure_surfaces_on_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), blocking=True)

    def _boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "save", _boom)
    ck.save(2, _tree(2))  # async: the failure lands on the worker thread
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    assert ck.steps() == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    ck.wait()  # the error is reported once
    monkeypatch.undo()
    ck.save(3, _tree(3))
    ck.wait()
    assert ck.latest_step() == 3
    assert torch.equal(ck.restore(3, _tree(0))["a"], torch.full((3,), 3.0))


def test_async_write_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    monkeypatch.setattr(ckpt_mod.np, "save",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("boom")))
    ck.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.save(2, _tree(2))  # joins the failed write before copying
    monkeypatch.undo()
    ck.save(2, _tree(2), blocking=True)
    assert ck.steps() == [2]


def test_crash_mid_write_leaves_only_tmp_and_resumes(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree(5), blocking=True)

    def _crash(src, dst):
        raise KeyboardInterrupt("simulated crash at the rename boundary")

    monkeypatch.setattr(ckpt_mod.os, "rename", _crash)
    with pytest.raises(KeyboardInterrupt):
        ck.save(6, _tree(6), blocking=True)
    monkeypatch.undo()
    assert (tmp_path / "step_6.tmp").is_dir()
    assert not (tmp_path / "step_6").exists()
    survivor = Checkpointer(str(tmp_path))  # a restart
    assert survivor.steps() == [5] and survivor.latest_step() == 5
    assert torch.equal(survivor.restore(5, _tree(0))["a"], torch.full((3,), 5.0))
    survivor.save(6, _tree(6), blocking=True)
    assert survivor.steps() == [5, 6]
    assert not (tmp_path / "step_6.tmp").exists()


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_retains_the_newest_steps(tmp_path, keep):
    ck = Checkpointer(str(tmp_path), keep=keep)
    for step in (3, 1, 4, 2, 5):
        ck.save(step, _tree(step))
    ck.wait()
    assert ck.steps() == [3, 4, 5][-keep:]  # step 2 came after 3 and 4: it went
    assert ck.latest_step() == 5


# ---------------------------------------------------------------------------
# the LM server's --ckpt-dir
# ---------------------------------------------------------------------------
def test_ckpt_dir_saves_then_restores_the_same_weights(tmp_path, capsys):
    cfg = get_config("rwkv6-3b", smoke=True)
    d = str(tmp_path / "lm")
    model_a = build_model(cfg, device="cpu", seed=0)
    assert serve_cli.load_or_save_params(model_a, d) is None  # nothing there: saved
    model_b = build_model(cfg, device="cpu", seed=1)
    assert not torch.equal(next(iter(model_b.state_dict().values())),
                           next(iter(model_a.state_dict().values())))
    assert serve_cli.load_or_save_params(model_b, d) == 0
    for k, v in model_a.state_dict().items():
        assert torch.equal(model_b.state_dict()[k], v), k
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6))
    want = Engine(model_a, ServeConfig(max_len=24)).generate(toks, 8)
    assert torch.equal(Engine(model_b, ServeConfig(max_len=24)).generate(toks, 8), want)

    argv = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--max-new", "6", "--max-len", "16", "--seed", "1", "--ckpt-dir", d]
    out = serve_cli.main(argv)  # seed 1's init, seed 0's weights from the directory
    assert "loaded checkpoint step 0" in capsys.readouterr().out
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6), dtype=np.int64)
    assert torch.equal(out, Engine(model_a, ServeConfig(max_len=16)).generate(prompts, 6))
    fresh = str(tmp_path / "fresh")
    serve_cli.main(argv[:-1] + [fresh])
    assert "saved checkpoint step 0" in capsys.readouterr().out
    assert Checkpointer(fresh).steps() == [0]
