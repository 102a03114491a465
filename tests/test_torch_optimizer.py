"""The port's optimizer, MoE ``aux_loss`` and token sources against repro's, on the CPU.

- ``adamw_update`` on identical random trees (leaves of rank 0 to 3, a last
  axis past one q8 block and ragged against it), two steps each side on
  its own state, clipping active, for float32 / bfloat16 / q8 moments:
  params and float moments rtol 1e-6 (bfloat16 moments within one bfloat16
  ulp); q8 codes within +-1 and equal in >= 99.9% of elements, scales rtol
  1e-6; ``grad_norm`` and ``lr`` rtol 1e-6;
- ``schedule``, ``global_norm`` and clipping against repro's;
- the decay rule: repro decays a leaf of rank >= 2 in its own tree, where
  scanned periods are stacked; the port's per-layer tensors must be judged
  by that rank (norm scales and ``router_bias`` of periods decay; those of
  the prefix, the shared block and MTP do not);
- ``aux_loss`` (switch-style) rtol 1e-6;
- ``FileSource`` byte-equal to repro's; ``SyntheticSource``'s contract.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import moe as jmoe
from repro.models.model import build_model as j_build_model
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import repro_path
from repro_torch.data import pipeline as tpipe
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import decay_mask
from torch_train_common import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = {"a_scalar": (), "b_vec": (7,), "c_mat": (5, 300), "d_wide": (3, 2, 600),
          "e_row": (1, 256)}
BF16_ULP = 2.0**-7


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8"])
def test_adamw_update_matches_repro(state_dtype):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=5.0, state_dtype=state_dtype)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    params = _tree(0)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _t(params)
    jstate, tstate = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    # eager: jit fuses b1 * m + (1 - b1) * g into FMAs that round once
    jupdate = lambda g, s, p: jopt.adamw_update(g, s, p, jcfg)  # noqa: E731
    for step in range(2):
        grads = _tree(10 + step, scale=3.0)  # global norm ~ 70: clipped to 5
        jp, jstate, jm = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        tp, tstate, tm = topt.adamw_update(_t(grads), tstate, tp, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for k in SHAPES:
            assert tuple(tp[k].shape) == SHAPES[k] and tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                got, want = tstate[mom][k], jstate[mom][k]
                if state_dtype == "q8":
                    q, jq = got["q"].numpy().astype(int), np.asarray(want["q"]).astype(int)
                    assert q.shape == jq.shape and got["q"].dtype == torch.int8
                    assert np.abs(q - jq).max() <= 1 and (q == jq).mean() >= 0.999
                    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                                               rtol=1e-6)
                elif state_dtype == "bfloat16":
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=0)
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                               atol=1e-12)


def test_q8_codec_round_trips_as_repro():
    x = _tree(3, scale=2.0)["d_wide"]
    enc = topt._q8_encode(torch.as_tensor(x))
    jenc = jopt._q8_encode(jnp.asarray(x))
    assert enc["q"].shape == jenc["q"].shape == (3, 2, 3, 256)
    np.testing.assert_array_equal(enc["q"].numpy(), np.asarray(jenc["q"]))
    np.testing.assert_array_equal(enc["scale"].numpy(), np.asarray(jenc["scale"]))
    np.testing.assert_array_equal(topt._q8_decode(enc, x.shape).numpy(),
                                  np.asarray(jopt._q8_decode(jenc, x.shape)))
    # half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    enc = topt._q8_encode(torch.tensor([0.5, 1.5, 2.5, 127.0]))
    assert enc["q"].flatten().tolist() == [0, 2, 2, 127]


def test_schedule_global_norm_and_clipping_match_repro():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(topt.schedule(topt.OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))),
            float(jopt.schedule(jopt.OptConfig(**cfg), jnp.asarray(step, jnp.int32))), rtol=1e-6)
    tree = _tree(5)
    want = jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(topt.global_norm(_t(tree))), float(want), rtol=1e-6)
    # repro's own clipping check: a huge gradient moves a parameter by at most lr
    ocfg = topt.OptConfig(lr=1.0, clip_norm=1.0, warmup_steps=0, total_steps=10,
                          weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    new, _, metrics = topt.adamw_update({"w": torch.full((3,), 1e6)},
                                        topt.init_opt_state(params, ocfg), params, ocfg)
    assert float(metrics["grad_norm"]) > 1e5 and float(new["w"].abs().max()) < 10.0


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8"])
def test_adamw_converges_on_a_quadratic(state_dtype):
    cfg = topt.OptConfig(lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0,
                         state_dtype=state_dtype)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    opt = topt.init_opt_state(params, cfg)
    for _ in range(200):
        params, opt, _ = topt.adamw_update({"w": 2 * (params["w"] - 1.0)}, opt, params, cfg)
    assert float(((params["w"] - 1.0) ** 2).sum()) < 1e-2


def _repro_shapes(arch):
    jm = j_build_model(j_get_config(arch, smoke=True))
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-2.7b", "whisper-base"])
def test_decay_rule_reads_the_rank_in_repros_stacked_tree(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    shapes = _repro_shapes(arch)
    mask = decay_mask(model)
    trapped = []  # decayed by repro although the port's tensor is 1-D
    for name, p in model.named_parameters():
        path, period = repro_path(cfg, name)
        leaf = _get(shapes, path)
        assert tuple(leaf.shape)[period is not None:] == tuple(p.shape), name
        assert mask[name] == (leaf.ndim >= 2), name
        if mask[name] and p.dim() < 2:
            trapped.append(name)
    assert trapped
    # the same leaves outside the periods do not decay
    kept = [n for n, p in model.named_parameters() if p.dim() < 2 and not mask[n]]
    assert "final_norm.scale" in kept
    if arch == "deepseek-v3-671b":  # 1 dense prefix layer, MoE periods, MTP
        assert "stack.1.ffn.router_bias" in trapped and "stack.1.pre_norm.scale" in trapped
        assert "stack.0.pre_norm.scale" in kept and "mtp.norm_h.scale" in kept
    if arch == "zamba2-2.7b":  # Mamba2 periods around one shared attention block
        assert "stack.0.inner.a_log" in trapped and "stack.0.inner.norm.scale" in trapped
        assert "stack.shared_block.pre_norm.scale" in kept
    if arch == "whisper-base":
        assert "encoder.0.pre_norm.scale" in trapped and "enc_norm.scale" in kept


def test_aux_loss_matches_repro():
    cfg = j_get_config("deepseek-moe-16b", smoke=True)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = np.random.default_rng(4).normal(size=(40, cfg.d_model)).astype(np.float32)
    want = float(jax.jit(lambda p, x: jmoe.aux_loss(p, x, cfg))(jp, jnp.asarray(x)))
    layer = tmoe.MoE(get_config("deepseek-moe-16b", smoke=True), torch.float32, "cpu",
                     torch.Generator().manual_seed(0))
    layer.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in jp.items()})
    got = tmoe.aux_loss(layer, torch.as_tensor(x), get_config("deepseek-moe-16b", smoke=True))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_file_source_is_byte_equal_to_repro(tmp_path, dtype):
    toks = (np.arange(5000, dtype=np.int64) * 7919 % 60000).astype(dtype)
    path = tmp_path / "toks.bin"
    toks.tofile(path)
    for hosts in (1, 2):
        for host in range(hosts):
            j = jpipe.make_source(jpipe.DataConfig(vocab=60000, global_batch=4, seq_len=33,
                                                   path=str(path), token_dtype=dtype), host, hosts)
            t = tpipe.make_source(tpipe.DataConfig(vocab=60000, global_batch=4, seq_len=33,
                                                   path=str(path), token_dtype=dtype), host, hosts)
            assert isinstance(t, tpipe.FileSource)
            for step in (0, 1, 7, 200):
                a, b = j.batch(step), t.batch(step)
                for key in ("tokens", "labels"):
                    assert b[key].dtype == a[key].dtype == np.int32
                    assert b[key].tobytes() == a[key].tobytes()


def test_synthetic_source_contract():
    cfg = tpipe.DataConfig(vocab=97, global_batch=4, seq_len=16, seed=3)
    src = tpipe.make_source(cfg)
    assert isinstance(src, tpipe.SyntheticSource)
    b5 = src.batch(5)
    tpipe.make_source(cfg).batch(0)  # another source's history changes nothing
    again = tpipe.make_source(cfg).batch(5)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(b5[key], again[key])
        assert b5[key].shape == (4, 16) and b5[key].dtype == np.int32
    assert b5["tokens"].min() >= 0 and b5["tokens"].max() < 97
    np.testing.assert_array_equal(b5["labels"][:, :-1], b5["tokens"][:, 1:])
    assert not np.array_equal(src.batch(6)["tokens"], b5["tokens"])
    other = tpipe.make_source(dataclasses.replace(cfg, seed=4)).batch(5)
    assert not np.array_equal(other["tokens"], b5["tokens"])
    h0 = tpipe.make_source(dataclasses.replace(cfg, global_batch=8), 0, 2).batch(0)
    h1 = tpipe.make_source(dataclasses.replace(cfg, global_batch=8), 1, 2).batch(0)
    assert h0["tokens"].shape == h1["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    # full range: every token value of a small vocab appears
    wide = tpipe.make_source(tpipe.DataConfig(vocab=5, global_batch=8, seq_len=64)).batch(0)
    assert set(np.unique(wide["tokens"])) == set(range(5))
