"""The port's training step against repro's on the MoE, MLA, Mamba2, RWKV-6 and
encoder-decoder archs, on the CPU.

- deepseek-moe-16b (MoE with shared experts and the switch load term),
  deepseek-v3-671b (MLA, aux-free MoE, MTP), zamba2-2.7b (Mamba2 around one
  shared attention block applied at every period: its gradient sums over
  the applications), rwkv6-3b (the plain chunked WKV core) and
  whisper-base (encoder and cross-attention, its frames fed): float32 smoke
  configs, the port's ``loss_and_grads`` / ``make_train_step`` against one
  jitted ``jax.value_and_grad(repro Model.loss)`` (``torch_train_common``);
  deepseek-v3's ``router_bias`` moves by exactly +-u or 0 per period after
  one step from zero;
- ``_update_router_bias`` against repro's on the same tree and loads;
- a 2-step repro run (deepseek-moe-16b cut to its prefix layer and one MoE
  period, q8 moments, ``microbatches=2``; repro moves every period's
  ``router_bias``, aux-free router or not) carried
  into the port by ``convert.train_state_from_numpy``: the third step's
  loss within rel 1e-4 of repro's, its norm within rel 1e-4, its router
  biases within 1e-9 and its q8 moment codes within +-1 (equal in >= 99.9%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.convert import lm_params_to_numpy, train_state_from_numpy
from repro_torch.train import loop as tloop
from repro_torch.train.optimizer import OptConfig
from torch_train_common import (
    assert_step_matches_repro,
    build_pair,
    jbatch,
    make_batch,
    one_torch_thread,  # noqa: F401
)

U = 1e-3  # repro's router-bias step


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    else:
        yield "/".join(path), np.asarray(tree, dtype=np.float32)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b", "zamba2-2.7b",
                                  "rwkv6-3b", "whisper-base"])
def test_train_step_matches_repro(arch):
    cfg, model, state, new_state, metrics, aux = assert_step_matches_repro(arch)
    assert int(new_state["opt"]["step"]) == 1
    for name, p in new_state["params"].items():
        assert torch.isfinite(p).all(), name
    if arch == "deepseek-v3-671b":
        load = aux["moe_load_periods"]
        assert load.shape == (cfg.n_periods, cfg.n_experts)
        for period in range(cfg.n_periods):
            name = f"stack.{len(cfg.prefix_layers) + period}.ffn.router_bias"
            moved = new_state["params"][name] - state["params"][name]
            want = U * torch.sign(load[period].mean() - load[period])
            u = float(torch.tensor(U))  # u in float32
            assert set(moved.tolist()) <= {-u, 0.0, u} and torch.equal(moved, want)


def test_router_bias_update_matches_repro():
    cfg_j, jm, jparams, cfg, model = build_pair("deepseek-v3-671b")
    rng = np.random.default_rng(7)
    params = {n: p.detach() for n, p in model.named_parameters()}
    for n in params:  # random biases, so the update adds to something
        if n.endswith("router_bias"):
            params[n] = torch.as_tensor(rng.normal(size=params[n].shape).astype(np.float32))
    tree = jax.tree.map(jnp.asarray, lm_params_to_numpy(cfg, params))
    load = rng.integers(0, 9, (cfg.n_periods, cfg.n_experts)).astype(np.float32)
    load[0] = load[0].mean()  # a period at its mean moves by 0
    want = jloop._update_router_bias(tree, {"moe_load_periods": jnp.asarray(load)})
    got = tloop._update_router_bias(cfg, params, {"moe_load_periods": torch.as_tensor(load)})
    assert tloop._update_router_bias(cfg, params, {}) is params
    want, got = dict(_leaves(want)), dict(_leaves(lm_params_to_numpy(cfg, got)))
    moved = [k for k in want if not np.array_equal(want[k], np.asarray(tree_get(tree, k)))]
    assert moved == ["stack/periods/b0/ffn/router_bias"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def tree_get(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def test_repro_run_carried_into_the_port_continues_as_repro():
    """Two q8 steps of repro carried into the port, and a third step on both:
    loss and gradient norm within 1e-4, router biases within 1e-9, the q8
    codes within +-1. No other parameter is compared, because of how q8
    moments update: ``_q8_encode`` scales a block of 256 by its largest
    |x| / 127, so an element with 0.004 G < |g| < 0.063 G (G the block's
    largest) decodes a nonzero ``m`` while its ``v`` rounds to code 0, and
    AdamW's update ``m_hat / (sqrt(v_hat) + eps)`` then divides by eps =
    1e-8. One code of difference in ``m`` between the packages (the codes
    are held within +-1) then moves such a parameter differently, by about
    lr * scale / eps (ROADMAP.md §3: a defect of repro that the port keeps)."""
    # the dense prefix layer and one MoE period: half deepseek-v3's compile
    cfg_j, jm, jparams, cfg, model = build_pair("deepseek-moe-16b", n_periods=1)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, state_dtype="q8")
    jstep = jax.jit(jloop.make_train_step(jm, jopt.OptConfig(**opt), microbatches=2))
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jparams, jopt.OptConfig(**opt))}
    batches = [make_batch(cfg, b=4, seed=20 + i) for i in range(3)]
    for batch in batches[:2]:
        jstate, _ = jstep(jstate, jbatch(batch))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), "cpu")
    assert int(state["opt"]["step"]) == 2 and set(state["params"]) == set(state["opt"]["m"])
    assert set(state["opt"]["m"]["stack.1.ffn.wo"]) == {"q", "scale"}
    jstate3, jmetrics = jstep(jstate, jbatch(batches[2]))
    state3, metrics = tloop.make_train_step(model, OptConfig(**opt), microbatches=2)(
        state, batches[2])
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-4)
    assert int(state3["opt"]["step"]) == 3
    want = dict(_leaves(jstate3["params"]))
    got = dict(_leaves(lm_params_to_numpy(cfg, state3["params"])))
    for k in (k for k in want if k.endswith("router_bias")):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
    # the q8 moments after the step: codes within +-1, equal in >= 99.9%
    for mom in ("m", "v"):
        codes = {n: e["q"] for n, e in state3["opt"][mom].items()}
        got = dict(_leaves(lm_params_to_numpy(cfg, codes)))
        want = dict(_leaves(jax.tree.map(lambda e: e["q"], jstate3["opt"][mom],
                                         is_leaf=lambda e: isinstance(e, dict) and "q" in e)))
        assert got.keys() == want.keys()
        q = np.concatenate([got[k].ravel() for k in sorted(got)])
        jq = np.concatenate([want[k].ravel() for k in sorted(got)])
        assert np.abs(q - jq).max() <= 1 and (q == jq).mean() >= 0.999, mom
