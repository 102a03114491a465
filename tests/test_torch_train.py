"""The port's training step against repro's on the attention archs, on the CPU.

- gemma3-1b, gemma2-27b, glm4-9b, yi-34b and internvl2-76b (its vision
  prefix fed): float32 smoke configs on the same weights and batch, the
  port's ``loss_and_grads`` / ``make_train_step`` against one jitted
  ``jax.value_and_grad(repro Model.loss)``: loss rel 1e-5, global norm rel
  1e-4, gradients leaf by leaf (``torch_train_common``);
- glm4-9b in bfloat16: loss within 2e-3 relative, global norm within 2e-2,
  each gradient leaf within 5e-2 of its max |g| (bf16 products and
  roundings in another order than jit's fused ones);
- ``microbatches=2`` against one batch (a dense model: each half's mean is
  half the whole mean): loss rel 1e-6, gradients allclose(1e-5, 1e-6 * max);
- remat ``"full"`` (each period under ``torch.utils.checkpoint``) against
  ``"none"``: loss, norm and every gradient bit-equal on the CPU, the
  period's forward run twice.
The other archs are in tests/test_torch_train_archs.py; the CUDA leg of the
refusal of ``rwkv6_chunk`` in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, loss_and_grads, make_train_step
from repro_torch.train.optimizer import OptConfig, global_norm
from torch_train_common import (
    assert_grads_match,
    assert_step_matches_repro,
    build_pair,
    make_batch,
    one_torch_thread,  # noqa: F401
    repro_loss_and_grads,
)


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-27b", "glm4-9b", "yi-34b",
                                  "internvl2-76b"])
def test_train_step_matches_repro(arch):
    cfg, model, state, new_state, metrics, _ = assert_step_matches_repro(arch)
    for name, p in new_state["params"].items():
        assert p.dtype == state["params"][name].dtype and torch.isfinite(p).all(), name
    assert not torch.equal(new_state["params"]["embedding.table"],
                           state["params"]["embedding.table"])
    assert int(new_state["opt"]["step"]) == 1


def test_bf16_train_step_matches_repro():
    cfg_j, jm, jparams, cfg, model = build_pair("glm4-9b", dtype="bfloat16")
    batch = make_batch(cfg)
    jloss, _, jgrads, jnorm = repro_loss_and_grads(jm, jparams, batch)
    params = {n: p.detach() for n, p in model.named_parameters()}
    loss, _, grads = loss_and_grads(model, params, batch)
    assert all(grads[n].dtype == p.dtype for n, p in params.items())
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)
    np.testing.assert_allclose(float(global_norm(grads)), jnorm, rtol=2e-2)
    assert_grads_match(cfg, grads, jgrads, rtol=0, atol=5e-2)


def _model(remat="none", seed=3):
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True), param_dtype="float32",
                              compute_dtype="float32", remat=remat)
    return build_model(cfg, device="cpu", rwkv_kernel=False, seed=seed)


def test_microbatches_accumulate_as_one_batch():
    model = _model()
    batch = make_batch(model.cfg, b=4, seed=5)
    params = {n: p.detach() for n, p in model.named_parameters()}
    loss1, _, g1 = loss_and_grads(model, params, batch)
    loss2, _, g2 = loss_and_grads(model, params, batch, microbatches=2)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-6)
    for name in g1:
        assert g2[name].dtype == torch.float32
        top = float(g1[name].abs().max())
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), rtol=1e-5,
                                   atol=1e-6 * top, err_msg=name)
    opt = OptConfig(warmup_steps=1)
    s1, m1 = make_train_step(model, opt)(init_train_state(model, opt), batch)
    s2, m2 = make_train_step(model, opt, microbatches=2)(init_train_state(model, opt), batch)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)


def test_remat_full_is_bit_equal_to_none():
    legs = {}
    for remat in ("none", "full"):
        model = _model(remat)
        calls = []
        block = model.stack[len(model.cfg.prefix_layers)]
        block.register_forward_hook(lambda *_: calls.append(1))
        params = {n: p.detach() for n, p in model.named_parameters()}
        legs[remat] = loss_and_grads(model, params, make_batch(model.cfg, seed=6)), len(calls)
    (loss_n, _, g_n), calls_n = legs["none"]
    (loss_f, _, g_f), calls_f = legs["full"]
    assert (calls_n, calls_f) == (1, 2)  # the period's forward again in the backward
    assert float(loss_f) == float(loss_n)
    assert float(global_norm(g_f)) == float(global_norm(g_n))
    for name in g_n:
        assert torch.equal(g_f[name], g_n[name]), name


def test_loss_is_differentiable_and_serving_stays_frozen():
    """``build_model`` serves frozen; ``requires_grad=True`` gives a model
    whose ``loss`` backpropagates into every parameter."""
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True), param_dtype="float32",
                              compute_dtype="float32")
    frozen = build_model(cfg, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    model = build_model(cfg, device="cpu", requires_grad=True)
    loss, _ = model.loss(make_batch(cfg))
    assert loss.requires_grad and not loss.is_inference()
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
