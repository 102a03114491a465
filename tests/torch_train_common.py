"""Shared setup of the port's training tests against repro's (not collected).

A smoke config is built in both packages (float32 unless asked), the
port's random init carried into repro with ``convert.lm_params_to_numpy``
(``lm_params_from_numpy`` carries it back bit for bit); a batch of
tokens from a numpy seed, labels the next token, with the frontends' inputs
(whisper's frames, internvl2's patch embeddings). repro's loss and gradients
come from one jitted ``jax.value_and_grad(Model.loss)``; the port's from
``train.loop.loss_and_grads``. Gradients are compared leaf by leaf in
repro's tree (the port's periods stacked again by
``convert.lm_params_to_numpy``): allclose(rtol=1e-4, atol=1e-5 * the leaf's
max |g|) (see ``GRAD_ATOL``); the loss within rel 1e-5 and the global norm
within rel 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.models.model import build_model

LOSS_RTOL, NORM_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4
# float32 rounding: against a float64 evaluation of the same function,
# repro's jitted gradients miss by up to 2.4e-6 of a leaf's max |g| and the
# port's by up to 4.8e-6 (gemma3-1b's attention projections, on elements
# near zero), so elements are held to 1e-5 of the leaf's max |g|
GRAD_ATOL = 1e-5


def build_pair(arch, dtype="float32", seed=1, **overrides):
    """(cfg_j, repro model, repro params, cfg, port model): the port's random
    init (the same distributions as repro's) carried into repro's tree by
    ``convert.lm_params_to_numpy``, each leaf in repro's dtype (no compile of
    repro's init)."""
    fields = dict(param_dtype=dtype, compute_dtype=dtype, **overrides)
    cfg_j = dataclasses.replace(j_get_config(arch, smoke=True), **fields)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **fields)
    jm = j_build_model(cfg_j)
    model = build_model(cfg, device="cpu", rwkv_kernel=False, seed=seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                           lm_params_to_numpy(cfg, model), shapes)
    return cfg_j, jm, jparams, cfg, model


def make_batch(cfg, b=2, s=16, seed=0):
    """numpy batch: tokens, labels (the next token) and the frontend's input."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeddings"] = rng.normal(
            size=(b, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def repro_loss_and_grads(jm, jparams, batch):
    """(loss, aux, grads as numpy, global norm) from repro, jitted."""
    def f(params, batch):
        (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, batch)
        return loss, aux, grads, jopt.global_norm(grads)

    loss, aux, grads, gnorm = jax.jit(f)(jparams, jbatch(batch))
    return float(loss), aux, jax.tree.map(np.asarray, grads), float(gnorm)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    else:
        yield "/".join(path), tree


def assert_grads_match(cfg, grads, jgrads, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """The port's gradients (a dict by name) against repro's tree, leaf by
    leaf: allclose(rtol, atol * the leaf's max |g|)."""
    got = dict(_leaves(lm_params_to_numpy(cfg, grads)))
    want = dict(_leaves(jgrads))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=atol * np.abs(w).max(),
                                   err_msg=name)


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def assert_step_matches_repro(arch):
    """One train step of the port against repro's loss, aux loads, global
    norm and gradients on the same weights and batch; returns (cfg, model,
    the state before the step, the step's new state, its metrics, aux)."""
    from repro_torch.train.loop import init_train_state, loss_and_grads, make_train_step
    from repro_torch.train.optimizer import OptConfig, global_norm

    cfg_j, jm, jparams, cfg, model = build_pair(arch)
    batch = make_batch(cfg)
    jloss, jaux, jgrads, jnorm = repro_loss_and_grads(jm, jparams, batch)
    state = init_train_state(model, OptConfig())
    loss, aux, grads = loss_and_grads(model, state["params"], batch)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    for key in ("moe_load", "moe_load_periods"):
        assert (key in aux) == (key in jaux)
        if key in aux:
            np.testing.assert_array_equal(aux[key].numpy(), np.asarray(jaux[key]))
    np.testing.assert_allclose(float(global_norm(grads)), jnorm, rtol=NORM_RTOL)
    assert_grads_match(cfg, grads, jgrads)
    new_state, metrics = make_train_step(model, OptConfig(warmup_steps=1))(state, batch)
    assert float(metrics["loss"]) == float(loss)
    assert float(metrics["grad_norm"]) == float(global_norm(grads))
    return cfg, model, state, new_state, metrics, aux


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU side here is many small ops: one intra-op thread, so
    test workers running side by side do not oversubscribe the cores (as
    tests/test_torch_sharded_engine.py pins it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
