"""The port's MoE (two-stage expert dispatch) against repro's, on the CPU.

repro's ``init_moe`` parameters carried across as numpy arrays; the same
tokens, made with numpy seeds, through both packages at float32:
- ``route`` for the softmax top-k and the aux-free sigmoid + bias routers:
  ``top_idx`` and ``load`` equal, weights allclose(rtol=1e-6, atol=1e-7);
  ties between experts go to the lower id in both;
- ``moe_local`` at the default capacity and at capacity 1 (most assignments
  drop): outputs allclose(rtol=1e-5, atol=1e-6), ``load`` and the kept
  assignments equal; ``moe_reference`` the same; ``moe_local`` equals
  ``moe_reference`` where nothing drops (atol 2e-6, as repro holds them);
- the capacity rule ``max(8, int(t * k / E * capacity_factor))``, including
  deepseek-moe-16b's 480 slots per expert at T = 4096 and 8 at T = 8.
The CUDA legs are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.two_stage import dispatch_slots as j_dispatch_slots
from repro.models import moe as j_moe
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.two_stage import dispatch_slots
from repro_torch.models import moe


# repro's functions jitted: one compile per shape instead of one per primitive
j_route = jax.jit(j_moe.route, static_argnames=("cfg",))
j_local = jax.jit(j_moe.moe_local, static_argnames=("cfg", "capacity"))
j_reference = jax.jit(j_moe.moe_reference, static_argnames=("cfg",))


def _pair(seed=0, bias=False, **kw):
    cfg_j, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    if bias:
        jp["router_bias"] = jax.random.normal(jax.random.PRNGKey(seed + 1), jp["router_bias"].shape)
    layer = moe.MoE(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in jp.items()})
    return cfg_j, jp, cfg, layer.requires_grad_(False)


def _x(t, d, seed=1):
    return np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)


def _kept(top_idx, e, cap):
    """Kept assignments of repro's dispatch rule on these decisions."""
    _, keep = j_dispatch_slots(jnp.asarray(top_idx).reshape(-1), e, cap)
    return int(np.asarray(keep).sum())


@pytest.mark.parametrize("aux_free", [False, True])
def test_route_matches_repro(aux_free):
    cfg_j, jp, cfg, layer = _pair(bias=aux_free, d_model=32, n_experts=8, top_k=3, moe_d_ff=16,
                                  router_aux_free=aux_free)
    x = _x(40, 32)
    j_idx, j_w, j_load = j_route(jp, jnp.asarray(x), cfg=cfg_j)
    idx, w, load = moe.route(layer, torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(load.numpy(), np.asarray(j_load))
    assert w.dtype == load.dtype == torch.float32 and layer.router.dtype == torch.float32


@pytest.mark.parametrize("aux_free", [False, True])
def test_route_breaks_ties_as_repro(aux_free):
    """A zero router scores every expert the same: both packages pick the
    lowest ids. Half the experts duplicated: the lower of each pair first."""
    cfg_j, jp, cfg, layer = _pair(d_model=16, n_experts=8, top_k=3, moe_d_ff=8,
                                  router_aux_free=aux_free)
    rng = np.random.default_rng(2)
    half = rng.normal(size=(16, 4)).astype(np.float32)
    for router in (np.zeros((16, 8), np.float32), np.concatenate([half, half], 1)):
        jp = {**jp, "router": jnp.asarray(router)}
        layer.router.copy_(torch.as_tensor(router))
        x = _x(12, 16, seed=3)
        j_idx, _, _ = j_route(jp, jnp.asarray(x), cfg=cfg_j)
        idx, _, _ = moe.route(layer, torch.as_tensor(x), cfg)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(
        moe.route(layer, torch.zeros((2, 16)), cfg)[0].numpy(), [[0, 1, 2], [0, 1, 2]])


MOE_CASES = {
    # (config, tokens, capacity): repro's test_models shapes; capacity 1 drops most
    "default_capacity": (dict(d_model=32, n_experts=8, top_k=2, moe_d_ff=16), 24, None),
    "capacity_1": (dict(d_model=16, n_experts=4, top_k=2, moe_d_ff=8, capacity_factor=1.0),
                   32, 1),
    "truncated_capacity": (dict(d_model=16, n_experts=4, top_k=3, moe_d_ff=8,
                                capacity_factor=1.1, router_aux_free=False), 37, None),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_local_and_reference_match_repro(case):
    kw, t, cap = MOE_CASES[case]
    cfg_j, jp, cfg, layer = _pair(**kw)
    x = _x(t, cfg.d_model, seed=4)
    jy, jaux = j_local(jp, jnp.asarray(x), cfg=cfg_j, capacity=cap)
    y, aux = moe.moe_local(layer, torch.as_tensor(x), cfg, capacity=cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(aux["load"].numpy(), np.asarray(jaux["load"]))
    # the same assignments kept (and dropped) by the port's dispatch as by repro's
    c = cap or moe.expert_capacity(cfg, t)
    idx = moe.route(layer, torch.as_tensor(x), cfg)[0]
    _, keep = dispatch_slots(idx.reshape(-1), cfg.n_experts, c)
    assert int(keep.sum()) == _kept(idx.numpy(), cfg.n_experts, c)
    if cap == 1:
        assert int(keep.sum()) < t * cfg.top_k  # it drops
    jr, jraux = j_reference(jp, jnp.asarray(x), cfg=cfg_j)
    r, raux = moe.moe_reference(layer, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(raux["load"].numpy(), np.asarray(jraux["load"]))


@pytest.mark.parametrize("aux_free", [True, False])
def test_moe_local_equals_reference_without_drops(aux_free):
    _, _, cfg, layer = _pair(d_model=32, n_experts=8, top_k=2, moe_d_ff=16, capacity_factor=8.0,
                             router_aux_free=aux_free)
    x = torch.as_tensor(_x(24, 32, seed=5))
    y, aux = moe.moe_local(layer, x, cfg)
    r, raux = moe.moe_reference(layer, x, cfg)
    torch.testing.assert_close(y, r, rtol=0, atol=2e-6)
    assert torch.equal(aux["load"], raux["load"])


def test_expert_capacity_rule():
    cfg = get_config("deepseek-moe-16b")
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (64, 6, 1.25)
    assert moe.expert_capacity(cfg, 4096) == 480  # prefill, B = 8 x 512
    assert moe.expert_capacity(cfg, 8) == 8  # decode: int(0.9375) = 0 -> the floor of 8
    small = ModelConfig(n_experts=4, top_k=3, capacity_factor=1.1)
    assert moe.expert_capacity(small, 37) == 30  # int(30.525): truncation, not rounding
