"""The port's deepseek-v3-671b (MLA, MTP) and zamba2-2.7b (Mamba2, one shared
attention block) against repro's, on the CPU.

Each smoke config is built in both packages, repro's init carried across
with ``convert.lm_params_from_numpy``:
- served through ``Engine.generate``: float32 prefill and teacher-forced
  decode logits allclose(rtol=1e-4, atol=1e-4), greedy tokens equal;
- prefill + decode against the port's own full forward (repro's 3e-4);
- zamba2's shared block: one parameter set under ``stack.shared_block``,
  once in ``state_dict()`` and in ``parameters()``, ``sum(numel)`` equal to
  repro's leaf count, the same module at each application, and each
  application's own KV ring (after a prefill, every ring as repro's
  per-period stacked cache);
- ``Model.loss`` (forward only) against repro's ``loss`` within rtol 1e-5:
  deepseek-v3 with MTP (``loss_chunk`` with a mask, a softmax router with
  the switch-style load term; the whole cross-entropy against the chunked
  one) and zamba2 without MTP;
- the serving CLI for both archs.
The CUDA legs are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig

ARCHS = ["deepseek-v3-671b", "zamba2-2.7b"]
B, S, NEW, MAX_LEN = 2, 11, 6, 24


@pytest.fixture(scope="module")
def pairs():
    """arch -> (repro model, its params, its serving engine, cfg, port model),
    built once for the module."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = get_config(arch, smoke=True)
            jm = j_build_model(j_get_config(arch, smoke=True))
            # one compile, not one per op; the rbg key compiles in two thirds
            # of threefry's time and draws from the same normal distributions
            jparams = jax.jit(jm.init)(jax.random.key(0, impl="rbg"))
            model = build_model(cfg, device="cpu", seed=1)
            model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                       "cpu"))
            engine = JEngine(jm, jparams, JServeConfig(max_len=MAX_LEN))
            built[arch] = jm, jparams, engine, cfg, model
        return built[arch]

    return get


def _prompts(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_serves_as_repro(pairs, arch):
    """Prefill and 3 teacher-forced decode steps: logits allclose; then
    ``Engine.generate``: greedy tokens equal."""
    jm, jparams, jengine, cfg, model = pairs(arch)
    toks = _prompts(cfg)
    # batch_extras=None passed as generate passes it: one compile serves both
    jl, jc = jengine._prefill(jparams, jnp.asarray(toks), jm.init_caches(B, MAX_LEN), None)
    with torch.inference_mode():
        logits, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(B, MAX_LEN))
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):
        pos = np.full((B, 1), S + t, np.int32)
        jl, jc = jengine._decode(jparams, jnp.asarray(cur), jnp.asarray(pos), jc)
        with torch.inference_mode():
            logits, caches = model.decode_step(torch.as_tensor(cur).long(),
                                               torch.as_tensor(pos).long(), caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    want = jengine.generate(jnp.asarray(toks), NEW)
    got = Engine(model, ServeConfig(max_len=MAX_LEN)).generate(toks, NEW)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_prefill_decode_equals_full_forward(pairs, arch):
    """repro's tests/test_smoke_archs.py check on the port: prefill 8
    (MLA: the decompressed path; Mamba2: the chunked core), decode 4 (MLA
    absorbed, Mamba2 sequential), against one forward over all 12 positions
    (max abs err < 3e-4)."""
    *_, cfg, model = pairs(arch)
    toks = torch.as_tensor(_prompts(cfg, s=12, seed=1)).long()
    pos = torch.arange(12).expand(B, 12)
    with torch.inference_mode():
        h, _, _ = model(toks, pos)
        full = model._unembed(h)
        lp, caches = model.prefill(toks[:, :8], model.init_caches(B, 12, torch.float32))
        errs = [float((lp[:, 0] - full[:, 7]).abs().max())]
        for t in range(8, 12):
            ld, caches = model.decode_step(toks[:, t:t + 1], pos[:, t:t + 1], caches)
            errs.append(float((ld[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs


def test_shared_block_is_one_parameter_set_with_a_ring_per_application(pairs):
    """zamba2 smoke: 2 periods of (mamba2, mamba2, shared attention)."""
    jm, jparams, jengine, cfg, model = pairs("zamba2-2.7b")
    n_p = len(cfg.period)
    shared_layers = [i for i, spec in enumerate(cfg.period * cfg.n_periods) if spec.shared]
    assert shared_layers == [2, 5] and len(model.stack) == cfg.n_layers == 6
    assert all(model.stack[i] is model.stack.shared_block for i in shared_layers)
    sd = model.state_dict()
    keys = [k for k in sd if k.startswith("stack.shared_block.")]
    assert keys and not any(k.startswith(("stack.2.", "stack.5.")) for k in sd)
    assert len(set(map(id, model.parameters()))) == len(list(model.parameters())) == len(sd)
    n_repro = sum(int(np.size(a)) for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in model.parameters()) == sum(t.numel() for t in sd.values()) == n_repro
    # each application its own KV ring, as repro's per-period stacked cache
    toks = _prompts(cfg, seed=2)
    _, jc = jengine._prefill(jparams, jnp.asarray(toks), jm.init_caches(B, MAX_LEN), None)
    with torch.inference_mode():
        _, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(B, MAX_LEN))
    rings = [caches["stack"][i] for i in shared_layers]
    assert rings[0]["k"].data_ptr() != rings[1]["k"].data_ptr()
    assert not torch.equal(rings[0]["k"], rings[1]["k"])
    for period, ring in enumerate(rings):
        want = jax.tree.map(lambda a: np.asarray(a[period]), jc["stack"]["periods"][f"b{n_p - 1}"])
        np.testing.assert_array_equal(ring["pos"].numpy(), want["pos"])
        np.testing.assert_allclose(ring["k"].numpy(), want["k"], atol=1e-5)
        np.testing.assert_allclose(ring["v"].numpy(), want["v"], atol=1e-5)
    for layer in (0, 4):  # a Mamba2 state in each period
        want = jax.tree.map(lambda a: np.asarray(a[layer // n_p]),
                            jc["stack"]["periods"][f"b{layer % n_p}"])
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(caches["stack"][layer][key].numpy(), want[key], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch,loss_chunk", [("deepseek-v3-671b", 4), ("zamba2-2.7b", 0)])
def test_loss_matches_repro(pairs, arch, loss_chunk):
    """``Model.loss`` forward only, against repro's, on the fixture's weights:
    deepseek-v3 with MTP (0.3 x the loss of predicting t + 2) over chunks of
    ``loss_chunk`` with a mask, its router switched to softmax top-k with the
    switch-style load term (``router_aux_free=False``, the same parameters),
    then the port's whole cross-entropy against its chunked one; zamba2
    without MTP or MoE, the whole cross-entropy."""
    _, jparams, _, cfg, model = pairs(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, router_aux_free=False)
        tuned = build_model(cfg, device="cpu", seed=1, loss_chunk=loss_chunk)
        tuned.load_state_dict(model.state_dict())
        model = tuned
    jm = j_build_model(dataclasses.replace(j_get_config(arch, smoke=True),
                                           router_aux_free=cfg.router_aux_free),
                       loss_chunk=loss_chunk)
    assert hasattr(model, "mtp") == bool(cfg.mtp_depth)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if loss_chunk:
        batch["mask"] = (rng.random((B, 12)) < 0.7).astype(np.float32)
    jloss, jaux = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = model.loss(batch)
    assert loss.shape == () and loss.dtype == torch.float32 and torch.equal(aux["loss"], loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    if cfg.n_experts:
        np.testing.assert_array_equal(aux["moe_load"].numpy(), np.asarray(jaux["moe_load"]))
    if loss_chunk:
        model.loss_chunk = 0
        whole, _ = model.loss(batch)
        np.testing.assert_allclose(float(whole), float(loss), rtol=1e-5)
        model.loss_chunk = 5  # 12 is no multiple of 5: the whole cross-entropy, as repro
        assert torch.equal(model.loss(batch)[0], whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_both_archs(capsys, arch):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "7", "--max-new", "4"])
    assert out.shape == (2, 4)
    cfg = get_config(arch, smoke=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 7), dtype=np.int64)
    model = build_model(cfg, device="cpu", seed=0)
    assert torch.equal(out, Engine(model, ServeConfig(max_len=128)).generate(prompts, 4))
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
