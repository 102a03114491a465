"""The port's Multi-head Latent Attention against repro's, on the CPU.

repro's ``init_mla`` weights carried across as numpy arrays, the same
inputs from a numpy seed, through both packages, with and without the query
LoRA (``q_lora_rank`` 24 and 0):
- the layer without a cache and a prefill into the latent ring (the
  decompressed path) followed by absorbed decode steps: allclose(rtol=1e-5,
  atol=2e-5), float32; the rings
  (``c_kv``, ``k_rope``) allclose(rtol=1e-5, atol=1e-6), positions equal;
- the port's absorbed decode against its own full forward (atol 2e-5, as
  repro's tests/test_models.py holds repro's);
- an MLA block in bfloat16 with a cache (a prefill of 7, then one decode
  step): within one bfloat16 ulp (rtol=2**-7), the rings equal. repro's
  block is jitted: without an FFN's elementwise chain XLA keeps no excess
  bfloat16 precision here, and the jitted block equals the port's bit for
  bit (one compile instead of one per primitive: eager costs ~15 s). Its
  weights are float32 draws rounded to bfloat16, as ``init_block`` in
  bfloat16 lays them out (the norms float32).
The CUDA leg is in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import backbone as j_bb
from repro.models import mla as j_mla
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import backbone as bb
from repro_torch.models import mla

BF16_ULP = 2.0**-7  # bfloat16 keeps 8 significant bits
B, S, PREFILL, MAX_LEN = 2, 10, 6, 12
DIMS = dict(d_model=64, n_heads=4, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)

# repro's functions jitted: one compile per shape instead of one per primitive
j_layer = jax.jit(j_mla.mla_layer, static_argnames=("cfg",))
j_init = jax.jit(j_mla.init_mla, static_argnames=("cfg", "dtype"))
j_apply_block = jax.jit(j_bb.apply_block, static_argnames=("spec", "cfg"))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flat(sub, (*path, key)))
        return out
    return {".".join(path): torch.as_tensor(np.array(tree, np.float32))}


def _pair(q_lora: int):
    cfg_j, cfg = JModelConfig(q_lora_rank=q_lora, **DIMS), ModelConfig(q_lora_rank=q_lora, **DIMS)
    jp = j_init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    layer = mla.MLA(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.load_state_dict(_flat(jp))
    return cfg_j, jp, cfg, layer


@pytest.mark.parametrize("q_lora", [24, 0])
def test_mla_layer_full_prefill_and_absorbed_decode_match_repro(q_lora):
    cfg_j, jp, cfg, layer = _pair(q_lora)
    assert hasattr(layer, "w_dq") == bool(q_lora) and hasattr(layer, "q_norm") == bool(q_lora)
    rng = np.random.default_rng(q_lora)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    xt, pt = torch.as_tensor(x), torch.as_tensor(pos)

    # no cache: the decompressed path, as the prefill below takes it
    jfull, jnone = j_layer(jp, jnp.asarray(x[:, :PREFILL]), jnp.asarray(pos[:, :PREFILL]), cfg_j)
    with torch.inference_mode():
        full, none = mla.mla_layer(layer, xt, pt, cfg)
    assert none is None and jnone is None and full.dtype == torch.float32
    np.testing.assert_allclose(full[:, :PREFILL].numpy(), np.asarray(jfull), rtol=1e-5, atol=2e-5)

    jc = j_mla.init_mla_cache(B, MAX_LEN, cfg_j, jnp.float32)
    cache = mla.init_mla_cache(B, MAX_LEN, cfg, torch.float32, "cpu")
    outs = []
    for lo, hi in ((0, PREFILL), *((t, t + 1) for t in range(PREFILL, S))):
        jo, jc = j_layer(jp, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cfg_j, jc)
        with torch.inference_mode():
            o, ret = mla.mla_layer(layer, xt[:, lo:hi], pt[:, lo:hi], cfg, cache)
        assert ret is cache  # written in place, as the port's KV rings are
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=2e-5)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jc["pos"]))
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jc[key]), rtol=1e-5, atol=1e-6)
        outs.append(o)
    assert cache["pos"][0].tolist() == [*range(S), -1, -1]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-5)


def test_mla_block_bf16_matches_repro_within_one_ulp():
    """An MLA block (q LoRA, no FFN) in bfloat16: prefill of 7 into the
    ring, then one absorbed decode step."""
    spec_j, spec = JBlockSpec(kind="mla", ffn="none"), BlockSpec(kind="mla", ffn="none")
    cfg_j = JModelConfig(q_lora_rank=24, param_dtype="bfloat16", **DIMS)
    cfg = ModelConfig(q_lora_rank=24, param_dtype="bfloat16", **DIMS)
    block = bb.Block(spec, cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    # repro's init_block in bfloat16: the float32 draws (one compiled init,
    # shared with the test above) rounded to bfloat16; the norms float32
    inner = j_init(jax.random.PRNGKey(3), JModelConfig(q_lora_rank=24, **DIMS), jnp.float32)
    jp = {"pre_norm": {"scale": jnp.zeros(cfg.d_model, jnp.float32)},
          "inner": {k: v if k.endswith("norm") else v.astype(jnp.bfloat16) for k, v in inner.items()}}
    sd = {k: v.to(block.state_dict()[k].dtype)
          for k, v in _flat(jax.tree.map(lambda a: a.astype(jnp.float32), jp)).items()}
    block.load_state_dict(sd)
    assert block.inner.w_uk.dtype == torch.bfloat16 and block.inner.kv_norm.scale.dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(4).normal(size=(B, 8, cfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.array(x.astype(jnp.float32))).bfloat16()
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (B, 8)).copy()
    jc = j_bb.init_block_cache(spec_j, cfg_j, B, MAX_LEN, jnp.bfloat16)
    tc = bb.init_block_cache(spec, cfg, B, MAX_LEN, torch.bfloat16, "cpu")
    for lo, hi in ((0, 7), (7, 8)):
        jx, jc, _ = j_apply_block(jp, spec_j, cfg_j, x[:, lo:hi], jnp.asarray(pos[:, lo:hi]), jc)
        with torch.inference_mode():
            tx, tc, _ = block(xt[:, lo:hi], torch.as_tensor(pos[:, lo:hi]), tc)
        assert tx.dtype == torch.bfloat16
        np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)),
                                   rtol=BF16_ULP, atol=1e-6)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_array_equal(tc[key].float().numpy(),
                                          np.asarray(jc[key].astype(jnp.float32)))


def test_mla_cache_shapes_and_dtypes_match_repro():
    cfg_j, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    jc = j_mla.init_mla_cache(3, 5, cfg_j, jnp.bfloat16)
    tc = mla.init_mla_cache(3, 5, cfg, torch.bfloat16, "cpu")
    assert set(tc) == set(jc) == {"c_kv", "k_rope", "pos"}
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_array_equal(tc[key].float().numpy(), np.asarray(jc[key], np.float32))
    assert tc["pos"].dtype == torch.int32 and tc["c_kv"].dtype == torch.bfloat16
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
