"""The port's Mamba2 (SSD) block against repro's, on the CPU.

repro's ``init_mamba2`` weights carried across as numpy arrays, the same
inputs from a numpy seed, through both packages:
- the sequential and chunked cores on the same heads, at a length that is
  not a multiple of the chunk (37 over chunks of 16) and from a carried-in
  state ``h0``: outputs and final states allclose(rtol=1e-5, atol=2e-5)
  against repro's, and the port's chunked core against its sequential one
  (repro's 2e-5);
- ``mamba2_layer``: the chunked forward against repro's and the port's
  sequential one, then a prefill of 30 into a state and 20 decode steps
  against repro's: outputs allclose(rtol=1e-5, atol=2e-5),
  the states (``conv``, ``ssm``) after the prefill and after the last step
  allclose(rtol=1e-5, atol=1e-6);
- a Mamba2 block in bfloat16, run eagerly on both sides: a prefill of 13
  from a carried-in state (a random conv history and SSM state), within one
  bfloat16 ulp (rtol=2**-7), the conv histories equal and the SSM states
  allclose(rtol=1e-5, atol=1e-6). (The decode step's bfloat16 ops are the
  prefill's; its sequential core is float32, held above.)
The CUDA leg is in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import BlockSpec as JBlockSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import backbone as j_bb
from repro.models import ssm as j_ssm
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import backbone as bb
from repro_torch.models import ssm

BF16_ULP = 2.0**-7  # bfloat16 keeps 8 significant bits
DIMS = dict(d_model=32, ssm_state=8, ssm_expand=2, ssm_heads=4, ssm_chunk=16)

# repro's functions jitted: one compile per shape instead of one per primitive
j_layer = jax.jit(j_ssm.mamba2_layer, static_argnames=("cfg",))
j_seq = jax.jit(j_ssm.mamba2_sequential_core)
j_chunked = jax.jit(j_ssm.mamba2_chunked_core, static_argnames=("chunk",))
j_init = jax.jit(j_ssm.init_mamba2, static_argnames=("cfg", "dtype"))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flat(sub, (*path, key)))
        return out
    return {".".join(path): torch.as_tensor(np.array(tree, np.float32))}


def _t(a):
    return torch.as_tensor(np.array(a))


def test_cores_match_repro_on_a_padded_tail_from_a_carried_state():
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 2, 37, 3, 4, 5, 16
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 1.0, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    d_skip = rng.normal(size=h).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    args = (xh, bm, cm, dt, a, d_skip)
    jy_seq, jh_seq = j_seq(*map(jnp.asarray, args), jnp.asarray(h0))
    jy_chk, jh_chk = j_chunked(*map(jnp.asarray, args), chunk, jnp.asarray(h0))
    y_seq, h_seq = ssm.mamba2_sequential_core(*map(_t, args), _t(h0))
    y_chk, h_chk = ssm.mamba2_chunked_core(*map(_t, args), chunk, _t(h0))
    assert y_chk.shape == (b, s, h, p) and h_chk.shape == (b, h, p, n)
    for got, want in ((y_seq, jy_seq), (h_seq, jh_seq), (y_chk, jy_chk), (h_chk, jh_chk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=2e-5)
    np.testing.assert_allclose(h_chk.numpy(), h_seq.numpy(), rtol=1e-5, atol=2e-5)
    # no carried state: the zero state, on both sides
    y0, _ = ssm.mamba2_chunked_core(*map(_t, args), chunk)
    jy0, _ = j_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), rtol=1e-5, atol=2e-5)


def test_mamba2_layer_chunked_sequential_prefill_and_decode_match_repro():
    cfg_j, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    jp = j_init(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    layer = ssm.Mamba2(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.load_state_dict(_flat(jp))
    b, s, pre = 2, 50, 30
    u = np.random.default_rng(1).normal(size=(b, s, cfg.d_model)).astype(np.float32) * 0.5
    ut = torch.as_tensor(u)
    with torch.inference_mode():
        y_chk, none = layer(ut)
        y_seq, _ = layer(ut, sequential=True)
    assert none is None
    np.testing.assert_allclose(y_chk.numpy(), np.asarray(j_layer(jp, jnp.asarray(u), cfg_j)[0]),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=2e-5)

    jst = j_ssm.init_mamba2_state(b, cfg_j)
    st = ssm.init_mamba2_state(b, cfg, "cpu")
    for key in ("conv", "ssm"):
        assert st[key].dtype == torch.float32 and tuple(st[key].shape) == jst[key].shape
    outs = []
    for lo, hi in ((0, pre), *((t, t + 1) for t in range(pre, s))):
        jo, jst = j_layer(jp, jnp.asarray(u[:, lo:hi]), cfg_j, jst)
        with torch.inference_mode():
            o, st = layer(ut[:, lo:hi], st)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=2e-5)
        if hi in (pre, s):
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]), rtol=1e-5,
                                           atol=1e-6)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_seq.numpy(), atol=2e-5)


def test_mamba2_block_bf16_matches_repro_within_one_ulp():
    """A Mamba2 block (no FFN) in bfloat16, eager on both sides: the conv
    taps summed in repro's order after the carried-in history, silu and the
    gated norm op by op."""
    spec_j, spec = JBlockSpec(kind="mamba2", ffn="none"), BlockSpec(kind="mamba2", ffn="none")
    cfg_j = JModelConfig(param_dtype="bfloat16", **DIMS)
    cfg = ModelConfig(param_dtype="bfloat16", **DIMS)
    # repro's init_block in bfloat16: the float32 draws (one compiled init,
    # shared with the test above) rounded to bfloat16 where init_mamba2 draws
    # in the parameter dtype; A, D, dt_bias and the norms float32
    inner = j_init(jax.random.PRNGKey(3), JModelConfig(**DIMS), jnp.float32)
    wide = ("in_proj", "conv_w", "conv_b", "out_proj")
    jp = {"pre_norm": {"scale": jnp.zeros(cfg.d_model, jnp.float32)},
          "inner": {k: v.astype(jnp.bfloat16) if k in wide else v for k, v in inner.items()}}
    block = bb.Block(spec, cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    sd = {k: v.to(block.state_dict()[k].dtype)
          for k, v in _flat(jax.tree.map(lambda a: a.astype(jnp.float32), jp)).items()}
    block.load_state_dict(sd)
    assert block.inner.in_proj.dtype == torch.bfloat16 and block.inner.a_log.dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(4).normal(size=(2, 14, cfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.array(x.astype(jnp.float32))).bfloat16()
    rng = np.random.default_rng(5)
    state = {"conv": rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)),
             "ssm": rng.normal(size=(2, cfg.n_ssm_heads, cfg.d_inner // cfg.n_ssm_heads,
                                     cfg.ssm_state)) * 0.3}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    pos = np.broadcast_to(np.arange(13, dtype=np.int32)[None], (2, 13)).copy()
    jx, jc, _ = j_bb.apply_block(jp, spec_j, cfg_j, x[:, :13], jnp.asarray(pos),
                                 {k: jnp.asarray(v) for k, v in state.items()})
    with torch.inference_mode():
        tx, tc, _ = block(xt[:, :13], torch.as_tensor(pos),
                          {k: torch.as_tensor(v) for k, v in state.items()})
    assert tx.dtype == torch.bfloat16 and tc["conv"].dtype == torch.float32
    np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-6)
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]), rtol=1e-5, atol=1e-6)
