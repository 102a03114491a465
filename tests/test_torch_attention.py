"""The port's attention against repro's, on the CPU.

Same inputs, made with numpy seeds (or repro's own init, carried across as
numpy arrays), through both packages:
- ``apply_rope``, ``softcap`` and ``mlp(act=)``: allclose(rtol=1e-6, atol=1e-5)
  (float32 sin, cos, tanh and exp of two libraries, one ulp apart);
- ``attend_dense`` and ``attend_chunked`` at repro's test shapes (S = 130,
  blocks of 32, GQA 8/2, window None/17, softcap None/20) at float32:
  atol 2e-6, as repro holds chunked to dense; rows with no valid key give 0;
- ``attention_core``'s dispatch threshold (which path each shape takes);
- ``attention_layer``: no cache, prefill longer than the ring followed by
  decode (ring contents and positions), qk-norm, ``attn_scale``, softcap and
  ``cross_kv``: atol 2e-5, as repro holds prefill + decode to the full layer.
The CUDA legs are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as j_at
from repro.models import layers as j_layers
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as at
from repro_torch.models import layers


# repro's layer jitted: one compile per shape instead of one per primitive
j_layer = jax.jit(j_at.attention_layer, static_argnames=("cfg", "window"))


def _t(a):
    return torch.as_tensor(np.array(a))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flat(sub, (*path, key)))
        return out
    return {".".join(path): torch.as_tensor(np.array(tree, np.float32))}


# ---------------------------------------------------------------------------
# layers: RoPE, softcap, the gated MLP's activations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_repro(theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 37)).astype(np.int32)
    np.testing.assert_allclose(layers.rope_freqs(16, theta).numpy(),
                               np.asarray(j_layers.rope_freqs(16, theta)), rtol=1e-6)
    got = layers.apply_rope(_t(x), _t(pos).long(), theta)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    # bfloat16 in, bfloat16 out: the rotation itself runs in float32
    xb = jnp.asarray(x, jnp.bfloat16)
    got_b = layers.apply_rope(torch.as_tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                              _t(pos), theta)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(),
                               np.asarray(j_layers.apply_rope(xb, jnp.asarray(pos), theta)
                                          .astype(jnp.float32)), rtol=2.0**-7, atol=1e-5)


def test_softcap_and_mlp_activations_match_repro():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 64)) * 40).astype(np.float32)
    for cap in (None, 20.0, 50.0):
        np.testing.assert_allclose(layers.softcap(_t(x), cap).numpy(),
                                   np.asarray(j_layers.softcap(jnp.asarray(x), cap)),
                                   rtol=1e-6, atol=1e-5)
    jp = j_layers.init_mlp(jax.random.PRNGKey(0), 16, 24, jnp.float32)
    m = layers.MLP(16, 24, torch.float32, "cpu", torch.Generator().manual_seed(0))
    m.load_state_dict(_flat(jp))
    m.requires_grad_(False)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(layers.mlp(m, _t(h), act=act).numpy(),
                                   np.asarray(j_layers.mlp(jp, jnp.asarray(h), act=act)),
                                   rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the masked softmax core
# ---------------------------------------------------------------------------
def _qkv(b=2, s=130, h=8, kv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("window", [None, 17])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_attend_dense_and_chunked_match_repro(window, softcap):
    q, k, v, pos = _qkv()
    kw = dict(window=window, scale=0.25, softcap=softcap)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [_t(a) for a in (q, k, v, pos, pos)]
    j_dense = np.asarray(j_at.attend_dense(*jargs, **kw))
    j_chunk = np.asarray(j_at.attend_chunked(*jargs, **kw, block_q=32, block_k=32))
    dense = at.attend_dense(*targs, **kw)
    chunk = at.attend_chunked(*targs, **kw, block_q=32, block_k=32)
    assert dense.shape == chunk.shape == q.shape
    np.testing.assert_allclose(dense.numpy(), j_dense, atol=2e-6)
    np.testing.assert_allclose(chunk.numpy(), j_chunk, atol=2e-6)
    np.testing.assert_allclose(chunk.numpy(), dense.numpy(), atol=2e-6)


def test_rows_with_no_valid_key_output_zero_on_both_paths():
    """Keys at position -1 (unwritten cache slots) and queries before every
    key: those rows are 0 in both packages, dense and chunked."""
    q, k, v, _ = _qkv(s=40, seed=3)
    q_pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40)).copy()
    k_pos = q_pos + 10  # the first 10 queries see no key
    k_pos[:, ::3] = -1
    kw = dict(window=None, scale=0.3, softcap=None)
    jargs = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    targs = [_t(a) for a in (q, k, v, q_pos, k_pos)]
    for got, want in ((at.attend_dense(*targs, **kw), j_at.attend_dense(*jargs, **kw)),
                      (at.attend_chunked(*targs, **kw, block_q=16, block_k=16),
                       j_at.attend_chunked(*jargs, **kw, block_q=16, block_k=16))):
        assert torch.count_nonzero(got[:, :10]) == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("sq,sk,threshold,path", [
    (64, 64, 128, "attend_dense"),  # 64 * 64 == 128 * 128 // 4
    (65, 64, 128, "attend_chunked"),  # just past it
    (1, 100_000, 128, "attend_dense"),  # one query (decode) is always dense
    (4096, 4096, 4096, "attend_chunked"),  # gemma3-1b's 4096-token prefill
    (2048, 2048, 4096, "attend_dense"),
])
def test_attention_core_takes_repro_path(monkeypatch, sq, sk, threshold, path):
    taken = []
    for mod, name in ((j_at, "repro"), (at, "port")):
        for fn in ("attend_dense", "attend_chunked"):
            monkeypatch.setattr(mod, fn, lambda *a, _f=fn, _n=name, **kw: taken.append((_n, _f)))
    q = np.zeros((1, sq, 1, 4), np.float32)
    k = np.zeros((1, sk, 1, 4), np.float32)
    qp, kp = np.zeros((1, sq), np.int32), np.zeros((1, sk), np.int32)
    j_at.attention_core(q, k, k, qp, kp, scale=1.0, chunk_threshold=threshold)
    at.attention_core(_t(q), _t(k), _t(k), _t(qp), _t(kp), scale=1.0, chunk_threshold=threshold)
    assert taken == [("repro", path), ("port", path)]


# ---------------------------------------------------------------------------
# the full layer
# ---------------------------------------------------------------------------
CFGS = {
    "gqa_qknorm": dict(d_model=64, n_heads=8, n_kv_heads=2, head_dim=16, qk_norm=True),
    "mqa_softcap_scale": dict(d_model=48, n_heads=4, n_kv_heads=1, head_dim=12,
                              attn_softcap=50.0, attn_scale=0.2, rope_theta=1e6),
}


def _layer_pair(name, seed=3):
    cfg_j, cfg = JModelConfig(**CFGS[name]), ModelConfig(**CFGS[name])
    jp = j_at.init_attention(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    layer = at.Attention(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.load_state_dict(_flat(jp))
    return cfg_j, jp, cfg, layer.requires_grad_(False)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("window", [None, 5])
def test_attention_layer_without_cache_matches_repro(name, window):
    cfg_j, jp, cfg, layer = _layer_pair(name)
    x = np.random.default_rng(4).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32)[None], (2, 12))
    want, _ = j_layer(jp, jnp.asarray(x), jnp.asarray(pos), cfg=cfg_j, window=window)
    got, cache = at.attention_layer(layer, _t(x), _t(pos).long(), cfg, window=window)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("window", [None, 5])
def test_attention_layer_prefill_past_the_ring_then_decode_matches_repro(name, window):
    """Prefill 8 tokens into a ring of 5 slots (window 5) or 12 (global), then
    decode 4: every output, and the ring's K, V and positions, as repro's."""
    cfg_j, jp, cfg, layer = _layer_pair(name)
    b, s, max_len = 2, 12, 12
    x = np.random.default_rng(5).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    jc = j_at.init_kv_cache(b, max_len, cfg.n_kv_heads, cfg.head_dim, window, jnp.float32)
    tc = at.init_kv_cache(b, max_len, cfg.n_kv_heads, cfg.head_dim, window, torch.float32, "cpu")
    assert tc["k"].shape == jc["k"].shape and tc["pos"].dtype == torch.int32
    outs = []
    for lo, hi in ((0, 8), *((t, t + 1) for t in range(8, s))):
        jo, jc = j_layer(jp, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cfg=cfg_j,
                         window=window, cache=jc)
        to, tc = at.attention_layer(layer, _t(x[:, lo:hi]), _t(pos[:, lo:hi]).long(), cfg,
                                    window=window, cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=2e-6)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=2e-6)
        outs.append(to)
    full, _ = at.attention_layer(layer, _t(x), _t(pos).long(), cfg, window=window)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=2e-5)


def test_attention_layer_cross_kv_matches_repro():
    """Cross-attention: encoder K/V of 9 frames, queries without RoPE, not causal."""
    cfg_j, jp, cfg, layer = _layer_pair("gqa_qknorm", seed=7)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32)[None], (2, 5))
    jk = jnp.einsum("bsd,dhk->bshk", jnp.asarray(enc), jp["wk"])
    jv = jnp.einsum("bsd,dhk->bshk", jnp.asarray(enc), jp["wv"])
    want, _ = j_layer(jp, jnp.asarray(x), jnp.asarray(pos), cfg=cfg_j, window=None,
                      cross_kv=(jk, jv))
    tk, tv = at.project_heads(_t(enc), layer.wk), at.project_heads(_t(enc), layer.wv)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-6)
    got, cache = at.attention_layer(layer, _t(x), _t(pos).long(), cfg, window=None,
                                    cross_kv=(tk, tv))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
