"""The port's RWKV-6 serving path against repro's, on the CPU.

Same inputs, made with numpy seeds (or repro's own init, carried across as
numpy arrays), through both packages:
- the chunk step: the port's plain version against repro's
  ``rwkv6_chunk_ref`` and its Pallas kernel in interpret mode, at the shapes
  of repro's kernel test and at the deepest decay the model can produce
  (log_w = -e), allclose(rtol=1e-4, atol=1e-5) as repro holds its kernel;
- one rwkv6 layer (chunked, sequential, prefill then decode with state),
  allclose(atol=2e-5) as repro's model test holds chunked to sequential;
- the rwkv6-3b smoke model through ``lm_params_from_numpy``: float32 logits
  allclose(rtol=1e-4, atol=1e-4), greedy tokens equal; in bfloat16 each
  block run eagerly equal within one bfloat16 ulp (rtol=2**-7), and the
  jitted model's logits within atol=0.025 (XLA fuses bfloat16 chains under
  jit and skips roundings between ops, which op-by-op PyTorch cannot);
- the serving engine's bounds, the sampler, the CLI and the config registry.
The CUDA legs (kernel against plain version on the card) are in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.rwkv6.ref import rwkv6_chunk_ref as j_chunk_ref
from repro.kernels.rwkv6.rwkv6 import rwkv6_chunk_pallas
from repro.models import backbone as j_bb
from repro.models import rwkv as j_rwkv
from repro.models.model import build_model as j_build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.mesh import make_mesh
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import rwkv
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig

BF16_ULP = 2.0**-7  # bfloat16 keeps 8 significant bits


def _chunk_inputs(b, t, h, p, decay, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, p)).astype(np.float32) * 0.5 for _ in range(3))
    if decay == "deep":
        lw = np.full((b, t, h, p), -np.e, np.float32)
    else:
        lw = -rng.uniform(0.01, 1.0, size=(b, t, h, p)).astype(np.float32)
    u = rng.normal(size=(h, p)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(b, h, p, p)).astype(np.float32) * 0.2
    return r, k, v, lw, u, s0


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# the chunk step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "b,t,h,p,decay",
    [
        (2, 8, 3, 16, "uniform"),  # repro's kernel-test shapes
        (1, 64, 2, 64, "uniform"),
        (2, 16, 4, 32, "uniform"),
        (1, 32, 1, 8, "uniform"),
        (1, 64, 2, 64, "deep"),  # log_w = -e: cum reaches -174
    ],
)
def test_chunk_plain_version_matches_repro(b, t, h, p, decay):
    """Both sides' products pinned to full float32 (``highest``): the
    tolerance is one for float32 sums in two orders, and neither library may
    pick a lower-precision product for its default on this CPU."""
    args = _chunk_inputs(b, t, h, p, decay, seed=b * 100 + t)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        y, s1 = rwkv_ops.rwkv6_chunk_ref(*_t(args))
    finally:
        torch.set_float32_matmul_precision(precision)
    jargs = [jnp.asarray(a) for a in args]
    with jax.default_matmul_precision("highest"):
        refs = {"rwkv6_chunk_ref": j_chunk_ref(*jargs),
                "rwkv6_chunk_pallas (interpret)": rwkv6_chunk_pallas(*jargs, interpret=True)}
    for name, (jy, js) in refs.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5,
                                   err_msg=f"y against repro's {name}")
        np.testing.assert_allclose(s1.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5,
                                   err_msg=f"s1 against repro's {name}")
    assert np.isfinite(y.numpy()).all() and np.isfinite(s1.numpy()).all()


def test_chunk_wrapper_runs_the_plain_version_on_cpu_tensors():
    args = _t(_chunk_inputs(2, 8, 3, 16, "uniform", seed=1))
    before = rwkv_ops.rwkv6_chunk.launches
    y, s1 = rwkv_ops.rwkv6_chunk(*args)
    y_ref, s1_ref = rwkv_ops.rwkv6_chunk_ref(*args)
    assert torch.equal(y, y_ref) and torch.equal(s1, s1_ref)
    assert rwkv_ops.rwkv6_chunk.launches == before  # no kernel on the CPU
    # the meta device (the dry run) gives outputs of the right shapes only
    y_m, s1_m = rwkv_ops.rwkv6_chunk(*(a.to("meta") for a in args))
    assert (y_m.device.type, y_m.shape, s1_m.shape) == ("meta", y.shape, s1.shape)
    assert rwkv_ops.rwkv6_chunk.launches == before


def test_chunked_core_pads_the_tail_and_threads_the_state():
    """Two chunks and a padded tail through the chunk step equal the
    sequential oracle, state carried in and out."""
    r, k, v, lw, u, _ = _t(_chunk_inputs(2, 21, 3, 16, "uniform", seed=7))
    s0 = torch.as_tensor(np.random.default_rng(8).normal(size=(2, 3, 16, 16)).astype(np.float32))
    y_seq, s_seq = rwkv.rwkv6_sequential_core(r, k, v, lw, u, s0)
    for use_kernel in (True, False):
        y, s = rwkv.rwkv6_chunked_core(r, k, v, lw, u, 8, s0, use_kernel)
        assert y.shape == (2, 21, 3, 16)
        torch.testing.assert_close(y, y_seq, rtol=1e-4, atol=2e-5)
        torch.testing.assert_close(s, s_seq, rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flat(sub, (*path, key)))
        return out
    return {".".join(path): torch.as_tensor(np.array(tree, np.float32))}


def test_rwkv6_layer_matches_repro_chunked_sequential_and_decode():
    cfg_j = JModelConfig(d_model=32, n_heads=4, ssm_chunk=8, rwkv_lora_w=8, rwkv_lora_mix=4)
    cfg = ModelConfig(d_model=32, n_heads=4, ssm_chunk=8, rwkv_lora_w=8, rwkv_lora_mix=4)
    jp = j_rwkv.init_rwkv6(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    layer = rwkv.RWKV6(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.load_state_dict(_flat(jp))
    b, s = 2, 36
    x = np.random.default_rng(1).normal(size=(b, s, 32)).astype(np.float32) * 0.5
    xt = torch.as_tensor(x)
    with torch.no_grad():
        y_chk, _ = layer(xt)
        y_seq, _ = layer(xt, sequential=True)
        st = rwkv.init_state(b, cfg, "cpu")
        y_p, st = layer(xt[:, :20], st)
        outs = [y_p]
        for t in range(20, s):
            o, st = layer(xt[:, t: t + 1], st)
            outs.append(o)
    jy_chk, _ = j_rwkv.rwkv6_layer(jp, jnp.asarray(x), cfg_j)
    jy_seq, _ = j_rwkv.rwkv6_layer(jp, jnp.asarray(x), cfg_j, sequential=True)
    jst = j_rwkv.init_rwkv6_state(b, cfg_j)
    _, jst = j_rwkv.rwkv6_layer(jp, jnp.asarray(x[:, :20]), cfg_j, state=jst)
    np.testing.assert_allclose(y_chk.numpy(), np.asarray(jy_chk), atol=2e-5)
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(jy_seq), atol=2e-5)
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=2e-5)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_seq.numpy(), atol=2e-5)
    with torch.no_grad():
        _, st20 = layer(xt[:, :20], rwkv.init_state(b, cfg, "cpu"))
    np.testing.assert_allclose(st20["wkv"].numpy(), np.asarray(jst["wkv"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(st20["x_prev"].numpy(), np.asarray(jst["x_prev"]))


# ---------------------------------------------------------------------------
# the rwkv6-3b smoke model
# ---------------------------------------------------------------------------
def _smoke_pair(dtype):
    cfg_j = dataclasses.replace(j_get_config("rwkv6-3b", smoke=True),
                                param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                              param_dtype=dtype, compute_dtype=dtype)
    jm = j_build_model(cfg_j)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    return cfg_j, jm, jparams, cfg, model


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_smoke_model_fp32_prefill_and_decode_logits_match_repro():
    cfg_j, jm, jparams, cfg, model = _smoke_pair("float32")
    toks = _prompts(cfg, 2, 13)
    jl, jc = jax.jit(jm.prefill)(jparams, jnp.asarray(toks), jm.init_caches(2, 32))
    with torch.inference_mode():
        logits, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(2, 32))
    assert logits.shape == (2, 1, cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(caches["stack"][layer]["wkv"].numpy(),
                                   np.asarray(jc["stack"]["periods"]["b0"]["wkv"][layer]),
                                   rtol=1e-4, atol=1e-4)
    jdecode = jax.jit(jm.decode_step)
    cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):  # teacher-forced: repro's greedy tokens into both
        pos = np.full((2, 1), 13 + t, np.int32)
        jl, jc = jdecode(jparams, jnp.asarray(cur), jnp.asarray(pos), jc)
        with torch.inference_mode():
            logits, caches = model.decode_step(torch.as_tensor(cur).long(),
                                               torch.as_tensor(pos).long(), caches)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def test_smoke_model_greedy_tokens_equal_repro():
    """16 new tokens after a 13-token prompt (not a multiple of the chunk of 8)."""
    cfg_j, jm, jparams, cfg, model = _smoke_pair("float32")
    toks = _prompts(cfg, 3, 13, seed=4)
    want = JEngine(jm, jparams, JServeConfig(max_len=32)).generate(jnp.asarray(toks), 16)
    got = Engine(model, ServeConfig(max_len=32)).generate(toks, 16)
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smoke_model_bf16_matches_repro():
    cfg_j, jm, jparams, cfg, model = _smoke_pair("bfloat16")
    assert model.stack[0].inner.wr.dtype == torch.bfloat16
    assert model.stack[0].inner.mu.dtype == torch.float32
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, 13, cfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.array(x.astype(jnp.float32))).bfloat16()
    # each block run eagerly (op by op, as PyTorch runs it), with a carried state
    for layer in range(cfg.n_layers):
        jp = jax.tree.map(lambda a: a[layer], jparams["stack"]["periods"]["b0"])
        st = {"x_prev": rng.normal(size=(2, cfg.d_model)).astype(np.float32),
              "wkv": rng.normal(size=(2, 4, 12, 12)).astype(np.float32)}
        for s in (13, 1):  # prefill (chunked, a padded tail) and decode (sequential)
            jx, jst, _ = j_bb.apply_block(jp, cfg_j.period[0], cfg_j, x[:, :s], None,
                                          jax.tree.map(jnp.asarray, st))
            with torch.inference_mode():
                tx, tst, _ = model.stack[layer](xt[:, :s], None,
                                                {k: torch.as_tensor(v) for k, v in st.items()})
            assert tx.dtype == torch.bfloat16
            np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)),
                                       rtol=BF16_ULP, atol=1e-6)
            np.testing.assert_allclose(tst["wkv"].numpy(), np.asarray(jst["wkv"]),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(tst["x_prev"].numpy(), np.asarray(jst["x_prev"]))
    # the whole model, repro's under jit
    toks = _prompts(cfg, 2, 13)
    jl, jc = jax.jit(jm.prefill)(jparams, jnp.asarray(toks), jm.init_caches(2, 32))
    with torch.inference_mode():
        logits, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(2, 32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=0.025)
    # the first layer's state sees only the (bit-equal) embedding and pre-norm
    np.testing.assert_allclose(caches["stack"][0]["wkv"].numpy(),
                               np.asarray(jc["stack"]["periods"]["b0"]["wkv"][0]),
                               rtol=1e-4, atol=1e-4)
    cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    pos = np.full((2, 1), 13, np.int32)
    jl, _ = jax.jit(jm.decode_step)(jparams, jnp.asarray(cur), jnp.asarray(pos), jc)
    with torch.inference_mode():
        logits, _ = model.decode_step(torch.as_tensor(cur).long(), torch.as_tensor(pos).long(),
                                      caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=0.025)


def test_prefill_runs_one_chunk_step_per_chunk_per_layer(monkeypatch):
    """S tokens run ceil(S / chunk) chunk steps in each layer; decode runs none."""
    calls = []
    real = rwkv_ops.rwkv6_chunk

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(rwkv_ops, "rwkv6_chunk", counting)
    cfg = get_config("rwkv6-3b", smoke=True)
    model = build_model(cfg, device="cpu")
    caches = model.init_caches(2, 32)
    with torch.inference_mode():
        _, caches = model.prefill(torch.as_tensor(_prompts(cfg, 2, 13)).long(), caches)
        assert calls == [(2, cfg.ssm_chunk, cfg.n_heads, cfg.head_dim)] * (2 * cfg.n_layers)
        model.decode_step(torch.zeros((2, 1), dtype=torch.long), torch.full((2, 1), 13), caches)
    assert len(calls) == 2 * cfg.n_layers
    plain = build_model(cfg, device="cpu", rwkv_kernel=False)
    with torch.inference_mode():
        plain.prefill(torch.as_tensor(_prompts(cfg, 2, 13)).long(), plain.init_caches(2, 32))
    assert len(calls) == 2 * cfg.n_layers  # rwkv_kernel=False never calls the wrapper


# ---------------------------------------------------------------------------
# engine, CLI, configs, conversion
# ---------------------------------------------------------------------------
def test_engine_refuses_past_max_len_as_repro_does():
    cfg_j, jm, jparams, cfg, model = _smoke_pair("float32")
    toks = _prompts(cfg, 1, 10)
    with pytest.raises(ValueError) as want:
        JEngine(jm, jparams, JServeConfig(max_len=16)).generate(jnp.asarray(toks), 7)
    with pytest.raises(ValueError) as got:
        Engine(model, ServeConfig(max_len=16)).generate(toks, 7)
    assert str(got.value) == str(want.value)
    assert Engine(model, ServeConfig(max_len=16)).generate(toks, 0).shape == (1, 0)
    assert Engine(model, ServeConfig(max_len=16)).generate(toks, 6).shape == (1, 6)


def test_temperature_sampling_is_seeded_and_stays_in_the_vocabulary():
    cfg = get_config("rwkv6-3b", smoke=True)
    model = build_model(cfg, device="cpu")
    toks = _prompts(cfg, 4, 9)

    def sample(seed):
        return Engine(model, ServeConfig(max_len=32, temperature=1.5, seed=seed)).generate(toks, 8)

    a, b, c = sample(0), sample(0), sample(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (4, 8) and int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    greedy = Engine(model, ServeConfig(max_len=32)).generate(toks, 8)
    assert not torch.equal(a, greedy)


def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys, tmp_path):
    out = serve_cli.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "11", "--max-new", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert "generated (2, 5) on cpu" in capsys.readouterr().out
    # --ckpt-dir is ported (tests/test_torch_checkpoint.py): saved, then loaded
    ckpt = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "11", "--max-new", "5", "--ckpt-dir", str(tmp_path / "ckpt")]
    assert torch.equal(serve_cli.main(ckpt), out)
    assert torch.equal(serve_cli.main(ckpt), out)
    assert "loaded checkpoint step 0" in capsys.readouterr().out
    # every arch serves now (gemma3-1b is the default, as in repro); an
    # unknown one is refused
    for arch in ("gemma3-1b", "zamba2-2.7b"):
        assert serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu"]).shape == (4, 16)
    with pytest.raises(KeyError, match="unknown architecture"):
        serve_cli.main(["--arch", "mamba-7b", "--smoke", "--device", "cpu"])


def _port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    for key in ("period", "remainder", "prefix_layers"):
        fields[key] = tuple(BlockSpec(**b) for b in fields[key])
    return ModelConfig(**fields)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_config_schema_and_param_count_match_repro(arch):
    assert set(ARCHS) == set(J_ARCHS)
    for smoke in (False, True):
        jcfg = j_get_config(arch, smoke=smoke)
        port = _port_config(jcfg)
        assert dataclasses.asdict(port) == dataclasses.asdict(jcfg)
        assert port.param_count() == jcfg.param_count()
        assert port.n_layers == jcfg.n_layers
        assert get_config(arch, smoke=smoke) == port  # all ten, MLA/MTP and Mamba2/shared too


def test_build_model_refuses_what_is_not_ported_and_needs_a_device():
    cfg = get_config("rwkv6-3b", smoke=True)
    moe = dict(n_experts=4, top_k=2, moe_d_ff=16)
    for ported in (  # every block kind, shared blocks and MTP build now
        dataclasses.replace(cfg, period=(BlockSpec(kind="attn"),)),
        dataclasses.replace(cfg, period=(BlockSpec(kind="rwkv6", ffn="moe"),), **moe),
        dataclasses.replace(cfg, post_block_norm=True),
        dataclasses.replace(cfg, remainder=(BlockSpec(kind="rwkv6"),)),
        dataclasses.replace(cfg, period=(BlockSpec(kind="mla"),), q_lora_rank=8, kv_lora_rank=8,
                            qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8),
        dataclasses.replace(cfg, period=(BlockSpec(kind="mamba2"),), ssm_heads=4, ssm_state=8),
        dataclasses.replace(cfg, period=(BlockSpec(kind="rwkv6"), BlockSpec(kind="attn",
                                                                            shared=True))),
        dataclasses.replace(cfg, mtp_depth=1),
    ):
        assert len(build_model(ported, device="cpu").stack) == ported.n_layers
    # the expert-parallel MoE builds over a mesh, and is refused without one
    sharded = dataclasses.replace(cfg, period=(BlockSpec(kind="rwkv6", ffn="moe"),), **moe)
    assert len(build_model(sharded, device="cpu", moe_impl="sharded",
                           mesh=make_mesh((1, 2), devices=["cpu"] * 2)).stack) == sharded.n_layers
    with pytest.raises(ValueError, match="needs a mesh"):
        build_model(sharded, device="cpu", moe_impl="sharded")
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg)


def test_lm_params_from_numpy_unstacks_the_periods():
    """A tree laid out as repro's (periods stacked on a leading axis, bf16
    leaves as ml_dtypes arrays) lands in the right per-layer modules with
    its dtypes. The smoke-model tests load repro's own trees the same way."""
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True), param_dtype="bfloat16",
                              n_periods=3)
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    tree: dict = {}
    for name, t in model.state_dict().items():
        dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else np.float32
        parts = name.split(".")
        if parts[0] == "stack":
            if parts[1] != "0":
                continue
            path = ("stack", "periods", "b0", *parts[2:])
            leaf = rng.normal(size=(3, *t.shape)).astype(dtype)
        else:
            path, leaf = tuple(parts), rng.normal(size=t.shape).astype(dtype)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    sd = lm_params_from_numpy(cfg, tree, "cpu")
    assert set(sd) == set(model.state_dict())
    for layer in range(3):
        wr = sd[f"stack.{layer}.inner.wr"]
        assert wr.dtype == torch.bfloat16
        want = tree["stack"]["periods"]["b0"]["inner"]["wr"][layer].astype(np.float32)
        np.testing.assert_array_equal(wr.float().numpy(), want)
        assert sd[f"stack.{layer}.inner.mu"].dtype == torch.float32
    model.load_state_dict(sd)
    # MTP and a shared block keep their names (their models:
    # tests/test_torch_lm_remainder.py); a leaf outside repro's tree is refused
    extra = lm_params_from_numpy(cfg, {**tree, "mtp": {"proj": np.ones((2, 2), np.float32)},
                                       "stack": {**tree["stack"], "shared_block": {
                                           "pre_norm": {"scale": np.zeros(2, np.float32)}}}},
                                 "cpu")
    assert set(extra) - set(sd) == {"mtp.proj", "stack.shared_block.pre_norm.scale"}
    assert torch.equal(extra["mtp.proj"], torch.ones(2, 2))
    for stray in ({"lm_head": np.zeros(2)}, {"stack": {**tree["stack"], "periodz": np.zeros(2)}}):
        with pytest.raises(ValueError, match="not part of repro's LM tree"):
            lm_params_from_numpy(cfg, {**tree, **stray}, "cpu")
