"""The port's attention and MoE language models against repro's, on the CPU.

Each of the seven smoke configs whose blocks are attention with a dense or
MoE FFN (gemma2-27b, glm4-9b, yi-34b, gemma3-1b, whisper-base,
deepseek-moe-16b, internvl2-76b) is built in both packages, repro's init
carried across with ``convert.lm_params_from_numpy``, and served through
``Engine.generate`` with ``batch_extras`` (whisper's frames, internvl2's
patch embeddings): float32 prefill and teacher-forced decode logits
allclose(rtol=1e-4, atol=1e-4), greedy tokens equal. Also: prefill + decode
against the port's own full forward (repro's 3e-4), the MoE load aux, the KV
rings after a prefill, the encoder output carried in the caches, and
deepseek-moe-16b's smoke config in bfloat16 block by block (each block run
eagerly within one bfloat16 ulp, rtol=2**-7, as tests/test_torch_rwkv6.py
holds RWKV-6 blocks; the jitted model's logits within atol=0.025). The CUDA
legs are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import backbone as j_bb
from repro.models.model import build_model as j_build_model
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed.mesh import make_mesh
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig

ATTN_ARCHS = ["deepseek-moe-16b", "gemma2-27b", "gemma3-1b", "glm4-9b", "internvl2-76b",
              "whisper-base", "yi-34b"]
B, S, NEW, MAX_LEN = 2, 11, 6, 24
BF16_ULP = 2.0**-7


def _extras(cfg, b, seed=9):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"prefix_embeddings": rng.normal(
            size=(b, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)}
    return None


def _j(extras):
    return None if extras is None else {k: jnp.asarray(v) for k, v in extras.items()}


def _build(arch, dtype="float32"):
    cfg_j = dataclasses.replace(j_get_config(arch, smoke=True), param_dtype=dtype,
                                compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype,
                              compute_dtype=dtype)
    jm = j_build_model(cfg_j)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))  # one compile, not one per op
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    return cfg_j, jm, jparams, cfg, model


@pytest.fixture(scope="module")
def pairs():
    """arch -> (cfg_j, repro model, its params, its serving engine, cfg, port model),
    built once for the module."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg_j, jm, jparams, cfg, model = _build(arch)
            engine = JEngine(jm, jparams, JServeConfig(max_len=MAX_LEN))
            built[arch] = cfg_j, jm, jparams, engine, cfg, model
        return built[arch]

    return get


def _prompts(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_smoke_arch_serves_as_repro(pairs, arch):
    """Prefill and 3 teacher-forced decode steps: logits allclose; then
    ``Engine.generate``: greedy tokens equal."""
    cfg_j, jm, jparams, jengine, cfg, model = pairs(arch)
    toks, extras = _prompts(cfg), _extras(cfg, B)
    jl, jc = jengine._prefill(jparams, jnp.asarray(toks), jm.init_caches(B, MAX_LEN), _j(extras))
    with torch.inference_mode():
        logits, caches = model.prefill(torch.as_tensor(toks).long(),
                                       model.init_caches(B, MAX_LEN), extras)
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
    want = jengine.generate(jnp.asarray(toks), NEW, _j(extras))
    got = Engine(model, ServeConfig(max_len=MAX_LEN)).generate(toks, NEW, extras)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_smoke_arch_prefill_decode_equals_full_forward(pairs, arch):
    """repro's tests/test_smoke_archs.py check on the port: prefill 8, decode
    4, against one forward over all 12 positions (max abs err < 3e-4)."""
    *_, cfg, model = pairs(arch)
    toks = torch.as_tensor(_prompts(cfg, s=12, seed=1)).long()
    extras = _extras(cfg, B, seed=2)
    pos = torch.arange(12).expand(B, 12)
    with torch.inference_mode():
        h, _, _ = model(toks, pos, None, extras)
        full = model._unembed(h)
        lp, caches = model.prefill(toks[:, :8], model.init_caches(B, 12, torch.float32), extras)
        errs = [float((lp[:, 0] - full[:, 7]).abs().max())]
        for t in range(8, 12):
            ld, caches = model.decode_step(toks[:, t:t + 1], pos[:, t:t + 1], caches)
            errs.append(float((ld[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 3e-4, errs


def test_moe_load_aux_matches_repro(pairs):
    """The forward's ``moe_load`` (every MoE layer summed) and
    ``moe_load_periods`` [n_periods, E] equal repro's."""
    cfg_j, jm, jparams, _, cfg, model = pairs("deepseek-moe-16b")
    toks = _prompts(cfg, seed=3)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    _, _, jaux = jm.forward(jparams, jnp.asarray(toks), jnp.asarray(pos))
    with torch.inference_mode():
        _, _, aux = model(torch.as_tensor(toks).long(), torch.as_tensor(pos).long())
    assert aux["moe_load_periods"].shape == (cfg.n_periods, cfg.n_experts)
    for key in ("moe_load", "moe_load_periods"):
        np.testing.assert_array_equal(aux[key].numpy(), np.asarray(jaux[key]))
    assert float(aux["moe_load"].sum()) == B * S * cfg.top_k * cfg.n_periods


def test_kv_rings_after_prefill_match_repro(pairs):
    """gemma3-1b smoke: windows of 8 hold the last 8 of 11 prompt tokens in
    ring order, global layers all 11 (unwritten slots at -1); every layer's
    K, V and positions as repro's, prefix/period/remainder layers in order."""
    cfg_j, jm, jparams, jengine, cfg, model = pairs("gemma3-1b")
    toks = _prompts(cfg, seed=4)
    _, jc = jengine._prefill(jparams, jnp.asarray(toks), jm.init_caches(B, MAX_LEN), None)
    with torch.inference_mode():
        _, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(B, MAX_LEN))
    n_p = len(cfg.period)
    for layer, got in enumerate(caches["stack"]):
        if layer < cfg.n_periods * n_p:
            want = jax.tree.map(lambda a: a[layer // n_p], jc["stack"]["periods"][f"b{layer % n_p}"])
        else:
            want = jc["stack"][f"remainder{layer - cfg.n_periods * n_p}"]
        np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
        np.testing.assert_allclose(got["k"].numpy(), np.asarray(want["k"]), atol=1e-5)
        np.testing.assert_allclose(got["v"].numpy(), np.asarray(want["v"]), atol=1e-5)
    assert caches["stack"][0]["pos"][0].tolist() == [8, 9, 10, 3, 4, 5, 6, 7]


def test_encoder_output_rides_in_the_caches(pairs):
    """whisper-base smoke: prefill encodes the frames once and leaves the
    normed encoder output in the caches, as repro's; decode reads it there."""
    cfg_j, jm, jparams, jengine, cfg, model = pairs("whisper-base")
    toks, extras = _prompts(cfg, seed=5), _extras(cfg, B, seed=6)
    _, jc = jengine._prefill(jparams, jnp.asarray(toks), jm.init_caches(B, MAX_LEN), _j(extras))
    with torch.inference_mode():
        fresh = model.init_caches(B, MAX_LEN)
        assert fresh["enc_out"].shape == (B, cfg.enc_seq, cfg.d_model)
        assert torch.count_nonzero(fresh["enc_out"]) == 0
        _, caches = model.prefill(torch.as_tensor(toks).long(), fresh, extras)
    np.testing.assert_allclose(caches["enc_out"].numpy(), np.asarray(jc["enc_out"]), atol=1e-5)
    assert len(model.encoder) == cfg.n_enc_layers and hasattr(model.stack[0], "cross")


def test_vision_prefix_overwrites_the_first_embeddings(pairs):
    """internvl2-76b smoke: the patch embeddings replace the first
    ``n_prefix_embeddings`` token embeddings only when the batch carries them."""
    *_, cfg, model = pairs("internvl2-76b")
    toks = torch.as_tensor(_prompts(cfg, seed=7)).long()
    extras = _extras(cfg, B, seed=8)
    with torch.inference_mode():
        plain = model._embed(toks, None)
        over = model._embed(toks, {k: torch.as_tensor(v) for k, v in extras.items()})
    n = cfg.n_prefix_embeddings
    assert torch.equal(over[:, n:], plain[:, n:])
    torch.testing.assert_close(over[:, :n], torch.as_tensor(extras["prefix_embeddings"]))


def test_bf16_blocks_and_model_match_repro():
    """deepseek-moe-16b smoke in bfloat16 (the dense prefix layer and two MoE
    layers with shared experts): each block run eagerly with a KV cache (a
    prefill of 13, then one decode step), within one bfloat16 ulp
    of repro's, the MoE loads equal; the jitted model's logits within 0.025."""
    cfg_j, jm, jparams, cfg, model = _build("deepseek-moe-16b", "bfloat16")
    assert model.stack[1].ffn.wi_gate.dtype == torch.bfloat16
    assert model.stack[1].ffn.router.dtype == torch.float32
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(B, 14, cfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.array(x.astype(jnp.float32))).bfloat16()
    pos = np.broadcast_to(np.arange(14, dtype=np.int32)[None], (B, 14))
    specs = (*cfg_j.prefix_layers, *cfg_j.period * cfg_j.n_periods)
    for layer, spec in enumerate(specs):
        jp = (jparams["stack"]["prefix0"] if layer == 0 else
              jax.tree.map(lambda a: a[layer - 1], jparams["stack"]["periods"]["b0"]))
        jc = j_bb.init_block_cache(spec, cfg_j, B, 16, jnp.bfloat16)
        tc = model.stack.init_caches(B, 16)[layer]
        for lo, hi, cached in ((0, 13, True), (13, 14, True)):
            jx, jnc, jaux = j_bb.apply_block(jp, spec, cfg_j, x[:, lo:hi], jnp.asarray(pos[:, lo:hi]),
                                             jc if cached else None)
            with torch.inference_mode():
                tx, tnc, aux = model.stack[layer](xt[:, lo:hi], torch.as_tensor(pos[:, lo:hi]),
                                                  tc if cached else None)
            assert tx.dtype == torch.bfloat16
            np.testing.assert_allclose(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)),
                                       rtol=BF16_ULP, atol=1e-6)
            if "moe_load" in aux:
                np.testing.assert_array_equal(aux["moe_load"].numpy(), np.asarray(jaux["moe_load"]))
            if cached:
                jc, tc = jnc, tnc
                np.testing.assert_array_equal(tc["k"].float().numpy(),
                                              np.asarray(jc["k"].astype(jnp.float32)))
    toks = _prompts(cfg, s=13)
    jl, jc = jax.jit(jm.prefill)(jparams, jnp.asarray(toks), jm.init_caches(B, 16))
    with torch.inference_mode():
        logits, caches = model.prefill(torch.as_tensor(toks).long(), model.init_caches(B, 16))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=0.025)
    cur = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    pos1 = np.full((B, 1), 13, np.int32)
    jl, _ = jax.jit(jm.decode_step)(jparams, jnp.asarray(cur), jnp.asarray(pos1), jc)
    with torch.inference_mode():
        logits, _ = model.decode_step(torch.as_tensor(cur).long(), torch.as_tensor(pos1).long(),
                                      caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=0.025)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_and_smoke_configs_build(arch):
    """Every architecture's full config is repro's and its smoke config
    builds on the CPU (the full ones are built on the card)."""
    assert ARCHS[arch] is not None
    full = get_config(arch)
    assert full.n_layers == j_get_config(arch).n_layers and full.name == arch
    model = build_model(get_config(arch, smoke=True), device="cpu")
    assert len(model.stack) == get_config(arch, smoke=True).n_layers


def test_unported_parts_raise_lm_remainder():
    """Nothing of the LM remainder is refused any more: the expert-parallel
    MoE (``moe_impl="sharded"``) builds over a mesh
    (tests/test_torch_expert_parallel.py holds it to repro), and only a
    sharded build without a mesh, or an unknown ``moe_impl``, is refused."""
    assert None not in ARCHS.values()
    cfg = get_config("deepseek-moe-16b", smoke=True)
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    model = build_model(cfg, device="cpu", moe_impl="sharded", mesh=mesh)
    assert all(block.moe_impl == "sharded" and block.mesh is mesh for block in model.stack)
    with pytest.raises(ValueError, match="needs a mesh"):
        build_model(cfg, device="cpu", moe_impl="sharded")
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(cfg, device="cpu", moe_impl="ring")


def test_serve_cli_defaults_to_gemma3_and_feeds_whisper_zero_frames(capsys):
    out = serve_cli.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "7",
                          "--max-new", "4"])
    assert out.shape == (2, 4)
    cfg = get_config("gemma3-1b", smoke=True)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 7), dtype=np.int64)
    model = build_model(cfg, device="cpu", seed=0)
    assert torch.equal(out, Engine(model, ServeConfig(max_len=128)).generate(prompts, 4))
    out = serve_cli.main(["--arch", "whisper-base", "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "7", "--max-new", "4"])
    cfg = get_config("whisper-base", smoke=True)
    model = build_model(cfg, device="cpu", seed=0)
    frames = {"frames": np.zeros((2, cfg.enc_seq, cfg.d_model), np.float32)}
    assert torch.equal(out, Engine(model, ServeConfig(max_len=128)).generate(prompts, 4, frames))
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
