"""DeepSeek-V2-Lite on the port (``configs/deepseek_v2_lite.py``), at
``smoke()`` size on the CPU, against the plain reference.

The reference (``plain_deepseek_v2_lite.py``, a copy of
``perfbench/reference/deepseek_v2_lite.py``) is the published model's
forward pass in plain float32 PyTorch, in the published checkpoint's layout;
the port's model loads the reference's seeded tensors by name through
``checkpoint.hf.load_deepseek_v2``, as a checkpoint load would. Held here:
prefill logits and the latent cache, prefill then absorbed decode against
the reference's full forward, YaRN's frequencies and temperature in closed
form, the router's raw top-k probabilities, dropless dispatch under a
router that sends every token to one expert, the published parameter
count, the registry, the serving CLI and the MoE's profiler spans. One
torch thread; no JAX.
"""

import dataclasses
import math
from pathlib import Path

import plain_deepseek_v2_lite as plain
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.checkpoint.hf import deepseek_v2_tensors, load_deepseek_v2
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.configs.base import ModelConfig, PortModelConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models import backbone, layers, mla, moe
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 11
B, S = 2, 37
# float32 on both sides, summed in other orders: a few float32 ulps after
# seven layers (measured 2e-7 - 8e-7 relative)
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def published(cfg) -> dict:
    """``cfg`` under the published config's keys, as the reference reads them."""
    y = cfg.yarn
    return dict(
        hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_dim, qk_rope_head_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim, vocab_size=cfg.vocab, num_hidden_layers=cfg.n_layers,
        first_k_dense_replace=len(cfg.prefix_layers), intermediate_size=cfg.d_ff,
        moe_intermediate_size=cfg.moe_d_ff, n_routed_experts=cfg.n_experts,
        n_shared_experts=cfg.n_shared_experts, num_experts_per_tok=cfg.top_k,
        norm_topk_prob=cfg.norm_topk_prob, routed_scaling_factor=cfg.routed_scaling_factor,
        rope_theta=cfg.rope_theta,
        rope_scaling=dict(type="yarn", factor=y.factor,
                          original_max_position_embeddings=y.original_max_position,
                          beta_fast=y.beta_fast, beta_slow=y.beta_slow, mscale=y.mscale,
                          mscale_all_dim=y.mscale_all_dim))


def _model(cfg, seed=SEED, **kwargs):
    model = build_model(cfg, "cpu", seed=3, **kwargs)
    load_deepseek_v2(model, lambda name, shape: plain.make(seed, name, shape, "cpu"))
    return model


def _tokens(cfg, shape, seed=0):
    return torch.randint(0, cfg.vocab, shape, generator=torch.Generator().manual_seed(seed))


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def smoke():
    return get_config("deepseek-v2-lite", smoke=True)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_config_has_the_published_widths_and_depth():
    cfg = get_config("deepseek-v2-lite")
    assert isinstance(cfg, PortModelConfig)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.n_heads, cfg.q_lora_rank) == (
        27, 2048, 102400, 16, 0)
    assert (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim) == (
        512, 128, 64, 128)
    assert (cfg.d_ff, cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts, cfg.top_k) == (
        10944, 64, 1408, 2, 6)
    assert [b.kind for b in cfg.prefix_layers] == ["mla"] and cfg.n_periods == 26
    assert all(b.kind == "mla" and b.ffn == "moe" for b in cfg.period)
    assert (cfg.yarn.factor, cfg.yarn.original_max_position, cfg.yarn.beta_fast,
            cfg.yarn.beta_slow, cfg.yarn.mscale, cfg.yarn.mscale_all_dim) == (
        40.0, 4096, 32.0, 1.0, 0.707, 0.707)
    assert not cfg.norm_topk_prob and cfg.routed_scaling_factor == 1.0 and cfg.moe_dropless
    assert not cfg.tie_embeddings and not cfg.router_aux_free


def test_param_count_is_the_published_15_7_billion():
    total, _ = get_config("deepseek-v2-lite").param_count()
    assert abs(total - 15.7e9) / 15.7e9 < 0.01


def test_registry_keeps_repro_s_ten_and_names_the_port_s_own():
    assert len(ARCHS) == 10 and "deepseek-v2-lite" not in ARCHS
    assert set(PORT_ARCHS) == {"deepseek-v2-lite"}
    plain_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert {"yarn", "norm_topk_prob", "routed_scaling_factor", "moe_dropless"}.isdisjoint(
        plain_fields)
    for arch in ARCHS:  # repro's configs stay plain ModelConfigs
        assert type(get_config(arch)) is ModelConfig
    with pytest.raises(KeyError, match="deepseek-v2-lite"):
        get_config("mamba-7b")


def test_published_tensors_load_every_parameter(smoke):
    assert deepseek_v2_tensors(smoke) == plain.tensor_shapes(published(smoke))
    model = _model(smoke)
    for name, p in model.named_parameters():
        if name.endswith("router_bias"):
            assert not p.any()
    rope = plain.make(SEED, "model.layers.0.self_attn.kv_a_proj_with_mqa.weight", (24, 64),
                      "cpu")[16:].float()
    # the rope rows, de-interleaved: even ones, then odd ones
    want = torch.cat([rope[0::2], rope[1::2]]).T
    assert torch.equal(model.stack[0].inner.w_kr, want)


# ---------------------------------------------------------------------------
# the forward pass against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [SEED, 5])
def test_prefill_logits_and_latent_cache_match_the_reference(smoke, seed):
    model = _model(smoke, seed)
    tokens = _tokens(smoke, (B, S), seed)
    with torch.inference_mode():
        logits, caches, aux = model.prefill(tokens, model.init_caches(B, 48), return_aux=True)
    ref = plain.forward(published(smoke), seed, tokens)
    assert _rel(logits[:, 0], ref["logits"]) < REL
    last = caches["stack"][-1]
    assert _rel(last["c_kv"][:, :S], ref["c_kv"]) < REL
    assert _rel(last["k_rope"][:, :S], ref["k_rope"]) < REL
    assert torch.equal(aux["moe_choices"], ref["choices"])
    assert aux["moe_dropped"].tolist() == [0.0] * smoke.n_periods
    loads = torch.stack([torch.bincount(c.reshape(-1), minlength=smoke.n_experts)
                         for c in ref["choices"]]).float()
    assert torch.equal(aux["moe_load_periods"], loads)  # a period is one MoE layer


def test_prefill_then_absorbed_decode_match_the_full_forward(smoke):
    model = _model(smoke)
    prompt, more = _tokens(smoke, (B, S)), _tokens(smoke, (B, 4), seed=1)
    ref = plain.forward(published(smoke), SEED, torch.cat([prompt, more], 1), all_logits=True)
    with torch.inference_mode():
        logits, caches = model.prefill(prompt, model.init_caches(B, 48))
        got = [logits[:, 0]]
        for j in range(4):
            logits, caches = model.decode_step(more[:, j:j + 1], torch.full((B, 1), S + j),
                                               caches)
            got.append(logits[:, 0])
    for j, step in enumerate(got):
        assert _rel(step, ref["logits"][:, S - 1 + j]) < REL, j


def test_loss_backpropagates_through_the_dropless_dispatch(smoke):
    model = _model(smoke, requires_grad=True)
    tokens = _tokens(smoke, (B, 12))
    loss, _ = model.loss({"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
    loss.backward()
    assert torch.isfinite(loss)
    assert model.stack[1].ffn.wi_gate.grad.abs().sum() > 0
    assert model.stack[1].ffn.router.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------
def test_yarn_frequencies_and_temperature_in_closed_form():
    cfg = get_config("deepseek-v2-lite")
    y = cfg.yarn
    # correction dims of 32 and 1 rotations in 4096 positions, 64 rope dims
    assert layers.yarn_correction_range(64, 10000.0, y) == (10, 23)
    got = layers.rope_freqs(64, 10000.0, yarn=y).double()
    for i in range(32):
        base = 10000.0 ** (-2 * i / 64)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want = base / 40 * ramp + base * (1 - ramp)
        assert got[i].item() == pytest.approx(want, rel=1e-6), i
    m = 0.1 * 0.707 * math.log(40) + 1
    assert layers.yarn_mscale(40, 0.707) == pytest.approx(m) and m == pytest.approx(1.2608, 1e-4)
    assert layers.yarn_mscale(1.0, 0.707) == 1.0
    assert torch.equal(layers.rope_freqs(64, 10000.0), layers.rope_freqs(64, 10000.0, yarn=None))


def test_mla_softmax_scale_takes_the_squared_temperature(smoke, monkeypatch):
    seen = []
    core = mla.attention_core

    def spy(*args, **kwargs):
        seen.append(kwargs["scale"])
        return core(*args, **kwargs)

    monkeypatch.setattr(mla, "attention_core", spy)
    model = _model(smoke)
    with torch.inference_mode():
        model.prefill(_tokens(smoke, (1, 5)), model.init_caches(1, 8))
    m = layers.yarn_mscale(40, 0.707)
    want = (smoke.qk_nope_dim + smoke.qk_rope_dim) ** -0.5 * m * m
    assert seen and all(s == pytest.approx(want) for s in seen)


# ---------------------------------------------------------------------------
# the router and the dropless dispatch
# ---------------------------------------------------------------------------
def _moe_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return moe.MoE(cfg, torch.float32, "cpu", gen)


def test_router_keeps_the_raw_softmax_top_k_probabilities(smoke):
    params = _moe_params(smoke)
    x = torch.randn(50, smoke.d_model, generator=torch.Generator().manual_seed(1))
    probs = torch.softmax(x @ params.router, -1)
    idx, w, _ = moe.route(params, x, smoke)
    assert torch.allclose(w, torch.gather(probs, 1, idx), rtol=1e-6)
    assert (w.sum(-1) < 1).all()
    scaled = dataclasses.replace(smoke, routed_scaling_factor=2.5)
    assert torch.allclose(moe.route(params, x, scaled)[1], 2.5 * w, rtol=1e-6)
    renorm = dataclasses.replace(smoke, norm_topk_prob=True)
    assert torch.allclose(moe.route(params, x, renorm)[1].sum(-1), torch.ones(50))
    # repro's configs renormalise, as before
    plain_cfg = get_config("deepseek-moe-16b", smoke=True)
    assert torch.allclose(moe.route(_moe_params(plain_cfg), x, plain_cfg)[1].sum(-1),
                          torch.ones(50))


def _one_hot_router(cfg, t=96):
    """Every token's router favours expert 0 by far: it takes all ``t``."""
    params = _moe_params(cfg, seed=2)
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(cfg.d_model, generator=gen)
    v = v / v.norm()
    x = torch.randn(t, cfg.d_model, generator=gen) * 0.1 + 2.0 * v
    with torch.no_grad():
        params.router[:, 0] = 8.0 * v
    return params, x


def _loop_over_experts(params, rows, ends):
    """``moe.grouped_experts_ffn``'s yardstick: each expert's rows through
    its FFN in turn, the offsets read on the host."""
    bounds = [0, *ends.tolist()]
    out = torch.empty_like(rows)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        gate = layers.matmul(rows[lo:hi], params.wi_gate[i])
        up = layers.matmul(rows[lo:hi], params.wi_up[i])
        out[lo:hi] = layers.matmul(layers.silu(gate) * up, params.wo[i])
    return out


@pytest.mark.parametrize("grouped", [False, True])
def test_dropless_dispatch_drops_nothing_when_one_expert_takes_every_token(smoke, grouped,
                                                                           monkeypatch):
    params, x = _one_hot_router(smoke)
    t = x.shape[0]
    _, _, load = moe.route(params, x, smoke)
    assert load[0] == t and load.sum() == t * smoke.top_k
    cap = moe.expert_capacity(dataclasses.replace(smoke, capacity_factor=1.25), t)
    assert cap < t  # a capacity of 1.25 would drop most of expert 0's tokens
    if not grouped:
        monkeypatch.setattr(moe, "grouped_experts_ffn", _loop_over_experts)
    y, aux = moe.moe_dropless(params, x, smoke)
    assert aux["dropped"].item() == 0.0 and torch.equal(aux["load"], load)
    want, _ = moe.moe_reference(params, x, smoke)
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-6)
    # the plain reference's MoE on the same tensors
    w = {"mlp.gate.weight": params.router.T}
    for e in range(smoke.n_experts):
        w[f"mlp.experts.{e}.gate_proj.weight"] = params.wi_gate[e].T
        w[f"mlp.experts.{e}.up_proj.weight"] = params.wi_up[e].T
        w[f"mlp.experts.{e}.down_proj.weight"] = params.wo[e].T
    zero = torch.zeros(smoke.n_shared_experts * smoke.moe_d_ff, smoke.d_model)
    for name in ("gate_proj", "up_proj"):
        w[f"mlp.shared_experts.{name}.weight"] = zero
    w["mlp.shared_experts.down_proj.weight"] = zero.T
    ref_y, ref_choices = plain._moe(plain._Math(torch.float32, None), published(smoke), x,
                                    w.__getitem__)
    assert torch.allclose(y, ref_y, rtol=1e-5, atol=1e-6)
    assert torch.equal(aux["choices"], ref_choices)


def test_capacity_dispatch_stays_the_default_of_repro_s_configs(smoke):
    params, x = _one_hot_router(smoke)
    capped = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True), capacity_factor=1.25)
    y, aux = moe.moe_local(params, x, capped)
    assert set(aux) == {"load"}
    block = backbone.Block(capped.period[0], capped, torch.float32, "cpu",
                           torch.Generator().manual_seed(0))
    _, _, block_aux = block(x[None], torch.arange(x.shape[0])[None], None)
    assert set(block_aux) == {"moe_load"}
    with pytest.raises(ValueError, match="dropless"):
        backbone.check_moe_impl("sharded", object(), smoke)


def test_grouped_gemm_equals_the_loop_over_experts(smoke):
    params = _moe_params(smoke, seed=4)
    counts = torch.tensor([5, 0, 17, 3, 0, 9, 1, 12])
    rows = torch.randn(int(counts.sum()), smoke.d_model, generator=torch.Generator().manual_seed(5))
    ends = torch.cumsum(counts, 0)
    loop = _loop_over_experts(params, rows, ends)
    grouped = moe.grouped_experts_ffn(params, rows, ends)
    assert torch.allclose(grouped, loop, rtol=1e-5, atol=1e-6)
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        want = moe.experts_ffn(params, rows[None, lo:hi].expand(smoke.n_experts, -1, -1))[e]
        assert torch.allclose(loop[lo:hi], want, rtol=1e-6, atol=1e-6)
        lo = hi


@pytest.mark.cuda
def test_grouped_gemm_on_the_card_equals_the_loop_at_published_widths():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch._grouped_mm's bf16 kernel runs there")
    cfg = get_config("deepseek-v2-lite")
    params = moe.MoE(cfg, torch.bfloat16, "cuda", torch.Generator("cuda").manual_seed(0))
    counts = torch.randint(0, 400, (cfg.n_experts,), generator=torch.Generator().manual_seed(1))
    counts[3] = 0
    rows = torch.randn(int(counts.sum()), cfg.d_model, device="cuda", dtype=torch.bfloat16)
    ends = torch.cumsum(counts, 0).cuda()
    grouped = moe.grouped_experts_ffn(params, rows, ends)
    loop = _loop_over_experts(params, rows, ends)
    assert torch.equal(grouped, loop)


# ---------------------------------------------------------------------------
# spans, the serving CLI, and the reference's copy
# ---------------------------------------------------------------------------
def _spans(prof, prefix="repro_torch."):
    out = {}
    for e in prof.events():
        if e.name.startswith(prefix):
            out.setdefault(e.name.removeprefix(prefix), []).append(e)
    return out


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_spans_open_and_charge_the_moe_s_operations(smoke):
    model = _model(smoke)
    tokens = _tokens(smoke, (1, 9))
    with torch.inference_mode():
        off = model.prefill(tokens, model.init_caches(1, 16))[0]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = model.prefill(tokens, model.init_caches(1, 16))[0]
    assert torch.equal(on, off)
    spans = _spans(prof)
    n_moe = smoke.n_periods
    assert {k: len(v) for k, v in spans.items()} == {
        "mla": smoke.n_layers, "moe": n_moe, "moe.dispatch": 2 * n_moe, "moe.experts": n_moe}
    for name in ("moe.dispatch", "moe.experts"):
        for e in spans[name]:
            assert sum(_inside(e, m) for m in spans["moe"]) == 1, name
    ops = [e for e in prof.events() if e.name.startswith("aten::")]

    def charged(op_name, span):
        return [o for o in ops if o.name == op_name and any(_inside(o, s) for s in spans[span])]

    assert charged("aten::sort", "moe.dispatch")  # the top-k and dispatch_slots
    assert charged("aten::cumsum", "moe.dispatch")
    assert charged("aten::mm", "moe.experts")  # the experts' products
    assert not charged("aten::sort", "moe.experts")


def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys):
    out = serve_cli.main(["--arch", "deepseek-v2-lite", "--smoke", "--device", "cpu", "--batch",
                          "2", "--prompt-len", "11", "--max-new", "5"])
    assert out.shape == (2, 5) and out.device.type == "cpu"
    assert "generated (2, 5) on cpu" in capsys.readouterr().out
    with pytest.raises(KeyError, match="deepseek-v2-lite"):
        serve_cli.main(["--arch", "deepseek-v3-lite", "--smoke", "--device", "cpu"])


def test_the_plain_reference_is_the_benchmark_s_own():
    bench = ROOT / "perfbench" / "reference" / "deepseek_v2_lite.py"
    assert Path(plain.__file__).read_bytes() == bench.read_bytes()
