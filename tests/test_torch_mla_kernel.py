"""The MLA prefill's causal attention kernel (``kernels/mla_attention``) on
the CPU: the dispatch in ``models/mla.py`` that sends only bf16 card tensors
at the full head sizes to it, the wrapper's refusal of CPU tensors, its
build, and the benchmark's two readers of it (``mla_attention_ms_per_prefill``,
``mla_attention_roofline``) with the byte and operation counts behind the
second. The kernel itself is held on the card in ``tests/test_torch_cuda.py``.
"""

import types

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.models import mla

ROOT = _build._REPO_ROOT
CELL = "deepseek-v2-lite.prefill4k"
KERNEL = ("(anonymous namespace)::mla_attention_kernel(CUtensorMap_st, CUtensorMap_st, "
          "CUtensorMap_st, (anonymous namespace)::Params)")


def _stand_in(shape, dtype=torch.bfloat16, cuda=True, requires_grad=False):
    """What :func:`mla.takes_kernel` reads of a tensor, for a card this
    machine may not have."""
    return types.SimpleNamespace(shape=shape, dtype=dtype, is_cuda=cuda,
                                 requires_grad=requires_grad)


def _args(b=2, s=9, h=16, dqk=192, dv=128, dtype=torch.bfloat16, cuda=True, pos=torch.int64,
          requires_grad=False):
    q, k = (_stand_in((b, s, h, dqk), dtype, cuda, requires_grad) for _ in range(2))
    v = _stand_in((b, s, h, dv), dtype, cuda, requires_grad)
    return q, k, v, _stand_in((b, s), pos, cuda)


@pytest.mark.parametrize("case,kwargs,want", [
    ("the card, bf16, 192 / 128", {}, True),
    ("128 heads (deepseek-v3)", {"h": 128}, True),
    ("the CPU", {"cuda": False}, False),
    ("float32 on the card", {"dtype": torch.float32}, False),
    ("the smoke sizes, 16 + 8 / 16", {"dqk": 24, "dv": 16}, False),
    ("int32 positions", {"pos": torch.int32}, False),
])
def test_takes_kernel_only_for_bf16_card_tensors_at_the_full_head_sizes(case, kwargs, want):
    with torch.inference_mode():
        assert mla.takes_kernel(*_args(**kwargs)) is want, case


def test_takes_kernel_leaves_inputs_that_need_a_gradient_to_attention_core():
    args = _args(requires_grad=True)
    with torch.enable_grad():
        assert not mla.takes_kernel(*args)
    with torch.no_grad():
        assert mla.takes_kernel(*args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_prefill_at_full_width_takes_attention_core(dtype, monkeypatch):
    """One MLA layer of DeepSeek-V2-Lite at its published sizes on the CPU:
    the prefill goes through ``attention_core`` and never reaches the
    kernel's wrapper."""
    cfg = get_config("deepseek-v2-lite")
    params = mla.MLA(cfg, dtype, "cpu", torch.Generator().manual_seed(0))
    seen = []
    core = mla.attention_core

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return core(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel's wrapper")

    monkeypatch.setattr(mla, "attention_core", spy)
    monkeypatch.setattr(mla.mla_ops, "mla_attention", refuse)
    x = torch.randn((1, 6, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(dtype)
    pos = torch.arange(6).expand(1, 6)
    with torch.inference_mode():
        out, _ = mla.mla_layer(params, x, pos, cfg)
    assert seen == [(1, 6, cfg.n_heads, mla_ops.QK_DIM)]
    assert out.shape == x.shape and out.dtype == dtype and torch.isfinite(out.float()).all()


def test_the_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 2, mla_ops.QK_DIM), dtype=torch.bfloat16)
    v = torch.zeros((1, 4, 2, mla_ops.V_DIM), dtype=torch.bfloat16)
    launches = mla_ops.mla_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        mla_ops.mla_attention(q, q, v, torch.arange(4).expand(1, 4), 0.1)
    assert mla_ops.mla_attention.launches == launches


def test_the_kernel_is_built_like_the_others_and_sizes_its_heads():
    src = _build.sources()["mla_attention"]
    assert src == ROOT / "src/repro_torch/kernels/mla_attention/csrc/mla_attention.cu"
    # a header of its own would enter every library's hash
    assert not any("mla_attention" in str(h) for h in _build.headers())
    text = src.read_text()
    assert f"constexpr int kDqk = {mla_ops.QK_DIM};" in text
    assert f"constexpr int kDv = {mla_ops.V_DIM};" in text
    assert f"constexpr int kBlockM = {mla_ops.BLOCK_ROWS};" in text
    cfg = get_config("deepseek-v2-lite")
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (mla_ops.QK_DIM, mla_ops.V_DIM)
    v3 = get_config("deepseek-v3-671b")
    assert (v3.qk_nope_dim + v3.qk_rope_dim, v3.v_head_dim) == (mla_ops.QK_DIM, mla_ops.V_DIM)


# ---------------------------------------------------------------------------
# the benchmark's readers of the kernel
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench():
    """The cell's files and the counts, imported from the repository root."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        from perfbench import harness
        from perfbench.drivers import lm_prefill
        from perfbench.reference import counts_mla_attention, counts_prefill

        cell = harness.Cell(ROOT, CELL)
        shape = lm_prefill.System(cell.config, cell.mix, cell.spec, "cpu").shape()
        yield types.SimpleNamespace(cell=cell, shape=shape, counts=counts_mla_attention,
                                    prefill=counts_prefill)


def test_attention_counts_are_the_prefill_counts_attention_term(bench):
    t = bench.counts.terms(bench.shape)
    assert sum(t["ops"].values()) == bench.prefill.terms(bench.shape)["ops"]["attention_scores"]
    # 2 * 27 layers * 16 heads * 4 * 4096 * 4097 / 2 pairs * (192 + 128)
    assert sum(t["ops"].values()) == pytest.approx(9.2803e12, rel=1e-4)
    # q, k, v read and o written once a layer in bf16: 27 * 16,384 * 16 * 640 * 2
    assert sum(t["bytes"].values()) == 27 * 4 * 4096 * 16 * (192 + 192 + 128 + 128) * 2
    other = dict(bench.shape, prompt_len=1000, n_heads=128)
    assert sum(bench.counts.terms(other)["ops"].values()) == (
        bench.prefill.terms(other)["ops"]["attention_scores"])


def _record(bench, by_name: dict[str, float], calls: dict[str, int], batches: int = 1) -> dict:
    trace = {"by_name": by_name, "calls": calls, "indices": list(range(5, 5 + batches))}
    return {"trace": trace, "shape": bench.shape}


def test_the_readers_read_nothing_without_the_kernel(bench):
    for name in ("mla_attention_ms_per_prefill", "mla_attention_roofline"):
        assert name in [m["name"] for m in bench.cell.metrics("per_layer")]
        reader = bench.cell.reader(name)
        assert reader.read(_record(bench, {}, {})) is None
        kept_no_table = {"trace": {"busy_s": 2.0, "indices": [7, 8], "ops": 40000},
                         "shape": bench.shape}
        assert reader.read(kept_no_table) is None
        plain = {"void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>": 0.26}
        assert reader.read(_record(bench, plain, {k: 108 for k in plain})) is None


def test_the_readers_read_the_kernel_per_batch(bench):
    by_name = {KERNEL: 0.040, "void at::native::elementwise_kernel<128, 2>": 0.5}
    calls = {KERNEL: 54, "void at::native::elementwise_kernel<128, 2>": 900}
    record = _record(bench, by_name, calls, batches=2)
    assert bench.cell.reader("mla_attention_ms_per_prefill").read(record) == pytest.approx(20.0)
    t = bench.counts.terms(bench.shape)
    least = sum(t["ops"].values()) / 989.4e12  # operations bound it
    assert least > sum(t["bytes"].values()) / 3.35e12
    got = bench.cell.reader("mla_attention_roofline").read(record)
    assert got == pytest.approx(100.0 * least / 0.020)
    assert 45.0 < got < 48.0
