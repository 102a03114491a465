"""Model configuration schema: the port's copy of ``repro.configs.base``.

One ``ModelConfig`` describes every architecture of the pool; the block
pattern is a repeating *period* of block descriptors repeated
``n_periods`` times (DESIGN.md §4). The port builds the period's blocks
one module per layer. Frozen dataclasses, no imports beyond the standard
library, field for field as in ``repro`` so a configuration means the same
model in both packages.

``PortModelConfig`` adds what only the port's own configurations use
(``configs.PORT_ARCHS``, which ``repro`` does not have): YaRN rope
scaling, top-k weights kept as the raw router probabilities, a routed
scaling factor, and dropless expert dispatch. Code reads these options
with :func:`option`, so a plain ``ModelConfig`` keeps its defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mla", "mamba2", "rwkv6"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block of the repeating period."""

    kind: BlockKind = "attn"
    window: int | None = None  # sliding-window size; None = global attention
    ffn: Literal["dense", "moe", "none"] = "dense"
    shared: bool = False  # zamba2: block re-uses the single shared param set


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"] = "dense"

    # -- dimensions -------------------------------------------------------
    d_model: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 4096
    vocab: int = 32000

    # -- stack ------------------------------------------------------------
    period: tuple[BlockSpec, ...] = (BlockSpec(),)
    n_periods: int = 12
    remainder: tuple[BlockSpec, ...] = ()  # extra blocks after the scan
    prefix_layers: tuple[BlockSpec, ...] = ()  # blocks before the scan (dsv3 dense-first)

    # -- attention --------------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None  # gemma2: 50.0
    final_softcap: float | None = None  # gemma2: 30.0
    attn_scale: float | None = None  # override 1/sqrt(head_dim) (gemma2 uses d/ n_heads)

    # -- MLA (deepseek) ----------------------------------------------------
    q_lora_rank: int = 0  # 0 = no q compression
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0  # per-expert hidden
    capacity_factor: float = 1.25
    router_aux_free: bool = True  # deepseek-v3 bias-based load balancing
    moe_two_stage: bool = True  # use the paper's two-stage tag dispatch

    # -- SSM (mamba2) -------------------------------------------------------
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0  # 0 -> d_inner / 64
    ssm_chunk: int = 128

    # -- rwkv6 ---------------------------------------------------------------
    rwkv_lora_w: int = 64  # decay lora rank
    rwkv_lora_mix: int = 32

    # -- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 1500  # stub frame-embedding count

    # -- modality frontend stub ----------------------------------------------
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    n_prefix_embeddings: int = 0  # vlm: vision tokens prepended (stubbed)

    # -- embeddings / norm -----------------------------------------------------
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6
    post_block_norm: bool = False  # gemma2/3: extra norms after attn/ffn

    # -- MTP (deepseek-v3) -------------------------------------------------------
    mtp_depth: int = 0

    # -- numerics / training ------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: Literal["none", "dots", "full"] = "full"

    @property
    def n_layers(self) -> int:
        return (
            len(self.prefix_layers)
            + self.n_periods * len(self.period)
            + len(self.remainder)
        )

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // 64

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter estimate — used for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb

        def block_params(b: BlockSpec) -> tuple[int, int]:
            t = a = 0
            if b.kind == "attn":
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                o = self.n_heads * self.head_dim * d
                t = a = qkv + o
            elif b.kind == "mla":
                t = d * self.kv_lora_rank + d * self.qk_rope_dim
                q_in = self.q_lora_rank or d
                if self.q_lora_rank:
                    t += d * self.q_lora_rank
                t += q_in * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                t += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                t += self.n_heads * self.v_head_dim * d
                a = t
            elif b.kind == "mamba2":
                di = self.d_inner
                t = d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) + di * d
                a = t
            elif b.kind == "rwkv6":
                t = d * d * 4 + d * (self.rwkv_lora_w + self.rwkv_lora_mix) * 2
                a = t
            if b.ffn == "dense":
                f = 3 * d * self.d_ff
                t += f
                a += f
            elif b.ffn == "moe":
                fe = 3 * d * self.moe_d_ff
                t += self.n_experts * fe + self.n_shared_experts * fe + d * self.n_experts
                a += (self.top_k + self.n_shared_experts) * fe + d * self.n_experts
            return t, a

        blocks = (
            list(self.prefix_layers)
            + list(self.period) * self.n_periods
            + list(self.remainder)
        )
        seen_shared = False
        for b in blocks:
            t, a = block_params(b)
            if b.shared:  # one param set, many applications
                if not seen_shared:
                    total += t
                    seen_shared = True
                active += a  # compute happens on every application
            else:
                total += t
                active += a
        # encoder stack (whisper): same attn+ffn blocks without KV grouping
        if self.n_enc_layers:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            o = self.n_heads * self.head_dim * d
            f = 3 * d * self.d_ff
            cross = qkv + o
            total += self.n_enc_layers * (qkv + o + f) + self.n_layers * cross
            active += self.n_enc_layers * (qkv + o + f) + self.n_layers * cross
        return int(total), int(active)


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN rope scaling (arXiv:2309.00071), as DeepSeek-V2 configures it:
    the inverse frequencies blend extrapolated and ``factor``-interpolated
    ones over a linear ramp between the correction dims of ``beta_fast``
    and ``beta_slow`` rotations in ``original_max_position`` positions;
    the softmax scale takes ``mscale(mscale_all_dim) ** 2`` and cos/sin
    ``mscale(mscale) / mscale(mscale_all_dim)``, with ``mscale(m) = 0.1 *
    m * ln(factor) + 1``."""

    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ``ModelConfig`` with the options of the port's own configurations."""

    yarn: YaRN | None = None  # None: plain rope at rope_theta
    norm_topk_prob: bool = True  # False: top-k weights are the raw softmax probabilities
    routed_scaling_factor: float = 1.0  # multiplies the routed experts' weights
    moe_dropless: bool = False  # every assignment reaches its expert (no capacity)


_OPTIONS = {f.name: f.default for f in dataclasses.fields(PortModelConfig)
            if f.name not in {g.name for g in dataclasses.fields(ModelConfig)}}


def option(cfg: ModelConfig, name: str):
    """``cfg``'s value of a ``PortModelConfig`` option, its default for a
    plain ``ModelConfig``."""
    return getattr(cfg, name, _OPTIONS[name])
