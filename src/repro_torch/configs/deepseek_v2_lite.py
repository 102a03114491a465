"""deepseek-v2-lite [moe] — 27L d2048, MLA 16H, 2 shared + 64 routed top-6.

DeepSeek-V2-Lite (15.7B total, 2.4B active; arXiv:2405.04434, and
huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json): multi-head
latent attention on every layer with no query compression (kv_lora 512,
nope 128, rope 64, v 128, RMSNorm on the latent), YaRN rope (factor 40 over
an original 4096 positions, beta_fast 32, beta_slow 1, mscale =
mscale_all_dim = 0.707, theta 10,000); layer 0 a dense SwiGLU FFN of
10,944, layers 1-26 MoE with 64 routed experts of 1,408 and 2 shared (one
SwiGLU of 2,816), a softmax router, greedy top-6, ``norm_topk_prob`` false
(the six weights are the raw softmax probabilities),
``routed_scaling_factor`` 1; vocab 102,400, untied embeddings, RMSNorm eps
1e-6. Served dropless: every one of a batch's ``T * 6`` assignments reaches
its expert (``models.moe.moe_dropless``).

A port-only configuration (``configs.PORT_ARCHS``): ``repro`` has no such
model. Departures from the published model:

* rope layout: the port rotates split halves (element ``i`` with ``i +
  D/2``); the published checkpoint's rope columns of ``q_proj`` and of the
  rope rows of ``kv_a_proj_with_mqa`` are interleaved pairs, which
  ``checkpoint.hf.load_deepseek_v2`` permutes once into the port's layout
  (the model's outputs are the same);
* RMSNorm scales enter as ``1 + scale`` (the port's norm), so a published
  weight ``w`` loads as ``w - 1``.
"""

from repro_torch.configs.base import BlockSpec, PortModelConfig, YaRN


def config() -> PortModelConfig:
    return PortModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab=102400,
        prefix_layers=(BlockSpec(kind="mla", ffn="dense"),),
        period=(BlockSpec(kind="mla", ffn="moe"),),
        n_periods=26,
        q_lora_rank=0,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        router_aux_free=False,
        rope_theta=10000.0,
        tie_embeddings=False,
        yarn=YaRN(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                  mscale=0.707, mscale_all_dim=0.707),
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        moe_dropless=True,
    )


def smoke() -> PortModelConfig:
    return PortModelConfig(
        name="deepseek-v2-lite-smoke",
        family="moe",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        prefix_layers=(BlockSpec(kind="mla", ffn="dense"),),
        period=(BlockSpec(kind="mla", ffn="moe"),),
        n_periods=2,
        q_lora_rank=0,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        n_experts=8,
        n_shared_experts=2,
        top_k=3,
        moe_d_ff=32,
        router_aux_free=False,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
        yarn=YaRN(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                  mscale=0.707, mscale_all_dim=0.707),
        norm_topk_prob=False,
        routed_scaling_factor=1.0,
        moe_dropless=True,
    )
