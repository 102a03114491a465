"""deepseek-v3-671b [moe] — 61L d7168, MLA 128H, 1 shared + 256 routed top-8.

First 3 layers dense (ff18432), remaining 58 MoE (per-expert ff2048),
v129280, MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128), MTP depth
1, aux-free sigmoid router. [arXiv:2412.19437; hf]
The port's copy of ``repro.configs.deepseek_v3_671b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,
        vocab=129280,
        prefix_layers=(BlockSpec(kind="mla", ffn="dense"),) * 3,
        period=(BlockSpec(kind="mla", ffn="moe"),),
        n_periods=58,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=256,
        n_shared_experts=1,
        top_k=8,
        moe_d_ff=2048,
        router_aux_free=True,
        mtp_depth=1,
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
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
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        moe_d_ff=32,
        capacity_factor=4.0,
        router_aux_free=True,
        mtp_depth=1,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
