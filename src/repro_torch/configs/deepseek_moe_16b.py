"""deepseek-moe-16b [moe] — 28L d2048 16H (kv=16), 2 shared + 64 routed top-6.

Fine-grained experts (ff1408 each), first layer dense (ff10944), v102400,
softmax router with aux loss. [arXiv:2401.06066; hf]
The port's copy of ``repro.configs.deepseek_moe_16b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab=102400,
        prefix_layers=(BlockSpec(kind="attn", ffn="dense"),),
        period=(BlockSpec(kind="attn", ffn="moe"),),
        n_periods=27,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        router_aux_free=False,
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        prefix_layers=(BlockSpec(kind="attn", ffn="dense"),),
        period=(BlockSpec(kind="attn", ffn="moe"),),
        n_periods=2,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        moe_d_ff=32,
        capacity_factor=4.0,
        router_aux_free=False,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
