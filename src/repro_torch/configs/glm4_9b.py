"""glm4-9b [dense] — 40L d4096 32H (GQA kv=2) ff13696 v151552. RoPE, GQA.

[hf:THUDM/glm-4-9b; hf]
The port's copy of ``repro.configs.glm4_9b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab=151552,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=40,
        rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family="dense",
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=3,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
