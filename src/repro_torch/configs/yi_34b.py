"""yi-34b [dense] — 60L d7168 56H (GQA kv=8) ff20480 v64000. llama-arch GQA.

[arXiv:2403.04652; hf]
The port's copy of ``repro.configs.yi_34b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=60,
        rope_theta=5_000_000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        family="dense",
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab=512,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=3,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
