"""internvl2-76b [vlm] — 80L d8192 64H (GQA kv=8) ff28672 v128256.

Llama-3-70B-style language backbone; InternViT frontend is a STUB per the
assignment (``input_specs`` provides 256 precomputed patch embeddings that
overwrite the first token positions). [arXiv:2404.16821; unverified]
The port's copy of ``repro.configs.internvl2_76b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=80,
        rope_theta=500000.0,
        frontend="vision_stub",
        n_prefix_embeddings=256,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        family="vlm",
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab=512,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=3,
        frontend="vision_stub",
        n_prefix_embeddings=4,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
