"""gemma3-1b [dense] — 26L d1152 4H (GQA kv=1) ff6912 v262144.

5:1 local(512):global pattern, 128k context, qk-norm, head_dim 256.
[hf:google/gemma-3-1b-pt; unverified]
The port's copy of ``repro.configs.gemma3_1b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig

_LOCAL = BlockSpec(kind="attn", window=512, ffn="dense")
_GLOBAL = BlockSpec(kind="attn", window=None, ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262144,
        period=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
        n_periods=4,
        remainder=(_LOCAL, _LOCAL),
        qk_norm=True,
        post_block_norm=True,
        scale_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke",
        family="dense",
        d_model=48,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=96,
        vocab=512,
        period=(
            BlockSpec(kind="attn", window=8, ffn="dense"),
            BlockSpec(kind="attn", window=8, ffn="dense"),
            BlockSpec(kind="attn", window=None, ffn="dense"),
        ),
        n_periods=2,
        remainder=(BlockSpec(kind="attn", window=8, ffn="dense"),),
        qk_norm=True,
        post_block_norm=True,
        scale_embeddings=True,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
