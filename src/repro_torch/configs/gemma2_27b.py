"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) ff36864 v256000.

Local(4096):global alternating, attn softcap 50, final softcap 30, post-block
norms, embedding scaling. [arXiv:2408.00118; hf]
The port's copy of ``repro.configs.gemma2_27b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig

_LOCAL = BlockSpec(kind="attn", window=4096, ffn="dense")
_GLOBAL = BlockSpec(kind="attn", window=None, ffn="dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        period=(_LOCAL, _GLOBAL),
        n_periods=23,
        attn_softcap=50.0,
        final_softcap=30.0,
        attn_scale=(4608 / 32) ** -0.5,  # query scaled by d_model/n_heads
        post_block_norm=True,
        scale_embeddings=True,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        family="dense",
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        period=(
            BlockSpec(kind="attn", window=8, ffn="dense"),
            BlockSpec(kind="attn", window=None, ffn="dense"),
        ),
        n_periods=2,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_block_norm=True,
        scale_embeddings=True,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
