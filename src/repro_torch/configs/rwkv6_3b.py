"""rwkv6-3b [ssm] — Finch: 32L d2560 (attn-free) ff8960 v65536.

Data-dependent decay linear attention; channel-mix realized as the gated MLP
(deviation from the relu^2 channel-mix noted in DESIGN.md).
[arXiv:2404.05892; hf] The port's copy of ``repro.configs.rwkv6_3b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab=65536,
        period=(BlockSpec(kind="rwkv6", ffn="dense"),),
        n_periods=32,
        rwkv_lora_w=64,
        rwkv_lora_mix=32,
        ssm_chunk=64,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        family="ssm",
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        head_dim=12,
        d_ff=96,
        vocab=512,
        period=(BlockSpec(kind="rwkv6", ffn="dense"),),
        n_periods=2,
        rwkv_lora_w=8,
        rwkv_lora_mix=4,
        ssm_chunk=8,
        tie_embeddings=False,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
