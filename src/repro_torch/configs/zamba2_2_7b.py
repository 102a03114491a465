"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d2560 + shared attention block.

32H (kv=32, head_dim 80) shared transformer block applied every 6 Mamba2
blocks with a single parameter set; ff10240 in the shared block; v32000;
ssm_state=64. [arXiv:2411.15242; hf]
The port's copy of ``repro.configs.zamba2_2_7b``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig

_M = BlockSpec(kind="mamba2", ffn="none")
_SHARED = BlockSpec(kind="attn", ffn="dense", shared=True)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        period=(_M, _M, _M, _M, _M, _M, _SHARED),
        n_periods=9,
        ssm_state=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_heads=80,  # d_inner 5120 / 64
        ssm_chunk=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        head_dim=12,
        d_ff=96,
        vocab=512,
        period=(
            BlockSpec(kind="mamba2", ffn="none"),
            BlockSpec(kind="mamba2", ffn="none"),
            BlockSpec(kind="attn", ffn="dense", shared=True),
        ),
        n_periods=2,
        ssm_state=8,
        ssm_expand=2,
        ssm_heads=4,
        ssm_chunk=8,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
