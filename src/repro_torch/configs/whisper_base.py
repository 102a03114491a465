"""whisper-base [audio] — 6L enc + 6L dec, d512 8H ff2048 v51865.

Enc-dec; the conv frontend is a STUB per the assignment: ``input_specs``
provides precomputed 1500-frame embeddings. [arXiv:2212.04356; unverified]
The port's copy of ``repro.configs.whisper_base``.
"""

from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=6,
        n_enc_layers=6,
        enc_seq=1500,
        frontend="audio_stub",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke",
        family="audio",
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        head_dim=12,
        d_ff=96,
        vocab=512,
        period=(BlockSpec(kind="attn", ffn="dense"),),
        n_periods=2,
        n_enc_layers=2,
        enc_seq=24,
        frontend="audio_stub",
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
