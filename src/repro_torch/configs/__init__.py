"""Architecture registry: ``get_config(arch, smoke=False)``.

``ARCHS`` names the ten architectures of ``repro.configs``. The port builds
the blocks of eight of them (attention with a dense or MoE FFN, encoders,
frontend stubs, RWKV-6); asking for ``deepseek-v3-671b`` (MLA, MTP) or
``zamba2-2.7b`` (Mamba2, shared blocks) raises ``NotImplementedError``
(ROADMAP queue 1, 'LM remainder').
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import BlockSpec, ModelConfig

# arch -> the port's config module, or None while its block kinds are not ported
ARCHS: dict[str, str | None] = {
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "zamba2-2.7b": None,
    "whisper-base": "repro_torch.configs.whisper_base",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-v3-671b": None,
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; have {sorted(ARCHS)}")
    module = ARCHS[arch]
    if module is None:
        raise NotImplementedError(
            f"{arch}: its block kinds are not ported to repro_torch yet "
            "(ROADMAP queue 1, 'LM remainder')"
        )
    mod = importlib.import_module(module)
    return mod.smoke() if smoke else mod.config()


__all__ = ["ARCHS", "BlockSpec", "ModelConfig", "get_config"]
