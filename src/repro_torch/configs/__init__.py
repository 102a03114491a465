"""Architecture registry: ``get_config(arch, smoke=False)``.

``ARCHS`` names the ten architectures of ``repro.configs``. The port builds
the blocks of one of them so far, ``rwkv6-3b``; asking for another raises
``NotImplementedError`` (ROADMAP queue 1, 'LM remainder').
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import BlockSpec, ModelConfig

# arch -> the port's config module, or None while its block kinds are not ported
ARCHS: dict[str, str | None] = {
    "gemma2-27b": None,
    "glm4-9b": None,
    "yi-34b": None,
    "gemma3-1b": None,
    "zamba2-2.7b": None,
    "whisper-base": None,
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-v3-671b": None,
    "deepseek-moe-16b": None,
    "internvl2-76b": None,
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {arch!r}; have {sorted(ARCHS)}")
    module = ARCHS[arch]
    if module is None:
        raise NotImplementedError(
            f"{arch}: its block kinds are not ported to repro_torch yet "
            "(ROADMAP queue 1, 'LM remainder'); only rwkv6-3b is"
        )
    mod = importlib.import_module(module)
    return mod.smoke() if smoke else mod.config()


__all__ = ["ARCHS", "BlockSpec", "ModelConfig", "get_config"]
