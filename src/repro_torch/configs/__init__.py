"""Architecture registry: ``get_config(arch, smoke=False)``, and the shape cells.

``ARCHS`` names the ten architectures of ``repro.configs``, each mapped to
the port's field-for-field copy of its config module. The port builds the
blocks of all ten: attention with a dense or MoE FFN, encoders, frontend
stubs, RWKV-6, MLA with MTP (deepseek-v3-671b), Mamba2 with a shared
attention block (zamba2-2.7b). ``PORT_ARCHS`` names the port's own
configurations, which ``repro`` does not have (deepseek-v2-lite: MLA with
YaRN and dropless MoE, on ``configs.base.PortModelConfig``);
``get_config`` reads both registries.

``SHAPES`` are ``repro``'s per-arch input shapes and ``cells()`` its 40
(arch x shape) cells with their applicability flags (DESIGN.md §5), field
for field.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import BlockSpec, ModelConfig

# arch -> the port's config module
ARCHS: dict[str, str] = {
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
}

# arch -> config module, for the port's own configurations (not in repro)
PORT_ARCHS: dict[str, str] = {
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = (
    Shape("train_4k", 4096, 256, "train"),
    Shape("prefill_32k", 32768, 32, "prefill"),
    Shape("decode_32k", 32768, 128, "decode"),
    Shape("long_500k", 524288, 1, "decode"),
)

# archs allowed to run long_500k (sub-quadratic families; DESIGN.md §5)
LONG_OK = {"zamba2-2.7b", "rwkv6-3b"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    modules = {**ARCHS, **PORT_ARCHS}
    if arch not in modules:
        raise KeyError(f"unknown architecture {arch!r}; have {sorted(modules)}")
    mod = importlib.import_module(modules[arch])
    return mod.smoke() if smoke else mod.config()


def cells():
    """All 40 (arch, shape, runnable, skip_reason) cells."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            skip = None
            if shape.name == "long_500k" and arch not in LONG_OK:
                skip = "full-attention family: long_500k skipped per shape rules"
            out.append((arch, shape, skip is None, skip))
    return out


__all__ = ["ARCHS", "LONG_OK", "PORT_ARCHS", "SHAPES", "BlockSpec", "ModelConfig", "Shape", "cells",
           "get_config"]
