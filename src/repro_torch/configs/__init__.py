"""Architecture registry of the port: ``repro_torch.configs.get("<arch-id>")``.

It holds the architectures the port serves so far.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (deepseek_v2_lite_16b, mamba2_370m, paper_mlp,
               phi_3_vision_4_2b, recurrentgemma_2b, seamless_m4t_medium,
               tinyllama_1_1b)

_REGISTRY: dict[str, ModelConfig] = {
    mod.CONFIG.name: mod.CONFIG
    for mod in (tinyllama_1_1b, mamba2_370m, recurrentgemma_2b, paper_mlp,
                deepseek_v2_lite_16b, phi_3_vision_4_2b,
                seamless_m4t_medium)}


def get(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
