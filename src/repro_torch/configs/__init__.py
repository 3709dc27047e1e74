"""Architecture registry of the port: ``repro_torch.configs.get("<arch-id>")``.

It holds every architecture of the reference's registry.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (command_r_35b, deepseek_v2_lite_16b, gemma2_9b, mamba2_370m,
               minicpm_2b, mixtral_8x7b, paper_mlp, phi_3_vision_4_2b,
               recurrentgemma_2b, seamless_m4t_medium, tinyllama_1_1b)

_REGISTRY: dict[str, ModelConfig] = {
    mod.CONFIG.name: mod.CONFIG
    for mod in (tinyllama_1_1b, mamba2_370m, recurrentgemma_2b, paper_mlp,
                deepseek_v2_lite_16b, phi_3_vision_4_2b,
                seamless_m4t_medium, minicpm_2b, command_r_35b, gemma2_9b,
                mixtral_8x7b)}


def get(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
