"""Architecture registry of the port: ``repro_torch.configs.get("<arch-id>")``.

It holds the architectures the port serves so far.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import mamba2_370m, paper_mlp, recurrentgemma_2b, tinyllama_1_1b

_REGISTRY: dict[str, ModelConfig] = {
    mod.CONFIG.name: mod.CONFIG
    for mod in (tinyllama_1_1b, mamba2_370m, recurrentgemma_2b, paper_mlp)}


def get(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
