"""repro_torch.configs — the architectures the port serves (--arch <id>).

Each module exposes CONFIG (the published dims) and SMOKE (a reduced
same-family config for CPU tests), as in the JAX package. Every
architecture of the JAX package is registered: the nine decoder-only ones
and the encoder-decoder whisper-medium (`models.encdec`, served through
`launch.steps`). Asking for any other id raises."""
from __future__ import annotations

import importlib

from .base import (
    SHAPES,
    LayerSpec,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    ShapeConfig,
    SSMConfig,
    uniform_layers,
)

_MODULES = {
    "smollm-360m": "smollm_360m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma3-1b": "gemma3_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "command-r-35b": "command_r_35b",
    "chameleon-34b": "chameleon_34b",
    "whisper-medium": "whisper_medium",
}


#: archs whose attention is fully quadratic: long_500k does not apply
FULL_ATTENTION_ARCHS = frozenset({
    "llama4-scout-17b-a16e", "deepseek-v3-671b", "smollm-360m",
    "command-r-35b", "internlm2-1.8b", "whisper-medium", "chameleon-34b",
})


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def cell_is_applicable(arch: str, shape_name: str) -> bool:
    return not (shape_name == "long_500k" and arch in FULL_ATTENTION_ARCHS)


__all__ = ["SHAPES", "LayerSpec", "MLAConfig", "MoEConfig", "ModelConfig", "ShapeConfig",
           "SSMConfig", "FULL_ATTENTION_ARCHS", "uniform_layers", "list_archs", "get_config",
           "cell_is_applicable"]
