"""repro_torch.configs — the architectures the port serves (--arch <id>).

Each module exposes CONFIG (the published dims) and SMOKE (a reduced
same-family config for CPU tests), as in the JAX package. Only the
architectures whose serving path has been ported are registered; asking for
any other raises."""
from __future__ import annotations

import importlib

from .base import LayerSpec, ModelConfig, uniform_layers

_MODULES = {
    "smollm-360m": "smollm_360m",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: "
            f"{sorted(_MODULES)}"
        )
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["LayerSpec", "ModelConfig", "uniform_layers", "get_config"]
