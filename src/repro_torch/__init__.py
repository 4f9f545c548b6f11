"""repro_torch — the PyTorch/CUDA port of the Vec-LUT system (`repro`).

The JAX package `repro` is the reference; this package imports nothing of
it. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises, never falling
back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def module_to(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`module.to(device)` in place, unless every parameter and buffer is
    on `device` already (then nothing to move: a model of fake tensors, as
    `repro_torch.lint.ir` traces, cannot have its tensors swapped)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if all(t.device == device for t in [*module.parameters(), *module.buffers()]):
        return module
    return module.to(device)
