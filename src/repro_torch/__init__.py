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
